"""The port's CPU oracle, canary gate and explain query against the JAX
package's, on the CPU.

* ``OracleVerdictEngine``: verdicts, ``auth_required`` and ``l7_log``
  equal to the reference oracle's on the ``examples/policies`` corpus
  and the reference-capture golden (and their golden verdicts), on
  the synth scenarios under each auth
  view and audit mode, through the record entry points, and
  ``http_proxy_actions``; ``OracleMatcher`` alike. The oracle reads the
  port's own ``AUTH_UNENFORCED`` object.
* ``CanaryController`` (mirrors ``tests/test_canary.py``): the counter
  walk, a refused bad rollout with the serving triple untouched, a
  clean commit, the sample floor, the restage reset, the report, a
  shadow-dispatch fault that aborts — and the double dispatch through
  a ``ServeLoop`` bound to the port's real loader.
* ``resolve_explain``: a traced chunk served through each package's
  loader and serve loop re-resolves through ``fallback_engine`` with
  the same records and agreement.
"""

import copy
import importlib
import types

import numpy as np
import pytest

from test_torch_loader import _plain, corpora  # noqa: F401


def _pkg(root):
    ns = types.SimpleNamespace(root=root, jax=root == "cilium_tpu")
    for attr, mod in (("config", "core.config"),
                      ("loader", "runtime.loader"),
                      ("canary", "runtime.canary"),
                      ("explain", "runtime.explain"),
                      ("tracing", "runtime.tracing"),
                      ("serveloop", "runtime.serveloop"),
                      ("simclock", "runtime.simclock"),
                      ("faults", "runtime.faults"),
                      ("metrics", "runtime.metrics"),
                      ("oracle", "policy.oracle"),
                      ("omatch", "policy.compiler.oracle"),
                      ("synth", "ingest.synth"),
                      ("binary", "ingest.binary"),
                      ("flow", "core.flow")):
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    if ns.jax:
        from cilium_tpu.auth import AUTH_UNENFORCED
    else:
        from cilium_tpu_torch.engine.verdict import AUTH_UNENFORCED
    ns.AUTH_UNENFORCED = AUTH_UNENFORCED
    return ns


JAX, PORT = _pkg("cilium_tpu"), _pkg("cilium_tpu_torch")
PKGS = (JAX, PORT)


def _out(out):
    return {k: np.asarray(v).tolist() for k, v in out.items()}


def _loader(pkg, tmp_path, **canary):
    cfg = pkg.config.Config()
    cfg.enable_tpu_offload = True
    cfg.loader.enable_cache = False
    cfg.loader.cache_dir = str(tmp_path / pkg.root)
    cfg.compile.deadline_s = 600.0
    for k, v in canary.items():
        setattr(cfg.canary, k, v)
    return (pkg.loader.Loader(cfg) if pkg.jax
            else pkg.loader.Loader(cfg, device="cpu"))


# ================================================================ oracle
@pytest.mark.parametrize("name", ["controlplane", "capture"])
def test_oracle_on_the_corpus_equals_reference_and_goldens(corpora, name):
    jpi, jflows, ppi, pflows, golden, unenforced = corpora[name]
    runs = []
    for pkg, pi, flows in ((JAX, jpi, jflows), (PORT, ppi, pflows)):
        outs = []
        for audit in (False, True):
            o = pkg.oracle.OracleVerdictEngine(pi, audit=audit)
            outs.append(_out(o.verdict_flows(
                flows, authed_pairs=(pkg.AUTH_UNENFORCED if unenforced
                                     else None))))
            outs.append(_out(o.verdict_flows(flows)))
        o = pkg.oracle.OracleVerdictEngine(pi)
        outs.append([int(o.verdict_one(f)) for f in flows])
        outs.append([_plain(pkg.oracle.http_proxy_actions(
            e.l7_rules, f)) for f in flows
            for e in [pkg.oracle.lookup_entry(pi, f)[1]] if e is not None])
        runs.append(outs)
    assert runs[0] == runs[1]
    assert runs[1][0]["verdict"] == golden


@pytest.mark.parametrize("name", ["http", "fqdn", "kafka"])
def test_oracle_on_synth_scenarios_and_record_paths(name):
    runs = []
    for pkg in PKGS:
        pi, sc = pkg.synth.realize_scenario(
            pkg.synth.scenario_by_name(name, 24, 200))
        o = pkg.oracle.OracleVerdictEngine(pi)
        ids = sorted(sc.ids.values())
        pairs = np.array([[ids[0], ids[-1]], [ids[-1], ids[0]]],
                         dtype=np.int32)
        rec, l7, offsets, blob, gen = pkg.binary.capture_from_bytes(
            pkg.binary.capture_to_bytes(sc.flows))
        runs.append((_out(o.verdict_flows(sc.flows)),
                     _out(o.verdict_flows(sc.flows, authed_pairs=pairs)),
                     _out(o.verdict_flows(sc.flows, outputs=("verdict",))),
                     _out(o.verdict_l7_records(rec, l7, offsets, blob)),
                     _out(o.verdict_records(rec))))
    assert runs[0] == runs[1]
    assert runs[1][0]["verdict"] == runs[1][3]["verdict"]


def test_oracle_matcher_equals_reference():
    pats = ["/api/v[0-9]+/.*", "GET|PUT", "(?:www\\.)?example\\.com",
            "[a-z]{3}"]
    strings = ["/api/v3/x", "GET", "WWW.example.com", "abc", "ab", "",
               "/api/vx/"]
    for ci in (False, True):
        j = JAX.omatch.OracleMatcher(pats, case_insensitive=ci)
        p = PORT.omatch.OracleMatcher(pats, case_insensitive=ci)
        assert (j.match_matrix(strings) == p.match_matrix(strings)).all()
        assert (j.match_any(strings) == p.match_any(strings)).all()
        assert (j.match_one("GET") == p.match_one("GET")).all()


# ================================================================ canary
class _CanaryWorld:
    """The reference canary test's world: db accepts web on one port."""

    def __init__(self, pkg, tmp_path, port=5432, **canary_kw):
        self.pkg = pkg
        self.loader = _loader(pkg, tmp_path)
        self.per, self.db, self.web = self.policy(port)
        self.loader.regenerate(self.per, revision=1)
        self.ctrl = pkg.canary.CanaryController(self.loader, **canary_kw)

    def policy(self, port):
        from importlib import import_module

        r = self.pkg.root
        api = import_module(f"{r}.policy.api")
        flow = self.pkg.flow
        alloc = import_module(f"{r}.core.identity").IdentityAllocator()
        LabelSet = import_module(f"{r}.core.labels").LabelSet
        db = alloc.allocate(LabelSet.from_dict({"app": "db"}))
        web = alloc.allocate(LabelSet.from_dict({"app": "web"}))
        repo = import_module(f"{r}.policy.repository").Repository()
        repo.add([api.Rule(
            endpoint_selector=api.EndpointSelector.from_labels(app="db"),
            ingress=(api.IngressRule(
                from_endpoints=(api.EndpointSelector.from_labels(
                    app="web"),),
                to_ports=(api.PortRule(ports=(
                    api.PortProtocol(port, flow.Protocol.TCP),)),)),),
        )], sanitize=False)
        cache = import_module(f"{r}.policy.selectorcache").SelectorCache(
            alloc)
        res = import_module(f"{r}.policy.mapstate").PolicyResolver(
            repo, cache)
        return {db: res.resolve(alloc.lookup(db))}, db, web

    def flows(self, n, port=5432):
        f = self.pkg.flow
        return [f.Flow(src_identity=self.web, dst_identity=self.db,
                       dport=port, protocol=f.Protocol.TCP,
                       direction=f.TrafficDirection.INGRESS)] * n

    def served(self, flows):
        return [int(v) for v in
                self.loader.engine.verdict_flows(flows)["verdict"]]


def test_canary_counter_walk_equals_reference(tmp_path):
    picks = []
    for pkg in PKGS:
        w = _CanaryWorld(pkg, tmp_path, sample_fraction=0.25)
        try:
            picked = [c for c in range(1, 101) if w.ctrl.should_sample(c)]
            assert len(picked) == 25
            assert [c for c in range(1, 101)
                    if w.ctrl.should_sample(c)] == picked
            w.ctrl.sample_fraction = 0.0
            assert not any(w.ctrl.should_sample(c) for c in range(1, 50))
            w.ctrl.sample_fraction = 1.0
            assert all(w.ctrl.should_sample(c) for c in range(1, 50))
            picks.append(picked)
        finally:
            w.loader.close()
    assert picks[0] == picks[1]


def _bad(per):
    bad = copy.deepcopy(per)
    for ms in bad.values():
        for entry in ms.entries.values():
            entry.is_deny = True
    return bad


def test_canary_lifecycle_equals_reference(tmp_path):
    """Refused bad rollout (serving triple untouched), clean commit,
    sample floor, restage reset, idle inertia, report shape: the same
    ledger and reports in both packages."""
    runs = []
    for pkg in PKGS:
        m, trail = pkg.metrics, []
        w = _CanaryWorld(pkg, tmp_path / "a", sample_fraction=1.0,
                         diff_budget=0.0, min_samples=4)
        try:
            ctrl, loader = w.ctrl, w.loader
            assert not ctrl.observe_chunk(w.flows(1), [1])
            with pytest.raises(RuntimeError, match="no canary sampling"):
                ctrl.try_commit()
            refused0 = m.METRICS.get(m.CANARY_COMMITS,
                                     {"result": "refused"})
            serving = loader.engine
            ctrl.stage(_bad(w.per), revision=2)
            flows = w.flows(4)
            served = w.served(flows)
            assert ctrl.observe_chunk(flows, served) and ctrl.diffs == 4
            with pytest.raises(pkg.canary.CanaryRefused) as exc:
                ctrl.try_commit()
            assert loader.revision == 1 and loader.engine is serving
            assert loader.canary_engine is None
            assert w.served(flows) == served
            assert m.METRICS.get(m.CANARY_COMMITS,
                                 {"result": "refused"}) == refused0 + 1
            trail.append(exc.value.report)
            # clean: same semantics, a new generation commits
            per2, _, _ = w.policy(5432)
            ctrl.stage(per2, revision=3)
            ctrl.observe_chunk(flows, served)
            assert ctrl.diffs == 0
            engine = ctrl.try_commit()
            assert loader.revision == 3 and engine is loader.engine
            assert ctrl.state == pkg.canary.STATE_COMMITTED
            trail.append(ctrl.report())
            # the floor: zero diffs over too few samples refuses
            ctrl.min_samples = 64
            ctrl.stage(per2, revision=4)
            ctrl.observe_chunk(flows, served)
            with pytest.raises(pkg.canary.CanaryRefused) as exc:
                ctrl.try_commit()
            assert "floor" in exc.value.report["reason"]
            assert loader.revision == 3
            trail.append(exc.value.report)
            # a restage resets the ledger
            ctrl.stage(per2, revision=5)
            ctrl.observe_chunk(flows[:3], served[:3])
            ctrl.stage(per2, revision=6)
            assert (ctrl.samples, ctrl.diffs, ctrl.chunks) == (0, 0, 0)
            assert loader.canary_revision == 6
            trail.append(ctrl.report())
            loader.config.canary.sample_fraction = 0.125
            loader.config.canary.min_samples = 3
            c2 = pkg.canary.CanaryController.from_config(loader)
            trail.append(c2.report())
        finally:
            w.loader.close()
        runs.append(trail)
    assert runs[0] == runs[1]


def test_canary_shadow_fault_aborts_and_serving_is_untouched(tmp_path):
    runs = []
    for pkg in PKGS:
        w = _CanaryWorld(pkg, tmp_path, sample_fraction=1.0,
                         min_samples=1)
        try:
            w.ctrl.stage(_bad(w.per), revision=2)
            flows = w.flows(4)
            served = w.served(flows)
            f = pkg.faults
            with f.inject(f.FaultPlan([f.FaultRule("canary.dispatch",
                                                   times=1)])):
                assert not w.ctrl.observe_chunk(flows, served)
            assert w.ctrl.state == pkg.canary.STATE_ABORTED
            assert w.loader.canary_engine is None
            assert w.loader.revision == 1 and w.served(flows) == served
            runs.append(w.ctrl.report())
        finally:
            w.loader.close()
    assert runs[0] == runs[1]


def test_canary_double_dispatch_through_the_serve_loop(tmp_path):
    """A ServeLoop on the real loader, with a CanaryController wired:
    every sampled chunk re-verdicts through the staged (bad) shadow in
    the pack cycle; the gate refuses and the chunks served generation
    N's verdicts. Both packages keep the same ledger."""
    runs = []
    for pkg in PKGS:
        w = _CanaryWorld(pkg, tmp_path, sample_fraction=0.5,
                         min_samples=4)
        clock = pkg.simclock.VirtualClock()
        try:
            with pkg.simclock.use(clock):
                loop = pkg.serveloop.ServeLoop(
                    w.loader, capacity=4, lease_ttl_s=600.0,
                    pack_interval_s=0.01, canary=w.ctrl)
                w.ctrl.stage(_bad(w.per), revision=2)
                lease = loop.connect("s0")
                flows = w.flows(6)
                sec = pkg.binary.capture_from_bytes(
                    pkg.binary.capture_to_bytes(flows))
                tickets = [loop.submit(lease, *sec) for _ in range(4)]
                loop.step()
                assert [t.verdicts.tolist() for t in tickets] == \
                    [w.served(flows)] * 4
                assert [t.canary for t in tickets] == \
                    [False, True, False, True]
                report = loop.status()["canary"]
                with pytest.raises(pkg.canary.CanaryRefused):
                    w.ctrl.try_commit()
                assert w.loader.revision == 1
                runs.append({k: report[k] for k in (
                    "state", "chunks", "samples", "diffs",
                    "diff_fraction")})
        finally:
            w.loader.close()
    assert runs[0] == runs[1]
    assert runs[1]["chunks"] == 2 and runs[1]["diffs"] == 12


# =============================================================== explain
def test_resolve_explain_equals_reference(tmp_path):
    runs = []
    for pkg in PKGS:
        pi, sc = pkg.synth.realize_scenario(
            pkg.synth.scenario_by_name("http", 24, 64))
        loader = _loader(pkg, tmp_path)
        pkg.explain.EXPLAIN.clear()
        tracer = pkg.tracing.TRACER
        enabled, rate = tracer.enabled, tracer.sample_rate
        tracer.enabled, tracer.sample_rate = True, 1.0
        clock = pkg.simclock.VirtualClock()
        try:
            with pkg.simclock.use(clock):
                loader.regenerate(pi, revision=1)
                loop = pkg.serveloop.ServeLoop(
                    loader, capacity=4, lease_ttl_s=600.0,
                    pack_interval_s=0.01)
                lease = loop.connect("s")
                with tracer.trace("stream.chunk") as ctx:
                    t = loop.submit(lease, *pkg.binary.capture_from_bytes(
                        pkg.binary.capture_to_bytes(sc.flows[:24])))
                    tid = ctx.trace_id
                loop.step()
                assert t.done and t.error is None
                out = pkg.explain.resolve_explain(loader, tid)
                assert out["found"] and out["served_equals_fresh"]
                assert all(r["agreement"] for r in out["records"])
                miss = pkg.explain.resolve_explain(loader, "0" * 16)
                assert miss == {"trace_id": "0" * 16, "found": False,
                                "records": []}
                # the provenance minus the absolute generations, which
                # each package counts on its own
                runs.append([
                    (r["index"], r["verdict"], r["fresh_verdict"],
                     r["fresh_verdict_name"], r["flow"],
                     {k: v for k, v in r["provenance"].items()
                      if k not in ("word", "generation", "bank_epoch")})
                    for r in out["records"]] + [out["degraded"],
                                                out["revision"]])
        finally:
            tracer.enabled, tracer.sample_rate = enabled, rate
            pkg.explain.EXPLAIN.clear()
            loader.close()
    assert runs[0] == runs[1]
    assert len(runs[1]) > 2
