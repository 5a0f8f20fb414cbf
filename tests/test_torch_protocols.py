"""The protocol-frontend path of the port beyond the fused step, against
the JAX package's, exact, on the CPU:

* the ``generic`` and ``protocols`` synth scenarios (each package's own
  generator, one seed): the same flows and the same capture bytes;
* v3 capture replay (``CaptureReplay`` over a capture with a GENERIC
  section) on the memo, id and row routes, under the gather and the
  oblivious DFA arms, all ten lanes equal to the reference's replay and
  to the port's fused step; ``stage_capture_tables`` with its ``l7g``
  table; the ``l7g`` table left unscanned under a policy without
  frontend rules;
* the service's ``check`` and bulk ``verdict`` ops on frontend and
  generic records, equal to the reference's service;
* a hot swap through a stub loader that changes only a frontend rule:
  the replay's memo refills exactly the frontend family's rows.

Inputs: the protocols scenario (24 rules × 300 flows), the generic
scenario (12 × 200), a ``test.lineparser`` policy (12 × 200) and http
plus frontend rules on one endpoint (12 × 160), with the edge cases of
``tests/test_torch_frontends.py``.
"""

import os
import warnings

import numpy as np
import pytest

from cilium_tpu.core.config import EngineConfig as JaxEngineConfig
from cilium_tpu.engine import verdict as jax_verdict
from cilium_tpu.ingest import binary as jax_binary
from cilium_tpu.ingest import synth as jax_synth

from cilium_tpu_torch.core.config import EngineConfig
from cilium_tpu_torch.engine.compiled import CompiledPolicy
from cilium_tpu_torch.engine.replay import CaptureReplay
from cilium_tpu_torch.engine.verdict import (
    TorchVerdictEngine,
    stage_capture_tables,
)
from cilium_tpu_torch.ingest import binary, synth

from test_torch_frontends import (
    assert_lanes_equal,
    build_both,
)
from test_torch_replay import _dfa_env

NAMES = ("protocols", "generic", "lineparser", "mixed")
ARMS = {"gather": "gather", "oblivious": "pallas"}
ROUTES = ("memo", "id", "row")
CHUNK = 64


def _flow_tuple(f):
    g = f.generic
    return (f.src_identity, f.dst_identity, f.dport, int(f.protocol),
            int(f.direction), int(f.l7),
            None if g is None else (g.proto, sorted(g.fields.items())))


@pytest.mark.parametrize("name", ["generic", "protocols"])
def test_synth_scenarios_equal_reference(name, tmp_path):
    jpi, jsc = jax_synth.realize_scenario(
        jax_synth.scenario_by_name(name, 18, 150))
    pi, sc = synth.realize_scenario(synth.scenario_by_name(name, 18, 150))
    assert [_flow_tuple(f) for f in sc.flows] == \
        [_flow_tuple(f) for f in jsc.flows]
    assert sorted(pi) == sorted(jpi)
    a, b = str(tmp_path / "ref.bin"), str(tmp_path / "port.bin")
    jax_binary.write_capture_l7(a, jsc.flows)
    binary.write_capture_l7(b, sc.flows)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert binary.capture_version(b) == binary.VERSION_L7G
    assert synth.PROTOCOL_MIX == jax_synth.PROTOCOL_MIX
    assert synth.PROTOCOL_PORTS == jax_synth.PROTOCOL_PORTS


class _World:
    """Both packages' policies and one v3 capture per scenario, and the
    reference's replay outputs, computed once."""

    def __init__(self, tmpdir):
        self.scen = {}
        self._engines = {}
        self._ref = {}
        for name in NAMES:
            (jpi, jsc), (pi, sc) = build_both(name)
            path = os.path.join(tmpdir, f"{name}.bin")
            binary.write_capture_l7(path, sc.flows)
            rec = np.asarray(binary.map_capture(path))
            self.scen[name] = dict(
                jpol=jax_verdict.CompiledPolicy.build(jpi,
                                                      JaxEngineConfig()),
                pol=CompiledPolicy.build(pi, EngineConfig()),
                flows=sc.flows,
                sections=(rec, *binary.read_l7_sidecar(path),
                          binary.read_gen_sidecar(path)))

    def engines(self, name, arm):
        key = (name, arm)
        if key not in self._engines:
            s = self.scen[name]
            with _dfa_env(ARMS[arm]):
                self._engines[key] = (
                    jax_verdict.VerdictEngine(s["jpol"]),
                    TorchVerdictEngine(s["pol"], device="cpu"))
        return self._engines[key]

    def replays(self, name, arm, route):
        jeng, eng = self.engines(name, arm)
        rec, l7, offsets, blob, gen = self.scen[name]["sections"]
        out = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for cls, e, c in ((jax_verdict.CaptureReplay, jeng,
                               JaxEngineConfig()),
                              (CaptureReplay, eng, EngineConfig())):
                c.verdict_memo = route == "memo"
                r = cls(e, l7, offsets, blob, c, gen=gen)
                r.stage_rows(rec, l7)
                r.stage_unique(0.0 if route == "row" else None)
                out.append(r)
        return out

    def chunks(self, replay, name):
        rec, l7 = self.scen[name]["sections"][:2]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            outs = [replay.verdict_chunk(rec[s:s + CHUNK], l7[s:s + CHUNK],
                                         start=s)
                    for s in range(0, len(rec), CHUNK)]
        return {k: np.concatenate([np.asarray(o[k]) for o in outs])
                for k in outs[0]}

    def reference(self, name, arm, route):
        key = (name, arm, route)
        if key not in self._ref:
            jr, _ = self.replays(name, arm, route)
            self._ref[key] = self.chunks(jr, name)
        return self._ref[key]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _World(str(tmp_path_factory.mktemp("protocols")))


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("name", NAMES)
def test_stage_capture_tables_with_l7g_equal_reference(world, name, arm):
    jeng, eng = world.engines(name, arm)
    jr, r = world.replays(name, arm, "memo")
    assert sorted(r.table_words) == sorted(jr.table_words)
    assert ("l7g" in r.table_words) == (name != "lineparser")
    for k in jr.table_words:
        np.testing.assert_array_equal(
            r.table_words[k].numpy().view(np.uint32),
            np.asarray(jr.table_words[k]), k)
    np.testing.assert_array_equal(r.feat.gen_rows, jr.feat.gen_rows)
    np.testing.assert_array_equal(r.rows_all, jr.rows_all)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("name", NAMES)
def test_v3_replay_equals_reference(world, name, arm, route):
    want = world.reference(name, arm, route)
    _, r = world.replays(name, arm, route)
    got = world.chunks(r, name)
    assert_lanes_equal(want, got)
    assert (r.memo is not None) == (route == "memo")
    assert (r.row_idx is None) == (route == "row")
    # the fused step agrees on every flow a capture carries as it is: a
    # generic record on a flow whose L7 type is not GENERIC is written
    # without it (in both packages), so the live path alone sees it
    _, eng = world.engines(name, arm)
    flows = world.scen[name]["flows"]
    same = np.array([f.generic is None or int(f.l7) == 4 for f in flows])
    assert same.sum() > len(flows) // 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        live = eng.verdict_flows(flows)
    assert_lanes_equal({k: v[same] for k, v in live.items()},
                       {k: v[same] for k, v in got.items()})
    assert len(set(got["verdict"].tolist())) > 1


def test_l7g_table_unscanned_without_frontend_rules(world):
    """A v3 capture of frontend records under the http policy: the
    featurizer builds the ``l7g`` table, the staging does not scan it,
    and the verdicts equal the reference's."""
    from cilium_tpu_torch.ingest import synth as port_synth

    pi, _ = port_synth.realize_scenario(port_synth.scenario_by_name(
        "http", 12, 10))
    jpi, _ = jax_synth.realize_scenario(jax_synth.scenario_by_name(
        "http", 12, 10))
    eng = TorchVerdictEngine(CompiledPolicy.build(pi), device="cpu")
    jeng = jax_verdict.VerdictEngine(jax_verdict.CompiledPolicy.build(jpi))
    rec, l7, offsets, blob, gen = world.scen["protocols"]["sections"]
    outs = []
    for cls, e in ((jax_verdict.CaptureReplay, jeng), (CaptureReplay, eng)):
        r = cls(e, l7, offsets, blob, gen=gen)
        assert "l7g" in r.feat.tables and "l7g" not in r.table_words
        r.stage_rows(rec, l7)
        r.stage_unique()
        outs.append(r.verdict_chunk(rec, l7, start=0))
    assert_lanes_equal(*outs)
    assert "l7g" not in stage_capture_tables(eng, r.feat)


def _serve(pkg, loader, path):
    from test_torch_service import served

    return served(pkg, loader, path, deadline_ms=1.0)


def test_service_serves_generic_records_like_reference(tmp_path):
    """``check`` and bulk ``verdict`` on the protocols scenario's
    records (frontend, unknown-proto and L4-only ones among them) over
    each package's service: the responses are equal."""
    from test_torch_service import PKGS, client, make_loader, strip

    got = {}
    for pkg in PKGS:
        (jpi, jsc), (pi, sc) = build_both("protocols")
        per, flows = (jpi, jsc.flows) if pkg.jax else (pi, sc.flows)
        ld = make_loader(pkg, tmp_path / f"{pkg.root}-cache")
        try:
            ld.regenerate(per, revision=1)
            resps = []
            with _serve(pkg, ld, tmp_path / f"{pkg.root}.sock") as svc, \
                    client(pkg, svc) as c:
                for f in flows[:40]:
                    resps.append(strip(c.call({
                        "op": "check",
                        "flow": pkg.hubble.flow_to_dict(f)})))
                resps.append(strip(c.call({
                    "op": "verdict",
                    "flows": [pkg.hubble.flow_to_dict(f)
                              for f in flows[:120]]})))
            got[pkg.root] = resps
        finally:
            ld.close()
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]
    verdicts = {r.get("verdict") for r in got["cilium_tpu"][:40]}
    assert len(verdicts) > 1 and "error" not in got["cilium_tpu"][-1]


class _StubLoader:
    def __init__(self, engine):
        self.engine = engine


def _frontend_swap_world(pkg, table):
    """The protocols scenario with the cassandra table of rule 0
    replaced by ``table``: a frontend-only change."""
    flow, api, syn = pkg
    sc = syn.scenario_by_name("protocols", 12, 120)
    rule = sc.rules[0]
    ports = []
    for pr in rule.ingress[0].to_ports:
        if pr.rules.l7proto == "cassandra":
            l7 = list(pr.rules.l7)
            l7[0] = api.PortRuleL7.from_dict(
                {"query_action": "select", "query_table": table})
            pr = api.PortRule(ports=pr.ports, rules=api.L7Rules(
                l7proto="cassandra", l7=tuple(l7)))
        ports.append(pr)
    sc.rules = [api.Rule(endpoint_selector=rule.endpoint_selector,
                         ingress=(api.IngressRule(
                             from_endpoints=rule.ingress[0].from_endpoints,
                             to_ports=tuple(ports)),),
                         labels=rule.labels)]
    return syn.realize_scenario(sc)


def test_frontend_swap_refills_only_its_family(tmp_path):
    """A committed delta that names only the cassandra family: both
    packages' replays refill the same memo rows and serve the new
    policy's verdicts, equal to each other and to the new engine."""
    import cilium_tpu.core.flow as jax_flow
    import cilium_tpu.policy.api as jax_api
    import cilium_tpu_torch.core.flow as port_flow
    import cilium_tpu_torch.policy.api as port_api
    from cilium_tpu.engine import memo as jax_memo
    from cilium_tpu_torch.engine import memo

    got = {}
    for key, pkg, mem, eng_of, replay_cls in (
            ("jax", (jax_flow, jax_api, jax_synth), jax_memo,
             lambda pi: jax_verdict.VerdictEngine(
                 jax_verdict.CompiledPolicy.build(pi)),
             jax_verdict.CaptureReplay),
            ("port", (port_flow, port_api, synth), memo,
             lambda pi: TorchVerdictEngine(CompiledPolicy.build(pi),
                                           device="cpu"),
             CaptureReplay)):
        pi, sc = _frontend_swap_world(pkg, "ks.t0")
        pi2, _ = _frontend_swap_world(pkg, "ks.t3")
        e1, e2 = eng_of(pi), eng_of(pi2)
        bin_mod = jax_binary if key == "jax" else binary
        rec, l7, offsets, blob, gen = bin_mod.capture_from_bytes(
            bin_mod.capture_to_bytes(sc.flows))
        loader = _StubLoader(e1)
        r = replay_cls(e1, l7, offsets, blob, gen=gen, loader=loader)
        r.stage_rows(rec, l7)
        r.stage_unique()
        before = r.verdict_chunk(rec, l7, start=0)
        loader.engine = e2
        ep = sc.ids["polysvc"]
        mem.POLICY_GENERATION.bump(mem.PolicyDelta.banks(
            {ep}, set(), identity_families={(ep, "cassandra")}))
        after = r.verdict_chunk(rec, l7, start=0)
        m = r.memo
        got[key] = (np.asarray(before["verdict"]).tolist(),
                    np.asarray(after["verdict"]).tolist(),
                    (m.hits, m.misses, m.invalidations),
                    np.asarray(e2.verdict_flows(sc.flows)["verdict"])
                    .tolist())
    assert got["port"] == got["jax"]
    before, after, _, want = got["port"]
    assert after == want and before != after
