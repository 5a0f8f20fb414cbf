"""The port's loader plane against the JAX package's, on the CPU.

Both packages run the same snapshots through their own ``Loader`` (the
reference with the gate set on, ``JAX_PLATFORMS=cpu``; the port with
``device="cpu"``) and must agree:

* ``CompiledPolicy.build(bank_registry=…)`` arrays byte-equal at
  http-1000 (path stack ``(7, 2048, 28)``) and on the two golden
  corpora — ``examples/policies`` as the control-plane golden test
  resolves it, and the reference-capture golden's 50 recorded lines
  under its CNP — each snapshot converted object by object into the
  port's classes;
* the bank plan, the kernel plan under each arm, the per-identity and
  family fingerprint tuples (the digests differ only by the name of the
  ``TrafficDirection`` enum's module, which pickle records), and the
  ``PolicyDelta`` of every commit — add, delete, no-op, rollback, warm
  restore — compared field by field, never by absolute generation;
* all ten output lanes of the staged engine, and the memo refills of a
  ``ServeLoop`` and a ``CaptureReplay`` bound to each package's real
  loader.

Also: the two ``Config`` deviations (gate on, own cache directory),
``Loader()`` on the card by default (raises without CUDA), the
``isinstance`` fast paths, rollback without an oracle swap,
``fallback_engine`` per revision, and ``bank_isolation=False``.

Determinism: every loader gets a generous compile deadline (600 s, the
queue's two workers never lapse it on a loaded worker; each test asserts
no quarantine) and is closed in teardown so no worker thread outlives
its test.
"""

import dataclasses
import enum
import importlib
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

LANES = ("verdict", "match_spec", "ruleset", "allowed", "l3l4_allowed",
         "redirect", "l7_ok", "l7_log", "auth_required", "l7_match")


def _pkg(root):
    ns = types.SimpleNamespace(root=root, jax=root == "cilium_tpu")
    for attr, mod in (("config", "core.config"),
                      ("loader", "runtime.loader"),
                      ("memo", "engine.memo"),
                      ("megakernel", "engine.megakernel"),
                      ("synth", "ingest.synth"),
                      ("binary", "ingest.binary"),
                      ("flow", "core.flow"),
                      ("api", "policy.api"),
                      ("l7", "policy.api.l7"),
                      ("identity", "core.identity"),
                      ("labels", "core.labels"),
                      ("mapstate", "policy.mapstate"),
                      ("repository", "policy.repository"),
                      ("selectorcache", "policy.selectorcache"),
                      ("bankplan", "policy.compiler.bankplan"),
                      ("oracle", "policy.oracle"),
                      ("faults", "runtime.faults"),
                      ("metrics", "runtime.metrics"),
                      ("serveloop", "runtime.serveloop"),
                      ("simclock", "runtime.simclock")):
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    if ns.jax:
        from cilium_tpu.engine import verdict as v

        ns.compiled, ns.Engine, ns.Replay = v, v.VerdictEngine, \
            v.CaptureReplay
    else:
        from cilium_tpu_torch.engine import compiled, replay, verdict

        ns.compiled, ns.Engine, ns.Replay = compiled, \
            verdict.TorchVerdictEngine, replay.CaptureReplay
    return ns


JAX, PORT = _pkg("cilium_tpu"), _pkg("cilium_tpu_torch")
PKGS = (JAX, PORT)


def _plain(x):
    """Dataclasses, enums and sets as plain comparable data."""
    if dataclasses.is_dataclass(x):
        return tuple(_plain(v) for v in dataclasses.astuple(x))
    if isinstance(x, enum.Enum):
        return int(x.value)
    if isinstance(x, (set, frozenset)):
        return frozenset(_plain(v) for v in x)
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    return x


def _lanes(out):
    return {k: np.asarray(out[k].cpu() if isinstance(out[k], torch.Tensor)
                          else out[k]) for k in LANES}


def _assert_lanes_equal(want, got):
    want, got = _lanes(want), _lanes(got)
    for k in LANES:
        np.testing.assert_array_equal(want[k], got[k], k)


def _last_delta(pkg):
    """The delta the package's last generation bump carried."""
    return _plain(pkg.memo.POLICY_GENERATION._ring[-1][1])


@pytest.fixture()
def loaders(tmp_path):
    """``make(pkg, **config)`` → a gate-on loader on its own cache
    directory; every loader made is closed at teardown."""
    made = []

    def make(pkg, cache=None, **kw):
        cfg = pkg.config.Config()
        cfg.enable_tpu_offload = True
        cfg.loader.cache_dir = str(cache or tmp_path / pkg.root)
        cfg.compile.deadline_s = 600.0
        for k, v in kw.items():
            section, _, name = k.partition("__")
            setattr(getattr(cfg, section) if name else cfg,
                    name or section, v)
        ld = (pkg.loader.Loader(cfg) if pkg.jax
              else pkg.loader.Loader(cfg, device="cpu"))
        made.append(ld)
        return ld

    yield make
    for ld in made:
        ld.close()


# ---------------------------------------------------------- churn world
class _World:
    """The http scenario plus churn: one extra rule on the server
    identity per added path (the reference fleet's ``/churn{step}/.*``
    shape). Only the server re-resolves; the client keeps its MapState
    object, so the loader fingerprints O(Δ)."""

    def __init__(self, pkg, n_rules, n_flows):
        self.pkg = pkg
        _, sc = pkg.synth.realize_scenario(
            pkg.synth.scenario_by_name("http", n_rules, n_flows),
            resolve=False)
        self.sc, self.flows, self.ids = sc, sc.flows, sc.ids
        alloc = pkg.identity.IdentityAllocator()
        self.labels = {}
        for name, lbls in sc.endpoints.items():
            self.labels[name] = pkg.labels.LabelSet.from_dict(lbls)
            assert alloc.allocate(self.labels[name]) == self.ids[name]
        self.cache = pkg.selectorcache.SelectorCache(alloc)
        self.client = self._resolve(())["client"]

    def _rule(self, path):
        api, flow = self.pkg.api, self.pkg.flow
        sel = api.EndpointSelector.from_labels
        return api.Rule(
            endpoint_selector=sel(app="server"),
            ingress=(api.IngressRule(
                from_endpoints=(sel(app="client"),),
                to_ports=(api.PortRule(
                    ports=(api.PortProtocol(80, flow.Protocol.TCP),),
                    rules=api.L7Rules(http=(api.PortRuleHTTP(
                        path=path, method="GET"),))),)),),
            labels=("synth=churn",))

    def _resolve(self, paths):
        repo = self.pkg.repository.Repository()
        repo.add(list(self.sc.rules) + [self._rule(p) for p in paths],
                 sanitize=False)
        res = self.pkg.mapstate.PolicyResolver(repo, self.cache)
        return {n: res.resolve(ls) for n, ls in self.labels.items()}

    def snapshot(self, paths=()):
        server = self._resolve(paths)["server"]
        return {self.ids["server"]: server, self.ids["client"]: self.client}

    def probe(self, path):
        f = self.flows[0]
        return dataclasses.replace(f, http=dataclasses.replace(
            f.http, method="GET", path=path))


# --------------------------------------------------- the golden corpus
def _to_port(x):
    """A JAX-package object as the port's object of the same class
    (dataclasses, enums and plain classes, recursively)."""
    t = type(x)
    mod = t.__module__
    if mod.startswith("cilium_tpu."):
        pt = getattr(importlib.import_module(
            "cilium_tpu_torch" + mod[len("cilium_tpu"):]), t.__name__)
        if isinstance(x, enum.Enum):
            return pt(x.value)
        if dataclasses.is_dataclass(x):
            vals = {f.name: _to_port(getattr(x, f.name))
                    for f in dataclasses.fields(x)}
            obj = pt(**{f.name: vals[f.name]
                        for f in dataclasses.fields(pt) if f.init})
            for f in dataclasses.fields(pt):
                if not f.init:
                    object.__setattr__(obj, f.name, vals[f.name])
            return obj
        obj = pt.__new__(pt)
        obj.__dict__.update({k: _to_port(v) for k, v in vars(x).items()})
        return obj
    if isinstance(x, tuple):
        return tuple(_to_port(v) for v in x)
    if isinstance(x, list):
        return [_to_port(v) for v in x]
    if isinstance(x, dict):
        return {_to_port(k): _to_port(v) for k, v in x.items()}
    if isinstance(x, (set, frozenset)):
        return type(x)(_to_port(v) for v in x)
    return x


def _controlplane_corpus():
    """The examples/policies corpus as the control-plane golden test
    resolves it, its flows and golden verdicts (no auth table: flows
    that demand authentication fail closed)."""
    import test_controlplane_golden as g

    agent, ids = g.build_agent()
    try:
        flows = g.build_flows(ids)
        per_identity = dict(agent.loader.per_identity)
    finally:
        agent.stop()
    with open(g.GOLDEN) as fp:
        golden = json.load(fp)["verdicts"]
    return per_identity, flows, golden, False


def _capture_corpus():
    """The reference-capture golden: 50 recorded http/kafka/dns/access-
    log lines under its CNP, identities remapped by label as the replay
    CLI does, and its per-line golden verdicts (auth unenforced)."""
    import test_accesslog_ingest as g

    from cilium_tpu.agent import Agent
    from cilium_tpu.core.config import Config as JaxConfig
    from cilium_tpu.core.flow import Verdict
    from cilium_tpu.policy.api.cnp import load_cnp_yaml_text

    cfg = JaxConfig()
    cfg.configure_logging = False
    agent = Agent(cfg)
    try:
        for i, app in enumerate(g._ENDPOINTS):
            agent.endpoint_add(100 + i, {"app": app})
        agent.endpoint_add(200, {"k8s-app": "kube-dns"})
        for cnp in load_cnp_yaml_text(g.CNP):
            agent.policy_add(cnp)
        with open(g.GOLDEN) as fp:
            flows = [g.parse_capture_line(json.loads(line))
                     for line in fp if line.strip()]
        by_label = {}
        for nid, lbls in agent.selector_cache.identities().items():
            for lbl in lbls:
                by_label[lbl.format()] = nid
        for f in flows:
            if f.src_labels:
                f.src_identity = by_label.get(f.src_labels[0], 0)
            if f.dst_labels:
                f.dst_identity = by_label.get(f.dst_labels[0], 0)
        agent.endpoint_manager.regenerate_all(wait=True)
        per_identity = dict(agent.loader.per_identity)
    finally:
        agent.stop()
    with open(g.GOLDEN_VERDICTS) as fp:
        golden = [int(Verdict[v]) for v in json.load(fp)]
    return per_identity, flows, golden, True


@pytest.fixture(scope="module")
def corpora():
    """name → (JAX snapshot, JAX flows, port snapshot, port flows,
    golden verdicts, auth unenforced) of the two golden corpora."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    out = {}
    for name, build in (("controlplane", _controlplane_corpus),
                        ("capture", _capture_corpus)):
        pi, flows, golden, unenforced = build()
        out[name] = (pi, flows, _to_port(pi), _to_port(flows), golden,
                     unenforced)
    return out


@pytest.fixture(scope="module")
def http1000():
    out = {}
    for pkg in PKGS:
        pi, _ = pkg.synth.realize_scenario(
            pkg.synth.scenario_by_name("http", 1000, 10))
        out[pkg.root] = pi
    return out


def _build(pkg, per_identity, registry=True, **cfg):
    ec = pkg.config.EngineConfig()
    for k, v in cfg.items():
        setattr(ec, k, v)
    reg = pkg.bankplan.BankRegistry() if registry else None
    return pkg.compiled.CompiledPolicy.build(per_identity, ec,
                                             bank_registry=reg)


def _assert_same_policy(jp, pp):
    assert set(jp.arrays) == set(pp.arrays)
    for k, want in jp.arrays.items():
        want, got = np.asarray(want), np.asarray(pp.arrays[k])
        assert want.dtype == got.dtype and want.shape == got.shape, k
        assert want.tobytes() == got.tobytes(), k
    assert jp.bank_plan == pp.bank_plan
    assert jp.bank_quarantined == pp.bank_quarantined == ()


# =================================================================== config
def test_config_deviations_and_from_env():
    jc, pc = JAX.config.Config(), PORT.config.Config()
    assert jc.enable_tpu_offload is False and pc.enable_tpu_offload is True
    assert pc.loader.cache_dir.endswith(os.path.join(".cache",
                                                     "cilium_tpu_torch"))
    assert pc.loader.cache_dir != jc.loader.cache_dir
    # the port carries the sections it reads, each equal to the
    # reference's field for field
    ported = {f.name for f in dataclasses.fields(pc)}
    assert ported == {"enable_tpu_offload", "policy_audit_mode", "engine",
                      "loader", "compile", "slo", "provenance", "tenant",
                      "canary", "admission", "breaker", "serve", "fleet",
                      "parallel", "dst", "tracing", "cluster_name",
                      "node_name", "ipam_mode", "identity_allocation_mode",
                      "pod_cidr", "kube_apiserver_ips", "log_level",
                      "k8s_api_socket", "monitor_aggregation",
                      "configure_logging", "enable_metrics"}
    assert ported == {f.name for f in dataclasses.fields(jc)}

    def sections(cfg):
        d = dataclasses.asdict(cfg)
        d["loader"].pop("cache_dir")
        return {k: d[k] for k in ported - {"enable_tpu_offload"}}

    # the REST API's bound came with the API
    jsec = sections(jc)
    assert jsec["admission"]["api_max_inflight"] == 64
    assert pc.admission.api_max_inflight == 64
    assert jsec == sections(pc)
    env = {"CILIUM_TPU_COMPILE_WORKERS": "3",
           "CILIUM_TPU_COMPILE_DEADLINE_S": "9.5",
           "CILIUM_TPU_BANK_ISOLATION": "0",
           "CILIUM_TPU_BANK_SIZE": "64",
           "CILIUM_TPU_KERNEL_IMPL": "nfa-bitset",
           "CILIUM_TPU_CACHE_DIR": "/x",
           "CILIUM_TPU_TENANT_RANGES": "a:1-9,b:10-20",
           "CILIUM_TPU_CANARY_MIN_SAMPLES": "8",
           "CILIUM_TPU_SLO_SHED_RATE": "0.01",
           "CILIUM_TPU_PROVENANCE": "0",
           "CILIUM_TPU_ADMISSION_MAX_PENDING": "17",
           "CILIUM_TPU_STREAM_CREDIT_WINDOW": "5",
           "CILIUM_TPU_SERVE_LOOP": "1",
           "CILIUM_TPU_SERVE_SLOT_CAPACITY": "33",
           "CILIUM_TPU_SERVE_LEASE_TTL_S": "7.5",
           "CILIUM_TPU_SERVE_PACK_INTERVAL_MS": "0.5",
           "CILIUM_TPU_POLICY_AUDIT_MODE": "1",
           "CILIUM_TPU_FLEET_SUSPICION_TTL_S": "2.5",
           "CILIUM_TPU_DST_SEED": "9",
           "CILIUM_TPU_DST_MUTATION": "positional-banks",
           "CILIUM_TPU_TENANT_QUANTUM_S": "2.5",
           "CILIUM_TPU_TENANT_QUOTA_TTL_S": "7",
           "CILIUM_TPU_IDENTITY_REGEN_DEBOUNCE_S": "0.25",
           "CILIUM_TPU_NODE_NAME": "n7",
           "CILIUM_TPU_IPAM_MODE": "cluster-pool",
           "CILIUM_TPU_TRACING": "off",
           "CILIUM_TPU_TRACE_SAMPLE_RATE": "0.5"}
    jd = dataclasses.asdict(JAX.config.Config.from_env(env))
    pd = dataclasses.asdict(PORT.config.Config.from_env(env))
    assert pd["loader"]["cache_dir"] == "/x"
    assert {k: jd[k] for k in ported} == {**pd, "enable_tpu_offload": False}
    assert PORT.config.Config.from_env(
        {"CILIUM_TPU_ENABLE_OFFLOAD": "0"}).enable_tpu_offload is False
    assert PORT.config.Config.from_env(
        {"CILIUM_TPU_ENABLE_OFFLOAD": "1"}).enable_tpu_offload is True


def test_loader_defaults_to_the_card(tmp_path):
    cfg = PORT.config.Config()
    cfg.loader.cache_dir = str(tmp_path)
    if torch.cuda.is_available():
        ld = PORT.loader.Loader(cfg)
        assert ld.device.type == "cuda"
        ld.close()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PORT.loader.Loader(cfg)
    # the oracle needs no device: the gate set off serves it
    cfg.enable_tpu_offload = False
    ld = PORT.loader.Loader(cfg)
    try:
        w = _World(PORT, 6, 40)
        engine = ld.regenerate(w.snapshot(), revision=1)
        assert isinstance(engine, PORT.oracle.OracleVerdictEngine)
        assert ld.bank_status()["enabled"] is True
        assert ld.bank_registry.queue is not None
        assert ld.bank_registry.queue.status()["workers"] <= 2
    finally:
        ld.close()


# ============================================================== compile
def test_registry_arrays_byte_equal_at_http1000(http1000):
    jp = _build(JAX, http1000["cilium_tpu"])
    pp = _build(PORT, http1000["cilium_tpu_torch"])
    _assert_same_policy(jp, pp)
    assert pp.arrays["path_trans"].shape == (7, 2048, 28)
    assert pp.arrays["path_accept"].shape == (7, 2048, 7)
    assert [st.n_patterns for st in pp.path_matcher.banked.banks] == \
        [224, 18, 186, 216, 103, 33, 220]
    # and the positional build, the other side of bank_isolation
    _assert_same_policy(_build(JAX, http1000["cilium_tpu"], False),
                        _build(PORT, http1000["cilium_tpu_torch"], False))


@pytest.mark.parametrize("bank_size", [128, 8])
@pytest.mark.parametrize("name", ["controlplane", "capture"])
def test_registry_arrays_byte_equal_on_the_corpus(corpora, name,
                                                   bank_size):
    jpi, _, ppi, _, _, _ = corpora[name]
    _assert_same_policy(_build(JAX, jpi, bank_size=bank_size),
                        _build(PORT, ppi, bank_size=bank_size))


@pytest.mark.parametrize("mode", ["auto", "nfa-bitset", "dfa-dense"])
def test_impl_plan_equals_reference_on_the_registry_build(
        http1000, mode, monkeypatch):
    """Under ``nfa-bitset`` the 2048-state path banks (over 128 NFA
    positions) take the dense arm in both packages; under ``auto`` the
    reference's accelerator rule (a TPU backend) equals the port's on
    ``cuda``."""
    jp = _build(JAX, http1000["cilium_tpu"])
    pp = _build(PORT, http1000["cilium_tpu_torch"])
    jc, pc = JAX.config.EngineConfig(), PORT.config.EngineConfig()
    jc.kernel_impl = pc.kernel_impl = mode
    want = JAX.megakernel.plan_for_engine(jp, jc, True)
    assert want[0] == PORT.megakernel.plan_for_engine(pp, pc, "cpu")[0]
    monkeypatch.setattr(JAX.megakernel.jax, "default_backend",
                        lambda: "tpu")
    want = JAX.megakernel.plan_for_engine(jp, jc, True)
    got = PORT.megakernel.plan_for_engine(pp, pc, "cuda")
    assert want[0] == got[0]
    assert set(want[1]) == set(got[1])
    for k, v in want[1].items():
        np.testing.assert_array_equal(np.asarray(v), got[1][k], k)
    if mode == "nfa-bitset":
        assert got[0] == {"path": "dfa-dense", "method": "nfa-bitset",
                          "host": "nfa-bitset", "hdr": "nfa-bitset",
                          "dns": "nfa-bitset"}


# ======================================================= loader, verdicts
@pytest.mark.parametrize("name,size", [("http", (24, 200)),
                                       ("fqdn", (6, 160)),
                                       ("kafka", (12, 160))])
def test_loader_lanes_plan_and_fingerprints_equal_reference(
        loaders, name, size):
    runs = []
    for pkg in PKGS:
        pi, sc = pkg.synth.realize_scenario(
            pkg.synth.scenario_by_name(name, *size))
        ld = loaders(pkg)
        engine = ld.regenerate(pi, revision=3)
        assert isinstance(engine, pkg.Engine) and engine is ld.engine
        st = ld.bank_status()
        assert st["degraded"] is False and st["quarantined"] == 0
        runs.append((engine.verdict_flows(sc.flows), st["plan"],
                     st["kernel_plan"], ld._bank_plan,
                     {ep: pkg.loader._identity_entry_tuple(ms)
                      for ep, ms in pi.items()},
                     {ep: pkg.loader._identity_family_tuples(ms)
                      for ep, ms in pi.items()},
                     ld.bank_registry.kernel_picks, ld.revision))
    (jout, *jrest), (pout, *prest) = runs
    _assert_lanes_equal(jout, pout)
    assert _plain(jrest) == _plain(prest)


@pytest.mark.parametrize("name", ["controlplane", "capture"])
def test_loader_on_the_corpus_equals_reference_and_goldens(loaders,
                                                           corpora, name):
    from cilium_tpu.auth import AUTH_UNENFORCED as JAX_UNENFORCED
    from cilium_tpu_torch.engine.verdict import AUTH_UNENFORCED

    jpi, jflows, ppi, pflows, golden, unenforced = corpora[name]
    jauth, pauth = ((JAX_UNENFORCED, AUTH_UNENFORCED) if unenforced
                    else (None, None))
    jl, pl = loaders(JAX), loaders(PORT)
    jout = jl.regenerate(jpi, revision=1).verdict_flows(
        jflows, authed_pairs=jauth)
    pout = pl.regenerate(ppi, revision=1).verdict_flows(
        pflows, authed_pairs=pauth)
    _assert_lanes_equal(jout, pout)
    assert [int(v) for v in pout["verdict"]] == golden
    assert jl.bank_status()["plan"] == pl.bank_status()["plan"]
    # the fallback lane: the port's oracle over the same snapshot
    fb = pl.fallback_engine
    assert isinstance(fb, PORT.oracle.OracleVerdictEngine)
    assert [int(v) for v in fb.verdict_flows(
        pflows, authed_pairs=pauth)["verdict"]] == golden


def test_identity_fingerprints_move_only_for_touched_identities():
    runs = []
    for pkg in PKGS:
        w = _World(pkg, 12, 10)
        lm = pkg.loader
        fp0 = lm.identity_fingerprints(w.snapshot())
        fp1 = lm.identity_fingerprints(w.snapshot(["/churn0/.*"]))
        fam0 = lm.identity_family_fingerprints(w.snapshot())
        fam1 = lm.identity_family_fingerprints(w.snapshot(["/churn0/.*"]))
        moved = {ep for ep in fp0 if fp0[ep] != fp1[ep]}
        assert moved == {w.ids["server"]}
        assert lm.identity_fingerprints(w.snapshot()) == fp0
        fam_moved = {(ep, name) for ep in fam0 for name in fam0[ep]
                     if fam0[ep][name] != fam1[ep][name]}
        assert fam_moved == {(w.ids["server"], "http")}
        assert set(fam0[w.ids["server"]]) == \
            {"struct", "http", "kafka", "dns", "generic", "cassandra",
             "memcache", "r2d2"}
        runs.append((moved, fam_moved, {ep: set(fam0[ep]["http"])
                                        for ep in fam0}))
    assert runs[0] == runs[1]


# ================================================= deltas across commits
def test_policy_delta_sequence_equals_reference(loaders, tmp_path):
    """add, delete, no-op, rollback, retry, warm restore (fresh loader)
    and same-artifact restore: the delta each commit hands to memo
    owners, the bank compiles it cost and the engine identity, equal
    across the packages."""
    runs = []
    for pkg in PKGS:
        w = _World(pkg, 24, 10)
        ld = loaders(pkg)
        reg = ld.bank_registry
        trail = []

        def commit(paths, rev):
            c0 = reg.compiles
            before = ld.engine
            ld.regenerate(w.snapshot(paths), revision=rev)
            trail.append((rev, _last_delta(pkg), reg.compiles - c0,
                          ld.engine is before))

        commit((), 1)
        commit(("/churn1/.*",), 2)
        commit(("/churn1/.*", "/churn2/.*"), 3)
        commit(("/churn2/.*",), 4)
        commit(("/churn2/.*",), 5)                    # byte-identical
        assert trail[-1][1:] == (_plain(pkg.memo.PolicyDelta.none()), 0,
                                 True)
        serving = ld.engine
        rollbacks = pkg.metrics.METRICS.get(pkg.metrics.LOADER_ROLLBACKS)
        with pkg.faults.inject(pkg.faults.FaultPlan(
                [pkg.faults.FaultRule("loader.swap", times=1)])):
            with pytest.raises(pkg.faults.FaultInjected):
                ld.regenerate(w.snapshot(("/churn3/.*",)), revision=6)
        assert ld.engine is serving and ld.revision == 5
        assert pkg.metrics.METRICS.get(pkg.metrics.LOADER_ROLLBACKS) == \
            rollbacks + 1
        trail.append(("rollback", _last_delta(pkg)))
        commit(("/churn3/.*",), 6)                    # the retry
        assert ld.snapshot_warm()
        # a fresh loader on the same cache restores without compiling
        ld2 = loaders(pkg, cache=ld.config.loader.cache_dir)
        assert ld2.restore_warm()
        assert ld2.bank_registry.compiles == 0 and ld2.revision == 6
        trail.append(("fresh-restore", _last_delta(pkg)))
        _assert_lanes_equal(ld.engine.verdict_flows(w.flows),
                            ld2.engine.verdict_flows(w.flows))
        # restoring the serving artifact keeps the engine: nothing moved
        engine2 = ld2.engine
        assert ld2.restore_warm() and ld2.engine is engine2
        trail.append(("same-restore", _last_delta(pkg)))
        runs.append(trail)
    assert runs[0] == runs[1]
    kinds = [t[1][0] for t in runs[1]]     # the ``full`` flag
    assert kinds == [True, False, False, False, False, True, False,
                     True, False]


def test_stage_failure_rolls_back_and_never_serves_the_oracle(
        loaders, monkeypatch):
    w = _World(PORT, 12, 40)
    ld = loaders(PORT)
    ld.regenerate(w.snapshot(), revision=1)
    serving, plan = ld.engine, dict(ld._bank_plan)

    def fail(*a, **kw):
        raise RuntimeError("stage failed")

    monkeypatch.setattr(PORT.Engine, "__init__", fail)
    with pytest.raises(RuntimeError, match="stage failed"):
        ld.regenerate(w.snapshot(("/churn1/.*",)), revision=2)
    assert ld.engine is serving and ld.revision == 1
    assert ld._bank_plan == plan and ld._fallback is None
    assert isinstance(ld.engine, PORT.Engine)
    monkeypatch.undo()
    ld.regenerate(w.snapshot(("/churn1/.*",)), revision=2)
    assert ld.engine is not serving and ld.revision == 2


def test_fallback_engine_tracks_the_revision(loaders):
    w = _World(PORT, 12, 120)
    ld = loaders(PORT)
    ld.regenerate(w.snapshot(), revision=1)
    fb = ld.fallback_engine
    assert isinstance(fb, PORT.oracle.OracleVerdictEngine)
    assert ld.fallback_engine is fb and fb.per_identity is ld.per_identity
    np.testing.assert_array_equal(
        fb.verdict_flows(w.flows)["verdict"],
        ld.engine.verdict_flows(w.flows)["verdict"])
    ld.regenerate(w.snapshot(("/churn1/.*",)), revision=2)
    fb2 = ld.fallback_engine
    assert fb2 is not fb and fb2.per_identity is ld.per_identity
    probe = [w.probe("/churn1/x")]
    assert int(fb2.verdict_flows(probe)["verdict"][0]) == 5
    assert int(fb.verdict_flows(probe)["verdict"][0]) == 2


def test_bank_isolation_off_takes_the_positional_path(loaders):
    runs = []
    for pkg in PKGS:
        w = _World(pkg, 24, 40)
        ld = loaders(pkg, loader__bank_isolation=False)
        assert ld.bank_registry is None
        assert ld.bank_status() == {"enabled": False}
        engine = ld.regenerate(w.snapshot(), revision=1)
        want = _build(pkg, w.snapshot(), registry=False)
        _assert_same_policy(want, engine.policy)
        runs.append((engine.policy, engine.verdict_flows(w.flows)))
    _assert_same_policy(runs[0][0], runs[1][0])
    _assert_lanes_equal(runs[0][1], runs[1][1])


def test_tenant_namespaced_banks_equal_reference(loaders):
    runs = []
    for pkg in PKGS:
        w = _World(pkg, 24, 10)
        ld = loaders(pkg, tenant__enabled=True,
                     tenant__ranges=(f"srv:{w.ids['server']}-"
                                     f"{w.ids['server']}",))
        ld.regenerate(w.snapshot(("/churn1/.*",)), revision=1)
        reg = ld.bank_registry
        assert reg.keys_in_namespace("srv")
        runs.append((ld._bank_plan, reg.keys_in_namespace("srv"),
                     reg.keys_in_namespace("shared")))
    assert runs[0] == runs[1]


# ============================================= memo owners on a real loader
def _with_l4_rows(pkg, flows):
    """Every fifth flow without its L7 record: rows a churned http rule
    cannot touch."""
    return [dataclasses.replace(f, l7=pkg.flow.L7Type.NONE, http=None)
            if i % 5 == 0 else f for i, f in enumerate(flows)]


def test_serve_loop_refills_through_the_real_loader(loaders):
    """A ServeLoop bound to each package's Loader: serve, commit a
    churn add, serve again, re-commit the same snapshot, serve again.
    The churn refills the server's http rows only (the L4 rows keep
    serving), the no-op commit refills nothing, counted alike in both
    packages; the verdicts are always the committed engine's."""
    runs = []
    for pkg in PKGS:
        w = _World(pkg, 24, 240)
        flows = _with_l4_rows(pkg, w.flows) + [w.probe("/churn1/x")]
        ld = loaders(pkg)
        ld.regenerate(w.snapshot(), revision=1)
        clock = pkg.simclock.VirtualClock()
        books = []
        with pkg.simclock.use(clock):
            loop = pkg.serveloop.ServeLoop(ld, capacity=8,
                                           lease_ttl_s=600.0,
                                           pack_interval_s=0.01)
            lease = loop.connect("s0")
            for paths, rev in (((), None), (("/churn1/.*",), 2),
                               (("/churn1/.*",), 3)):
                if rev is not None:
                    ld.regenerate(w.snapshot(paths), revision=rev)
                m0 = dict(loop.ring.memo_stats())
                sec = pkg.binary.capture_from_bytes(
                    pkg.binary.capture_to_bytes(flows))
                t = loop.submit(lease, *sec)
                loop.step()
                got = t.verdicts.tolist()
                want = np.asarray(ld.engine.verdict_flows(flows)[
                    "verdict"]).tolist()
                assert got == want
                m1 = loop.ring.memo_stats()
                books.append((got, {k: m1[k] - m0.get(k, 0)
                                    for k in ("hits", "misses")}))
        runs.append(books)
    assert runs[0] == runs[1]
    (_, first), (_, refill), (_, noop) = runs[1]
    assert 0 < refill["misses"] < first["misses"]
    assert noop["misses"] == 0


def test_capture_replay_refills_through_the_real_loader(loaders,
                                                        tmp_path):
    runs = []
    for pkg in PKGS:
        w = _World(pkg, 24, 240)
        flows = _with_l4_rows(pkg, w.flows)
        ld = loaders(pkg)
        engine = ld.regenerate(w.snapshot(), revision=1)
        path = str(tmp_path / f"{pkg.root}.bin")
        pkg.binary.write_capture_l7(path, flows)
        rec = np.asarray(pkg.binary.map_capture(path))
        l7, offsets, blob = pkg.binary.read_l7_sidecar(path)
        r = pkg.Replay(engine, l7, offsets, blob, None, loader=ld)
        r.stage_rows(rec, l7)
        r.stage_unique()
        out0 = r.verdict_chunk(rec, l7)
        m0 = r.memo.misses
        ld.regenerate(w.snapshot(("/churn1/.*",)), revision=2)
        out1 = r.verdict_chunk(rec, l7)
        _assert_lanes_equal(ld.engine.verdict_flows(flows), out1)
        runs.append((out0, out1, r.memo.misses - m0, r.memo.invalidations,
                     r.engine is ld.engine, r.n_unique))
    (j0, j1, *jrest), (p0, p1, *prest) = runs
    _assert_lanes_equal(j0, p0)
    _assert_lanes_equal(j1, p1)
    assert jrest == prest
    refill, inv, rebound, n_unique = prest
    assert rebound and 0 < refill < n_unique and inv == 1
