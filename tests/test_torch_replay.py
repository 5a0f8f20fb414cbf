"""The port's capture replay against the JAX package's, exact on every
lane, word, row and id, on the CPU.

* ``stage_capture_tables`` — the five table scans, ``path_groups``
  included — under the gather arm and the oblivious arm (the JAX side
  runs its Pallas kernel in interpret mode, as its own tests do), with
  the reference's fallback warning for a path bank over 128 states;
* ``stage_unique``: ``n_unique``, the unique-row table and the id
  stream, also under a forced total hash collision
  (``tests/test_ingest_columnar.py::test_hash_collision_falls_back_to_exact``);
* ``verdict_chunk`` on all ten lanes for http, fqdn and kafka captures,
  on the three routes (memo, id stream without the memo, row stream),
  under both arms, against the reference's ``CaptureReplay``;
* the memo's behaviour, mirroring ``tests/test_ingest_columnar.py``'s
  memo tests: bit-equal and counted, the ``verdict_memo`` knob,
  invalidation on a generation bump, keying on the auth view,
  prefetched chunks, and the scatter refill after a bank-scoped
  ``PolicyDelta`` through a stub loader.

Inputs: the synth scenarios at 12 rules × 240 flows (http), 6 × 180
(fqdn), 12 × 200 (kafka), realized in both packages from one seed;
one capture file per scenario (the two writers' files are
byte-identical, ``tests/test_torch_capture.py``).
"""

import contextlib
import os
import warnings

import numpy as np
import pytest

from cilium_tpu.core.config import EngineConfig as JaxEngineConfig
from cilium_tpu.engine import memo as jax_memo
from cilium_tpu.engine import verdict as jax_verdict
from cilium_tpu.ingest import synth as jax_synth

from cilium_tpu_torch.core.config import EngineConfig
from cilium_tpu_torch.engine import memo
from cilium_tpu_torch.engine.compiled import CaptureFeaturizer, CompiledPolicy
from cilium_tpu_torch.engine.replay import CaptureReplay
from cilium_tpu_torch.engine.verdict import (
    OUTPUT_LANES,
    TorchVerdictEngine,
    stage_capture_tables,
)
from cilium_tpu_torch.ingest import binary, synth
from cilium_tpu_torch.runtime.metrics import (
    METRICS,
    VERDICT_MEMO_HITS,
    VERDICT_MEMO_MISSES,
)

SIZES = {"http": (12, 240), "fqdn": (6, 180), "kafka": (12, 200)}
#: arm → CILIUM_TPU_DFA_IMPL value (both packages read it)
ARMS = {"gather": "gather", "oblivious": "pallas"}
ROUTES = ("memo", "id", "row")
CHUNK = 120


@contextlib.contextmanager
def _dfa_env(value):
    old = os.environ.get("CILIUM_TPU_DFA_IMPL")
    os.environ["CILIUM_TPU_DFA_IMPL"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("CILIUM_TPU_DFA_IMPL", None)
        else:
            os.environ["CILIUM_TPU_DFA_IMPL"] = old


def _cfgs(route):
    jcfg, cfg = JaxEngineConfig(), EngineConfig()
    jcfg.verdict_memo = cfg.verdict_memo = route == "memo"
    return jcfg, cfg


class _World:
    """Both packages' policies, engines and one capture per scenario;
    reference outputs are computed once and kept."""

    def __init__(self, tmpdir):
        self.tmpdir = tmpdir
        self.scen = {}
        self._engines = {}
        self._ref = {}
        for name, (n_rules, n_flows) in SIZES.items():
            jpi, jsc = jax_synth.realize_scenario(
                jax_synth.scenario_by_name(name, n_rules, n_flows))
            pi, sc = synth.realize_scenario(
                synth.scenario_by_name(name, n_rules, n_flows))
            path = os.path.join(tmpdir, f"{name}.bin")
            binary.write_capture_l7(path, sc.flows)
            rec = np.asarray(binary.map_capture(path))
            self.scen[name] = dict(
                jpol=jax_verdict.CompiledPolicy.build(jpi,
                                                      JaxEngineConfig()),
                pol=CompiledPolicy.build(pi, EngineConfig()),
                flows=sc.flows, jflows=jsc.flows,
                sections=(rec, *binary.read_l7_sidecar(path)))

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
        """(reference replay, port replay), staged for ``route``."""
        jeng, eng = self.engines(name, arm)
        rec, l7, offsets, blob = self.scen[name]["sections"]
        jcfg, cfg = _cfgs(route)
        drop = 0.0 if route == "row" else None
        out = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for cls, e, c in ((jax_verdict.CaptureReplay, jeng, jcfg),
                              (CaptureReplay, eng, cfg)):
                r = cls(e, l7, offsets, blob, c)
                r.stage_rows(rec, l7)
                r.stage_unique(drop)
                out.append(r)
        return out

    def chunks(self, replay, name, step=CHUNK):
        rec, l7 = self.scen[name]["sections"][:2]
        outs = [replay.verdict_chunk(rec[s:s + step], l7[s:s + step],
                                     start=s)
                for s in range(0, len(rec), step)]
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
    return _World(str(tmp_path_factory.mktemp("replay")))


def _assert_lanes_equal(want, got):
    assert set(got) == set(OUTPUT_LANES)
    for lane in OUTPUT_LANES:
        a, b = np.asarray(want[lane]), np.asarray(got[lane])
        assert (a.shape, a.dtype) == (b.shape, b.dtype), lane
        np.testing.assert_array_equal(b, a, lane)


# ------------------------------------------------------------ table scans
@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("name", list(SIZES))
def test_stage_capture_tables_equal_reference(world, name, arm):
    jeng, eng = world.engines(name, arm)
    s = world.scen[name]
    _, l7, offsets, blob = s["sections"]
    want = jax_verdict.stage_capture_tables(
        jeng, jax_verdict.CaptureFeaturizer(l7, offsets, blob,
                                            s["jpol"].kafka_interns))
    got = stage_capture_tables(
        eng, CaptureFeaturizer(l7, offsets, blob, s["pol"].kafka_interns))
    assert sorted(got) == sorted(want)
    assert ("path_groups" in got) == ("rp_path_gaccept" in s["pol"].arrays)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy().view(np.uint32)
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, k)


def _long_path_policies():
    """Four http rules with long literal paths: the path bank passes
    128 states, so the oblivious arm falls back for it."""
    made = []
    for pkg_synth, api in ((jax_synth, "cilium_tpu.policy.api"),
                           (synth, "cilium_tpu_torch.policy.api")):
        import importlib

        a = importlib.import_module(api)
        rules = [a.PortRuleHTTP(path="/" + "/".join(
            f"segment{i}x{j}" for j in range(6)) + "/[a-z]+")
            for i in range(4)]
        rule = a.Rule(
            endpoint_selector=a.EndpointSelector.from_labels(app="server"),
            ingress=(a.IngressRule(
                from_endpoints=(a.EndpointSelector.from_labels(
                    app="client"),),
                to_ports=(a.PortRule(
                    ports=(a.PortProtocol(80, pkg_synth.Protocol.TCP),),
                    rules=a.L7Rules(http=tuple(rules))),)),),
            labels=("long=1",))
        pi, sc = pkg_synth.realize_scenario(pkg_synth.SynthScenario(
            name="http", rules=[rule],
            endpoints={"server": {"app": "server"},
                       "client": {"app": "client"}}, flows=[]))
        made.append((pi, sc, rules))
    return made


def test_oblivious_table_scan_warns_for_an_oversized_path_bank(tmp_path):
    from cilium_tpu_torch.core import flow as pf

    (jpi, _, _), (pi, sc, rules) = _long_path_policies()
    jpol = jax_verdict.CompiledPolicy.build(jpi, JaxEngineConfig())
    pol = CompiledPolicy.build(pi, EngineConfig())
    assert pol.arrays["path_trans"].shape[1] > 128
    flows = [pf.Flow(src_identity=sc.ids["client"],
                     dst_identity=sc.ids["server"], dport=80,
                     l7=pf.L7Type.HTTP,
                     http=pf.HTTPInfo(method="GET",
                                      path=r.path[:-6] + "ab" * (i + 1)))
             for i, r in enumerate(rules)]
    path = str(tmp_path / "long.bin")
    binary.write_capture_l7(path, flows)
    l7, offsets, blob = binary.read_l7_sidecar(path)
    with _dfa_env("pallas"):
        jeng = jax_verdict.VerdictEngine(jpol)
        eng = TorchVerdictEngine(pol, device="cpu")
    with pytest.warns(RuntimeWarning, match="constant-time guarantee"):
        want = jax_verdict.stage_capture_tables(
            jeng, jax_verdict.CaptureFeaturizer(l7, offsets, blob,
                                                jpol.kafka_interns))
    with pytest.warns(RuntimeWarning, match="constant-time guarantee"):
        got = stage_capture_tables(
            eng, CaptureFeaturizer(l7, offsets, blob, pol.kafka_interns))
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy().view(np.uint32),
                                      np.asarray(w), k)
    assert np.asarray(want["path"]).any()


# ------------------------------------------------------------------ dedup
@pytest.mark.parametrize("collide", [False, True])
@pytest.mark.parametrize("name", list(SIZES))
def test_stage_unique_equals_reference(world, name, collide, monkeypatch):
    if collide:
        for mod in (jax_memo, memo):
            monkeypatch.setattr(
                mod, "hash_rows",
                lambda rows: np.zeros(len(rows), dtype=np.uint64))
    jr, r = world.replays(name, "gather", "id")
    assert r.n_unique == jr.n_unique
    np.testing.assert_array_equal(r._uniq_host, jr._uniq_host)
    assert r.row_idx.dtype == jr.row_idx.dtype == np.uint16
    np.testing.assert_array_equal(r.row_idx, jr.row_idx)
    np.testing.assert_array_equal(r._uniq_host[r.row_idx], r.rows_all)


def test_stage_unique_declines_past_the_drop_ratio(world):
    jr, r = world.replays("kafka", "gather", "row")
    assert r.row_idx is None and jr.row_idx is None
    assert r.n_unique == jr.n_unique


# ----------------------------------------------------------- replay lanes
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("name", list(SIZES))
def test_verdict_chunk_equals_reference(world, name, arm, route):
    want = world.reference(name, arm, route)
    _, r = world.replays(name, arm, route)
    got = world.chunks(r, name)
    _assert_lanes_equal(want, got)
    assert (r.memo is not None) == (route == "memo")
    assert (r.row_idx is None) == (route == "row")
    # every route and arm gives the fused step's verdicts
    _, eng = world.engines(name, arm)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        _assert_lanes_equal(eng.verdict_flows(world.scen[name]["flows"]),
                            got)
    assert len(set(got["verdict"].tolist())) > 1


# ------------------------------------------------------------ memo checks
def test_memo_replay_bit_equal_and_counted(world):
    _, eng = world.engines("http", "gather")
    _, r = world.replays("http", "gather", "memo")
    hits0 = METRICS.get(VERDICT_MEMO_HITS)
    misses0 = METRICS.get(VERDICT_MEMO_MISSES)
    got = world.chunks(r, "http", step=64)
    _assert_lanes_equal(eng.verdict_flows(world.scen["http"]["flows"]),
                        got)
    m = r.memo
    n = len(world.scen["http"]["flows"])
    assert (m.misses, m.hits) == (r.n_unique, n)
    assert METRICS.get(VERDICT_MEMO_HITS) - hits0 == n
    assert METRICS.get(VERDICT_MEMO_MISSES) - misses0 == r.n_unique
    assert m.filled == r.n_unique and m.capacity == len(r._uniq_host)


def test_memo_disabled_by_config_knob(world):
    _, eng = world.engines("http", "gather")
    _, r = world.replays("http", "gather", "id")
    rec, l7 = world.scen["http"]["sections"][:2]
    out = r.verdict_chunk(rec, l7)
    assert r.memo is None
    _assert_lanes_equal(eng.verdict_flows(world.scen["http"]["flows"]),
                        out)


def test_memo_invalidated_on_policy_generation_bump(world):
    _, eng = world.engines("http", "gather")
    _, r = world.replays("http", "gather", "memo")
    rec, l7 = world.scen["http"]["sections"][:2]
    want = eng.verdict_flows(world.scen["http"]["flows"])
    _assert_lanes_equal(want, r.verdict_chunk(rec, l7))
    m = r.memo
    inv0 = m.invalidations
    memo.POLICY_GENERATION.bump()
    _assert_lanes_equal(want, r.verdict_chunk(rec, l7))
    assert m.invalidations == inv0 + 1
    assert m.misses == 2 * r.n_unique      # refilled once


def _auth_world(pkg):
    """(engine, flows, cart, pay) of a policy whose only entry demands
    authentication, in the JAX package or the port."""
    import importlib

    root = "cilium_tpu" if pkg == "jax" else "cilium_tpu_torch"
    m = {n: importlib.import_module(f"{root}.{n}") for n in (
        "core.flow", "core.identity", "core.labels", "policy.api",
        "policy.mapstate", "policy.repository", "policy.selectorcache")}
    api, fl = m["policy.api"], m["core.flow"]
    rules = [api.Rule(
        endpoint_selector=api.EndpointSelector.from_labels(app="pay"),
        ingress=(api.IngressRule(
            from_endpoints=(api.EndpointSelector.from_labels(app="cart"),),
            auth_mode="required",
            to_ports=(api.PortRule(
                ports=(api.PortProtocol(8443, fl.Protocol.TCP),)),)),),
    )]
    alloc = m["core.identity"].IdentityAllocator()
    LabelSet = m["core.labels"].LabelSet
    pay = alloc.allocate(LabelSet.from_dict({"app": "pay"}))
    cart = alloc.allocate(LabelSet.from_dict({"app": "cart"}))
    cache = m["policy.selectorcache"].SelectorCache(alloc)
    repo = m["policy.repository"].Repository()
    repo.add(rules, sanitize=False)
    per_identity = {pay: m["policy.mapstate"].PolicyResolver(
        repo, cache).resolve(alloc.lookup(pay))}
    flows = [fl.Flow(src_identity=cart, dst_identity=pay, dport=8443)]
    if pkg == "jax":
        engine = jax_verdict.VerdictEngine(
            jax_verdict.CompiledPolicy.build(per_identity,
                                             JaxEngineConfig()))
    else:
        engine = TorchVerdictEngine(
            CompiledPolicy.build(per_identity, EngineConfig()),
            device="cpu")
    return engine, flows, cart, pay


def _session(engine, flows, cls, tmp_path, cfg=None, loader=None):
    path = str(tmp_path / f"s{id(engine)}.bin")
    binary.write_capture_l7(path, flows)
    rec = np.asarray(binary.map_capture(path))
    l7, offsets, blob = binary.read_l7_sidecar(path)
    r = cls(engine, l7, offsets, blob, cfg, loader=loader)
    r.stage_rows(rec, l7)
    r.stage_unique()
    return r, rec, l7


def test_memo_keys_on_auth_view(tmp_path):
    """A different auth view never reads another view's verdicts: the
    memo invalidates on a signature change, fails closed without a
    table, and forwards once the pair is authed — as the reference."""
    results = []
    for pkg, cls in (("jax", jax_verdict.CaptureReplay),
                     ("port", CaptureReplay)):
        engine, flows, cart, pay = _auth_world(pkg)
        r, rec, l7 = _session(engine, flows, cls, tmp_path)
        authed = np.array([[cart, pay]], dtype=np.int32)
        closed = r.verdict_chunk(rec, l7, authed_pairs=None)
        inv0 = r.memo.invalidations
        opened = r.verdict_chunk(rec, l7, authed_pairs=authed)
        results.append((closed, opened,
                        r.memo.invalidations - inv0))
    (jc, jo, jinv), (c, o, inv) = results
    assert int(c["verdict"][0]) == 2 and int(o["verdict"][0]) == 1
    assert inv == jinv == 1
    _assert_lanes_equal(jc, c)
    _assert_lanes_equal(jo, o)


def test_prefetched_id_chunks_replay_identically(world):
    _, eng = world.engines("fqdn", "gather")
    _, r = world.replays("fqdn", "gather", "memo")
    got = world.chunks(r, "fqdn", step=48)
    _assert_lanes_equal(eng.verdict_flows(world.scen["fqdn"]["flows"]),
                        got)
    assert r._prefetched == {}     # every prefetched chunk was consumed


class _StubLoader:
    """Just an ``.engine``, as the replay session reads a loader."""

    def __init__(self, engine):
        self.engine = engine


def test_scatter_refill_after_bank_scoped_delta(tmp_path):
    """A bank-scoped delta naming (server, http) rebinds the session to
    the loader's new engine, restages the table scan and scatter-
    refills ONLY the http rows of the memo; the l4 rows keep serving.
    Lanes, refill count and invalidations equal the reference's."""
    import cilium_tpu.core.flow as jax_flow
    import cilium_tpu_torch.core.flow as port_flow

    runs = []
    for pkg_synth, flow_mod, build, cls, gen, eng_of in (
            (jax_synth, jax_flow,
             lambda pi: jax_verdict.CompiledPolicy.build(
                 pi, JaxEngineConfig()),
             jax_verdict.CaptureReplay, jax_memo,
             jax_verdict.VerdictEngine),
            (synth, port_flow,
             lambda pi: CompiledPolicy.build(pi, EngineConfig()),
             CaptureReplay, memo,
             lambda p: TorchVerdictEngine(p, device="cpu"))):
        pi_a, sc = pkg_synth.realize_scenario(
            pkg_synth.scenario_by_name("http", 12, 160))
        pi_b, _ = pkg_synth.realize_scenario(
            pkg_synth.scenario_by_name("http", 10, 1))
        for i, f in enumerate(sc.flows):
            if i % 5 == 0:       # L4-only rows: untouched by the delta
                f.l7, f.http = flow_mod.L7Type.NONE, None
        eng_a, eng_b = eng_of(build(pi_a)), eng_of(build(pi_b))
        loader = _StubLoader(eng_a)
        r, rec, l7 = _session(eng_a, sc.flows, cls, tmp_path,
                              loader=loader)
        r.verdict_chunk(rec, l7)
        misses0 = r.memo.misses
        loader.engine = eng_b
        server = sc.ids["server"]
        gen.POLICY_GENERATION.bump(gen.PolicyDelta.banks(
            {server}, set(), identity_families={(server, "http")}))
        out = r.verdict_chunk(rec, l7)
        want = eng_b.verdict_flows(sc.flows)
        runs.append((out, want, r.memo.misses - misses0,
                     r.memo.invalidations, r.engine is eng_b,
                     r.n_unique))
    (jout, jwant, jrefill, jinv, jswapped, _), \
        (out, want, refill, inv, swapped, n_unique) = runs
    _assert_lanes_equal(want, out)
    _assert_lanes_equal(jout, out)
    for lane in OUTPUT_LANES:
        np.testing.assert_array_equal(np.asarray(jwant[lane]),
                                      np.asarray(jout[lane]), lane)
    assert jswapped and swapped
    assert refill == jrefill and 0 < refill < n_unique
    assert inv == jinv == 1
