"""The three BASELINE configs the port newly runs, and the ``autotune``
scan-arm pick, against the JAX package, on the CPU, exact.

* fqdn (configs[0]: 10 rules × 100 names × 10000 flows, ``bench.py``'s
  published size), mixed (configs[3]: the ``examples/policies`` corpus ×
  20000 tuples, cut from 1000000) and clustermesh (configs[4]: 500
  identities × 250 CNPs × 5000 flows, cut from 10000 × 5000 × 100000),
  each made from seed 0 by both packages' ``synth``, resolved by each
  package's ``realize_scenario`` (the port shares one MapState among
  identities that select the same rules; the contents are equal) and
  staged by each package's real ``Loader`` (the reference with the gate
  on under ``JAX_PLATFORMS=cpu``, the port with ``device="cpu"``): all
  ten output lanes equal on every flow, under the gather and the
  oblivious DFA arm, and the compiled arrays byte-equal;
* ``realize_scenario``'s MapStates equal the reference's, identity by
  identity, and ``Repository.matching_rules`` (indexed in the port)
  returns the reference's rules in the reference's order;
* counterparts of the reference's ``tests/test_megakernel.py``
  autotune cases: the shape-key cache hit, the snapshot/adopt round
  trip, the metric counts, ``kernel_impl="autotune"`` staging a plan and
  its lanes equal to ``auto``'s; the key's device type (a pick measured
  on the CPU is never served for ``cuda``); the loader's warm state
  carrying the picks.

The arm ``autotune`` picks is a wall-clock race: nothing here asserts
which arm wins on the CPU.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)

from test_torch_loader import (  # noqa: E402
    JAX,
    PKGS,
    PORT,
    _assert_same_policy,
    _build,
    _lanes,
    _plain,
)

REPO = os.path.dirname(TESTS)
CORPUS = os.path.join(REPO, "examples", "policies")
LANES = ("verdict", "match_spec", "ruleset", "allowed", "l3l4_allowed",
         "redirect", "l7_ok", "l7_log", "auth_required", "l7_match")
#: (config, rules, flows) at the tests' sizes; clustermesh's identities
CONFIGS = {"fqdn": (10, 10_000), "mixed": (0, 20_000),
           "clustermesh": (250, 5_000)}
CM_IDENTITIES = 500


def _scenario(pkg, name):
    n_rules, n_flows = CONFIGS[name]
    if name == "fqdn":
        sc = pkg.synth.scenario_by_name("fqdn", n_rules, n_flows)
    elif name == "mixed":
        sc = pkg.synth.synth_mixed_scenario(CORPUS, n_tuples=n_flows, seed=0)
    else:
        sc = pkg.synth.synth_clustermesh_scenario(
            n_identities=CM_IDENTITIES, n_policies=n_rules,
            n_flows=n_flows, seed=0)
    return pkg.synth.realize_scenario(sc)


def _loader(pkg, per_identity, cache_dir):
    cfg = pkg.config.Config()
    cfg.enable_tpu_offload = True
    cfg.loader.cache_dir = str(cache_dir)
    cfg.compile.deadline_s = 600.0
    ld = (pkg.loader.Loader(cfg) if pkg.jax
          else pkg.loader.Loader(cfg, device="cpu"))
    ld.regenerate(per_identity, revision=1)
    return ld


@pytest.fixture(scope="module", params=list(CONFIGS))
def config(request, tmp_path_factory):
    """name → per package: (snapshot, scenario, loader)."""
    name = request.param
    out = {}
    for pkg in PKGS:
        pi, sc = _scenario(pkg, name)
        out[pkg.root] = (pi, sc, _loader(
            pkg, pi, tmp_path_factory.mktemp(f"{name}-{pkg.root}")))
    yield name, out
    for _, _, ld in out.values():
        ld.close()


def test_scenarios_and_snapshots_equal_the_reference(config):
    name, out = config
    (jpi, jsc, _), (ppi, psc, _) = out["cilium_tpu"], out["cilium_tpu_torch"]
    assert jsc.ids == psc.ids and sorted(jpi) == sorted(ppi)

    def key(f):
        return (f.src_identity, f.dst_identity, f.dport, int(f.protocol),
                int(f.direction), int(f.l7), _plain(f.http),
                _plain(f.kafka), _plain(f.dns))

    assert [key(f) for f in psc.flows] == [key(f) for f in jsc.flows]
    for nid in jpi:
        assert _plain(ppi[nid].entries) == _plain(jpi[nid].entries), nid
        assert (ppi[nid].ingress_enforced, ppi[nid].egress_enforced) == \
            (jpi[nid].ingress_enforced, jpi[nid].egress_enforced)
    if name == "clustermesh":
        # one MapState a rule set: the 250 apps with a CNP, and one
        # (empty) for the 250 identities no rule selects; at the
        # published size 500 serve 8000 identities
        assert len({id(ms) for ms in ppi.values()}) == 251


def test_compiled_arrays_equal_the_reference(config):
    _, out = config
    _assert_same_policy(_build(JAX, out["cilium_tpu"][0]),
                        _build(PORT, out["cilium_tpu_torch"][0]))


@pytest.mark.parametrize("arm", ["gather", "pallas"])
def test_all_ten_lanes_equal_the_reference(config, arm, monkeypatch):
    """Every flow of the config through each package's loader-staged
    engine (rebuilt under the arm; the JAX engine reads
    ``CILIUM_TPU_DFA_IMPL`` when it is built)."""
    name, out = config
    monkeypatch.setenv("CILIUM_TPU_DFA_IMPL", arm)
    got = {}
    for pkg in PKGS:
        _, sc, ld = out[pkg.root]
        if pkg.jax:
            from cilium_tpu.engine.verdict import VerdictEngine

            eng = VerdictEngine(ld.engine.policy, cfg=ld.engine.cfg)
        else:
            from cilium_tpu_torch.engine.verdict import TorchVerdictEngine

            eng = TorchVerdictEngine(ld.engine.policy, device="cpu",
                                     cfg=ld.engine.cfg)
        got[pkg.root] = _lanes(eng.verdict_flows(sc.flows))
    for k in LANES:
        np.testing.assert_array_equal(got["cilium_tpu_torch"][k],
                                      got["cilium_tpu"][k], f"{name} {k}")
    mix = np.bincount(got["cilium_tpu_torch"]["verdict"], minlength=6)
    assert mix[2] > 0 and mix[1] + mix[5] > 0, mix


def test_loader_engine_lanes_equal_the_reference(config):
    name, out = config
    flows = {p.root: out[p.root][1].flows[:4096] for p in PKGS}
    want = _lanes(out["cilium_tpu"][2].engine.verdict_flows(
        flows["cilium_tpu"]))
    got = _lanes(out["cilium_tpu_torch"][2].engine.verdict_flows(
        flows["cilium_tpu_torch"]))
    for k in LANES:
        np.testing.assert_array_equal(got[k], want[k], f"{name} {k}")


def test_indexed_matching_rules_equal_the_full_scan():
    """The port's index returns, for every identity, the rules a scan
    of every rule returns, in order; and it follows the revision."""
    from cilium_tpu_torch.core.labels import LabelSet
    from cilium_tpu_torch.policy.api import load_cnp_dir
    from cilium_tpu_torch.policy.repository import Repository

    rules = [r for c in load_cnp_dir(CORPUS) for r in c.rules]
    sc = PORT.synth.synth_clustermesh_scenario(200, 100, 10)
    repo = Repository()
    repo.add(rules)
    repo.add(sc.rules, sanitize=False)
    label_sets = [LabelSet.from_dict(v) for v in sc.endpoints.values()]
    label_sets += [LabelSet.parse(["reserved:host", "k8s:node-role=worker"]),
                   LabelSet.from_dict({"app": "crawler"}),
                   LabelSet.from_dict({"ns": "fintech", "app": "ledger"}),
                   LabelSet.from_dict({"env": "prod", "tier": "web"}),
                   LabelSet()]
    for ls in label_sets:
        want = tuple(r for r in repo.rules() if r.selects(ls))
        assert repo.matching_rules(ls) == want
    n, _ = repo.delete_by_labels(["synth=mesh3"])
    assert n == 1
    for ls in label_sets[:20]:
        assert repo.matching_rules(ls) == tuple(
            r for r in repo.rules() if r.selects(ls))


# ---------------------------------------------------------------- autotune
def _autotune_inputs():
    from cilium_tpu_torch.core.config import EngineConfig
    from cilium_tpu_torch.engine import nfa_kernel
    from cilium_tpu_torch.policy.compiler.dfa import compile_patterns

    banked = compile_patterns([f"/t{i}/x" for i in range(6)], bank_size=3)
    arrays = {f"at_{k}": v for k, v in banked.stacked().items()}
    stacked = nfa_kernel.stack_nfa_banks(
        nfa_kernel.banks_from_dfa(banked, EngineConfig()))
    return arrays, stacked


def test_autotune_mechanics_and_recording(monkeypatch):
    """The reference's ``test_autotune_mechanics_and_recording`` on the
    port: a pick with both times, counted once; a cache hit serves the
    same pick; the snapshot adopts into a cold cache; the key carries the
    device type."""
    from cilium_tpu_torch.engine import megakernel
    from cilium_tpu_torch.runtime.metrics import (
        KERNEL_AUTOTUNE_PICKS,
        KERNEL_AUTOTUNE_SECONDS,
        METRICS,
    )

    arrays, stacked = _autotune_inputs()
    monkeypatch.setattr(megakernel, "_AUTOTUNE_CACHE", {})
    before = {impl: METRICS.get(KERNEL_AUTOTUNE_PICKS,
                                {"impl": impl, "field": "at-test"})
              for impl in ("dfa-dense", "nfa-bitset")}
    secs = METRICS.histo_sum(KERNEL_AUTOTUNE_SECONDS)
    r1 = megakernel.autotune_field("at-test", arrays, "at", stacked,
                                   width=16, device="cpu", probe_batch=64)
    assert r1["impl"] in ("dfa-dense", "nfa-bitset")
    assert r1["dense_ms"] is not None and r1["nfa_ms"] is not None
    after = {impl: METRICS.get(KERNEL_AUTOTUNE_PICKS,
                               {"impl": impl, "field": "at-test"})
             for impl in before}
    assert after[r1["impl"]] == before[r1["impl"]] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    assert METRICS.histo_sum(KERNEL_AUTOTUNE_SECONDS) > secs
    r2 = megakernel.autotune_field("at-test", arrays, "at", stacked,
                                   width=16, device="cpu", probe_batch=64)
    assert r2 is r1
    assert sum(METRICS.get(KERNEL_AUTOTUNE_PICKS,
                           {"impl": i, "field": "at-test"})
               for i in before) == sum(after.values())
    (key,) = megakernel._AUTOTUNE_CACHE
    assert key == ("at-test", arrays["at_trans"].shape,
                   stacked["nfa_follow"].shape, 16, "cpu")
    snap = megakernel.autotune_cache_snapshot()
    megakernel._AUTOTUNE_CACHE.clear()
    megakernel.autotune_cache_adopt(snap)
    megakernel.autotune_cache_adopt({"not a key": {}, "[1]": {}})
    r3 = megakernel.autotune_field("at-test", arrays, "at", stacked,
                                   width=16, device="cpu", probe_batch=64)
    assert r3 == r1
    # a pick measured on the CPU is not the card's: another key
    assert megakernel._shape_key("at-test", arrays["at_trans"].shape,
                                 stacked["nfa_follow"].shape, 16,
                                 "cuda") not in megakernel._AUTOTUNE_CACHE
    # no NFA stack: the dense arm, one time
    r4 = megakernel.autotune_field("at-dense", arrays, "at", None,
                                   width=16, device="cpu", probe_batch=64)
    assert r4["impl"] == "dfa-dense" and r4["nfa_ms"] is None


@pytest.mark.parametrize("arm", ["gather", "pallas"])
def test_autotune_mode_stages_and_records_plan(arm, monkeypatch, tmp_path):
    """The reference's ``test_autotune_mode_stages_and_records_plan``:
    every field carries a measured pick, the plan rides the policy and
    the loader's bank status, and the lanes equal ``auto``'s and the
    reference's ``autotune`` engine's, whatever arm each picked."""
    from cilium_tpu.core.config import EngineConfig as JaxEngineConfig
    from cilium_tpu.engine import megakernel as jax_mk
    from cilium_tpu.engine.verdict import CompiledPolicy as JaxPolicy
    from cilium_tpu.engine.verdict import VerdictEngine

    from cilium_tpu_torch.core.config import EngineConfig
    from cilium_tpu_torch.engine import megakernel
    from cilium_tpu_torch.engine.compiled import CompiledPolicy
    from cilium_tpu_torch.engine.verdict import TorchVerdictEngine

    monkeypatch.setenv("CILIUM_TPU_DFA_IMPL", arm)
    monkeypatch.setattr(megakernel, "_AUTOTUNE_CACHE", {})
    monkeypatch.setattr(jax_mk, "_AUTOTUNE_CACHE", {})
    pi, sc = PORT.synth.realize_scenario(
        PORT.synth.synth_http_scenario(n_rules=16, n_flows=64))
    jpi, jsc = JAX.synth.realize_scenario(
        JAX.synth.synth_http_scenario(n_rules=16, n_flows=64))
    cfg = EngineConfig()
    cfg.bank_size, cfg.kernel_impl = 4, "autotune"
    pol = CompiledPolicy.build(pi, cfg)
    engine = TorchVerdictEngine(pol, device="cpu", cfg=cfg)
    assert set(engine.kernel_report) == {"path", "method", "host", "hdr",
                                         "dns"}
    for rep in engine.kernel_report.values():
        assert rep["impl"] in ("dfa-dense", "nfa-bitset")
        assert rep["dense_ms"] is not None and rep["nfa_ms"] is not None
    assert engine.policy.kernel_plan == engine.impl_plan
    auto = TorchVerdictEngine(pol, device="cpu", cfg=dataclasses.replace(
        cfg, kernel_impl="auto"))
    jcfg = JaxEngineConfig()
    jcfg.bank_size, jcfg.kernel_impl = 4, "autotune"
    ref = VerdictEngine(JaxPolicy.build(jpi, jcfg), cfg=jcfg)
    want = _lanes(ref.verdict_flows(jsc.flows))
    for got in (engine.verdict_flows(sc.flows), auto.verdict_flows(sc.flows)):
        got = _lanes(got)
        for k in LANES:
            np.testing.assert_array_equal(got[k], want[k], k)
    # the loader stages under autotune and reports the plan
    cfg = PORT.config.Config()
    cfg.loader.cache_dir = str(tmp_path)
    cfg.engine.kernel_impl = "autotune"
    ld = PORT.loader.Loader(cfg, device="cpu")
    try:
        ld.regenerate(pi, revision=2)
        status = ld.bank_status()
        assert status["enabled"] and "kernel_plan" in status
        assert set(ld.engine.impl_plan) == {"path", "method", "host", "hdr",
                                            "dns"}
    finally:
        ld.close()


def test_warm_state_carries_the_picks(monkeypatch, tmp_path):
    """The loader's warm-restart snapshot carries the autotune cache and
    a fresh loader's ``restore_warm`` adopts it: the restaged engine
    serves the recorded picks without measuring again."""
    from cilium_tpu_torch.engine import megakernel
    from cilium_tpu_torch.runtime.metrics import (
        KERNEL_AUTOTUNE_PICKS,
        METRICS,
    )

    monkeypatch.setattr(megakernel, "_AUTOTUNE_CACHE", {})
    pi, _ = PORT.synth.realize_scenario(
        PORT.synth.synth_http_scenario(n_rules=8, n_flows=16))

    def loader():
        cfg = PORT.config.Config()
        cfg.loader.cache_dir = str(tmp_path)
        cfg.engine.kernel_impl = "autotune"
        return PORT.loader.Loader(cfg, device="cpu")

    def picks():
        return sum(METRICS.get(KERNEL_AUTOTUNE_PICKS, {"impl": i, "field": f})
                   for i in ("dfa-dense", "nfa-bitset")
                   for f in ("path", "method", "host", "hdr", "dns"))

    ld = loader()
    try:
        ld.regenerate(pi, revision=1)
        plan = dict(ld.engine.impl_plan)
        assert ld.snapshot_warm()
    finally:
        ld.close()
    snap = megakernel.autotune_cache_snapshot()
    assert len(snap) == 5
    megakernel._AUTOTUNE_CACHE.clear()
    n0 = picks()
    ld = loader()
    try:
        assert ld.restore_warm()
        assert megakernel.autotune_cache_snapshot() == snap
        assert ld.engine.impl_plan == plan
    finally:
        ld.close()
    assert picks() == n0
