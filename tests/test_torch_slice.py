"""The whole fused verdict step of the port against the JAX package's,
bit-equal on all ten output lanes, on the CPU.

Three configurations, as the engine runs them:

* ``auto`` — every field on the dense-gather arm (the port's KD);
* ``nfa-bitset`` — the JAX side runs ``fused_verdict_step(...,
  use_pallas_nfa=True, interpret=True)`` (on the CPU ``VerdictEngine``
  would not reach Pallas), the port its K1 arm;
* the oblivious DFA — JAX ``dfa_impl="pallas"`` in interpret mode, the
  port its K2 arm, picked from ``CILIUM_TPU_DFA_IMPL=pallas`` as the
  reference picks it (with the reference's fallback warning for banks
  over 128 states).

Inputs: the http scenario at 40 rules × 256 flows, some flows mutated
(empty and overlong paths, unmatched ports, egress, missing L7 record)
so that every lane sees both values. The port is fed the JAX package's
compiled arrays through ``weights.arrays_from_reference``, and then
its own compiled policy through ``TorchVerdictEngine``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cilium_tpu.core.config import EngineConfig as JaxEngineConfig
from cilium_tpu.engine import megakernel as jax_mk
from cilium_tpu.engine.verdict import CompiledPolicy as JaxCompiledPolicy
from cilium_tpu.engine.verdict import encode_flows as jax_encode_flows
from cilium_tpu.engine.verdict import (
    flowbatch_to_host_dict as jax_flowbatch_to_host_dict,
)
from cilium_tpu.ingest import synth as jax_synth

from cilium_tpu_torch.core.config import EngineConfig
from cilium_tpu_torch.engine import megakernel as mk
from cilium_tpu_torch.engine.compiled import CompiledPolicy
from cilium_tpu_torch.engine.verdict import (
    OUTPUT_LANES,
    TorchVerdictEngine,
    batch_to_device,
)
from cilium_tpu_torch.ingest import synth
from cilium_tpu_torch.weights import arrays_from_reference

N_RULES, N_FLOWS = 40, 256

#: name → (kernel_impl, bank_size, JAX dfa_impl, port dfa_impl)
CONFIGS = {
    "auto": ("auto", 128, "gather", "gather"),
    "nfa-bitset": ("nfa-bitset", 128, "gather", "gather"),
    "nfa-bitset-small-banks": ("nfa-bitset", 4, "gather", "gather"),
    "oblivious": ("auto", 128, "pallas", "oblivious"),
    "oblivious-small-banks": ("auto", 8, "pallas", "oblivious"),
}


def _mutate(flows, pkg_flow):
    """Deterministic edge cases, applied alike to both packages' flows."""
    for i, f in enumerate(flows):
        if i % 17 == 0:
            f.http.path = ""
        if i % 19 == 0:
            f.http.path = "/" + "a" * 300          # past the 256 bucket
        if i % 23 == 0:
            f.dport = 8080                         # no L4 entry
        if i % 29 == 0:
            f.l7 = pkg_flow.L7Type.NONE
        if i % 31 == 0:
            f.direction = pkg_flow.TrafficDirection.EGRESS
        if i % 37 == 0:
            f.http.method = ""
        if i % 13 == 0:
            f.http.host = f.http.host.upper()
    return flows


def _scenarios():
    import cilium_tpu.core.flow as jax_flow
    import cilium_tpu_torch.core.flow as port_flow

    jpi, jsc = jax_synth.realize_scenario(
        jax_synth.scenario_by_name("http", N_RULES, N_FLOWS))
    pi, sc = synth.realize_scenario(
        synth.scenario_by_name("http", N_RULES, N_FLOWS))
    _mutate(jsc.flows, jax_flow)
    _mutate(sc.flows, port_flow)
    return (jpi, jsc), (pi, sc)


@pytest.fixture(scope="module")
def scenarios():
    return _scenarios()


@pytest.fixture(scope="module")
def runs(scenarios):
    """config → (JAX outputs, port outputs on the JAX arrays, port
    policy + flows + cfg + ``CILIUM_TPU_DFA_IMPL`` value, JAX outputs'
    plan)."""
    (jpi, jsc), (pi, sc) = scenarios
    out = {}
    for name, (mode, bank, jax_dfa, port_dfa) in CONFIGS.items():
        jcfg, cfg = JaxEngineConfig(), EngineConfig()
        for c in (jcfg, cfg):
            c.kernel_impl = mode
            c.bank_size = bank
        jpol = JaxCompiledPolicy.build(jpi, jcfg)
        jplan, jextra, _ = jax_mk.plan_for_engine(jpol, jcfg, True)
        host = jax_flowbatch_to_host_dict(
            jax_encode_flows(jsc.flows, jpol.kafka_interns, jcfg))
        step = jax.jit(lambda a, b, p=tuple(sorted(jplan.items())),
                       d=jax_dfa: jax_mk.fused_verdict_step(
                           a, b, impl_plan=p, dfa_impl=d, interpret=True,
                           use_pallas_nfa=True))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            want = step({k: jnp.asarray(v)
                         for k, v in {**jpol.arrays, **jextra}.items()},
                        {k: jnp.asarray(v) for k, v in host.items()})
        want = {k: np.asarray(v) for k, v in want.items()}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got = mk.fused_verdict_step(
                arrays_from_reference({**jpol.arrays, **jextra}, "cpu"),
                batch_to_device(host, "cpu"),
                impl_plan=tuple(sorted(jplan.items())), dfa_impl=port_dfa)
        out[name] = (want, {k: v.numpy() for k, v in got.items()},
                     (CompiledPolicy.build(pi, cfg), sc.flows, cfg,
                      jax_dfa), jplan)
    return out


def _assert_lanes_equal(want, got):
    assert set(got) == set(OUTPUT_LANES)
    for lane in OUTPUT_LANES:
        a, b = np.asarray(want[lane]), np.asarray(got[lane])
        assert (a.shape, a.dtype) == (b.shape, b.dtype), lane
        np.testing.assert_array_equal(b, a, lane)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_fused_step_on_reference_arrays(runs, config):
    want, got, _, plan = runs[config]
    _assert_lanes_equal(want, got)
    # the scenario must exercise both sides of the verdict
    codes = set(np.unique(want["verdict"]).tolist())
    assert {2, 5} <= codes, codes
    if config == "nfa-bitset-small-banks":
        assert set(plan.values()) == {"nfa-bitset"}
    if config == "auto":
        assert set(plan.values()) == {"dfa-dense"}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_engine_on_port_compiled_policy(runs, config, monkeypatch):
    want, _, (pol, flows, cfg, env_dfa), plan = runs[config]
    monkeypatch.setenv("CILIUM_TPU_DFA_IMPL", env_dfa)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        engine = TorchVerdictEngine(pol, device="cpu", cfg=cfg)
        got = engine.verdict_flows(flows)
    assert engine.impl_plan == plan
    assert pol.kernel_plan == plan
    _assert_lanes_equal(want, got)


def test_oblivious_arm_warns_for_the_path_stack(runs, monkeypatch):
    _, _, (pol, flows, cfg, env_dfa), _ = runs["oblivious"]
    monkeypatch.setenv("CILIUM_TPU_DFA_IMPL", env_dfa)
    engine = TorchVerdictEngine(pol, device="cpu", cfg=cfg)
    with pytest.warns(RuntimeWarning, match="constant-time guarantee"):
        engine.verdict_flows(flows[:8])


def test_auth_demanding_policy_fails_closed():
    """A policy whose entries demand auth drops those flows when no
    authed table is given (the reference's sentinel), forwards them
    when the pair is authed, and ``AUTH_UNENFORCED`` opts out."""
    from cilium_tpu_torch.engine.verdict import AUTH_UNENFORCED

    (_, _), (pi, sc) = _scenarios()
    for ms in pi.values():
        for e in ms.entries.values():
            e.auth_required = True
    pol = CompiledPolicy.build(pi, EngineConfig())
    engine = TorchVerdictEngine(pol, device="cpu")
    assert engine.needs_auth
    flows = sc.flows[:64]
    closed = engine.verdict_flows(flows)
    assert not closed["allowed"][closed["auth_required"]].any()
    pairs = np.array(sorted({(f.src_identity, f.dst_identity)
                             for f in flows}), dtype=np.int32)
    authed = engine.verdict_flows(flows, authed_pairs=pairs)
    opted = engine.verdict_flows(flows, authed_pairs=AUTH_UNENFORCED)
    np.testing.assert_array_equal(authed["allowed"], opted["allowed"])
    assert authed["allowed"].sum() > closed["allowed"].sum()
