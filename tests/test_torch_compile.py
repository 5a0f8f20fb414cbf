"""The port's host half is byte-equal to the JAX package's.

``cilium_tpu_torch`` carries its own copy of the policy compiler (the
machine with the card has no JAX and no pyyaml), so every staged array
— ``CompiledPolicy.build``, the factored resolve plan, the per-field
scan-arm extras of ``plan_for_engine`` and the encoded flow batch —
must come out identical, dtype and shape included, for the same
resolved policy.
"""

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
from cilium_tpu_torch.engine.compiled import (
    CompiledPolicy,
    encode_flows,
    flowbatch_to_host_dict,
)
from cilium_tpu_torch.ingest import synth


def _assert_same_arrays(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        assert np.array_equal(a, b), k


def _both(n_rules, n_flows, mode, bank_size):
    jpi, jsc = jax_synth.realize_scenario(
        jax_synth.scenario_by_name("http", n_rules, n_flows))
    pi, sc = synth.realize_scenario(
        synth.scenario_by_name("http", n_rules, n_flows))
    jcfg, cfg = JaxEngineConfig(), EngineConfig()
    for c in (jcfg, cfg):
        c.kernel_impl = mode
        c.bank_size = bank_size
    jpol = JaxCompiledPolicy.build(jpi, jcfg)
    pol = CompiledPolicy.build(pi, cfg)
    return (jpol, jsc, jcfg), (pol, sc, cfg)


@pytest.mark.parametrize("mode,bank_size", [
    ("auto", 128),
    ("nfa-bitset", 4),
    ("nfa-bitset", 128),
])
def test_compiled_arrays_byte_equal(mode, bank_size):
    (jpol, _, jcfg), (pol, _, cfg) = _both(40, 64, mode, bank_size)
    _assert_same_arrays(jpol.arrays, pol.arrays)
    assert jpol.kafka_interns == pol.kafka_interns
    assert jpol.resolve_meta["groups"] == pol.resolve_meta["groups"]
    assert np.array_equal(jpol.resolve_meta["lane_groups"],
                          pol.resolve_meta["lane_groups"])
    jplan, jextra, _ = jax_mk.plan_for_engine(jpol, jcfg, True)
    plan, extra, _ = mk.plan_for_engine(pol, cfg, "cpu")
    assert jplan == plan
    _assert_same_arrays(jextra, extra)


def test_small_banks_put_path_on_the_nfa_arm():
    """At a bank size where every path bank fits 128 NFA positions the
    forced nfa-bitset plan takes the path field too, with its group
    plane."""
    (_, _, _), (pol, _, cfg) = _both(40, 8, "nfa-bitset", 4)
    plan, extra, report = mk.plan_for_engine(pol, cfg, "cpu")
    assert plan["path"] == "nfa-bitset", report
    assert "path_nfa_gaccept" in extra
    assert all(r["nfa_positions"] <= 128 for r in report.values())


def test_auto_on_cuda_keeps_dense_at_1000_rules():
    """The `auto` rule the port applies to cuda is the reference's TPU
    rule: at http-1000 the path DFA busts 128 states but its positions
    do not fit either, and every other field fits the dense budget —
    so every field stays dense. (Decided on the host; no card needed.)"""
    pi, _ = synth.realize_scenario(synth.scenario_by_name("http", 1000, 1))
    cfg = EngineConfig()
    pol = CompiledPolicy.build(pi, cfg)
    plan, extra, report = mk.plan_for_engine(pol, cfg, "cuda")
    assert set(plan.values()) == {"dfa-dense"}, report
    assert report["path"]["dfa_states"] > 128
    assert extra == {}


@pytest.mark.parametrize("n_flows", [1, 97, 256])
def test_encoded_flows_byte_equal(n_flows):
    (jpol, jsc, jcfg), (pol, sc, cfg) = _both(40, n_flows, "auto", 128)
    jfb = jax_encode_flows(jsc.flows, jpol.kafka_interns, jcfg)
    fb = encode_flows(sc.flows, pol.kafka_interns, cfg)
    _assert_same_arrays(jax_flowbatch_to_host_dict(jfb),
                        flowbatch_to_host_dict(fb))


def test_l7proto_rules_name_the_later_slice():
    """An ``l7proto`` rule with no key/value constraint compiles as the
    reference compiles it: a frontend proto (r2d2) to one ``l7g``-family
    rule with no scan lane, a proxy-only proto (test.lineparser) to the
    0-pair generic rule — the same arrays and interns either way."""
    import cilium_tpu.policy.api as jax_api
    import cilium_tpu.policy.mapstate as jax_ms
    import cilium_tpu_torch.policy.api as port_api
    import cilium_tpu_torch.policy.mapstate as port_ms

    def policy(api, msm, proto):
        ms = msm.MapState()
        ms.insert(msm.MapStateKey(0, 80, 6, 0), msm.MapStateEntry(
            l7_rules=(api.L7Rules(l7proto=proto),)))
        return {1: ms}

    for proto in ("r2d2", "test.lineparser"):
        want = JaxCompiledPolicy.build(policy(jax_api, jax_ms, proto))
        got = CompiledPolicy.build(policy(port_api, port_ms, proto))
        _assert_same_arrays(want.arrays, got.arrays)
        assert want.kafka_interns == got.kafka_interns
        assert (got.fe_rules, got.gen_rules) == \
            (want.fe_rules, want.gen_rules)
        assert ("l7g_trans" in got.arrays) == (proto == "r2d2")
