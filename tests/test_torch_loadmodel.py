"""The port's serve soak (``runtime/loadmodel.py``) against the JAX
package's, on the CPU.

``driven`` mode is byte-deterministic: the same seed gives the same
event schedule, the same chunks and the same pack ticks in both
packages, so the whole result dict must be equal, key for key — lease
books, sheds, retries, packs, served records, memo hits and misses,
bytes saved and shipped, sampled checks, explain coverage, SLO burn
rates and the (virtual) latencies. Each package runs on its own
``VirtualClock`` and its own loader (the port's with ``device="cpu"``).

Sizes: the reference's own soak tests (``tests/test_serve_soak.py``), at
a few hundred streams and 20-40 virtual seconds. Those tests run the
pack thread too and are marked slow; so is the port's counterpart here.

Also: the soak at ``protocol_mix`` 0.2 and 1.0 (protocol-frontend
chunks blended into the pool) equals the reference's, frontend records
explain on their family lane, the soak stages on ``cuda`` by default,
and ``main`` prints one stamped line with its latencies labelled
virtual.
"""

import importlib
import json
import types

import numpy as np
import pytest
import torch

from cilium_tpu.runtime import faults as jax_faults
from cilium_tpu.runtime import loadmodel as jax_lm

from cilium_tpu_torch.runtime import faults as port_faults
from cilium_tpu_torch.runtime import loadmodel as port_lm

#: the reference tests' cases: (seed, streams, virtual_s, ramp_s,
#: storms, storm_size, lease_ttl_s, faults armed)
CASES = {
    "gates": (3, 300, 30.0, 5.0, 2, 60, 300.0, False),
    "armed-faults": (7, 200, 20.0, 4.0, 1, 40, 300.0, True),
    "lease-expiries": (11, 150, 40.0, 4.0, 0, 2000, 6.0, False),
}


def _model(mod, faults, case, **kw):
    seed, streams, vs, ramp, storms, size, ttl, armed = CASES[case]
    rules = ([faults.FaultRule("serve.lease", prob=1.0, times=4),
              faults.FaultRule("serve.ring_slot", prob=1.0, times=4)]
             if armed else None)
    return mod.LoadModel(seed=seed, streams=streams, virtual_s=vs,
                         ramp_s=ramp, storms=storms, storm_size=size,
                         lease_ttl_s=ttl, fault_rules=rules,
                         mode="driven", **kw)


@pytest.fixture(scope="module")
def soaks():
    return {case: (_model(jax_lm, jax_faults, case).run(),
                   _model(port_lm, port_faults, case, device="cpu").run())
            for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_driven_soak_result_equals_reference(soaks, case):
    want, got = soaks[case]
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key


def test_driven_soak_holds_its_gates(soaks):
    res = soaks["gates"][1]
    assert res["violations"] == []
    assert res["concurrency_peak"] >= int(0.95 * 300)
    assert res["p99_ratio"] <= 2.0
    assert res["bytes_saved"] > 0 and res["sampled_checks"] > 0
    assert res["submissions"] > 300 and res["packs"] > 10
    assert res["memo"]["hits"] > 0
    assert res["resolved"] + res["sheds"] >= \
        res["submissions"] - res["retries"]
    assert res["explain_coverage"] == 1.0


def test_armed_serve_faults_shed_explicitly(soaks):
    res = soaks["armed-faults"][1]
    assert res["violations"] == [] and res["sheds"] >= 8
    assert res["sampled_checks"] > 0


def test_idle_streams_expire_and_resume(soaks):
    res = soaks["lease-expiries"][1]
    assert res["violations"] == []
    assert res["expiries"] > 0 and res["retries"] > 0
    assert res["grants"] - res["expiries"] - res["releases"] >= 0


@pytest.mark.slow
@pytest.mark.soak
@pytest.mark.serve
def test_thread_mode_under_autojump():
    """The production pack thread under an autojumping clock (the
    reference's ``test_load_model_thread_mode_under_autojump``)."""
    res = port_lm.LoadModel(seed=5, streams=300, virtual_s=30.0,
                            ramp_s=5.0, storms=2, storm_size=60,
                            mode="thread", device="cpu").run()
    assert res["violations"] == []
    assert res["concurrency_peak"] >= int(0.95 * 300)
    assert res["p99_ratio"] <= 2.0 and res["sampled_checks"] > 0


@pytest.mark.parametrize("mix", [0.2, 1.0])
def test_protocol_mix_raises_naming_q5(mix):
    """The driven soak with protocol-frontend chunks blended in at
    ``mix``: the whole result dict equals the reference's, with no
    violation (pool truth, sampled checks and explain coverage hold)."""
    kw = dict(seed=13, streams=120, virtual_s=12.0, ramp_s=3.0, storms=1,
              storm_size=30, mode="driven", protocol_mix=mix)
    want = jax_lm.LoadModel(**kw).run()
    got = port_lm.LoadModel(device="cpu", **kw).run()
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key
    assert got["violations"] == [] and got["explain_coverage"] == 1.0
    (pi, http, proto), (jpi, jhttp, jproto) = (
        mod._build_policy(12, 8, protocol_mix=mix)
        for mod in (port_lm, jax_lm))
    assert (len(http), len(proto)) == (len(jhttp), len(jproto)) and proto
    assert sorted(pi) == sorted(jpi)


def test_explaining_frontend_records_raises_naming_q5():
    """A chunk of protocol-frontend records explains: their codes decode
    on the family lane (the capture carries GENERIC), in both
    packages."""
    from cilium_tpu.engine import attribution as jax_attribution
    from cilium_tpu.engine.verdict import CompiledPolicy as JaxPolicy
    from cilium_tpu.engine.verdict import VerdictEngine
    from cilium_tpu.ingest import binary as jax_binary

    from cilium_tpu_torch.engine import attribution
    from cilium_tpu_torch.engine.compiled import CompiledPolicy
    from cilium_tpu_torch.engine.verdict import TorchVerdictEngine
    from cilium_tpu_torch.ingest import binary

    decoded = []
    for mod, bin_mod, attr, make in (
            (jax_lm, jax_binary, jax_attribution,
             lambda pi: VerdictEngine(JaxPolicy.build(pi))),
            (port_lm, binary, attribution,
             lambda pi: TorchVerdictEngine(CompiledPolicy.build(pi),
                                           device="cpu"))):
        pi, _, proto = mod._build_policy(12, 8, protocol_mix=1.0)
        engine = make(pi)
        flows = proto[:48]
        out = engine.verdict_flows(flows)
        l7m = np.asarray(out["l7_match"])
        assert (l7m >= 0).any()
        amap = attr.AttributionMap.from_policy(engine.policy)
        model = mod.LoadModel(streams=10)
        model._loop = types.SimpleNamespace(
            _amap_for=lambda e, m=amap: m,
            ring=types.SimpleNamespace(
                session=types.SimpleNamespace(engine=engine)))
        memo = importlib.import_module(
            mod.__name__.split(".")[0] + ".engine.memo")
        memo.POLICY_GENERATION.bump(memo.PolicyDelta.none())
        prov = types.SimpleNamespace(
            l7_match=l7m,
            gens=np.full(len(l7m), memo.policy_generation(), np.int64))
        sections = bin_mod.capture_from_bytes(
            bin_mod.capture_to_bytes(flows))
        assert sections[4] is not None
        model._check_explainable(types.SimpleNamespace(prov=prov),
                                 mod._Chunk(sections, [1] * len(flows)),
                                 0, 1)
        decoded.append(l7m.tolist())
    assert decoded[0] == decoded[1]


def test_soak_stages_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_lm.LoadModel(streams=10, n_rules=4, pool_chunks=2).run()


def test_main_prints_one_stamped_line(capsys, monkeypatch):
    for var in ("CILIUM_TPU_DST_SEED", "CILIUM_TPU_DST_DIGEST"):
        monkeypatch.delenv(var, raising=False)      # main sets them
    rc = port_lm.main(["--streams", "60", "--virtual-s", "12",
                       "--mode", "driven", "--storms", "1",
                       "--storm-size", "10", "--faults", "0",
                       "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert len(lines) == 1
    line = lines[0]
    assert line["lane"] == "serve-soak" and line["streams"] == 60
    assert line["unit"].endswith("(virtual)")
    assert line["violations"] == 0 and line["mode"] == "driven"
    assert line["provenance"]["backend"] == "cpu"
    assert rc == (0 if all(line["gates"].values()) else 1)
