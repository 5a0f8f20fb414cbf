"""The port's CUDA kernels on the card (marked ``gpu``; skipped without
one). Run on a machine with an H100, from the repo root:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest forces JAX onto the CPU, and the
machine with the card has no JAX; this file imports none.)

Each kernel is held exactly against its plain version on the same CUDA
tensors, and the fused step on the card against the same step on the
CPU (the plain versions), at a small size.
"""

import numpy as np
import pytest
import torch

from cilium_tpu_torch.core.config import EngineConfig
from cilium_tpu_torch.engine import (
    _build,
    dfa_dense_cuda,
    dfa_oblivious_cuda,
    nfa_cuda,
)
from cilium_tpu_torch.engine.compiled import CompiledPolicy
from cilium_tpu_torch.engine.verdict import OUTPUT_LANES, TorchVerdictEngine
from cilium_tpu_torch.ingest import synth

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("nb,s,k,b,l", [(1, 2, 1, 7, 4), (3, 17, 5, 50, 12),
                                        (2, 128, 31, 300, 9),
                                        (4, 500, 20, 129, 32)])
def test_kd_and_k2_equal_plain(cuda, nb, s, k, b, l):
    rng = np.random.default_rng(s)
    args = [_t(x, cuda) for x in (
        rng.integers(0, s, (nb, s, k)).astype(np.int32),
        rng.integers(0, k, (nb, 256)).astype(np.int32),
        rng.integers(0, s, (nb,)).astype(np.int32),
        rng.integers(0, 256, (b, l)).astype(np.uint8),
        rng.integers(0, l + 1, (b,)).astype(np.int32))]
    acc = _t(rng.integers(-2 ** 31, 2 ** 31 - 1, (nb, s, 2),
                          dtype=np.int64).astype(np.int32), cuda)
    got = dfa_dense_cuda.dense_scan_cuda(*args, accept=acc, extra=acc)
    want = dfa_dense_cuda.dense_scan_plain(*args, accept=acc, extra=acc)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if s <= 128:
        assert torch.equal(
            dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*args),
            dfa_oblivious_cuda.dfa_finals_oblivious_plain(*args))


@pytest.mark.parametrize("nb,p,k,b,l", [(1, 1, 1, 7, 4), (2, 33, 4, 129, 1),
                                        (3, 128, 13, 300, 9)])
def test_k1_equals_plain(cuda, nb, p, k, b, l):
    rng = np.random.default_rng(p)
    args = [_t(x, cuda) for x in (
        (rng.random((nb, p, p)) < 0.1).astype(np.float32),
        (rng.random((nb, p, k)) < 0.5).astype(np.float32),
        rng.integers(0, k, (nb, 256)).astype(np.int32),
        (rng.random((nb, p)) < 0.3).astype(np.float32),
        rng.integers(0, 256, (b, l)).astype(np.uint8),
        rng.integers(0, l + 1, (b,)).astype(np.int32))]
    assert torch.equal(nfa_cuda.nfa_finals_cuda(*args),
                       nfa_cuda.nfa_finals_plain(*args))


@pytest.mark.parametrize("mode,dfa_impl,kernel", [
    ("auto", "gather", "KD"), ("nfa-bitset", "gather", "K1"),
    ("auto", "pallas", "K2")])
def test_fused_step_on_card_equals_plain(cuda, mode, dfa_impl, kernel,
                                         monkeypatch):
    monkeypatch.setenv("CILIUM_TPU_DFA_IMPL", dfa_impl)
    pi, sc = synth.realize_scenario(synth.scenario_by_name("http", 40, 300))
    cfg = EngineConfig()
    cfg.kernel_impl, cfg.bank_size = mode, 8
    pol = CompiledPolicy.build(pi, cfg)
    _build.reset_launches()
    got = TorchVerdictEngine(pol, cfg=cfg).verdict_flows(sc.flows)
    assert _build.KERNELS[kernel].launches > 0
    want = TorchVerdictEngine(pol, device="cpu", cfg=cfg) \
        .verdict_flows(sc.flows)
    for lane in OUTPUT_LANES:
        np.testing.assert_array_equal(got[lane], want[lane], lane)
