"""The port's CUDA kernels on the card (marked ``gpu``; skipped without
one). Run on a machine with an H100, from the repo root:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest forces JAX onto the CPU, and the
machine with the card has no JAX; this file imports none.)

Each kernel is held exactly against its plain version on the same CUDA
tensors (random, all-zero and all-full lengths; the tile edges of the
tensor-core kernels), and the fused step, capture replay (memo route)
and the legacy step on the card against the same paths on the CPU (the
plain versions), at a small size.
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


def _length_cases(rng, b, l):
    """Random lengths, then an all-zero-length and an all-full batch."""
    return [rng.integers(0, l + 1, (b,)).astype(np.int32),
            np.zeros(b, np.int32), np.full(b, l, np.int32)]


#: tile edges of the tensor-core kernels: S or P off and on the 16-row
#: k-step, K + 1 off the 8-column n-tile (K = 255, 256), B below one
#: warp's 16 flows and past a CTA's 64, L = 1, L = 33, and L past the
#: 256-byte staging chunk
K2_EDGES = [(1, 1, 1, 1, 1), (2, 16, 255, 15, 33), (1, 17, 256, 17, 1),
            (3, 128, 256, 65, 33), (1, 128, 255, 8193, 33),
            (2, 16, 1, 8193, 1), (1, 40, 7, 100, 300)]
K1_EDGES = [(1, 1, 1, 1, 1), (2, 16, 256, 15, 33), (1, 17, 1, 17, 33),
            (3, 128, 256, 65, 1), (1, 128, 1, 8193, 33),
            (2, 17, 256, 8193, 1), (1, 40, 7, 100, 300)]


@pytest.mark.parametrize("nb,s,k,b,l", [(1, 2, 1, 7, 4), (3, 17, 5, 50, 12),
                                        (2, 128, 31, 300, 9),
                                        (4, 500, 20, 129, 32), *K2_EDGES])
def test_kd_and_k2_equal_plain(cuda, nb, s, k, b, l):
    rng = np.random.default_rng(s)
    tables = [_t(x, cuda) for x in (
        rng.integers(0, s, (nb, s, k)).astype(np.int32),
        rng.integers(0, k, (nb, 256)).astype(np.int32),
        rng.integers(0, s, (nb,)).astype(np.int32))]
    data = _t(rng.integers(0, 256, (b, l)).astype(np.uint8), cuda)
    acc = _t(rng.integers(-2 ** 31, 2 ** 31 - 1, (nb, s, 2),
                          dtype=np.int64).astype(np.int32), cuda)
    for lens in _length_cases(rng, b, l):
        args = [*tables, data, _t(lens, cuda)]
        got = dfa_dense_cuda.dense_scan_cuda(*args, accept=acc, extra=acc)
        want = dfa_dense_cuda.dense_scan_plain(*args, accept=acc, extra=acc)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        if s <= 128:
            assert torch.equal(
                dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*args),
                dfa_oblivious_cuda.dfa_finals_oblivious_plain(*args))


#: KD's edges: B below one CTA's 512 flows, one past it and 8193; L on
#: and off the 16-byte row loads, 300 and 1024; banks over the
#: shared-memory budget (S = 8192, K = 256: 8 MB) take the global variant
KD_EDGES = [(1, 1, 1, 1, 1), (2, 17, 5, 511, 15), (3, 40, 7, 513, 16),
            (2, 128, 31, 8193, 17), (1, 300, 20, 100, 33),
            (2, 768, 31, 1000, 300), (1, 74, 16, 512, 1024),
            (1, 8192, 256, 8193, 33), (2, 8192, 256, 513, 1024)]


@pytest.mark.parametrize("nb,s,k,b,l", KD_EDGES)
def test_kd_edges_equal_plain(cuda, nb, s, k, b, l):
    """Random, all-zero, all-full, negative and past-L lengths with W in
    (1, 3, 4) and the extra plane on and off; a finals-only call; data
    that is a column slice of a wider blob at an odd offset with strided
    lengths. The plan's variant is the one that launched."""
    rng = np.random.default_rng(s * 7 + l)
    tables = [_t(x, cuda) for x in (
        rng.integers(0, s, (nb, s, k)).astype(np.int32),
        rng.integers(0, k, (nb, 256)).astype(np.int32),
        rng.integers(0, s, (nb,)).astype(np.int32))]
    planes = {w: _t(rng.integers(-2 ** 31, 2 ** 31 - 1, (nb, s, w),
                                 dtype=np.int64).astype(np.int32), cuda)
              for w in (1, 3, 4)}
    data = _t(rng.integers(0, 256, (b, l)).astype(np.uint8), cuda)
    lens = [*_length_cases(rng, b, l), np.full(b, -7, np.int32),
            np.full(b, l + 9, np.int32)]
    _build.reset_launches()
    for i, ln in enumerate(lens):
        args = [*tables, data, _t(ln, cuda)]
        acc = planes[(1, 3, 4)[i % 3]]
        extra = planes[(4, 1, 3)[i % 3]] if i % 2 == 0 else None
        got = dfa_dense_cuda.dense_scan_cuda(*args, accept=acc, extra=extra)
        want = dfa_dense_cuda.dense_scan_plain(*args, accept=acc,
                                               extra=extra)
        if extra is None:
            got, want = (got,), (want,)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    args = [*tables, data, _t(lens[0], cuda)]
    assert torch.equal(dfa_dense_cuda.dense_scan_cuda(*args),
                       dfa_dense_cuda.dense_scan_plain(*args))
    blob = _t(rng.integers(0, 256, (b, l + 9)).astype(np.uint8), cuda)
    cols = _t(np.stack([lens[0]] * 3, axis=1), cuda)
    args = [*tables, blob[:, 3:3 + l], cols[:, 1]]
    got = dfa_dense_cuda.dense_scan_cuda(*args, accept=planes[4],
                                         extra=planes[1])
    want = dfa_dense_cuda.dense_scan_plain(*args, accept=planes[4],
                                           extra=planes[1])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    variant = dfa_dense_cuda.plan_launch(nb, s, k, b, l).variant
    kd = _build.KERNELS["KD"]
    assert kd.launches_by_variant == {variant: kd.launches} \
        and kd.launches == len(lens) + 2


@pytest.mark.parametrize("nb,p,k,b,l", [(1, 1, 1, 7, 4), (2, 33, 4, 129, 1),
                                        (3, 128, 13, 300, 9), *K1_EDGES])
def test_k1_equals_plain(cuda, nb, p, k, b, l):
    rng = np.random.default_rng(p)
    tables = [_t(x, cuda) for x in (
        (rng.random((nb, p, p)) < 0.1).astype(np.float32),
        (rng.random((nb, p, k)) < 0.5).astype(np.float32),
        rng.integers(0, k, (nb, 256)).astype(np.int32),
        (rng.random((nb, p)) < 0.3).astype(np.float32))]
    data = _t(rng.integers(0, 256, (b, l)).astype(np.uint8), cuda)
    for lens in _length_cases(rng, b, l):
        args = [*tables, data, _t(lens, cuda)]
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


def _replay_lanes(engine, sections, cfg):
    from cilium_tpu_torch.engine.replay import CaptureReplay

    rec, l7, offsets, blob = sections
    r = CaptureReplay(engine, l7, offsets, blob, cfg)
    r.stage_rows(rec, l7)
    r.stage_unique()
    outs = [r.verdict_chunk(rec[s:s + 128], l7[s:s + 128], start=s)
            for s in range(0, len(rec), 128)]
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


@pytest.mark.parametrize("dfa_impl,kernel", [("gather", "KD"),
                                             ("pallas", "K2")])
def test_capture_replay_on_card_equals_plain(cuda, dfa_impl, kernel,
                                             monkeypatch, tmp_path):
    from cilium_tpu_torch.ingest import binary

    monkeypatch.setenv("CILIUM_TPU_DFA_IMPL", dfa_impl)
    pi, sc = synth.realize_scenario(synth.scenario_by_name("http", 40, 600))
    cfg = EngineConfig()
    cfg.bank_size = 8
    pol = CompiledPolicy.build(pi, cfg)
    path = str(tmp_path / "c.bin")
    binary.write_capture_l7(path, sc.flows)
    sections = (np.asarray(binary.map_capture(path)),
                *binary.read_l7_sidecar(path))
    _build.reset_launches()
    got = _replay_lanes(TorchVerdictEngine(pol, cfg=cfg), sections, cfg)
    assert _build.KERNELS[kernel].launches > 0
    want = _replay_lanes(TorchVerdictEngine(pol, device="cpu", cfg=cfg),
                         sections, cfg)
    for lane in OUTPUT_LANES:
        np.testing.assert_array_equal(got[lane], want[lane], lane)


def test_legacy_step_on_card_equals_plain(cuda):
    pi, sc = synth.realize_scenario(synth.scenario_by_name("http", 40, 300))
    cfg = EngineConfig()
    cfg.kernel_impl = "legacy"
    pol = CompiledPolicy.build(pi, cfg)
    _build.reset_launches()
    got = TorchVerdictEngine(pol, cfg=cfg).verdict_flows_blob(sc.flows)
    assert _build.KERNELS["KD"].launches > 0
    want = TorchVerdictEngine(pol, device="cpu", cfg=cfg) \
        .verdict_flows(sc.flows)
    for lane in OUTPUT_LANES:
        np.testing.assert_array_equal(got[lane], want[lane], lane)


class _Loader:
    """Just an ``.engine``, as the serve loop reads a loader."""

    def __init__(self, engine):
        self.engine = engine


def _session_run(engine, flows):
    """Uneven chunks through an incremental session → (verdicts, each
    field's match-word table on the host)."""
    from cilium_tpu_torch.engine.session import IncrementalSession
    from cilium_tpu_torch.ingest import binary

    sess = IncrementalSession(engine)
    got = []
    for s in range(0, len(flows), 97):
        rec, l7, offsets, blob, gen = binary.capture_from_bytes(
            binary.capture_to_bytes(flows[s:s + 97]))
        n, dev = sess.verdict_chunk(rec, l7, offsets, blob, gen=gen)
        got.append(dev[:n].cpu().numpy())
    words = {f: t.words.cpu() for f, t in sess.tables.items()
             if t.words is not None}
    return np.concatenate(got), words


def test_session_delta_scans_on_card_equal_plain(cuda):
    """The session's delta scans (KD, written in place into the device
    word tables) and the served verdicts equal the plain path's."""
    pi, sc = synth.realize_scenario(synth.scenario_by_name("http", 40, 600))
    cfg = EngineConfig()
    cfg.bank_size = 8
    pol = CompiledPolicy.build(pi, cfg)
    _build.reset_launches()
    got, words = _session_run(TorchVerdictEngine(pol, cfg=cfg), sc.flows)
    assert _build.KERNELS["KD"].launches > 0
    want, want_words = _session_run(
        TorchVerdictEngine(pol, device="cpu", cfg=cfg), sc.flows)
    np.testing.assert_array_equal(got, want)
    assert sorted(words) == sorted(want_words)
    for f, w in words.items():
        assert torch.equal(w, want_words[f]), f


def test_ring_pack_on_card_equals_direct_step(cuda):
    """One pack of interleaved streams on the card: verdicts equal the
    direct step's, and the provenance lanes equal the plain path's."""
    from cilium_tpu_torch.ingest import binary
    from cilium_tpu_torch.runtime.serveloop import ServeLoop

    pi, sc = synth.realize_scenario(synth.scenario_by_name("http", 40, 600))
    cfg = EngineConfig()
    cfg.bank_size = 8
    pol = CompiledPolicy.build(pi, cfg)
    lanes = []
    for device in ("cuda", "cpu"):
        engine = TorchVerdictEngine(pol, device=device, cfg=cfg)
        loop = ServeLoop(_Loader(engine), capacity=8)
        leases = [loop.connect(f"s{i}") for i in range(8)]
        tickets = [loop.submit(leases[k % 8], *binary.capture_from_bytes(
            binary.capture_to_bytes(sc.flows[s:s + 50])))
            for k, s in enumerate(range(0, len(sc.flows), 50))]
        _build.reset_launches()
        assert loop.step() == len(sc.flows)
        if device == "cuda":
            assert _build.KERNELS["KD"].launches > 0
            np.testing.assert_array_equal(
                np.concatenate([t.verdicts for t in tickets]),
                engine.verdict_flows(sc.flows)["verdict"])
        lanes.append([np.concatenate([getattr(t.prov, k) for t in tickets])
                      for k in ("verdict", "l7_match", "match_spec")])
    for got, want in zip(*lanes):
        np.testing.assert_array_equal(got, want)
