"""The port's CUDA kernels on the card (marked ``gpu``; skipped without
one). Run on a machine with an H100, from the repo root:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest forces JAX onto the CPU, and the
machine with the card has no JAX; this file imports none.)

Each kernel is held exactly against its plain version on the same CUDA
tensors (random, all-zero and all-full lengths; the tile edges of the
tensor-core kernels), and the fused step, capture replay (memo route)
and the legacy step on the card against the same paths on the CPU (the
plain versions), at a small size. The protocol frontends' ``l7g``
stacks: KD, and K2 and K1 wherever they take the stack, at each lane
policy's l7g automaton, and the memcache policy (whose l7g stack both
take) through the fused step and v3 capture replay on each arm.
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
from cilium_tpu_torch.engine.compiled import CompiledPolicy, encode_strings
from cilium_tpu_torch.engine.verdict import OUTPUT_LANES, TorchVerdictEngine
from cilium_tpu_torch.ingest import synth
from cilium_tpu_torch.weights import arrays_from_reference

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


def test_loader_regenerate_on_card_equals_plain(cuda, tmp_path, monkeypatch):
    """``Loader()`` stages its engine on the card by default; all ten
    lanes equal the plain engine of the same compiled policy."""
    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.runtime.loader import Loader

    monkeypatch.setenv("CILIUM_TPU_DFA_IMPL", "gather")
    pi, sc = synth.realize_scenario(synth.scenario_by_name("http", 60, 400))
    cfg = Config()
    cfg.loader.cache_dir = str(tmp_path)
    loader = Loader(cfg)
    try:
        _build.reset_launches()
        engine = loader.regenerate(pi, revision=1)
        assert engine.device.type == "cuda"
        got = engine.verdict_flows(sc.flows)
        assert _build.KERNELS["KD"].launches > 0
        want = TorchVerdictEngine(engine.policy, device="cpu",
                                  cfg=cfg.engine).verdict_flows(sc.flows)
        for lane in OUTPUT_LANES:
            np.testing.assert_array_equal(got[lane], want[lane], lane)
    finally:
        loader.close()


def test_kd_at_the_loader_path_stack_equals_plain(cuda):
    """KD at the content-addressed path stack of the http-1000 policy,
    (7, 2048, 28) with W = 7 accept words and the group plane: the
    shared-memory variant with the accept planes read from global
    memory."""
    from cilium_tpu_torch.engine import megakernel
    from cilium_tpu_torch.policy.compiler.bankplan import BankRegistry

    pi, sc = synth.realize_scenario(synth.scenario_by_name("http", 1000,
                                                           4096))
    pol = CompiledPolicy.build(pi, EngineConfig(),
                               bank_registry=BankRegistry())
    a = pol.arrays
    assert a["path_trans"].shape == (7, 2048, 28)
    assert a["path_accept"].shape[2] == 7
    staged = arrays_from_reference(
        {k: a[k] for k in ("path_trans", "path_byteclass", "path_start",
                           "path_accept", "rp_path_gaccept")}, cuda)
    tables = [staged[f"path_{k}"] for k in ("trans", "byteclass", "start")]
    acc, extra = staged["path_accept"], staged["rp_path_gaccept"]
    data, lens, _ = encode_strings(
        [f.http.path.encode() for f in sc.flows], 256)
    plan = dfa_dense_cuda.plan_launch(7, 2048, 28, *data.shape, 7,
                                      extra.shape[2])
    assert plan.variant == "smem" and not plan.words_smem
    _build.reset_launches()
    for ln in (lens, *_length_cases(np.random.default_rng(7), *data.shape)):
        args = [*tables, _t(data, cuda), _t(ln, cuda)]
        got = dfa_dense_cuda.dense_scan_cuda(*args, accept=acc, extra=extra)
        want = dfa_dense_cuda.dense_scan_plain(*args, accept=acc,
                                               extra=extra)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert _build.KERNELS["KD"].launches_by_variant == {"smem": 4}
    assert megakernel.plan_for_engine(pol, EngineConfig(), cuda)[0][
        "path"] == "dfa-dense"


def test_kd_at_the_fleet_path_stack_equals_plain_in_both_variants(
        cuda, tmp_path):
    """KD at the churn storm's stacks at 10k identities x 5k CNPs, built
    by the port's ``Loader`` on the card: path (30, 2816, 18) with 16
    accept words and 7 group words (the table fits in shared memory, the
    planes do not) and dns (2, 1536, 19), over the storm's corpus. The
    path field is held under both variants, each counted as launched."""
    from cilium_tpu_torch.engine.compiled import (
        encode_flows,
        flowbatch_to_host_dict,
    )
    from cilium_tpu_torch.engine.megakernel import SCAN_FIELDS
    from cilium_tpu_torch.engine.verdict import (
        batch_field,
        batch_to_device,
        unpack_batch,
    )
    from cilium_tpu_torch.runtime import fleet

    world = fleet.FleetWorld(10000, 5000, str(tmp_path), workers=4,
                             device=cuda)
    try:
        world.loader.regenerate(world.per_identity(), revision=1)
        engine = world.loader.engine
        arr = engine._arrays
        assert tuple(arr["path_trans"].shape) == (30, 2816, 18)
        assert tuple(arr["path_accept"].shape) == (30, 2816, 16)
        assert tuple(arr["rp_path_gaccept"].shape) == (30, 2816, 7)
        assert tuple(arr["dns_trans"].shape) == (2, 1536, 19)
        flows, _ = world.corpus()
        fb = encode_flows(flows, engine.policy.kafka_interns, engine.cfg)
        batch = unpack_batch(batch_to_device(flowbatch_to_host_dict(fb),
                                             cuda))
        for prefix, field in SCAN_FIELDS:
            data, lens, _ = batch_field(batch, field)
            a = (arr[f"{prefix}_trans"], arr[f"{prefix}_byteclass"],
                 arr[f"{prefix}_start"], data.contiguous(),
                 lens.contiguous())
            acc = arr[f"{prefix}_accept"]
            extra = arr.get("rp_path_gaccept") if prefix == "path" \
                else None
            want = dfa_dense_cuda.dense_scan_plain(*a, accept=acc,
                                                   extra=extra)
            if extra is None:
                want = (want,)
            variants = (("smem", "global") if prefix == "path"
                        else (None,))
            for variant in variants:
                _build.reset_launches()
                got = dfa_dense_cuda.dense_scan_cuda(
                    *a, accept=acc, extra=extra, _variant=variant)
                if extra is None:
                    got = (got,)
                assert all(torch.equal(g, w) for g, w in zip(got, want))
                if variant is not None:
                    assert _build.KERNELS["KD"].launches_by_variant == \
                        {variant: 1}
    finally:
        world.loader.close()


def test_service_and_stream_on_card_equal_plain(cuda, tmp_path,
                                                monkeypatch):
    """The port's ``VerdictService`` over a loader on the card: ``check``
    requests and a stream, every verdict equal to the plain engine of
    the same compiled policy, KD launched, the breaker untouched."""
    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.ingest.hubble import flow_to_dict
    from cilium_tpu_torch.runtime.loader import Loader
    from cilium_tpu_torch.runtime.metrics import METRICS
    from cilium_tpu_torch.runtime.service import (
        VerdictClient,
        VerdictService,
    )
    from cilium_tpu_torch.runtime.stream import StreamClient

    monkeypatch.setenv("CILIUM_TPU_DFA_IMPL", "gather")
    pi, sc = synth.realize_scenario(synth.scenario_by_name("http", 60, 512))
    cfg = Config()
    cfg.loader.cache_dir = str(tmp_path / "cache")
    loader = Loader(cfg)
    trips = "cilium_tpu_breaker_trips_total"
    fallback = "cilium_tpu_breaker_fallback_verdicts_total"
    before = (METRICS.get(trips), METRICS.get(fallback))
    try:
        engine = loader.regenerate(pi, revision=1)
        want = [int(v) for v in TorchVerdictEngine(
            engine.policy, device="cpu", cfg=cfg.engine).verdict_flows(
                sc.flows)["verdict"]]
        svc = VerdictService(loader, str(tmp_path / "v.sock"),
                             deadline_ms=1.0)
        svc.start()
        try:
            _build.reset_launches()
            c = VerdictClient(svc.socket_path)
            got = [c.call({"op": "check", "flow": flow_to_dict(f)})[
                "verdict"] for f in sc.flows[:32]]
            c.close()
            assert got == want[:32]
            assert _build.KERNELS["KD"].launches > 0
            _build.reset_launches()
            s = StreamClient(svc.socket_path)
            seqs = [s.send_flows(sc.flows[i:i + 128])
                    for i in range(0, 512, 128)]
            got = [int(v) for q in seqs for v in s.result(q)]
            s.finish()
            s.close()
            assert got == want
            assert _build.KERNELS["KD"].launches > 0
        finally:
            svc.stop()
    finally:
        loader.close()
    assert (METRICS.get(trips), METRICS.get(fallback)) == before


def test_stream_readback_equals_a_blocking_copy(cuda):
    """The stream's pinned, non-blocking readback returns the bytes a
    blocking copy does, for a lane written just before it is issued."""
    from cilium_tpu_torch.runtime.stream import Readback, _host_verdicts

    rng = np.random.default_rng(3)
    for n, pad in ((1, 32), (1000, 1024), (4096, 4096)):
        lane = _t(rng.integers(0, 6, pad).astype(np.int32), cuda)
        lane = lane * 1  # a kernel still in flight when the copy issues
        rb = Readback(lane, n)
        assert rb.host.is_pinned()
        got = _host_verdicts(rb, n)
        want = lane[:n].cpu().numpy().astype(np.uint8)
        assert got.dtype == np.uint8 and np.array_equal(got, want)


# ------------------------------------------------- protocol frontends (l7g)
def _frontend_policy(name, n_rules=40, n_flows=2048):
    """A frontend lane's policy through the content-addressed banks, as
    the loader builds it, and its flows."""
    from cilium_tpu_torch.policy.compiler.bankplan import BankRegistry

    sc = (synth.scenario_by_name(name, n_rules, n_flows)
          if name == "protocols" else synth.synth_protocols_scenario(
              n_rules=n_rules, n_flows=n_flows, mix=((name, 1.0),)))
    pi, sc = synth.realize_scenario(sc)
    return CompiledPolicy.build(pi, EngineConfig(),
                                bank_registry=BankRegistry()), sc


@pytest.mark.parametrize("name", ["cassandra", "memcache", "r2d2",
                                  "protocols"])
def test_kernels_at_the_l7g_stack_equal_plain(cuda, name):
    """KD, and K2 and K1 wherever they take the stack, at a frontend
    policy's ``l7g`` stack and its records' scan values (random, zero
    and full lengths too)."""
    from cilium_tpu_torch.engine import megakernel
    from cilium_tpu_torch.policy.compiler import frontends

    pol, sc = _frontend_policy(name)
    a = pol.arrays
    staged = arrays_from_reference(
        {k: a[f"l7g_{k}"] for k in ("trans", "byteclass", "start",
                                    "accept")}, cuda)
    data, lens, _ = encode_strings(
        [frontends.scan_value(f.generic.proto, f.generic.fields)
         for f in sc.flows], 256)
    cfg = EngineConfig()
    cfg.kernel_impl = "nfa-bitset"
    _, extra, _ = megakernel.plan_for_engine(pol, cfg, cuda)
    nfa = arrays_from_reference(
        {k: v for k, v in extra.items() if k.startswith("l7g_nfa_")}, cuda)
    _build.reset_launches()
    rng = np.random.default_rng(11)
    for ln in (lens, *_length_cases(rng, *data.shape)):
        args = [staged["trans"], staged["byteclass"], staged["start"],
                _t(data, cuda), _t(ln, cuda)]
        assert torch.equal(
            dfa_dense_cuda.dense_scan_cuda(*args, accept=staged["accept"]),
            dfa_dense_cuda.dense_scan_plain(*args, accept=staged["accept"]))
        if a["l7g_trans"].shape[1] <= 128:
            assert torch.equal(
                dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*args),
                dfa_oblivious_cuda.dfa_finals_oblivious_plain(*args))
        if nfa:
            n = [nfa[f"l7g_nfa_{k}"] for k in ("follow", "acc_cls",
                                                "byteclass", "start")]
            assert torch.equal(nfa_cuda.nfa_finals_cuda(*n, *args[3:]),
                               nfa_cuda.nfa_finals_plain(*n, *args[3:]))
    assert _build.KERNELS["KD"].launches == 4
    assert _build.KERNELS["K2"].launches == (
        4 if a["l7g_trans"].shape[1] <= 128 else 0)
    assert _build.KERNELS["K1"].launches == (4 if nfa else 0)


@pytest.mark.parametrize("mode,dfa_impl,kernel", [
    ("auto", "gather", "KD"), ("nfa-bitset", "gather", "K1"),
    ("auto", "pallas", "K2")])
def test_frontend_fused_step_and_replay_on_card_equal_plain(
        cuda, mode, dfa_impl, kernel, monkeypatch):
    """The memcache policy (its ``l7g`` stack fits K1 and K2) through the
    fused step and v3 capture replay on the card, all ten lanes equal to
    the plain path."""
    from cilium_tpu_torch.ingest import columnar

    monkeypatch.setenv("CILIUM_TPU_DFA_IMPL", dfa_impl)
    pol, sc = _frontend_policy("memcache", 40, 1500)
    cfg = EngineConfig()
    cfg.kernel_impl = mode
    engine = TorchVerdictEngine(pol, cfg=cfg)
    assert engine.impl_plan["l7g"] == (
        "nfa-bitset" if mode == "nfa-bitset" else "dfa-dense")
    plain = TorchVerdictEngine(pol, device="cpu", cfg=cfg)
    _build.reset_launches()
    got = engine.verdict_flows(sc.flows)
    assert _build.KERNELS[kernel].launches > 0
    want = plain.verdict_flows(sc.flows)
    for lane in OUTPUT_LANES:
        np.testing.assert_array_equal(got[lane], want[lane], lane)
    cols = columnar.flows_to_columns(sc.flows)
    sections = (cols.rec, cols.l7, cols.offsets, cols.blob)
    assert cols.gen is not None
    from cilium_tpu_torch.engine.replay import CaptureReplay

    outs = []
    for e in (engine, plain):
        r = CaptureReplay(e, *sections[1:], cfg, gen=cols.gen)
        r.stage_rows(cols.rec, cols.l7)
        r.stage_unique()
        outs.append(r.verdict_chunk(cols.rec, cols.l7, start=0))
    for lane in OUTPUT_LANES:
        np.testing.assert_array_equal(outs[0][lane], outs[1][lane], lane)
        np.testing.assert_array_equal(outs[0][lane], want[lane], lane)
