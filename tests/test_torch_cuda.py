"""The port's CUDA kernels on the card (marked ``gpu``; skipped without
one). Run on a machine with an H100, from the repo root:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest forces JAX onto the CPU, and the
machine with the card has no JAX; this file imports none.)

Each kernel is held exactly against its plain version on the same CUDA
tensors (random, all-zero and all-full lengths; the tile edges of the
tensor-core kernels; KR, the group-space resolve, at random plans of 1
to 2047 groups a family over 1 to 262144 rows, and at the benchmark's
http-1k plan on one 262144-record replay chunk), and the fused step, capture replay (memo route)
and the legacy step on the card against the same paths on the CPU (the
plain versions), at a small size. The protocol frontends' ``l7g``
stacks: KD, and K2 and K1 wherever they take the stack, at each lane
policy's l7g automaton, and the memcache policy (whose l7g stack both
take) through the fused step and v3 capture replay on each arm. The
sequence-parallel payload scan (plain torch on the card) against KD and
K2, and ``lb_lookup`` on the card against its ``device="cpu"`` run. The
parallel layer in a one-rank NCCL world in the test's process: the DP,
EP and CP verdict lanes against the fused step on the card (EP launches
KD), the Ulysses, TP and CP scans against KD, ``payload_scan_cp``
against ``payload_scan_sp``, with their collective budgets. A DST
schedule with a ``multichip`` and a ``serve`` event gives the same trace
on the card as on the CPU, and the committed regression case reproduces
on the card. The bench plane: KD, K2 and K1 at ``tools/bench_kernel``'s
sweep banks, and ``tools/bench.py --config http --check`` at a small
size on the card with 0 mismatches. The observability plane: one 8192-flow
chunk of a flowpb capture through the replay cursor and the fan-out
sequence on the card, its annotated flows, events and exported lines
equal to the plain path's. The agent plane on the card, alone and as
two agents on the cluster control services (a served kvstore and
apiserver, the operator, ``crd`` identities, a CNP through the
apiserver), each node's lanes equal to the plain engine's. The daemon
as a process on the card (``python -m cilium_tpu_torch.daemon`` from a
TOML, no ``--device``): endpoints and a CNP through the CLI, and
``capture stream`` through its socket equal, record for record, to a
plain engine of the same policy.
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
    resolve_cuda,
)
from cilium_tpu_torch.engine.compiled import CompiledPolicy, encode_strings
from cilium_tpu_torch.engine.verdict import OUTPUT_LANES, TorchVerdictEngine
from cilium_tpu_torch.ingest import synth
from cilium_tpu_torch.weights import arrays_from_reference
from resolve_cases import GROUPS, ROWS, random_case, torch_args

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


@pytest.mark.parametrize("B", ROWS)
@pytest.mark.parametrize("G", GROUPS)
def test_kr_equals_plain_on_random_plans(cuda, G, B):
    """KR against its plain version, every output bit, with the generic
    block and the frontend groups and without them; each case launches
    once."""
    for gen in (True, False):
        args = torch_args(*random_case(G + B, G, B, gen=gen), cuda)
        _build.reset_launches()
        got = resolve_cuda.resolve_groups_cuda(*args)
        torch.cuda.synchronize()
        assert resolve_cuda.KERNEL.launches == 1
        want = resolve_cuda.resolve_groups_plain(*args)
        for lane, g, w in zip(("l7_ok", "l7_log_http", "l7_match"), got,
                              want):
            assert g.dtype == w.dtype and torch.equal(g, w), (lane, gen)


def test_kr_at_the_http_1k_plan_equals_plain(cuda, tmp_path, monkeypatch):
    """KR at the benchmark's http-1k deployment: its staged plan, and one
    chunk of 262144 distinct records of its replay traffic through
    ``CaptureReplay.verdict_chunk``, which launches KR once; that
    launch's inputs held against the plain version."""
    from benchmark import capture, deployment, registry, traffic
    from benchmark.system import System

    bench = registry.load_benchmark()
    dep = deployment.load(registry.config_path(bench, "http-1k"))
    tr = dict(traffic.load_traffic(registry.traffic_path("replay-unique")),
              records=262144, chunk=262144)
    cap = str(tmp_path / "capture.bin")
    capture.write(cap, traffic.generate(dep, tr, 3100000123))
    system = System(dep, str(tmp_path / "cache"), "cuda")
    try:
        system.stage(cap)
        noted = []
        real = resolve_cuda.resolve_groups_cuda

        def noting(*a, **k):
            noted.append((a, k))
            return real(*a, **k)

        monkeypatch.setattr(resolve_cuda, "resolve_groups_cuda", noting)
        _build.reset_launches()
        system.verdict_chunk(0, 262144)
        assert len(noted) == 1 and resolve_cuda.KERNEL.launches == 1
        a, k = noted[0]
        assert a[1].shape == (262144,)
        got, want = real(*a, **k), resolve_cuda.resolve_groups_plain(*a, **k)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert got[0].any() and not got[0].all()
    finally:
        system.close()


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


# ------------------------------------------ the fqdn config and the proxy
def _fqdn_dns_batch(dev, n=8192):
    """The fqdn scenario's rules (10 × 100 names) and its qnames as the
    DNS proxy scans them: ``[n, 256]``, sanitized."""
    from cilium_tpu_torch.fqdn.dnsproxy import QNAME_LEN
    from cilium_tpu_torch.policy.compiler import matchpattern

    sc = synth.scenario_by_name("fqdn", 10, n)
    rules = [d for r in sc.rules for er in r.egress for pr in er.to_ports
             for d in pr.rules.dns]
    names = [matchpattern.sanitize_name(f.dns.query) for f in sc.flows]
    data = np.zeros((n, QNAME_LEN), np.uint8)
    lens = np.zeros(n, np.int32)
    for i, q in enumerate(names):
        b = q.encode()[:QNAME_LEN]
        data[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return sc, rules, _t(data, dev), _t(lens, dev)


@pytest.mark.parametrize("bank_size", [64, 4])
def test_kd_and_k2_at_the_fqdn_dns_stack_equal_plain(cuda, bank_size):
    """KD at the fqdn rules' dns stack, L = 256 (one bank of 138 states
    at the proxy's bank size, 64), and K2 where the banks fit its 128
    states (bank size 4)."""
    from cilium_tpu_torch.fqdn.dnsproxy import DNSProxy
    from cilium_tpu_torch.policy.compiler.dfa import compile_patterns

    _, rules, data, lens = _fqdn_dns_batch(cuda)
    proxy = DNSProxy(use_tpu=False)
    proxy.update_allowed(1, 53, rules)
    st = compile_patterns(proxy._rules[(1, 53)],
                          bank_size=bank_size).stacked()
    trans, bc, start, acc = (_t(st[k].view(np.int32) if st[k].dtype ==
                                np.uint32 else st[k], cuda)
                             for k in ("trans", "byteclass", "start",
                                       "accept"))
    args = (trans, bc, start, data, lens)
    _build.reset_launches()
    assert torch.equal(dfa_dense_cuda.dense_scan_cuda(*args, accept=acc),
                       dfa_dense_cuda.dense_scan_plain(*args, accept=acc))
    assert _build.KERNELS["KD"].launches == 1
    if trans.shape[1] <= 128:
        assert torch.equal(
            dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*args),
            dfa_oblivious_cuda.dfa_finals_oblivious_plain(*args))
        assert _build.KERNELS["K2"].launches == 1
    assert (trans.shape[1] <= 128) == (bank_size == 4)


def test_autotune_field_on_card_records_a_pick(cuda, monkeypatch):
    from cilium_tpu_torch.engine import megakernel, nfa_kernel
    from cilium_tpu_torch.policy.compiler.dfa import compile_patterns

    monkeypatch.setattr(megakernel, "_AUTOTUNE_CACHE", {})
    banked = compile_patterns([f"/t{i}/x.*" for i in range(12)],
                              bank_size=4)
    arrays = {f"p_{k}": v for k, v in banked.stacked().items()}
    stacked = nfa_kernel.stack_nfa_banks(
        nfa_kernel.banks_from_dfa(banked, EngineConfig()))
    _build.reset_launches()
    pick = megakernel.autotune_field("path", arrays, "p", stacked,
                                     width=256, device=cuda)
    assert pick["impl"] in ("dfa-dense", "nfa-bitset")
    assert pick["dense_ms"] > 0 and pick["nfa_ms"] > 0
    assert _build.KERNELS["KD"].launches >= 4
    assert _build.KERNELS["K1"].launches >= 4
    assert ("path", arrays["p_trans"].shape, stacked["nfa_follow"].shape,
            256, "cuda") in megakernel._AUTOTUNE_CACHE


@pytest.mark.parametrize("dfa_impl,kernel", [("gather", "KD"),
                                             ("pallas", "K2")])
def test_dns_proxy_on_card_equals_check_allowed(cuda, dfa_impl, kernel,
                                                monkeypatch):
    """``DNSProxy(use_tpu=True)`` on the card over the fqdn scenario's
    qnames: each verdict equal to ``check_allowed``'s, the arm's kernel
    launched (the corpus's crawler rules fit K2; the fqdn rules' 138
    states do not), no fallback counted."""
    from cilium_tpu_torch.fqdn.dnsproxy import DNSProxy
    from cilium_tpu_torch.policy.api.l7 import PortRuleDNS
    from cilium_tpu_torch.runtime.metrics import DNSPROXY_FALLBACKS, METRICS

    monkeypatch.setenv("CILIUM_TPU_DFA_IMPL", dfa_impl)
    sc, rules, _, _ = _fqdn_dns_batch(cuda, 2000)
    if kernel == "K2":
        rules = [PortRuleDNS(match_pattern="*.cilium.io"),
                 PortRuleDNS(match_name="example.com")]
    qnames = [f.dns.query for f in sc.flows] + ["SVC0.CILIUM.IO.",
                                                "x" * 300, ""]
    proxy = DNSProxy(use_tpu=True)
    assert proxy.device.type == "cuda"
    proxy.update_allowed(7, 53, rules)
    n0 = METRICS.get(DNSPROXY_FALLBACKS)
    _build.reset_launches()
    got = np.concatenate([proxy.check_batch(7, 53, qnames[i:i + 512])
                          for i in range(0, len(qnames), 512)])
    want = [proxy.check_allowed(7, 53, q) for q in qnames]
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)
    assert _build.KERNELS[kernel].launches > 0
    assert METRICS.get(DNSPROXY_FALLBACKS) == n0


def test_dns_proxy_on_card_raises_an_oom_without_a_fallback(cuda,
                                                            monkeypatch):
    """An out of memory in the card's scan is raised by ``check_batch``;
    the host does not answer for it and no fallback is counted."""
    from cilium_tpu_torch.engine import dfa_kernel
    from cilium_tpu_torch.fqdn.dnsproxy import DNSProxy
    from cilium_tpu_torch.policy.api.l7 import PortRuleDNS
    from cilium_tpu_torch.runtime.metrics import DNSPROXY_FALLBACKS, METRICS

    proxy = DNSProxy()
    assert proxy.use_tpu and proxy.device.type == "cuda"
    proxy.update_allowed(7, 53, [PortRuleDNS(match_pattern="*.io")])
    np.testing.assert_array_equal(proxy.check_batch(7, 53, ["a.io", "b"]),
                                  [True, False])

    def oom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(dfa_kernel, "dfa_scan_banked", oom)
    n0 = METRICS.get(DNSPROXY_FALLBACKS)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        proxy.check_batch(7, 53, ["a.io"])
    assert METRICS.get(DNSPROXY_FALLBACKS) == n0


@pytest.mark.parametrize("s,l,b", [(16, 1024, 700), (300, 512, 300),
                                   (1, 256, 5)])
def test_payload_scan_sp_on_card_equals_kd(cuda, s, l, b):
    """The sequence-parallel scan (plain torch on the card) against KD
    (and K2 where S <= 128) on the same CUDA tensors; the lengths cover
    zero, negative and full rows (past-L rows differ by design: SP
    scans its padded tail)."""
    from cilium_tpu_torch.engine.dfa_kernel import dfa_finals_banked
    from cilium_tpu_torch.engine.longscan import payload_scan_sp

    rng = np.random.default_rng(s + l)
    k = 32
    trans = _t(rng.integers(0, s, (s, k)).astype(np.int32), cuda)
    bc = _t(rng.integers(0, k, 256).astype(np.int32), cuda)
    data = _t(rng.integers(0, 256, (b, l)).astype(np.uint8), cuda)
    lens = rng.integers(-2, l + 1, b).astype(np.int32)
    lens[:3] = (0, -1, l)
    lens = _t(lens, cuda)
    start = int(rng.integers(0, s))
    sp = payload_scan_sp(trans, bc, start, data, lens, block=256)
    st = torch.full((1,), start, dtype=torch.int32, device=cuda)
    _build.reset_launches()
    kd = dfa_finals_banked(trans[None], bc[None], st, data, lens,
                           impl="gather")[0]
    assert _build.KERNELS["KD"].launches == 1
    assert sp.device.type == "cuda" and torch.equal(sp, kd)
    if s <= 128:
        k2 = dfa_finals_banked(trans[None], bc[None], st, data, lens,
                               impl="oblivious")[0]
        assert _build.KERNELS["K2"].launches == 1
        assert torch.equal(sp, k2)


def test_lb_lookup_on_card_equals_cpu(cuda):
    """``lb_lookup`` on the card against its ``device="cpu"`` run: VIPs
    above 2**31, ClientIP affinity, unmatched flows, the empty pack."""
    import ipaddress

    from cilium_tpu_torch.loadbalancer import (
        Backend,
        Frontend,
        Service,
        ServiceManager,
        lb_lookup,
    )
    from cilium_tpu_torch.weights import lb_arrays_from_reference

    rng = np.random.default_rng(11)
    mgr = ServiceManager(table_size=1021)
    fes = []
    for i in range(40):
        vip = (f"203.0.113.{i}" if i % 2 else f"10.96.{i}.1")
        fes.append(Frontend(vip, 80 + i % 3, 6 if i % 5 else 17))
        mgr.upsert(Service(fes[-1], [Backend(f"10.{i}.0.{j}", 8080 + j)
                                     for j in range(1 + i % 7)],
                           affinity=i % 4 == 0))
    n = 5000
    pick = rng.integers(0, len(fes), n)
    live = rng.random(n) < 0.8
    cols = [rng.integers(0, 2 ** 32, n, dtype=np.int64),
            rng.integers(1024, 65536, n).astype(np.int32),
            np.where(live, [int(ipaddress.IPv4Address(fes[p].ip))
                            for p in pick],
                rng.integers(0, 2 ** 32, n, dtype=np.int64)),
            np.where(live, [fes[p].port for p in pick],
                     rng.integers(1, 65536, n)).astype(np.int32),
            np.where(live, [fes[p].proto for p in pick], 6).astype(np.int32)]
    for packed in (mgr.pack(), ServiceManager(table_size=1021).pack()):
        outs = [lb_lookup(*lb_arrays_from_reference(packed, dev),
                          *(_t(c, dev) for c in cols))
                for dev in (cuda, "cpu")]
        for key in ("backend", "ip", "port"):
            assert torch.equal(outs[0][key].cpu(), outs[1][key]), key
        hits = int((outs[1]["backend"] >= 0).sum())
        assert (hits > 0.5 * n) if packed.n_services > 1 else hits == 0


@pytest.fixture
def nccl_rank(cuda, tmp_path):
    """A one-rank NCCL world in this process (the card's only
    communicator; ranks that share it run on gloo)."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    yield cuda
    dist.destroy_process_group()


def _http_policy_and_batch(n_rules=40, n_flows=256):
    from cilium_tpu_torch.engine.compiled import (
        encode_flows,
        flowbatch_to_host_dict,
    )

    pi, sc = synth.realize_scenario(
        synth.scenario_by_name("http", n_rules, n_flows))
    cfg = EngineConfig()
    cfg.bank_size = 8
    pol = CompiledPolicy.build(pi, cfg)
    host = flowbatch_to_host_dict(
        encode_flows(sc.flows, pol.kafka_interns, cfg))
    return pol, cfg, host


@pytest.mark.parametrize("lane", ["dp", "ep", "cp"])
def test_parallel_lanes_on_one_nccl_rank_equal_the_fused_step(nccl_rank,
                                                              lane):
    """``stage_for_lane`` on a one-rank NCCL world on the card: all ten
    lanes equal the single-device fused step; EP runs KD and records
    one all-to-all, CP one carry exchange a sharded field, DP none."""
    from cilium_tpu_torch.engine.verdict import batch_to_device
    from cilium_tpu_torch.tools.parallel_lanes import run_lane

    pol, cfg, host = _http_policy_and_batch()
    engine = TorchVerdictEngine(pol, cfg=cfg)
    want = {k: v.cpu().numpy() for k, v in engine.verdict_batch_arrays(
        batch_to_device(host, nccl_rank)).items()}
    res = run_lane(lane, {"arrays": pol.arrays, "batch": host},
                   device="cuda", cp_block=8)
    for name in OUTPUT_LANES:
        np.testing.assert_array_equal(res["out"][name], want[name], name)
    sites = [(r["site"], r["op"], r["count_per_block"])
             for r in res["ledger"]]
    if lane == "dp":
        assert sites == []
    elif lane == "ep":
        assert sites == [("ulysses.switch", "all_to_all", 1)]
        assert res["kd_launches"] >= 5
    else:
        assert sites and all(s.startswith("cp.carry.") and c == 1
                             for s, _, c in sites)


@pytest.mark.parametrize("lane", ["ulysses", "tp_banked", "cp_scan"])
def test_parallel_scans_on_one_nccl_rank_equal_kd(nccl_rank, lane):
    """The raw sharded scans on a one-rank NCCL world against KD on the
    same path stack; TP's ledger: L psums and four accept planes."""
    from cilium_tpu_torch.tools.parallel_lanes import run_lane

    pol, _, host = _http_policy_and_batch()
    a = pol.arrays
    g = {"trans": a["path_trans"], "byteclass": a["path_byteclass"],
         "start": a["path_start"], "accept": a["path_accept"],
         "data": host["path_data"],
         "lengths": np.ascontiguousarray(
             np.minimum(host["path_data"].shape[1],
                        np.arange(len(host["path_data"])) % 40))
         .astype(np.int32)}
    t = {k: _t(v.view(np.int32) if v.dtype == np.uint32 else v, nccl_rank)
         for k, v in g.items()}
    want = dfa_dense_cuda.dense_scan_cuda(
        t["trans"], t["byteclass"], t["start"], t["data"], t["lengths"],
        accept=t["accept"]).cpu().numpy()
    res = run_lane(lane, g, device="cuda", cp_block=8)
    np.testing.assert_array_equal(res["out"], want)
    if lane == "tp_banked":
        counts = {r["site"]: r["count_per_block"] for r in res["ledger"]}
        assert counts == {"tp.scan_step": g["data"].shape[1],
                          "tp.accept_plane": 4}


def test_payload_scan_cp_on_one_nccl_rank_equals_sp(nccl_rank):
    from cilium_tpu_torch.engine.longscan import payload_scan_sp
    from cilium_tpu_torch.tools.parallel_lanes import run_lane

    rng = np.random.default_rng(5)
    s, k, b, l = 64, 16, 300, 1024
    g = {"trans": rng.integers(0, s, (s, k)).astype(np.int32),
         "byteclass": rng.integers(0, k, 256).astype(np.int32),
         "start": 3, "data": rng.integers(0, 256, (b, l)).astype(np.uint8),
         "lengths": rng.integers(0, l + 1, b).astype(np.int32)}
    want = payload_scan_sp(*(_t(g[x], nccl_rank) for x in
                             ("trans", "byteclass")), 3,
                           _t(g["data"], nccl_rank),
                           _t(g["lengths"], nccl_rank), block=256)
    res = run_lane("payload_cp", g, device="cuda", cp_block=256)
    np.testing.assert_array_equal(res["out"], want.cpu().numpy())


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_run_pipelined_on_the_card_equals_the_sequential_loop(cuda, depth):
    """The CUDA branch of ``run_pipelined``: the copies go out of the
    pinned ring on a side stream, each batch's step runs on the current
    stream after its copy's event, and every batch arrives intact even
    when a slow step keeps the ring's slots busy (a slot refilled before
    its copy finished would hand a later batch's bytes to an earlier
    step)."""
    from cilium_tpu_torch.engine.verdict import batch_to_device
    from cilium_tpu_torch.parallel.pipeline import collect, run_pipelined

    pol, cfg, host = _http_policy_and_batch()
    engine = TorchVerdictEngine(pol, cfg=cfg)
    step, arrays = engine._step, engine._arrays
    rng = np.random.default_rng(3)
    batches = [host] + [{k: v[p] for k, v in host.items()} for p in
                        (rng.permutation(len(host["scalars"]))
                         for _ in range(6))]
    compute = torch.cuda.current_stream()
    seen = []

    def slow_step(a, b):
        seen.append((torch.cuda.current_stream() == compute,
                     {v.device.type for v in b.values()}))
        torch.cuda._sleep(5_000_000)   # ~ms on the card: copies queue up
        return step(a, b)

    got = collect(run_pipelined(slow_step, arrays, batches, depth=depth))
    want = collect([step(arrays, batch_to_device(b, cuda)) for b in batches])
    assert seen == [(True, {"cuda"})] * len(batches)
    for g, w in zip(got, want):
        for name in OUTPUT_LANES:
            np.testing.assert_array_equal(g[name], w[name], name)


def test_dst_schedule_with_multichip_and_serve_on_card_equals_cpu(cuda):
    """A DST schedule with a ``multichip`` and a ``serve`` event (and a
    dispatch fault, traffic and a churn) gives the same trace on the
    card as on the CPU: the world's engine, memo, ring and the two gloo
    ranks' DP and CP lanes on ``cuda``."""
    from cilium_tpu_torch.runtime import dst

    events = [["fault", "engine.dispatch", 1], ["traffic"], ["serve", 4],
              ["churn", "add", 1], ["multichip"], ["serve", 2]]
    got = dst.run_schedule(0, events=events, device="cuda")
    want = dst.run_schedule(0, events=events, device="cpu")
    assert got["violation"] is None
    assert got["trace"] == want["trace"]
    assert got["digest"] == want["digest"]
    mc = [e["out"] for e in got["trace"] if e["event"] == ["multichip"]]
    assert mc[0]["devices"] == 2 and not mc[0].get("faulted")


def test_dst_regression_case_reproduces_on_card(cuda, monkeypatch):
    """The committed regression case replays on the card to the CPU
    run's violation (the recorded index and invariant), and is clean
    without its mutation."""
    import json
    import os

    from cilium_tpu_torch.runtime import dst, faults

    path = os.path.join(os.path.dirname(__file__), "dst", "regressions",
                        "dst_seed2_e27df4160b0adb25.json")
    with open(path) as fp:
        case = json.load(fp)
    monkeypatch.setenv(faults.MUTATION_ENV, case["mutation"])
    got = dst.run_schedule(case["seed"], events=case["events"],
                           device="cuda")
    want = dst.run_schedule(case["seed"], events=case["events"],
                            device="cpu")
    assert got["violation"] == want["violation"]
    assert (got["violation"]["index"], got["violation"]["invariant"]) == \
        (case["violation"]["index"], case["violation"]["invariant"])
    monkeypatch.delenv(faults.MUTATION_ENV)
    clean = dst.run_schedule(case["seed"], events=case["events"],
                             device="cuda")
    assert clean["violation"] is None


@pytest.mark.parametrize("name", ["literal", "explosion", "wide"])
def test_kernels_at_the_bench_kernel_sweep_banks_equal_plain(cuda, name):
    """KD, K2 (at most 128 states) and K1 at a sweep bank of
    ``tools/bench_kernel``, on the autotuner's probe batch (256 × 32,
    random bytes) and on zero and full lengths."""
    from cilium_tpu_torch.tools import bench_kernel

    bank = bench_kernel.sweep_banks()[name]
    st = arrays_from_reference(bank["stacked"], cuda)
    rng = np.random.default_rng(0)
    B, L = bench_kernel.SWEEP_BATCH, bench_kernel.SWEEP_WIDTH
    data = _t(rng.integers(0, 128, size=(B, L), dtype=np.uint8), cuda)
    nfa = bank["nfa"]
    n = ([_t(nfa[f"nfa_{k}"], cuda)
          for k in ("follow", "acc_cls", "byteclass", "start")]
         if nfa is not None else None)
    _build.reset_launches()
    cases = [rng.integers(0, L + 1, (B,)).astype(np.int32),
             *_length_cases(rng, B, L)[1:]]
    for ln in cases:
        args = [st["trans"], st["byteclass"], st["start"], data,
                _t(ln, cuda)]
        assert torch.equal(
            dfa_dense_cuda.dense_scan_cuda(*args, accept=st["accept"]),
            dfa_dense_cuda.dense_scan_plain(*args, accept=st["accept"]))
        if bank["stacked"]["trans"].shape[1] <= 128:
            assert torch.equal(
                dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*args),
                dfa_oblivious_cuda.dfa_finals_oblivious_plain(*args))
        if n is not None:
            assert torch.equal(nfa_cuda.nfa_finals_cuda(*n, *args[3:]),
                               nfa_cuda.nfa_finals_plain(*n, *args[3:]))
    assert _build.KERNELS["KD"].launches == len(cases)
    assert _build.KERNELS["K1"].launches == (len(cases) if n else 0)


def test_bench_http_check_on_card_has_no_mismatch(cuda, tmp_path,
                                                  monkeypatch):
    """``tools/bench.py --config http --check`` at a small size on the
    card: the capture lane runs, the oracle sample agrees."""
    import argparse

    from cilium_tpu_torch.tools import bench

    monkeypatch.setenv("CILIUM_TPU_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(bench, "PROV_WINDOW_S", 0.05)
    ns = argparse.Namespace(
        rules=40, flows=1000, iters=2, lat_iters=4, warmup=1, windows=2,
        window_s=0.05, capture_lat=8,
        check=True,
        check_sample=200, from_capture=str(tmp_path / "cap.bin"),
        capture_flows=20000, replay_chunk=4096, device=None)
    _build.reset_launches()
    line = bench.run_config("http", ns)
    assert line["metric"] == "e2e_capture_replay_http_40rules", line
    assert line["check_mismatches"] == 0
    assert line["device"].startswith("cuda")
    assert line["capture_records"] == 20000
    assert _build.KERNELS["KD"].launches > 0


def test_fan_out_on_card_equals_the_plain_path(cuda, tmp_path, monkeypatch):
    """One 8192-flow chunk of a flowpb capture through the replay cursor
    and the fan-out sequence (``notify_batch``, ``annotate_flows`` with
    the attribution map, ``observe``) on the card and on the plain path:
    annotated flows, events and the exporter's lines equal; KD launched
    on the card."""
    import copy
    import json

    from cilium_tpu_torch.engine.verdict import AUTH_UNENFORCED
    from cilium_tpu_torch.hubble import (
        FlowExporter,
        FlowMetrics,
        Observer,
        annotate_flows,
    )
    from cilium_tpu_torch.ingest import flowpb
    from cilium_tpu_torch.ingest.cursor import ReplayCursor, replay_chunks
    from cilium_tpu_torch.ingest.hubble import flow_to_dict
    from cilium_tpu_torch.monitor import MonitorAgent, event_to_dict
    from cilium_tpu_torch.runtime import simclock
    from cilium_tpu_torch.runtime.metrics import Metrics

    monkeypatch.setattr(simclock, "wall", lambda: 1753866000.25)
    per_identity, sc = synth.realize_scenario(
        synth.scenario_by_name("http", 40, 8192))
    policy = CompiledPolicy.build(per_identity, EngineConfig())
    cap = str(tmp_path / "cap.pb")
    flowpb.write_pb_capture(cap, sc.flows)
    cursor = ReplayCursor(str(tmp_path / "cursor.json"), cap)
    ((commit, chunk),) = list(replay_chunks(cap, chunk_size=8192,
                                            cursor=cursor))
    assert commit == 8192
    got = {}
    for dev in ("cuda", "cpu"):
        engine = TorchVerdictEngine(policy, device=dev)
        flows = copy.deepcopy(chunk)
        path = str(tmp_path / f"{dev}.jsonl")
        m, ex = Metrics(), FlowExporter(path)
        obs, mon = Observer(handlers=[FlowMetrics(m), ex]), MonitorAgent()
        _build.reset_launches()
        out = engine.verdict_flows(flows, authed_pairs=AUTH_UNENFORCED)
        assert all(isinstance(v, np.ndarray) for v in out.values())
        events = mon.notify_batch(flows, out)
        annotate_flows(flows, out, amap=engine.attribution)
        obs.observe(flows)
        ex.close()
        if dev == "cuda":
            assert _build.KERNELS["KD"].launches > 0
        with open(path) as f:
            lines = [json.loads(s) for s in f]
        got[dev] = ([flow_to_dict(f) for f in flows],
                    [event_to_dict(e) for e in events], lines,
                    dict(m._counters))
    assert got["cuda"] == got["cpu"]
    assert got["cuda"][2] == got["cuda"][0]
    assert len({d["verdict"] for d in got["cuda"][0]}) > 1


def test_agent_on_card_equals_plain_and_device_profile_names_kd(
        cuda, tmp_path):
    """The agent plane on the card: ``Agent(device="cuda")`` verdicts
    the http scenario through ``process_flows`` (KD launches) with all
    ten lanes equal to an ``Agent(device="cpu")``'s, and a device-mode
    profile taken while another thread runs ``process_flows`` writes a
    Chrome trace that names KD's kernel."""
    import json
    import threading

    from cilium_tpu_torch.agent import Agent
    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.runtime.profiling import Profiler

    sc = synth.synth_http_scenario(40, 2048, seed=5)
    outs = {}
    agents = {}
    try:
        for dev in ("cuda", "cpu"):
            cfg = Config()
            cfg.configure_logging = False
            cfg.loader.cache_dir = str(tmp_path / dev)
            agent = agents[dev] = Agent(cfg, device=dev).start()
            ids = {n: agent.endpoint_add(10 + i, lbl).identity
                   for i, (n, lbl) in enumerate(sorted(
                       sc.endpoints.items()))}
            from cilium_tpu_torch.policy.api.cnp import CiliumNetworkPolicy

            agent.policy_add(CiliumNetworkPolicy(
                name="synth-http", namespace="default",
                rules=tuple(sc.rules)))
            for f in sc.flows:
                f.src_identity, f.dst_identity = ids["client"], ids["server"]
            _build.reset_launches()
            outs[dev] = agent.process_flows(sc.flows)
            if dev == "cuda":
                assert _build.KERNELS["KD"].launches > 0
        for k in OUTPUT_LANES:
            np.testing.assert_array_equal(outs["cuda"][k], outs["cpu"][k])
        stop = threading.Event()

        def drive():
            while not stop.is_set():
                agents["cuda"].process_flows(sc.flows[:512])

        t = threading.Thread(target=drive)
        t.start()
        try:
            res = Profiler().capture(str(tmp_path / "prof"), seconds=1.0,
                                     mode="device")
        finally:
            stop.set()
            t.join(timeout=60)
        with open(res["path"]) as f:
            names = {e.get("name", "") for e in json.load(f)
                     .get("traceEvents", [])}
        assert any("dfa_dense_kernel" in n for n in names), sorted(names)[:40]
    finally:
        for a in agents.values():
            a.stop()


def test_two_agents_on_the_cluster_services_equal_plain(cuda, tmp_path):
    """The cluster control services with two agents on the card: a
    served kvstore and apiserver, an operator carving each node a /24,
    ``crd`` identities, and the http scenario's rule applied as a CNP
    through the apiserver. ``node-a`` serves under ``auto`` (KD) and
    ``node-b`` under ``nfa-bitset`` (K1); both nodes' ten lanes equal a
    plain ``TorchVerdictEngine(..., device="cpu")`` of the served
    policy, and each other's."""
    import shutil
    import tempfile
    import time

    from cilium_tpu_torch.agent import Agent
    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.k8s.apiserver import APIServer, K8sClient
    from cilium_tpu_torch.kvstore_service import KVStoreServer, RemoteKVStore
    from cilium_tpu_torch.operator import Operator

    sc = synth.synth_http_scenario(40, 2048, seed=5)
    short = tempfile.mkdtemp(prefix="t19")  # socket paths < 108 bytes
    kv = KVStoreServer(f"{short}/kv.sock").start()
    api = APIServer(f"{short}/k8s.sock").start()
    op_kv = RemoteKVStore(kv.socket_path)
    op = Operator(op_kv, pool_cidr="10.250.0.0/16",
                  k8s_api_socket=api.socket_path).start()
    agents = {}
    try:
        for name, impl in (("node-a", "auto"), ("node-b", "nfa-bitset")):
            cfg = Config()
            cfg.node_name = name
            cfg.configure_logging = False
            cfg.ipam_mode = "cluster-pool"
            cfg.identity_allocation_mode = "crd"
            cfg.k8s_api_socket = api.socket_path
            cfg.engine.kernel_impl = impl
            cfg.loader.cache_dir = str(tmp_path / name)
            agents[name] = Agent(cfg, kvstore=RemoteKVStore(kv.socket_path),
                                 device="cuda").start()
        a, b = agents["node-a"], agents["node-b"]
        assert str(a.ipam.cidr) != str(b.ipam.cidr)
        srv = a.endpoint_add(1, sc.endpoints["server"])
        cli = b.endpoint_add(2, sc.endpoints["client"])
        deadline = time.monotonic() + 30
        while (b.allocator.lookup(srv.identity) is None
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert b.endpoint_add(3, sc.endpoints["server"]).identity == \
            srv.identity
        for f in sc.flows:
            f.src_identity, f.dst_identity = cli.identity, srv.identity
        for x in (a, b):
            x.endpoint_manager.regenerate_all(wait=True)
        K8sClient(api.socket_path).apply(
            "ciliumnetworkpolicies",
            synth.http_rule_cnp(sc.rules[0], "synth-http"))
        outs = {}
        for name, x in agents.items():
            while (len(x.repo.rules()) != 1
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            x.endpoint_manager.regenerate_all(wait=True)
            _build.reset_launches()
            outs[name] = x.process_flows(sc.flows)
            kid = "KD" if name == "node-a" else "K1"
            assert _build.KERNELS[kid].launches > 0, name
            engine = x.loader.engine
            assert engine.device.type == "cuda"
            plain = TorchVerdictEngine(engine.policy, device="cpu",
                                       cfg=engine.cfg)
            want = plain.verdict_flows(sc.flows)
            for k in OUTPUT_LANES:
                np.testing.assert_array_equal(outs[name][k],
                                              np.asarray(want[k]))
        for k in OUTPUT_LANES:
            np.testing.assert_array_equal(outs["node-a"][k],
                                          outs["node-b"][k])
        assert 2 in outs["node-a"]["verdict"]
    finally:
        api.stop()
        for x in agents.values():
            x.stop()
        op.stop()
        op_kv.close()
        kv.stop()
        shutil.rmtree(short, ignore_errors=True)


def test_daemon_process_on_card_stream_equals_plain(cuda):
    """``python -m cilium_tpu_torch.daemon --config`` on the card (its
    device the default, ``cuda``; ``nfa-bitset`` from the TOML): the
    http scenario's two endpoints and its rule as a CNP file through the
    CLI, ``capture synth`` and ``capture stream`` of 2048 records
    through its verdict socket; the summary's counts and every record's
    verdict (the port's ``StreamClient``) equal a plain engine
    (``device="cpu"``) of the same policy; SIGTERM → rc 0."""
    import contextlib
    import io
    import json
    import os
    import shutil
    import signal
    import subprocess
    import sys
    import tempfile
    import time

    from cilium_tpu_torch import cli
    from cilium_tpu_torch.agent import Agent
    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.ingest import binary
    from cilium_tpu_torch.runtime.stream import StreamClient

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([str(a) for a in argv])
        assert rc == 0, buf.getvalue()[-500:]
        return json.loads(buf.getvalue())

    sc = synth.synth_http_scenario(40, 2048)
    tmp = tempfile.mkdtemp(prefix="t20")  # socket paths < 108 bytes
    socks = {k: f"{tmp}/{k}.sock" for k in ("svc", "api")}
    with open(f"{tmp}/d.toml", "w") as f:
        f.write('[engine]\nkernel_impl = "nfa-bitset"\nbank_size = 128\n'
                f'[loader]\ncache_dir = "{tmp}/cache"\n')
    with open(f"{tmp}/cnp.yaml", "w") as f:
        json.dump(synth.http_rule_cnp(sc.rules[0], "synth-http"), f)
    err = open(f"{tmp}/d.err", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cilium_tpu_torch.daemon", "--config",
         f"{tmp}/d.toml", "--socket", socks["svc"], "--api-socket",
         socks["api"]], cwd=repo, stdout=subprocess.DEVNULL, stderr=err)
    plain_agent = None
    try:
        deadline = time.monotonic() + 120
        while not all(os.path.exists(p) for p in socks.values()):
            assert proc.poll() is None and time.monotonic() < deadline, (
                err.seek(0), err.read()[-2000:])
            time.sleep(0.02)
        for i, (name, lbls) in enumerate(sc.endpoints.items(), start=1):
            run("endpoint", "add", i, "--labels",
                ",".join(f"{k}={v}" for k, v in lbls.items()), "--api",
                socks["api"])
        rev = run("policy", "import", f"{tmp}/cnp.yaml", "--api",
                  socks["api"])["revision"]
        while run("status", "--socket", socks["svc"])[
                "engine_revision"] < rev:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        cap = f"{tmp}/cap.bin"
        run("capture", "synth", cap, "--scenario", "http", "--rules", 40,
            "--flows", 2048)
        info = run("capture", "stream", cap, "--socket", socks["svc"],
                   "--chunk", 1024)
        rec = binary.map_capture(cap)
        l7, offsets, blob = binary.read_l7_sidecar(cap)
        client = StreamClient(socks["svc"],
                              widths=binary.capture_field_widths(l7, offsets))
        for i in range(0, len(rec), 1024):
            client.send_image(binary.sections_to_bytes(
                np.asarray(rec[i:i + 1024]), l7[i:i + 1024], offsets, blob))
        client.finish()
        got = np.concatenate([v for _, v in client.results()])
        client.close()
        cfg = Config.from_toml(f"{tmp}/d.toml")
        cfg.configure_logging = False
        cfg.loader.cache_dir = f"{tmp}/plain-cache"
        plain_agent = Agent(cfg, device="cpu")
        for i, lbls in enumerate(sc.endpoints.values(), start=1):
            plain_agent.endpoint_add(i, lbls)
        plain_agent.policy_add_file(f"{tmp}/cnp.yaml")
        want = plain_agent.loader.engine.verdict_l7_records(
            np.asarray(rec), l7, offsets, blob)["verdict"]
        np.testing.assert_array_equal(got, want)
        assert info["verdicts"] == np.bincount(want, minlength=6).tolist()
        assert info["errors"] == 0 and not info["truncated"]
        assert len(set(want.tolist())) > 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        err.close()
        if plain_agent is not None:
            plain_agent.stop()
        shutil.rmtree(tmp, ignore_errors=True)
