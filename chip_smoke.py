"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero before the result line):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the hand-written kernels (KD, K1, K2) from
   ``cilium_tpu_torch/engine/csrc`` — one nvcc per source, in parallel —
   and check in their SASS (``cuobjdump``) that every instantiation of
   K1 and K2 issues tensor-core instructions (HMMA, HGMMA) and that
   KD's shared-memory instantiations stage with the bulk copy on an
   mbarrier and read the table with shared loads;
3. kernel phase: each kernel against its plain PyTorch version on the
   card, exactly, on random banks (0/1/128 positions, 128 states,
   zero-length rows, batches that are not a multiple of the block), on
   the tile edges of the tensor-core kernels K1 and K2 (with random,
   all-zero and all-full lengths), on KD's edges (both variants, a bank
   over the shared-memory budget included; L from 1 to 1024; B around
   one CTA; W in 1, 3, 4 with and without the extra plane; finals only;
   a column slice of a wider blob at an odd offset; negative and
   past-L lengths) and on the http-1000 policy's own banks; then K2 and K1 timed at the http-1000 host shape on
   random bytes and on one repeated byte at full length: their times
   must agree within 1.25x (the data-oblivious property of the
   reference kernels);
4. main path: the http scenario at 1000 rules x 10000 flows, bank size
   128, batches of 8192, under ``auto``, ``nfa-bitset`` and the
   oblivious DFA. Each configuration is verdicted once with every
   launch count set to 0 just before and read just after (a kernel of
   the configuration's path that never launched fails the run); all ten
   output lanes are held equal to the port's plain-version path
   (``device="cpu"``) on the same batches; the verdict mix must be a
   plausible allow/deny split; then the median batch time over 25
   timed batches after warm-up, and each kernel's time for one launch
   at the shapes of every field it scans. The http-1000 path bank must
   have run KD's shared-memory variant, phase 3's over-budget banks its
   global one (launch counts by variant);
5. capture replay: the scenario's 10000 flows repeated to a
   200000-record v2 capture, written with the port's writer into a
   temporary directory and read back with its reader; under the gather
   arm (KD) and the oblivious arm (K2, the path table on KD with the
   reference's warning), three routes — the device verdict memo
   (``stage_rows``, ``stage_unique``, ``stage_unique_device``,
   ``stage_verdict_memo``, chunks of 65536 by ``verdict_idx``), the id
   stream without the memo, and the row stream — all ten lanes equal
   to each other and to the fused step on the same flows in capture
   order, the memo's fill equal to the plain path's on the unique
   rows; launch counts zeroed before and read after each arm; the
   staging split, unique rows, median chunk latency with forced
   completion and rows/s of each route (median of 5 windows). Then the
   same records made unique (the high-cardinality capture): the dedup
   declines, KD scans a ~200k-row path table, the rows stream, and an
   8192-row sample equals the plain path;
6. legacy step: ``kernel_impl="legacy"``, a policy whose resolve plan
   degenerated (``GROUP_CAP`` = 1) and ``verdict_flows_blob`` on the
   http-1000 batches against the fused step; the legacy step's batch
   median and device kernels per batch beside the fused step's, and the
   blob route's device kernels per batch (KD reads its byte fields and
   length columns in place);
7. online serving: the port's ``ServeLoop`` over the ``auto`` engine
   with 1024 leased streams, driven inline by ``step()``. Cold: the
   10000 flows in chunks of 64 spread over the leases, one pack, with
   provenance; verdict, ``l7_match`` and ``match_spec`` equal to the
   engine's direct ``verdict_flows`` and every attribution code
   resolving. Warm: the flows repeated to 200000 records, waves of one
   chunk a lease, ``step()`` until drained: zero memo misses and 4 bytes
   shipped a record; median pack ms, records per pack, records/s, and
   a separate traced pack's kernels, device ms and busy share (device
   over wall ms of that one traced pack). A sample of the warm traffic
   through a ring over the plain (CPU) engine equals the card's lanes.
   Growth: unique paths across the session's string cap: one reset,
   the chunk encoded before it resolves ``session-reset`` and serves
   when resubmitted; the delta-scan shapes the session launches KD at
   are noted. Thread: ``start()`` against eight submitter threads for
   a few seconds, then ``stop()``; every verdict equal, KD launched
   from the pack thread. The launch counts cover these serving passes
   alone; after they are read, KD is held against its plain version
   and timed at every growth shape that phase 3 lacks. A
   ``serve: {...}`` line carries the numbers;
8. one JSON line ``{"kernels": [...]}``, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

The kernel phase (3) also holds KD and K2 at the capture tables'
shapes (each field's largest table over the two captures, at the
capture's widths), on a synthetic L = 1024 batch, and KD at the
incremental session's delta shapes (``SESSION_DELTAS``), and the
per-kernel times cover those shapes.

It imports nothing of JAX. Run it from the root of a checkout: it
imports ``cilium_tpu_torch`` from the directory it lives in.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

N_RULES, N_FLOWS, BATCH, BANK_SIZE = 1000, 10000, 8192, 128
DEVICE = "cuda"
TIMED_BATCHES, WARMUP = 25, 3
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and float32 outside
#: the tensor cores, which is the rate this file counts the kernels'
#: 32-bit integer/bit ops at
HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_OPS_PER_S = 67e12
#: and the dense int8 tensor-core peak, the lowest tensor-core bound of
#: the one-hot products K1 and K2 compute (their operands are exact in
#: int8)
TENSOR_INT8_OPS_PER_S = 1979e12
#: input-independence: the largest ratio allowed between K1's or K2's
#: times on two batches of one shape
TIMING_RATIO_MAX = 1.25
#: what the operation count of each kernel's bound counts
BOUND_OPS = {
    "KD": "2 per live byte and bank (one transition), non-tensor peak",
    "K1": "2*NB*B*(L-1)*P*P (D . Follow), int8 tensor-core peak",
    "K2": "2*NB*B*L*S*(K+1) (onehot(state) . table), int8 tensor-core "
          "peak",
}
#: phase 5: capture size and replay chunk (the reference benchmark's
#: ``--capture-flows`` and ``--replay-chunk`` defaults)
CAPTURE_RECORDS, REPLAY_CHUNK = 200_000, 65_536
#: phase 5: chunk-latency samples, target seconds of one throughput
#: window, and the high-cardinality pass's sample checked on the CPU
LATENCY_SAMPLES, WINDOW_S, HC_SAMPLE = 20, 0.25, 8192
#: the capture-staging phases of ``cilium_tpu_capture_stage_seconds``
STAGE_PHASES = ("tables", "featurize", "dedup", "table-h2d", "memo-fill")
#: phase 3: the incremental session's delta scans (KD, accept words
#: only) — field prefix → (B, L): a delta padded to at least 256 rows at
#: the session's field widths, and the path delta of one flush at the
#: string cap (``engine/session.py``)
SESSION_DELTAS = [("path", 256, 256), ("path", 131072, 256),
                  ("hdr", 256, 1024), ("method", 256, 16),
                  ("host", 256, 128), ("dns", 256, 256)]
#: phase 7: leased streams (the serve loop's default ring capacity) and
#: records per chunk; the warm pass's records (phase 5's capture size);
#: the string cap the growth pass crosses (the session's MAX_STRINGS);
#: the plain-path sample; the thread pass's submitters and seconds
SERVE_STREAMS, SERVE_CHUNK = 1024, 64
SERVE_WARM_RECORDS = CAPTURE_RECORDS
GROWTH_MAX_STRINGS = 1 << 16
#: growth pass: records per unique path, so that the records up to the
#: cap outnumber one pack's PACK_MAX (``engine/ring.py``)
GROWTH_REPEAT = 4
SERVE_PLAIN_SAMPLE, SERVE_THREADS, SERVE_THREAD_S = 2048, 8, 3.0
#: capture arm → (phase-4 configuration it replays on, kernels it must
#: launch)
CAPTURE_ARMS = {"gather": ("auto", ("KD",)),
                "oblivious": ("oblivious-dfa", ("KD", "K2"))}
#: configuration → (kernel_impl, CILIUM_TPU_DFA_IMPL, kernels its path
#: launches)
CONFIGS = {
    "auto": ("auto", "gather", ("KD",)),
    "nfa-bitset": ("nfa-bitset", "gather", ("KD", "K1")),
    "oblivious-dfa": ("auto", "pallas", ("KD", "K2")),
}


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------- timing
def time_launch(fn, reps: int = 20, warmup: int = 2) -> float:
    """ms per call, by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def launch_ms(fn) -> float:
    """Device ms of one call, by CUDA events. A spin kernel keeps the
    stream busy while the host enqueues the call between the two events,
    so the wrapper's host time is not counted."""
    import torch

    torch.cuda._sleep(1_000_000)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1)


def profile_kernels(fn, reps: int):
    """Run ``fn`` ``reps`` times under torch.profiler → {kernel name:
    (launches, device ms)} over the device-side kernel events. Empty
    when the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", 0.0)
        out[e.key] = (e.count, us / 1e3)
    return out


def kernel_device_ms(fn, symbol: str, reps: int = 20, tries: int = 3):
    """Device time of one launch of the kernel whose symbol contains
    ``symbol`` (profiler); None when the profiler saw no such kernel in
    any of ``tries`` traces (a trace now and then comes back without
    the kernel's events)."""
    for _ in range(tries):
        hits = [(n, ms) for k, (n, ms) in profile_kernels(fn, reps).items()
                if symbol in k]
        if hits:
            return sum(h[1] for h in hits) / sum(h[0] for h in hits)
    return None


def bound(n_bytes: float, ops: float, ops_per_s: float = NON_TENSOR_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and ops
    over the given peak (default: outside the tensor cores)."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def flow_bytes(data, lens) -> int:
    """Bytes a scan must read of a batch: the lengths, and each flow's
    first ``min(length, L)`` bytes (the padding past a flow's length is
    never read)."""
    live = int(lens.clamp(0, data.shape[1]).sum())
    return live * data.element_size() + nbytes(lens)


# ---------------------------------------------------------- kernel phase
#: (NB, S, K, B, L) and (NB, P, K, B, L) tile-edge cases of K2 and K1
K2_EDGES = [(1, 1, 1, 1, 1), (2, 16, 255, 15, 33), (1, 17, 256, 17, 1),
            (3, 128, 256, 65, 33), (1, 128, 255, 8193, 33),
            (2, 16, 1, 8193, 1), (1, 40, 7, 100, 300)]
K1_EDGES = [(1, 1, 1, 1, 1), (2, 16, 256, 15, 33), (1, 17, 1, 17, 33),
            (3, 128, 256, 65, 1), (1, 128, 1, 8193, 33),
            (2, 17, 256, 8193, 1), (1, 40, 7, 100, 300)]
#: (NB, S, K, B, L) edge cases of KD: B below one CTA's 512 flows, one
#: past it and 8193; L on and off the 16-byte load, past a chunk, 300
#: and 1024; banks over the shared-memory budget (S = 8192, K = 256:
#: 8 MB) take the global variant
KD_EDGES = [(1, 1, 1, 1, 1), (2, 17, 5, 511, 15), (3, 40, 7, 513, 16),
            (2, 128, 31, 8193, 17), (1, 300, 20, 100, 33),
            (2, 768, 31, 1000, 300), (1, 74, 16, 512, 1024),
            (1, 8192, 256, 8193, 33), (2, 8192, 256, 513, 1024)]
#: KD's lengths cases: random in [-3, L + 4], all zero, all L, negative,
#: past L
KD_LENGTHS = ("random", "zero", "full", "negative", "over")

def max_err(a, b) -> float:
    """Largest absolute difference; the kernels are exact, so 0."""
    import torch

    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"shape/dtype mismatch {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
        if not a.is_floating_point() else float((a - b).abs().max())


def hold(errs, kid, what, got, want):
    """Hold a kernel's result against its plain version's: exact, or
    fail; the largest error goes into ``errs``."""
    e = max_err(got, want)
    errs[kid] = max(errs.get(kid, 0.0), e)
    check(e == 0.0, f"{kid} disagrees with its plain version on "
                    f"{what}: max abs err {e}")
    log(f"  {kid} {what}: exact")


def session_check(errs, session_inputs):
    """KD against its plain version at the incremental session's delta
    scans: accept words only."""
    from cilium_tpu_torch.engine import dfa_dense_cuda

    for label, (prefix, arrays, data, lens) in session_inputs.items():
        a = (arrays[f"{prefix}_trans"], arrays[f"{prefix}_byteclass"],
             arrays[f"{prefix}_start"], data, lens)
        acc = arrays[f"{prefix}_accept"]
        hold(errs, "KD", f"{label} {tuple(a[0].shape)} B={data.shape[0]} "
                         f"L={data.shape[1]}",
             dfa_dense_cuda.dense_scan_cuda(*a, accept=acc),
             dfa_dense_cuda.dense_scan_plain(*a, accept=acc))


def kernel_phase(errs, field_inputs, capture_inputs, session_inputs):
    """Every kernel against its plain version on the card, exactly."""
    import numpy as np
    import torch

    from cilium_tpu_torch.engine import (
        dfa_dense_cuda,
        dfa_oblivious_cuda,
        nfa_cuda,
    )

    rng = np.random.default_rng(0)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    def flows(b, l):
        data = rng.integers(0, 256, (b, l)).astype(np.uint8)
        lens = rng.integers(0, l + 1, (b,)).astype(np.int32)
        lens[:3] = 0                                   # zero-length rows
        return T(data), T(lens)

    def record(kid, what, got, want):
        hold(errs, kid, what, got, want)

    for nb, s, k, w, b, l in [(1, 2, 1, 1, 7, 4), (3, 17, 5, 2, 50, 12),
                              (2, 128, 31, 1, 300, 9),
                              (8, 768, 31, 4, 1000, 32)]:
        trans = T(rng.integers(0, s, (nb, s, k)).astype(np.int32))
        bc = T(rng.integers(0, k, (nb, 256)).astype(np.int32))
        start = T(rng.integers(0, s, (nb,)).astype(np.int32))
        acc = T(rng.integers(-2 ** 31, 2 ** 31 - 1, (nb, s, w),
                             dtype=np.int64).astype(np.int32))
        data, lens = flows(b, l)
        args = (trans, bc, start, data, lens)
        what = f"random NB={nb} S={s} K={k} B={b} L={l}"
        record("KD", what + " words",
               dfa_dense_cuda.dense_scan_cuda(*args, accept=acc, extra=acc),
               dfa_dense_cuda.dense_scan_plain(*args, accept=acc, extra=acc))
        record("KD", what + " finals", dfa_dense_cuda.dense_scan_cuda(*args),
               dfa_dense_cuda.dense_scan_plain(*args))
        if s <= 128:
            record("K2", what,
                   dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*args),
                   dfa_oblivious_cuda.dfa_finals_oblivious_plain(*args))
    kd_variants = kd_edges(T, rng, record)
    for nb, p, k, b, l in [(1, 1, 1, 7, 4), (2, 17, 5, 50, 12),
                           (3, 128, 13, 300, 9), (2, 33, 4, 129, 1),
                           (1, 64, 9, 257, 32)]:
        fol = T((rng.random((nb, p, p)) < 0.1).astype(np.float32))
        ac = T((rng.random((nb, p, k)) < 0.5).astype(np.float32))
        bc = T(rng.integers(0, k, (nb, 256)).astype(np.int32))
        st = T((rng.random((nb, p)) < 0.3).astype(np.float32))
        data, lens = flows(b, l)
        args = (fol, ac, bc, st, data, lens)
        record("K1", f"random NB={nb} P={p} K={k} B={b} L={l}",
               nfa_cuda.nfa_finals_cuda(*args),
               nfa_cuda.nfa_finals_plain(*args))
    # the tile edges of the tensor-core kernels: S or P off and on the
    # 16-row k-step, K + 1 off the 8-column n-tile, B below one warp's
    # 16 flows and past a CTA's 64, L = 1, 33 and past the 256-byte
    # staging chunk; random, all-zero and all-full lengths
    def length_cases(b, l):
        return [("random", T(rng.integers(0, l + 1, (b,)).astype(np.int32))),
                ("zero", T(np.zeros(b, np.int32))),
                ("full", T(np.full(b, l, np.int32)))]

    for nb, s, k, b, l in K2_EDGES:
        tables = (T(rng.integers(0, s, (nb, s, k)).astype(np.int32)),
                  T(rng.integers(0, k, (nb, 256)).astype(np.int32)),
                  T(rng.integers(0, s, (nb,)).astype(np.int32)))
        data = T(rng.integers(0, 256, (b, l)).astype(np.uint8))
        for name, lens in length_cases(b, l):
            args = (*tables, data, lens)
            record("K2", f"edge NB={nb} S={s} K={k} B={b} L={l} {name} "
                         f"lengths",
                   dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*args),
                   dfa_oblivious_cuda.dfa_finals_oblivious_plain(*args))
    for nb, p, k, b, l in K1_EDGES:
        tables = (T((rng.random((nb, p, p)) < 0.1).astype(np.float32)),
                  T((rng.random((nb, p, k)) < 0.5).astype(np.float32)),
                  T(rng.integers(0, k, (nb, 256)).astype(np.int32)),
                  T((rng.random((nb, p)) < 0.3).astype(np.float32)))
        data = T(rng.integers(0, 256, (b, l)).astype(np.uint8))
        for name, lens in length_cases(b, l):
            args = (*tables, data, lens)
            record("K1", f"edge NB={nb} P={p} K={k} B={b} L={l} {name} "
                         f"lengths",
                   nfa_cuda.nfa_finals_cuda(*args),
                   nfa_cuda.nfa_finals_plain(*args))
    # a 0-position bank: nothing to scan, the wrapper launches nothing
    z = nfa_cuda.nfa_finals_cuda(
        T(np.zeros((1, 0, 0), np.float32)), T(np.zeros((1, 0, 1),
                                                       np.float32)),
        T(np.zeros((1, 256), np.int32)), T(np.zeros((1, 0), np.float32)),
        *flows(5, 4))
    check(tuple(z.shape) == (1, 5, 0), "K1 P=0 shape")

    # the http-1000 policy's own banks, on its first batch
    for prefix, (arrays, data, lens) in field_inputs.items():
        a = (arrays[f"{prefix}_trans"], arrays[f"{prefix}_byteclass"],
             arrays[f"{prefix}_start"], data, lens)
        extra = arrays.get("rp_path_gaccept") if prefix == "path" else None
        acc = arrays[f"{prefix}_accept"]
        record("KD", f"http-1000 {prefix} {tuple(a[0].shape)}",
               dfa_dense_cuda.dense_scan_cuda(*a, accept=acc, extra=extra),
               dfa_dense_cuda.dense_scan_plain(*a, accept=acc, extra=extra))
        if a[0].shape[1] <= 128:
            record("K2", f"http-1000 {prefix} {tuple(a[0].shape)}",
                   dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*a),
                   dfa_oblivious_cuda.dfa_finals_oblivious_plain(*a))
        if f"{prefix}_nfa_follow" in arrays:
            n = [arrays[f"{prefix}_nfa_{k}"] for k in
                 ("follow", "acc_cls", "byteclass", "start")] + [data, lens]
            record("K1", f"http-1000 {prefix} P={n[0].shape[1]}",
                   nfa_cuda.nfa_finals_cuda(*n), nfa_cuda.nfa_finals_plain(*n))

    # the capture tables of phase 5 (the largest B of each field's
    # table, at the capture's widths) and a synthetic L = 1024 batch
    for label, (prefix, arrays, data, lens) in capture_inputs.items():
        a = (arrays[f"{prefix}_trans"], arrays[f"{prefix}_byteclass"],
             arrays[f"{prefix}_start"], data, lens)
        extra = arrays.get("rp_path_gaccept") if prefix == "path" else None
        acc = arrays[f"{prefix}_accept"]
        what = f"{label} {tuple(a[0].shape)} B={data.shape[0]} " \
               f"L={data.shape[1]}"
        record("KD", what,
               dfa_dense_cuda.dense_scan_cuda(*a, accept=acc, extra=extra),
               dfa_dense_cuda.dense_scan_plain(*a, accept=acc, extra=extra))
        if a[0].shape[1] <= 128:
            record("K2", what,
                   dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*a),
                   dfa_oblivious_cuda.dfa_finals_oblivious_plain(*a))
    session_check(errs, session_inputs)
    return kd_variants


def kd_edges(T, rng, record):
    """KD against its plain version on KD_EDGES: every lengths case of
    KD_LENGTHS with W in (1, 3, 4) and the extra plane on and off, a
    finals-only call, a data tensor that is a column slice of a wider
    u8 blob at an odd offset with its lengths a strided int32 column.
    Returns KD's launches by variant over these cases."""
    import numpy as np

    from cilium_tpu_torch.engine import _build, dfa_dense_cuda as kd

    def lens_of(case, b, l):
        return {"random": rng.integers(-3, l + 5, (b,)),
                "zero": np.zeros(b), "full": np.full(b, l),
                "negative": np.full(b, -7),
                "over": np.full(b, l + 9)}[case].astype(np.int32)

    _build.reset_launches()
    for nb, s, k, b, l in KD_EDGES:
        tables = (T(rng.integers(0, s, (nb, s, k)).astype(np.int32)),
                  T(rng.integers(0, k, (nb, 256)).astype(np.int32)),
                  T(rng.integers(0, s, (nb,)).astype(np.int32)))
        planes = {w: T(rng.integers(-2 ** 31, 2 ** 31 - 1, (nb, s, w),
                                    dtype=np.int64).astype(np.int32))
                  for w in (1, 3, 4)}
        data = T(rng.integers(0, 256, (b, l)).astype(np.uint8))
        plan = kd.plan_launch(nb, s, k, b, l)
        what = f"edge NB={nb} S={s} K={k} B={b} L={l} ({plan.variant})"
        for i, case in enumerate(KD_LENGTHS):
            args = (*tables, data, T(lens_of(case, b, l)))
            acc = planes[(1, 3, 4)[i % 3]]
            extra = planes[(4, 1, 3)[i % 3]] if i % 2 == 0 else None
            record("KD", f"{what} {case} lengths W={acc.shape[2]} "
                         f"extra={extra is not None}",
                   kd.dense_scan_cuda(*args, accept=acc, extra=extra),
                   kd.dense_scan_plain(*args, accept=acc, extra=extra))
        args = (*tables, data, T(lens_of("random", b, l)))
        record("KD", f"{what} finals", kd.dense_scan_cuda(*args),
               kd.dense_scan_plain(*args))
        blob = T(rng.integers(0, 256, (b, l + 9)).astype(np.uint8))
        cols = T(np.stack([lens_of("random", b, l)] * 3, axis=1))
        args = (*tables, blob[:, 3:3 + l], cols[:, 1])
        record("KD", f"{what} blob column slice at offset 3, strided "
                     f"lengths", kd.dense_scan_cuda(*args, accept=planes[4],
                                                    extra=planes[1]),
               kd.dense_scan_plain(*args, accept=planes[4], extra=planes[1]))
    variants = dict(kd.KERNEL.launches_by_variant)
    log(f"  KD edge cases: launches by variant {variants}")
    check(variants.get("global", 0) > 0 and variants.get("smem", 0) > 0,
          f"KD edge cases: both variants must launch ({variants})")
    return variants


def sass_kd():
    """KD's shared-memory instantiations stage the table with the bulk
    copy (UBLKCP) on an mbarrier (SYNCS) and read it with shared loads
    (LDS); the global ones issue no bulk copy. Returns {variant:
    {"UBLKCP": n, "LDS": n}} over the instantiations."""
    from cilium_tpu_torch.engine import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass",
                          _build.KERNELS["KD"].library_path()],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump KD: {out.stderr[-500:]}")
    counts = {}
    for f in out.stdout.split("Function : ")[1:]:
        name = f.splitlines()[0]
        if "dfa_dense_kernel" not in name:
            continue
        variant = "smem" if "ILb1E" in name else "global"
        c = {op: f.count(op) for op in ("UBLKCP", "SYNCS", "LDS")}
        if variant == "smem":
            check(c["UBLKCP"] > 0 and c["SYNCS"] > 0 and c["LDS"] > 0,
                  f"KD {name}: no bulk copy on an mbarrier or no shared "
                  f"load ({c})")
        else:
            check(c["UBLKCP"] == 0, f"KD {name}: a bulk copy ({c})")
        agg = counts.setdefault(variant, {"instantiations": 0})
        agg["instantiations"] += 1
        for op, n in c.items():
            agg[op] = agg.get(op, 0) + n
    check(set(counts) == {"smem", "global"}, f"KD instantiations {counts}")
    log(f"  KD: {counts}")
    return counts


def sass_tensor_ops():
    """K1 and K2 run on the tensor cores: every instantiation of their
    kernels in the built libraries holds tensor-core instructions, HMMA
    (mma.sync) or HGMMA (wgmma), by cuobjdump of the toolkit that built
    them. Returns {kernel id: {"HMMA": n, "HGMMA": n}}."""
    from cilium_tpu_torch.engine import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    counts = {}
    for kid, sym in (("K1", "nfa_scan_kernel"), ("K2", "dfa_oblivious_kernel")):
        out = subprocess.run(
            [cuobjdump, "-sass", _build.KERNELS[kid].library_path()],
            capture_output=True, text=True, timeout=300)
        check(out.returncode == 0, f"cuobjdump {kid}: {out.stderr[-500:]}")
        funcs = [f for f in out.stdout.split("Function : ")[1:]
                 if sym in f.splitlines()[0]]
        per = [(f.count("HMMA"), f.count("HGMMA")) for f in funcs]
        check(bool(per) and min(h + g for h, g in per) > 0,
              f"{kid}: an instantiation of {sym} issues no tensor-core "
              f"instruction ({per})")
        counts[kid] = {"HMMA": sum(h for h, _ in per),
                       "HGMMA": sum(g for _, g in per)}
        log(f"  {kid}: tensor-core instructions in all {len(per)} "
            f"instantiations of {sym}: {counts[kid]}")
    return counts


def timing_independence(dense_fields, nfa_fields, card):
    """K2 and K1 at the http-1000 host shape on two batches of that
    shape: random bytes with random lengths, and one byte value repeated
    at full length. The median of 20 launches of each (CUDA events, in
    turns) must agree within TIMING_RATIO_MAX. Returns {kernel id:
    (random ms, repeated ms, ratio)}."""
    import numpy as np
    import torch

    from cilium_tpu_torch.engine import dfa_oblivious_cuda, nfa_cuda

    arr, data, _ = dense_fields["host"]
    B, L = data.shape
    rng = np.random.default_rng(1)
    batches = {
        "random": (torch.from_numpy(rng.integers(0, 256, (B, L))
                                    .astype(np.uint8)).cuda(),
                   torch.from_numpy(rng.integers(0, L + 1, (B,))
                                    .astype(np.int32)).cuda()),
        "repeated": (torch.full((B, L), ord("a"), dtype=torch.uint8,
                                device="cuda"),
                     torch.full((B,), L, dtype=torch.int32, device="cuda")),
    }
    narr = nfa_fields["host"][0]
    kernels = {
        "K2": (dfa_oblivious_cuda.dfa_finals_oblivious_cuda,
               [arr[f"host_{k}"] for k in ("trans", "byteclass", "start")]),
        "K1": (nfa_cuda.nfa_finals_cuda,
               [narr[f"host_nfa_{k}"] for k in
                ("follow", "acc_cls", "byteclass", "start")]),
    }
    out = {}
    for kid, (fn, tables) in kernels.items():
        times = {name: [] for name in batches}
        for _ in range(20):
            for name, (d, ln) in batches.items():
                times[name].append(launch_ms(lambda: fn(*tables, d, ln)))
        med = {name: statistics.median(v) for name, v in times.items()}
        ratio = max(med.values()) / min(med.values())
        out[kid] = (med["random"], med["repeated"], ratio)
        log(f"  {kid} host B={B} L={L}: random bytes {med['random']:.5f} ms,"
            f" one repeated byte {med['repeated']:.5f} ms, ratio "
            f"{ratio:.4f} (limit {TIMING_RATIO_MAX}) on {card}")
        check(ratio <= TIMING_RATIO_MAX,
              f"{kid}: time depends on the input (ratio {ratio:.4f})")
    return out


# ------------------------------------------------------------- main path
def build_policy():
    from cilium_tpu_torch.core.config import EngineConfig
    from cilium_tpu_torch.engine.compiled import CompiledPolicy
    from cilium_tpu_torch.ingest import synth

    t0 = time.perf_counter()
    per_identity, scenario = synth.realize_scenario(
        synth.scenario_by_name("http", N_RULES, N_FLOWS))
    cfg = EngineConfig()
    cfg.bank_size = BANK_SIZE
    policy = CompiledPolicy.build(per_identity, cfg)
    log(f"policy: http {N_RULES} rules, {len(scenario.flows)} flows, "
        f"compiled in {time.perf_counter() - t0:.2f}s; path stack "
        f"{tuple(policy.arrays['path_trans'].shape)}, "
        f"{policy.resolve_meta['groups']} resolve groups")
    return per_identity, scenario, cfg


def host_batches(policy, flows, cfg):
    from cilium_tpu_torch.engine.compiled import (
        encode_flows,
        flowbatch_to_host_dict,
    )

    out = []
    for lo in range(0, len(flows), BATCH):
        fb = encode_flows(flows[lo:lo + BATCH], policy.kafka_interns, cfg)
        out.append(flowbatch_to_host_dict(fb))
    return out


def setup_config(name, per_identity, scenario, base_cfg):
    """Compile and stage one configuration (no kernel launches)."""
    import dataclasses

    import torch

    from cilium_tpu_torch.engine.compiled import CompiledPolicy
    from cilium_tpu_torch.engine.verdict import (
        TorchVerdictEngine,
        batch_to_device,
    )

    mode, dfa_impl, _ = CONFIGS[name]
    cfg = dataclasses.replace(base_cfg, kernel_impl=mode)
    policy = CompiledPolicy.build(per_identity, cfg)
    host = host_batches(policy, scenario.flows, cfg)
    # the engine reads its DFA arm from the environment when it is built
    os.environ["CILIUM_TPU_DFA_IMPL"] = dfa_impl
    engine = TorchVerdictEngine(policy, device=DEVICE, cfg=cfg)
    plain = TorchVerdictEngine(policy, device="cpu", cfg=cfg)
    batches = [batch_to_device(h, DEVICE) for h in host]
    torch.cuda.synchronize()
    return {"engine": engine, "plain": plain, "host": host,
            "batches": batches, "full": batches[0],
            "host_cpu": [batch_to_device(h, "cpu") for h in host]}


def drive_config(name, setup, n_flows, card):
    """One configuration of the main path; returns its report."""
    import numpy as np
    import torch

    from cilium_tpu_torch.engine import _build

    _, dfa_impl, path_kernels = CONFIGS[name]
    engine, plain = setup["engine"], setup["plain"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        # the main path's run: counts to 0 just before, read just after
        _build.reset_launches()
        outs = [engine.verdict_batch_arrays(b) for b in setup["batches"]]
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in _build.KERNELS.items()}
        variants = kd_variants()
        want = [plain.verdict_batch_arrays(b) for b in setup["host_cpu"]]
    log(f"[{name}] impl_plan {json.dumps(engine.impl_plan, sort_keys=True)}"
        f" CILIUM_TPU_DFA_IMPL={dfa_impl} launches {launches}, KD by "
        f"variant {variants}")
    for kid in path_kernels:
        check(launches[kid] > 0,
              f"[{name}] kernel {kid} never launched on the main path")
    if dfa_impl == "pallas":
        check(any("constant-time guarantee" in str(w.message)
                  for w in caught),
              f"[{name}] the >128-state path stack must warn on fallback")
    got = {k: np.concatenate([o[k].cpu().numpy() for o in outs])
           for k in outs[0]}
    check(got["verdict"].shape == (n_flows,),
          f"[{name}] {got['verdict'].shape} verdicts for {n_flows} flows")
    assert_lanes(f"[{name}] vs the plain-version path", got,
                 {k: np.concatenate([o[k].numpy() for o in want])
                  for k in want[0]})
    mix = np.bincount(got["verdict"], minlength=6).tolist()
    log(f"[{name}] all 10 lanes equal to the plain path on "
        f"{n_flows} flows; verdict mix [code 0..5] {mix}")
    check(mix[5] > 0.2 * n_flows and mix[2] > 0.2 * n_flows,
          f"[{name}] implausible verdict mix {mix} (identity wiring?)")

    med, busy, kernels = batch_timing(engine, setup["full"], name, card)
    return {"launches": launches, "kd_variants": variants, "batch_ms": med,
            "mix": mix, "busy_share": busy, "device_kernels": kernels}


def kd_plan_check(arrays, path_data, auto_variants, edge_variants):
    """Phase 4's variant check: the http-1000 path bank plans, and ran
    on the main path, through KD's shared-memory variant; phase 3's
    over-budget banks ran through the global one."""
    from cilium_tpu_torch.engine import dfa_dense_cuda as kd

    NB, S, K = arrays["path_trans"].shape
    plan = kd.plan_launch(NB, S, K, *path_data.shape,
                          arrays["path_accept"].shape[2],
                          arrays["rp_path_gaccept"].shape[2])
    log(f"[auto] KD plan for the path bank {(NB, S, K)} at "
        f"{tuple(path_data.shape)}: {plan}; main path by variant "
        f"{auto_variants}; phase 3 edge cases by variant {edge_variants}")
    check(plan.variant == "smem" and auto_variants.get("smem", 0) > 0,
          "[auto] the http-1000 path bank must run KD's shared-memory "
          "variant")
    check(edge_variants.get("global", 0) > 0,
          "the over-budget banks must run KD's global variant")


def field_inputs_of(engine, batch):
    """prefix → (staged arrays, data, lengths) of one batch."""
    from cilium_tpu_torch.engine.megakernel import SCAN_FIELDS
    from cilium_tpu_torch.engine.verdict import batch_field, unpack_batch

    b = unpack_batch(batch)
    out = {}
    for prefix, field in SCAN_FIELDS:
        data, lens, _ = batch_field(b, field)
        out[prefix] = (engine._arrays, data.contiguous(), lens.contiguous())
    return out


def kernel_times(fields_dense, fields_nfa, capture_inputs, session_inputs,
                 card):
    """One launch of each kernel at the shape of every field it scans
    on the main path: its device time (profiler), its wall time per
    call from Python (CUDA events, wrapper included), the plain
    version's wall time per call, and the bound. The bound's operations
    are KD's transitions over live bytes at the non-tensor peak, and
    the one-hot products of K2 (2·NB·B·L·S·(K+1)) and K1
    (2·NB·B·(L−1)·P²) at the int8 tensor-core peak."""
    import torch

    from cilium_tpu_torch.engine import (
        dfa_dense_cuda,
        dfa_oblivious_cuda,
        nfa_cuda,
    )

    rows = {"KD": [], "K1": [], "K2": []}
    dense = [(p, (p, *v)) for p, v in fields_dense.items()]
    for label, (prefix, arr, data, lens) in dense + list(
            capture_inputs.items()) + list(session_inputs.items()):
        live = lens.clamp(0, data.shape[1]).to(torch.int64)
        a = (arr[f"{prefix}_trans"], arr[f"{prefix}_byteclass"],
             arr[f"{prefix}_start"], data, lens)
        NB = a[0].shape[0]
        acc = arr[f"{prefix}_accept"]
        # the session's delta scans read no group plane
        extra = arr.get("rp_path_gaccept") if prefix == "path" \
            and label not in session_inputs else None
        steps = NB * int(live.sum())
        tables = nbytes(*a[:3]) + flow_bytes(data, lens)
        out = dfa_dense_cuda.dense_scan_cuda(*a, accept=acc, extra=extra)
        kd_bytes = tables + nbytes(acc, extra, *(out if extra is not None
                                                 else (out,)))
        def kd():
            return dfa_dense_cuda.dense_scan_cuda(*a, accept=acc,
                                                  extra=extra)
        rows["KD"].append((label, tuple(a[0].shape) + tuple(data.shape),
                           kernel_device_ms(kd, "dfa_dense_kernel"),
                           time_launch(kd),
                           time_launch(lambda: dfa_dense_cuda.dense_scan_plain(
                               *a, accept=acc, extra=extra), reps=3),
                           *bound(kd_bytes, 2 * steps)))
        if a[0].shape[1] <= 128 and label not in session_inputs:
            def k2():
                return dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*a)
            fin = k2()
            rows["K2"].append((label,
                               tuple(a[0].shape) + tuple(data.shape),
                               kernel_device_ms(k2, "dfa_oblivious_kernel"),
                               time_launch(k2),
                               time_launch(lambda: dfa_oblivious_cuda
                                           .dfa_finals_oblivious_plain(*a),
                                           reps=3),
                               # the one-hot product over every byte:
                               # the trip count is fixed by the shape
                               *bound(tables + nbytes(fin),
                                      2 * NB * data.numel()
                                      * a[0].shape[1] * (a[0].shape[2] + 1),
                                      TENSOR_INT8_OPS_PER_S)))
    for prefix, (arr, data, lens) in fields_nfa.items():
        if f"{prefix}_nfa_follow" not in arr:
            continue
        n = [arr[f"{prefix}_nfa_{k}"] for k in
             ("follow", "acc_cls", "byteclass", "start")] + [data, lens]
        NB, P, _ = n[1].shape
        # D . Follow over every byte after the first (the trip count is
        # fixed by the shape)
        ops = 2 * NB * data.shape[0] * max(data.shape[1] - 1, 0) * P * P
        def k1():
            return nfa_cuda.nfa_finals_cuda(*n)
        fin = k1()
        rows["K1"].append((prefix, (NB, P, n[1].shape[2]) + tuple(data.shape),
                           kernel_device_ms(k1, "nfa_scan_kernel"),
                           time_launch(k1),
                           time_launch(lambda: nfa_cuda.nfa_finals_plain(*n),
                                       reps=3),
                           *bound(nbytes(*n[:4], fin)
                                  + flow_bytes(data, lens), ops,
                                  TENSOR_INT8_OPS_PER_S)))
    for kid, rs in rows.items():
        for prefix, shape, dev_ms, ms, plain_ms, bms, by in rs:
            check(dev_ms is not None, f"{kid} {prefix}: the profiler saw "
                                      f"no launch of the kernel")
            log(f"  {kid} {prefix:12s} {str(shape):30s} device "
                f"{dev_ms:.5f} ms, "
                f"call {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
                f"{bms:.6f} ms by {by}) on {card}")
    return rows


# ------------------------------------------------------ capture replay
def uniquify_flows(flows):
    """Clone flows so every record carries a unique string (query-
    suffixed http path, instance-suffixed kafka client, qname-left
    label): the high-cardinality capture of the reference benchmark's
    ``--capture-cardinality high`` (``bench.py`` ``_uniquify_flows``)."""
    import dataclasses

    for i, f in enumerate(flows):
        if f.http is not None:
            f = dataclasses.replace(f, http=dataclasses.replace(
                f.http, path=f"{f.http.path}?u={i}"))
        elif f.kafka is not None:
            f = dataclasses.replace(f, kafka=dataclasses.replace(
                f.kafka, client_id=f"{f.kafka.client_id}-u{i}"))
        elif f.dns is not None and f.dns.query:
            f = dataclasses.replace(f, dns=dataclasses.replace(
                f.dns, query=f"u{i}.{f.dns.query}"))
        yield f


def write_captures(scenario, policy, cfg, n_records):
    """The scenario's flows repeated to ``n_records``, as written by
    the reference benchmark's capture lane, and the same records made
    unique: each written with the port's writer into a temporary
    directory (never the repo), read back with the port's reader, and
    featurized (host only, no launch)."""
    import tempfile

    import numpy as np

    from cilium_tpu_torch.engine.compiled import CaptureFeaturizer
    from cilium_tpu_torch.ingest import binary

    flows = scenario.flows
    reps = -(-n_records // len(flows))
    low = (flows * reps)[:n_records]
    caps = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, fl in (("low", low), ("high", list(uniquify_flows(low)))):
            path = os.path.join(tmp, f"{kind}.bin")
            t0 = time.perf_counter()
            n = binary.write_capture_l7(path, fl)
            write_s = time.perf_counter() - t0
            check(n == n_records and binary.capture_version(path) == 2
                  and binary.read_gen_sidecar(path) is None,
                  f"{kind} capture: {n} records, v"
                  f"{binary.capture_version(path)}")
            rec = np.array(binary.map_capture(path))
            l7, offsets, blob = binary.read_l7_sidecar(path)
            feat = CaptureFeaturizer(l7, offsets, blob,
                                     policy.kafka_interns, cfg)
            caps[kind] = {"flows": fl, "sections": (rec, l7, offsets, blob),
                          "feat": feat, "bytes": os.path.getsize(path)}
            log(f"  {kind}-cardinality capture: {n} records, "
                f"{caps[kind]['bytes']} bytes, {len(offsets) - 1} strings, "
                f"written in {write_s:.2f}s; table rows "
                f"{ {f: t[0].shape for f, t in feat.tables.items()} }")
    return caps


def capture_inputs_of(arrays, caps):
    """label → (prefix, staged arrays, data, lengths) on the card: each
    field's capture table at its largest B over the two captures, and a
    synthetic L = 1024 batch through the header and path banks."""
    import numpy as np
    import torch

    from cilium_tpu_torch.engine.verdict import _TABLE_FIELDS

    out = {}
    for field, prefix in _TABLE_FIELDS:
        data, lens, _ = max((c["feat"].tables[field] for c in caps.values()),
                            key=lambda t: t[0].shape[0])
        out[f"capture-{prefix}"] = (
            prefix, arrays, torch.from_numpy(data).cuda(),
            torch.from_numpy(lens).cuda())
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, (4096, 1024)).astype(np.uint8)
    lens = rng.integers(0, 1025, (4096,)).astype(np.int32)
    lens[:64] = 1024
    for prefix in ("hdr", "path"):
        out[f"L1024-{prefix}"] = (prefix, arrays,
                                  torch.from_numpy(data).cuda(),
                                  torch.from_numpy(lens).cuda())
    return out


def session_inputs_of(arrays, deltas=SESSION_DELTAS, seed=4):
    """label → (prefix, staged arrays, data, lengths) on the card: a
    session delta scan of B random strings at the field's width L."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = {}
    for prefix, b, l in deltas:
        data = rng.integers(0, 256, (b, l)).astype(np.uint8)
        lens = rng.integers(0, l + 1, (b,)).astype(np.int32)
        lens[:8] = l
        out[f"session-{prefix}-{b}"] = (
            prefix, arrays, torch.from_numpy(data).to(DEVICE),
            torch.from_numpy(lens).to(DEVICE))
    return out


def stage_marks():
    from cilium_tpu_torch.runtime.metrics import (
        CAPTURE_STAGE_SECONDS,
        METRICS,
    )

    return {ph: METRICS.histo_sum(CAPTURE_STAGE_SECONDS, {"phase": ph})
            for ph in STAGE_PHASES}


def force(out) -> None:
    """Forced completion: a two-element read back of the verdict lane
    (the stream is in order, so everything before it has run)."""
    out["verdict"][:2].cpu()


def replay_all(replay, rec, l7):
    """Every chunk of the capture through ``verdict_chunk`` →
    {lane: numpy array} in capture order."""
    import numpy as np

    outs = [replay.verdict_chunk(rec[s:s + REPLAY_CHUNK],
                                 l7[s:s + REPLAY_CHUNK], start=s)
            for s in range(0, len(rec), REPLAY_CHUNK)]
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def assert_lanes(label, got, want, lanes=None):
    import numpy as np

    from cilium_tpu_torch.engine.verdict import OUTPUT_LANES

    for lane in lanes or OUTPUT_LANES:
        a, b = np.asarray(got[lane]), np.asarray(want[lane])
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{label} lane {lane}: {a.shape}/{a.dtype} vs "
              f"{b.shape}/{b.dtype}")
        check(np.array_equal(a, b),
              f"{label} lane {lane} differs in {int((a != b).sum())} rows")


def route_rate(chunk_fn, n_chunks, rows_per_chunk):
    """(median chunk latency ms with forced completion, rows/s): the
    reference benchmark's method — per-chunk latency over
    LATENCY_SAMPLES chunks, then the median of 5 windows that each
    replay the file R× with one forced completion at the end."""
    force(chunk_fn(0))
    lat = []
    for i in range(LATENCY_SAMPLES):
        t0 = time.perf_counter()
        force(chunk_fn(i % n_chunks))
        lat.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    out = None
    for c in range(n_chunks):
        out = chunk_fn(c)
    force(out)
    reps = max(1, int(WINDOW_S / max(time.perf_counter() - t0, 1e-4)))
    windows = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            for c in range(n_chunks):
                out = chunk_fn(c)
        force(out)
        windows.append(time.perf_counter() - t0)
    return (statistics.median(lat),
            reps * n_chunks * rows_per_chunk / statistics.median(windows))


def trace_route(fn, label, card, reps=3):
    """Device kernels and device ms of one replay chunk (profiler), and
    the device's busy share of the chunk's forced wall time."""
    kern = profile_kernels(lambda: force(fn(0)), reps)
    t0 = time.perf_counter()
    force(fn(0))
    wall = (time.perf_counter() - t0) * 1e3
    if not kern:
        log(f"{label} traced: the profiler saw no device time")
        return {}
    dev = sum(ms for _, ms in kern.values()) / reps
    n = sum(c for c, _ in kern.values()) / reps
    log(f"{label} traced: {n:.0f} device kernels, {dev:.4f} ms of device "
        f"time per chunk (busy share {dev / wall:.3f} of a {wall:.4f} ms "
        f"forced chunk) on {card}")
    return {"device_ms": dev, "kernels": n, "busy_share": dev / wall}


def capture_phase(arm, setups, caps, cfg, card):
    """One arm of phase 5 on the low-cardinality capture: the memo, id
    and row routes, each staged as a user stages it; lanes against each
    other, the fused step and (for the memo fill) the plain path."""
    import dataclasses

    import numpy as np
    import torch

    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.engine.replay import CaptureReplay

    setup = setups[CAPTURE_ARMS[arm][0]]
    engine, plain = setup["engine"], setup["plain"]
    rec, l7, offsets, blob = caps["low"]["sections"]
    N = len(rec)
    no_memo = dataclasses.replace(cfg, verdict_memo=False)
    drop = cfg.stage_unique_drop_ratio
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        # the arm's run: counts to 0 just before, read just after
        _build.reset_launches()
        marks = stage_marks()
        t0 = time.perf_counter()
        memo_r = CaptureReplay(engine, l7, offsets, blob, cfg)
        torch.cuda.synchronize()
        tables_forced_ms = (time.perf_counter() - t0) * 1e3
        memo_r.stage_rows(rec, l7)
        ratio = memo_r.stage_unique(drop)
        check(memo_r.row_idx is not None and
              memo_r.row_idx.dtype == np.uint16,
              f"[{arm}] the low-cardinality capture must dedup "
              f"(ratio {ratio})")
        memo_r.stage_unique_device()
        t0 = time.perf_counter()
        m = memo_r.stage_verdict_memo()
        m.table[:2].cpu()
        memo_fill_ms = (time.perf_counter() - t0) * 1e3
        split = {ph: (v - marks[ph]) * 1e3
                 for ph, v in stage_marks().items()}
        lanes = {"memo": replay_all(memo_r, rec, l7)}
        id_r = CaptureReplay(engine, l7, offsets, blob, no_memo)
        id_r.stage_rows(rec, l7)
        id_r.stage_unique(drop)
        lanes["id"] = replay_all(id_r, rec, l7)
        row_r = CaptureReplay(engine, l7, offsets, blob, cfg)
        row_r.stage_rows(rec, l7)
        row_r.stage_unique(drop_if_ratio_at_least=0.0)
        lanes["row"] = replay_all(row_r, rec, l7)
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in _build.KERNELS.items()}
        variants = kd_variants()
    log(f"[capture {arm}] launches {launches}, KD by variant {variants}")
    for kid in CAPTURE_ARMS[arm][1]:
        check(launches[kid] > 0,
              f"[capture {arm}] kernel {kid} never launched")
    if arm == "oblivious":
        check(any("constant-time guarantee" in str(w.message)
                  for w in caught),
              "[capture oblivious] the path table must warn on fallback")
    check(m.misses == memo_r.n_unique and id_r.memo is None
          and row_r.row_idx is None, f"[capture {arm}] route set-up")
    # the fused step on the same flows in capture order: the capture
    # is the scenario's flows repeated, so its lanes repeat too
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        fused = [engine.verdict_batch_arrays(b) for b in setup["batches"]]
    reps = -(-N // sum(len(o["verdict"]) for o in fused))
    want = {k: np.tile(np.concatenate([o[k].cpu().numpy() for o in fused]),
                       reps)[:N] for k in fused[0]}
    for route, got in lanes.items():
        assert_lanes(f"[capture {arm}] {route} route", got, want)
    # the memo's fill over the unique rows against the plain path
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        plain_r = CaptureReplay(plain, l7, offsets, blob, cfg)
        plain_r.stage_rows(rec, l7)
        plain_r.stage_unique(drop)
        plain_m = plain_r.stage_verdict_memo()
    check(np.array_equal(plain_r._uniq_host, memo_r._uniq_host)
          and np.array_equal(plain_r.row_idx, memo_r.row_idx),
          f"[capture {arm}] dedup differs from the plain path's")
    check(torch.equal(m.table.cpu(), plain_m.table),
          f"[capture {arm}] memo fill differs from the plain path's")
    log(f"[capture {arm}] all 10 lanes equal across the memo, id and row "
        f"routes and to the fused step on {N} records; memo fill equal "
        f"to the plain path's on {memo_r.n_unique} unique rows")
    log(f"[capture {arm}] staging split ms "
        f"{ {k: round(v, 3) for k, v in split.items()} } (tables with "
        f"forced completion {tables_forced_ms:.3f} ms, memo fill with "
        f"forced completion {memo_fill_ms:.3f} ms); unique rows "
        f"{memo_r.n_unique}/{N} ({ratio:.5f}) on {card}")
    ids = memo_r.row_idx
    rows_all = row_r.rows_all
    n_chunks = N // REPLAY_CHUNK
    chunk = {
        "memo": lambda c: memo_r.verdict_idx(
            ids[c * REPLAY_CHUNK:(c + 1) * REPLAY_CHUNK]),
        "id": lambda c: id_r.verdict_idx(
            ids[c * REPLAY_CHUNK:(c + 1) * REPLAY_CHUNK]),
        "row": lambda c: row_r.verdict_rows(
            rows_all[c * REPLAY_CHUNK:(c + 1) * REPLAY_CHUNK]),
    }
    rates = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for route, fn in chunk.items():
            lat, rate = route_rate(fn, n_chunks, REPLAY_CHUNK)
            rates[route] = {"chunk_ms": lat, "rows_per_s": rate}
            log(f"[capture {arm}] {route} route: chunk {REPLAY_CHUNK} "
                f"median {lat:.4f} ms forced, {rate:.0f} rows/s (median "
                f"of 5 windows) on {card}")
            rates[route].update(trace_route(
                fn, f"[capture {arm}] {route} route", card))
    return {"launches": launches, "kd_variants": variants,
            "split_ms": split, "rates": rates,
            "unique": memo_r.n_unique, "records": N,
            "tables_forced_ms": tables_forced_ms,
            "memo_fill_ms": memo_fill_ms}


def high_cardinality_phase(setups, caps, cfg, card):
    """Phase 5's high-cardinality pass (gather arm): every record
    unique, so ``stage_unique`` declines at the default ratio and the
    rows stream; lanes on a sample against the plain path."""
    import numpy as np
    import torch

    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.engine.replay import CaptureReplay

    setup = setups["auto"]
    engine, plain = setup["engine"], setup["plain"]
    cap = caps["high"]
    rec, l7, offsets, blob = cap["sections"]
    N = len(rec)
    _build.reset_launches()
    marks = stage_marks()
    r = CaptureReplay(engine, l7, offsets, blob, cfg)
    r.stage_rows(rec, l7)
    ratio = r.stage_unique(cfg.stage_unique_drop_ratio)
    split = {ph: (v - marks[ph]) * 1e3 for ph, v in stage_marks().items()}
    got = replay_all(r, rec, l7)
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in _build.KERNELS.items()}
    variants = kd_variants()
    path_rows = r.feat.tables["path"][0].shape
    log(f"[capture high-cardinality] launches {launches}, KD by variant "
        f"{variants}; path table "
        f"{path_rows}; unique rows {r.n_unique}/{N} ({ratio:.5f})")
    check(launches["KD"] > 0, "[capture high-cardinality] KD never launched")
    check(r.row_idx is None, "[capture high-cardinality] stage_unique "
                             "must decline at the default drop ratio")
    sample = np.sort(np.random.default_rng(3).choice(N, HC_SAMPLE,
                                                     replace=False))
    want = plain.verdict_flows([cap["flows"][i] for i in sample])
    assert_lanes("[capture high-cardinality] sample",
                 {k: v[sample] for k, v in got.items()}, want)
    log(f"[capture high-cardinality] all 10 lanes equal to the plain path "
        f"on a {HC_SAMPLE}-row sample; staging split ms "
        f"{ {k: round(v, 3) for k, v in split.items()} } on {card}")
    rows_all = r.rows_all

    def chunk(c):
        return r.verdict_rows(rows_all[c * REPLAY_CHUNK:
                                       (c + 1) * REPLAY_CHUNK])

    lat, rate = route_rate(chunk, N // REPLAY_CHUNK, REPLAY_CHUNK)
    log(f"[capture high-cardinality] row route: chunk {REPLAY_CHUNK} "
        f"median {lat:.4f} ms forced, {rate:.0f} rows/s (median of 5 "
        f"windows) on {card}")
    row = {"chunk_ms": lat, "rows_per_s": rate,
           **trace_route(chunk, "[capture high-cardinality] row route",
                         card)}
    return {"launches": launches, "kd_variants": variants,
            "split_ms": split, "unique": r.n_unique,
            "records": N, "path_table": list(path_rows),
            "rates": {"row": row}}


# ----------------------------------------------------------- legacy step
def batch_timing(engine, full, label, card):
    """The median of TIMED_BATCHES staged batches after WARMUP (host
    clock around the step and a synchronize), then a separate traced
    run of 5: device kernels and device ms per batch, the busy share
    of the untraced median, and the hand-written kernels' ms per batch.
    Returns (median ms, busy share or None, device kernels per batch or
    None)."""
    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for _ in range(WARMUP):
            engine.verdict_batch_arrays(full)
        torch.cuda.synchronize()
        samples = []
        for _ in range(TIMED_BATCHES):
            t0 = time.perf_counter()
            engine.verdict_batch_arrays(full)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        reps = 5
        kern = profile_kernels(lambda: engine.verdict_batch_arrays(full),
                               reps)
    med = statistics.median(samples)
    log(f"[{label}] batch {BATCH}: median {med:.4f} ms over "
        f"{TIMED_BATCHES} batches (min {min(samples):.4f}, max "
        f"{max(samples):.4f}) = {BATCH / med * 1e3:.0f} verdicts/s "
        f"on {card}")
    if not kern:
        log(f"[{label}] traced: the profiler saw no device time "
            f"(device busy share not measured)")
        return med, None, None
    dev_ms = sum(ms for _, ms in kern.values()) / reps
    n_launch = sum(n for n, _ in kern.values()) / reps
    ours = {sym: round(sum(ms for k, (_, ms) in kern.items()
                           if sym in k) / reps, 5)
            for sym in ("dfa_dense_kernel", "nfa_scan_kernel",
                        "dfa_oblivious_kernel")}
    log(f"[{label}] traced: {n_launch:.0f} device kernels per batch, "
        f"{dev_ms:.4f} ms of device time per batch (busy share "
        f"{dev_ms / med:.3f} of the untraced median); hand-written "
        f"kernels ms/batch {ours}")
    return med, dev_ms / med, n_launch


def legacy_phase(per_identity, base_cfg, setups, scenario, card):
    """Phase 6: the legacy step, a degenerate plan and the blob
    transport against the fused step on the http-1000 batches."""
    import dataclasses

    import numpy as np
    import torch

    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.engine import megakernel as mk
    from cilium_tpu_torch.engine.compiled import CompiledPolicy
    from cilium_tpu_torch.engine.verdict import (
        OUTPUT_LANES,
        TorchVerdictEngine,
    )

    fused = setups["auto"]
    os.environ["CILIUM_TPU_DFA_IMPL"] = "gather"

    def run(engine):
        outs = [engine.verdict_batch_arrays(b) for b in fused["batches"]]
        return {k: np.concatenate([o[k].cpu().numpy() for o in outs])
                for k in outs[0]}

    want = run(fused["engine"])
    launches = {}
    cfg_l = dataclasses.replace(base_cfg, kernel_impl="legacy")
    legacy = TorchVerdictEngine(CompiledPolicy.build(per_identity, cfg_l),
                                device=DEVICE, cfg=cfg_l)
    check(legacy.impl_plan == {}, "legacy engine staged a plan")
    _build.reset_launches()
    got = run(legacy)
    launches["legacy"] = {k: v.launches for k, v in _build.KERNELS.items()}
    variants = {"legacy": kd_variants()}
    assert_lanes("[legacy] kernel_impl=legacy", got, want)

    cap = mk.GROUP_CAP
    mk.GROUP_CAP = 1
    try:
        pol_d = CompiledPolicy.build(per_identity, base_cfg)
    finally:
        mk.GROUP_CAP = cap
    check(pol_d.resolve_meta is None and "rp_g_method" not in pol_d.arrays,
          "GROUP_CAP=1 left a resolve plan")
    degen = TorchVerdictEngine(pol_d, device=DEVICE, cfg=base_cfg)
    _build.reset_launches()
    got_d = run(degen)
    launches["degenerate-plan"] = {k: v.launches
                                   for k, v in _build.KERNELS.items()}
    variants["degenerate-plan"] = kd_variants()
    want_d = [TorchVerdictEngine(pol_d, device="cpu", cfg=base_cfg)
              .verdict_batch_arrays(b) for b in fused["host_cpu"]]
    assert_lanes("[legacy] degenerate plan vs its plain path", got_d,
                 {k: np.concatenate([o[k].numpy() for o in want_d])
                  for k in want_d[0]})
    # l7_match names a rule here (no rule → group map staged) and a
    # group under the plan; every other lane equals the fused step's
    assert_lanes("[legacy] degenerate plan vs fused", got_d, want,
                 [k for k in OUTPUT_LANES if k != "l7_match"])

    _build.reset_launches()
    flows = scenario.flows
    got_b = {}
    for lo in range(0, len(flows), BATCH):
        o = fused["engine"].verdict_flows_blob(flows[lo:lo + BATCH])
        for k, v in o.items():
            got_b.setdefault(k, []).append(v)
    torch.cuda.synchronize()
    launches["blob"] = {k: v.launches for k, v in _build.KERNELS.items()}
    variants["blob"] = kd_variants()
    assert_lanes("[legacy] verdict_flows_blob",
                 {k: np.concatenate(v) for k, v in got_b.items()}, want)
    for name, ln in launches.items():
        check(ln["KD"] > 0, f"[legacy] {name}: KD never launched")
    log(f"[legacy] all 10 lanes equal to the fused step for "
        f"kernel_impl=legacy and verdict_flows_blob, and to the plain "
        f"path for the degenerate plan (its other 9 lanes equal the "
        f"fused step's) on {len(want['verdict'])} flows; launches "
        f"{launches}")
    full = fused["full"]
    timing = {"legacy": batch_timing(legacy, full, "legacy step", card),
              "fused": batch_timing(fused["engine"], full, "fused step",
                                    card),
              "degenerate-plan": batch_timing(degen, full,
                                              "degenerate plan", card)}
    return {"launches": launches, "kd_variants": variants, "timing": timing,
            "blob": blob_route_kernels(fused["engine"], flows, card)}


def blob_route_kernels(engine, flows, card):
    """Device kernels and device ms per batch of the blob route: the
    fused step over a [B, W] u8 blob staged on the card and unpacked
    there, whose byte fields and length columns KD reads in place
    (profiler, 5 batches)."""
    import torch

    from cilium_tpu_torch.engine.compiled import (
        encode_flows,
        flowbatch_to_host_dict,
        pack_blob_host,
    )
    from cilium_tpu_torch.engine.verdict import unpack_blob

    blob, layout = pack_blob_host(flowbatch_to_host_dict(
        encode_flows(flows[:BATCH], engine.policy.kafka_interns, None)))
    blob = torch.from_numpy(blob).to(DEVICE)
    kern = profile_kernels(
        lambda: engine.verdict_batch_arrays(unpack_blob(blob, layout)), 5)
    if not kern:
        log("[blob route] traced: the profiler saw no device time")
        return {}
    out = {"device_kernels": sum(n for n, _ in kern.values()) / 5,
           "device_ms": sum(ms for _, ms in kern.values()) / 5,
           "kd_launches": sum(n for k, (n, _) in kern.items()
                              if "dfa_dense_kernel" in k) / 5}
    log(f"[blob route] traced: {out['device_kernels']:.0f} device kernels "
        f"per batch of {BATCH} ({out['kd_launches']:.0f} of them KD), "
        f"{out['device_ms']:.4f} ms of device time per batch on {card}")
    return out


# ---------------------------------------------------------- online serving
class StubLoader:
    """What the serve loop reads of a loader: its engine."""

    def __init__(self, engine):
        self.engine = engine


def chunk_sections(flows):
    """Capture sections of one stream chunk (the unit a stream submits,
    as the reference's stream transport ships it)."""
    from cilium_tpu_torch.ingest import binary

    return binary.capture_from_bytes(binary.capture_to_bytes(flows))


def serve_loop(engine, **kw):
    """A serve loop over ``engine`` with SERVE_STREAMS leases granted
    (a lease TTL longer than the phase: no lease lapses mid-pass)."""
    from cilium_tpu_torch.runtime.serveloop import ServeLoop

    loop = ServeLoop(StubLoader(engine), capacity=SERVE_STREAMS,
                     lease_ttl_s=600.0, **kw)
    leases = [loop.connect(f"s{i}") for i in range(SERVE_STREAMS)]
    return loop, leases


def ticket_lanes(tickets):
    """The served lanes of resolved tickets, concatenated."""
    import numpy as np

    return {k: np.concatenate([getattr(t.prov, k) for t in tickets])
            for k in ("verdict", "l7_match", "match_spec")}


def trace_once(fn):
    """(device kernels, device ms, wall ms) of one call of ``fn``, all
    three from the same traced call (profiler on, so the wall includes
    its overhead); kernels and device ms are None when the profiler saw
    no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages()
          if "CUDA" in str(getattr(e, "device_type", ""))]
    if not ev:
        return None, None, wall_ms
    return (sum(e.count for e in ev),
            sum(getattr(e, "self_device_time_total", 0.0) for e in ev) / 1e3,
            wall_ms)


@contextlib.contextmanager
def delta_scans_noted(arrays, shapes):
    """While open, append (field prefix, bank shape, B, L) of every
    delta scan the incremental session launches to ``shapes``: the
    session's scan call is wrapped, and runs unchanged."""
    from cilium_tpu_torch.engine import session

    scan = session.dfa_scan_banked
    prefix_of = {id(v): k[:-len("_trans")] for k, v in arrays.items()
                 if k.endswith("_trans")}

    def noted(trans, byteclass, start, accept, data, lens):
        shapes.append((prefix_of[id(trans)], tuple(trans.shape),
                       *data.shape))
        return scan(trans, byteclass, start, accept, data, lens)

    session.dfa_scan_banked = noted
    try:
        yield
    finally:
        session.dfa_scan_banked = scan


def serve_phase(setups, scenario, card):
    """Phase 7: online serving through the port's serve loop on the
    ``auto`` engine — cold, warm, plain, growth and thread passes. The
    launch counts cover the serving passes alone: the direct steps the
    passes are held against run before the counts are set to 0. Returns
    the counts, the growth pass's delta-scan shapes (KD is held and
    timed at them outside this phase's count) and the report."""
    import numpy as np
    import torch

    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.engine.attribution import (
        AttributionMap,
        flow_family,
    )
    from cilium_tpu_torch.runtime.serveloop import ShedError

    t_phase = time.perf_counter()
    engine, plain = setups["auto"]["engine"], setups["auto"]["plain"]
    flows = scenario.flows
    N = len(flows)
    direct = engine.verdict_flows(flows)
    lanes = ("verdict", "l7_match", "match_spec")
    # the warm stream: the flows repeated; a chunk's records depend only
    # on its start modulo N, so its sections are built once
    cache = {}

    def warm_chunk(c):
        s = (c * SERVE_CHUNK) % N
        if s not in cache:
            cache[s] = chunk_sections([flows[(s + i) % N]
                                       for i in range(SERVE_CHUNK)])
        return s, cache[s]

    def want_of(s, n):
        return {k: np.asarray(direct[k])[(s + np.arange(n)) % N]
                for k in lanes}

    # the growth pass's flows: unique paths, each in GROWTH_REPEAT
    # consecutive records, past the path table's cap; their direct
    # verdicts, a batch at a time
    copies = GROWTH_MAX_STRINGS // N + 1
    unique = list(uniquify_flows(flows * copies))
    uflows = [f for f in unique for _ in range(GROWTH_REPEAT)]
    ucheck = {}
    for lo in range(0, len(unique), BATCH):
        o = engine.verdict_flows(unique[lo:lo + BATCH])
        for k in lanes:
            ucheck.setdefault(k, []).append(np.asarray(o[k]))
    udirect = {k: np.repeat(np.concatenate(v), GROWTH_REPEAT)
               for k, v in ucheck.items()}
    # every chunk's sections (host featurize, set-up)
    cold = [chunk_sections(flows[s:s + SERVE_CHUNK])
            for s in range(0, N, SERVE_CHUNK)]
    n_chunks = SERVE_WARM_RECORDS // SERVE_CHUNK
    for c in range(n_chunks):
        warm_chunk(c)
    ucache = [(s, chunk_sections(uflows[s:s + SERVE_CHUNK]))
              for s in range(0, len(uflows), SERVE_CHUNK)]

    out = {"card": card, "streams": SERVE_STREAMS, "chunk": SERVE_CHUNK}
    # the serving passes' run: counts to 0 just before, read just after
    torch.cuda.synchronize()
    _build.reset_launches()
    t_serve = time.perf_counter()

    # -- cold: the scenario's flows once, one pack
    loop, leases = serve_loop(engine, provenance=True)
    tickets = [loop.submit(leases[k % SERVE_STREAMS], *sec)
               for k, sec in enumerate(cold)]
    t0 = time.perf_counter()
    served = loop.step()
    cold_ms = (time.perf_counter() - t0) * 1e3
    check(served == N and all(t.done and t.error is None for t in tickets),
          f"[serve cold] {served} of {N} records served")
    got = ticket_lanes(tickets)
    assert_lanes("[serve cold] vs the direct step", got, direct, lanes)
    amap = AttributionMap.from_policy(engine.policy)
    codes = got["l7_match"]
    unresolved = sum(1 for i in np.nonzero(codes >= 0)[0]
                     if amap.resolve(flow_family(flows[i]),
                                     int(codes[i])) is None)
    check(unresolved == 0, f"[serve cold] {unresolved} attribution codes "
                           f"do not resolve")
    memo = loop.ring.session.memo
    out["cold"] = {"records": N, "chunks": len(cold),
                   "unique_rows": loop.ring.session.n_rows,
                   "pack_ms": cold_ms, "memo_misses": memo.misses,
                   "codes_resolved": int((codes >= 0).sum())}
    # its kernels: a fresh ring's cold pack, traced
    tl, tleases = serve_loop(engine, provenance=True)
    for k, sec in enumerate(cold):
        tl.submit(tleases[k % SERVE_STREAMS], *sec)
    kern, dev_ms, tr_ms = trace_once(tl.step)
    out["cold"].update(device_kernels=kern, device_ms=dev_ms,
                       traced_pack_ms=tr_ms,
                       busy_share=None if dev_ms is None else dev_ms / tr_ms)
    log(f"[serve cold] {N} records in {len(cold)} chunks over "
        f"{SERVE_STREAMS} leases: one pack of {cold_ms:.3f} ms, "
        f"{out['cold']['unique_rows']} unique rows; verdict, l7_match and "
        f"match_spec equal to the direct step; "
        f"{out['cold']['codes_resolved']} attribution codes resolve; "
        f"traced cold pack {kern} device kernels, {dev_ms} ms of device "
        f"time in {tr_ms:.3f} ms, busy share {out['cold']['busy_share']} "
        f"on {card}")

    # -- warm: the flows repeated to SERVE_WARM_RECORDS, waves of one
    # chunk per lease, step() until drained
    ring = loop.ring
    misses0, shipped0, saved0, hits0 = (memo.misses, ring.bytes_shipped,
                                        ring.bytes_saved, memo.hits)
    warm, packs = [], []
    t_all = time.perf_counter()
    for w0 in range(0, n_chunks, SERVE_STREAMS):
        for c in range(w0, min(n_chunks, w0 + SERVE_STREAMS)):
            s, sec = warm_chunk(c)
            warm.append((s, loop.submit(leases[c % SERVE_STREAMS], *sec)))
        while not all(t.done for _, t in warm):
            t0 = time.perf_counter()
            n = loop.step()
            packs.append(((time.perf_counter() - t0) * 1e3, n))
    wall = time.perf_counter() - t_all
    records = n_chunks * SERVE_CHUNK
    check(all(t.error is None for _, t in warm), "[serve warm] errors")
    for s, t in warm:
        if not np.array_equal(t.verdicts, want_of(s, t.n)["verdict"]):
            raise SmokeFailure(f"[serve warm] chunk at {s} differs from "
                               f"the direct step")
    check(memo.misses == misses0,
          f"[serve warm] {memo.misses - misses0} memo misses")
    check(ring.bytes_shipped - shipped0 == 4 * records,
          f"[serve warm] {ring.bytes_shipped - shipped0} bytes shipped for "
          f"{records} records (4 each expected)")
    pack_ms = statistics.median(p for p, _ in packs)
    out["warm"] = {
        "records": records, "packs": len(packs),
        "pack_ms_median": pack_ms,
        "records_per_pack": statistics.median(n for _, n in packs),
        "records_per_s": records / wall,
        "pack_records_per_s": records / (sum(p for p, _ in packs) / 1e3),
        "memo_hits": memo.hits - hits0, "memo_misses": memo.misses - misses0,
        "bytes_saved": ring.bytes_saved - saved0,
        "bytes_shipped": ring.bytes_shipped - shipped0}
    # a separate traced pack of one full wave
    for c in range(SERVE_STREAMS):
        loop.submit(leases[c], *warm_chunk(c)[1])
    kern, dev_ms, tr_ms = trace_once(loop.step)
    out["warm"].update(device_kernels=kern, device_ms=dev_ms,
                       traced_pack_ms=tr_ms,
                       busy_share=None if dev_ms is None else dev_ms / tr_ms)
    log(f"[serve warm] {records} records, {len(packs)} packs: median pack "
        f"{pack_ms:.3f} ms, {out['warm']['records_per_pack']:.0f} records "
        f"per pack, {out['warm']['records_per_s']:.0f} records/s submit to "
        f"verdict ({out['warm']['pack_records_per_s']:.0f} in the packs); "
        f"memo hits {out['warm']['memo_hits']}, misses 0; bytes saved "
        f"{out['warm']['bytes_saved']}, shipped "
        f"{out['warm']['bytes_shipped']} (4 a record); traced pack {kern} "
        f"device kernels, {dev_ms} ms of device time in {tr_ms:.3f} ms, "
        f"busy share {out['warm']['busy_share']} on {card}")

    # -- plain: a sample of the warm traffic through a ring on the CPU
    pl, pleases = serve_loop(plain, provenance=True)
    n_s = SERVE_PLAIN_SAMPLE // SERVE_CHUNK
    pt = [pl.submit(pleases[c], *warm_chunk(c)[1]) for c in range(n_s)]
    pl.step()
    assert_lanes("[serve plain] the card's warm lanes vs a ring on the CPU",
                 ticket_lanes([t for _, t in warm[:n_s]]), ticket_lanes(pt),
                 lanes)
    log(f"[serve plain] {n_s * SERVE_CHUNK} records of the warm traffic: "
        f"the ring on the CPU serves the card's lanes")

    # -- growth: the unique paths until the path table passes the cap
    gl, gleases = serve_loop(engine, provenance=True)
    sess = gl.ring.session
    sess.max_strings = GROWTH_MAX_STRINGS
    shapes, done, stale = [], [], []
    todo = list(ucache)
    k = 0
    with delta_scans_noted(engine._arrays, shapes):
        # wave A: until the path table reaches the cap. The pack takes
        # the first PACK_MAX records, but the flush scans every pending
        # string: the largest delta a flush can hold. The chunks left in
        # the slots were encoded before the reset the next submit
        # triggers
        while todo and sess.tables["path"].n < GROWTH_MAX_STRINGS:
            s, sec = todo.pop(0)
            done.append((s, gl.submit(gleases[k % SERVE_STREAMS], *sec)))
            k += 1
        gl.step()
        # wave B: the rest, from a fresh session
        for s, sec in todo:
            done.append((s, gl.submit(gleases[k % SERVE_STREAMS], *sec)))
            k += 1
        gl.step()
        check(sess.resets == 1, f"[serve growth] {sess.resets} resets (1 "
                                f"expected)")
        for s, t in done:
            if t.error is not None:
                check(t.error == "session-reset",
                      f"[serve growth] chunk at {s}: {t.error}")
                stale.append(s)
        check(stale, "[serve growth] no chunk was orphaned by the reset")
        redo = [(s, gl.submit(gleases[i % SERVE_STREAMS],
                              *dict(ucache)[s]))
                for i, s in enumerate(stale)]
        gl.step()
    check(sess.resets == 1, "[serve growth] a second reset")
    for s, t in [d for d in done if d[1].error is None] + redo:
        if not np.array_equal(t.verdicts,
                              udirect["verdict"][s:s + t.n]):
            raise SmokeFailure(f"[serve growth] chunk at {s} differs from "
                               f"the direct step")
    out["growth"] = {
        "records": len(uflows), "unique_paths": len(unique),
        "resets": sess.resets, "stale_chunks": len(stale)}
    log(f"[serve growth] {len(uflows)} records, {len(unique)} unique "
        f"paths: 1 session reset, {len(stale)} chunks resolved "
        f"session-reset and served when resubmitted; all verdicts equal "
        f"the direct step; delta scans (prefix, bank, B, L): {shapes}")

    # -- thread: the pack thread against concurrent submitters
    kd0 = _build.KERNELS["KD"].launches
    th, tleases = serve_loop(engine, provenance=False,
                             pack_interval_s=0.002)
    per = SERVE_STREAMS // SERVE_THREADS
    results = [[] for _ in range(SERVE_THREADS)]
    sheds = [0] * SERVE_THREADS
    deadline = time.perf_counter() + SERVE_THREAD_S

    def submitter(i):
        c = i
        while time.perf_counter() < deadline:
            s, sec = warm_chunk(c)
            try:
                t = th.submit(tleases[i * per + (c // SERVE_THREADS) % per],
                              *sec)
            except ShedError:
                sheds[i] += 1
                time.sleep(0.001)
                continue
            results[i].append((s, t))
            c += SERVE_THREADS

    import threading

    th.start()
    t0 = time.perf_counter()
    try:
        workers = [threading.Thread(target=submitter, args=(i,))
                   for i in range(SERVE_THREADS)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        for rs in results:
            for s, t in rs:
                v = t.wait(timeout=120.0)
                if not np.array_equal(v, want_of(s, t.n)["verdict"]):
                    raise SmokeFailure(f"[serve thread] chunk at {s} "
                                       f"differs from the direct step")
    finally:
        th.stop()
    t_wall = time.perf_counter() - t0
    n_rec = sum(t.n for rs in results for _, t in rs)
    kd_thread = _build.KERNELS["KD"].launches - kd0
    check(th.pack_failures == 0, f"[serve thread] {th.pack_failures} "
                                 f"pack failures")
    check(kd_thread > 0, "[serve thread] KD never launched from the pack "
                         "thread")
    out["thread"] = {"records": n_rec, "packs": th.ring.packs,
                     "wall_s": t_wall, "records_per_s": n_rec / t_wall,
                     "sheds": sum(sheds), "kd_launches": kd_thread}
    log(f"[serve thread] {SERVE_THREADS} submitters over {per} leases "
        f"each for {SERVE_THREAD_S} s, pack thread on: {n_rec} records in "
        f"{th.ring.packs} packs, {t_wall:.3f} s to the last verdict "
        f"({n_rec / t_wall:.0f} records/s), {sum(sheds)} queue-full sheds "
        f"retried, KD launched {kd_thread} times from the pack thread; "
        f"every verdict equal to the direct step on {card}")

    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in _build.KERNELS.items()}
    variants = kd_variants()
    out["serve_wall_s"] = time.perf_counter() - t_serve
    check(launches["KD"] > 0, "[serve] kernel KD never launched")
    out["setup_wall_s"] = t_serve - t_phase
    log(f"[serve] serving passes: launches {launches}, KD by variant "
        f"{variants}, {out['serve_wall_s']:.1f} s (set-up "
        f"{out['setup_wall_s']:.1f} s)")
    return {"launches": launches, "kd_variants": variants,
            "delta_shapes": shapes, "report": out}


def growth_kd(errs, rows, arrays, serve, card):
    """KD at the growth pass's delta shapes, through phases 3 and 4's
    code and outside the serve count: the shapes SESSION_DELTAS lacks
    are held against the plain version and timed here (their rows join
    ``rows``); the serve report gains KD's device ms at every delta
    scan of the pass, and is returned."""
    deltas = sorted({(p, b, l) for p, _, b, l in serve["delta_shapes"]}
                    - set(SESSION_DELTAS))
    log(f"phase 7: KD at the growth pass's delta shapes {deltas}, against "
        f"its plain version")
    inputs = session_inputs_of(arrays, deltas, seed=5)
    session_check(errs, inputs)
    rows["KD"].extend(kernel_times({}, {}, {}, inputs, card)["KD"])
    kd_ms = {r[0]: r[2] for r in rows["KD"]}
    report = serve["report"]
    report["growth"]["delta_scans"] = [
        [p, list(bank), b, l, kd_ms[f"session-{p}-{b}"]]
        for p, bank, b, l in serve["delta_shapes"]]
    log(f"[serve growth] KD device ms at each delta scan (prefix, bank, "
        f"B, L, ms; exact): {report['growth']['delta_scans']} on {card}")
    return report


def kd_variants():
    """KD's launches by variant since the counts were last set to 0."""
    from cilium_tpu_torch.engine import _build

    return dict(_build.KERNELS["KD"].launches_by_variant)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from cilium_tpu_torch.engine import _build  # noqa: F401 (fails alone)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    check(bool(smi), "nvidia-smi printed nothing")
    card = smi.splitlines()[0]
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    log("phase 2: build")
    secs = _build.build()
    log(f"  built {len(_build.KERNELS)} kernels in {secs:.1f}s "
        f"(nvcc in parallel)")
    tensor_ops = sass_tensor_ops()
    kd_sass = sass_kd()

    log("set-up: the http-1000 policy, staged under each configuration")
    per_identity, scenario, cfg = build_policy()
    setups = {name: setup_config(name, per_identity, scenario, cfg)
              for name in CONFIGS}

    log(f"set-up: phase 5's {CAPTURE_RECORDS}-record captures")
    auto_engine = setups["auto"]["engine"]
    caps = write_captures(scenario, auto_engine.policy, cfg,
                          CAPTURE_RECORDS)
    capture_inputs = capture_inputs_of(auto_engine._arrays, caps)
    session_inputs = session_inputs_of(auto_engine._arrays)

    log("phase 3: kernels against their plain versions (exact)")
    errs = {}
    dense_fields = field_inputs_of(auto_engine, setups["auto"]["full"])
    nfa_fields = field_inputs_of(setups["nfa-bitset"]["engine"],
                                 setups["nfa-bitset"]["full"])
    edge_variants = kernel_phase(
        errs, {**dense_fields, **{p: v for p, v in nfa_fields.items()
                                  if f"{p}_nfa_follow" in v[0]}},
        capture_inputs, session_inputs)
    log("phase 3: K2 and K1 timing against the input (data-oblivious)")
    oblivious = timing_independence(dense_fields, nfa_fields, card)

    reports = {}
    for name in CONFIGS:
        log(f"phase 4: main path [{name}]")
        reports[name] = drive_config(name, setups[name],
                                     len(scenario.flows), card)
    kd_plan_check(auto_engine._arrays, dense_fields["path"][1],
                  reports["auto"]["kd_variants"], edge_variants)

    log("phase 4: one launch per kernel at the http-1000 shapes and the "
        "capture shapes")
    rows = kernel_times(dense_fields, nfa_fields, capture_inputs,
                        session_inputs, card)

    captures = {}
    for arm in CAPTURE_ARMS:
        log(f"phase 5: capture replay [{arm}]")
        captures[arm] = capture_phase(arm, setups, caps, cfg, card)
    log("phase 5: capture replay [high cardinality]")
    captures["high-cardinality"] = high_cardinality_phase(setups, caps, cfg,
                                                          card)
    log("phase 6: legacy step")
    legacy = legacy_phase(per_identity, cfg, setups, scenario, card)
    log("phase 7: online serving")
    t7 = time.perf_counter()
    serve = serve_phase(setups, scenario, card)
    report = growth_kd(errs, rows, auto_engine._arrays, serve, card)
    report["wall_s"] = time.perf_counter() - t7
    log(f"phase 7 wall {report['wall_s']:.1f} s")
    phase_launches = {n: r["launches"] for n, r in reports.items()}
    phase_launches.update({f"capture-{arm}": r["launches"]
                           for arm, r in captures.items()})
    phase_launches.update(legacy["launches"])
    phase_launches["serve"] = serve["launches"]
    phase_variants = {n: r["kd_variants"] for n, r in reports.items()}
    phase_variants.update({f"capture-{arm}": r["kd_variants"]
                           for arm, r in captures.items()})
    phase_variants.update(legacy["kd_variants"])
    phase_variants["serve"] = serve["kd_variants"]
    # the JSON line reports each kernel at its largest main-path shape
    pick = {"KD": "path", "K1": "host", "K2": "host"}
    kernels = []
    for kid, k in _build.KERNELS.items():
        row = next(r for r in rows[kid] if r[0] == pick[kid])
        kernels.append({
            "name": f"{kid}:{k.name}", "route": "cuda",
            "source": f"cilium_tpu_torch/engine/csrc/{k.source}",
            "replaces": k.replaces,
            "launches": sum(ln[kid] for ln in phase_launches.values()),
            "phases": {n: ln[kid] for n, ln in phase_launches.items()
                       if ln[kid]},
            "max_abs_err": errs[kid],
            # ms: device time of one launch (profiler); call_ms: wall
            # time per call from Python, wrapper included
            "ms": row[2],
            "call_ms": row[3], "plain_ms": row[4], "bound_ms": row[5],
            "bound_by": row[6], "library_ms": None,
            "bound_ops": BOUND_OPS[kid],
            "sass_tensor_ops": tensor_ops.get(kid),
            # KD: launches by variant in each phase, in phase 3's edge
            # cases, and the bulk copies and shared loads in its SASS
            **({"variants": {n: v for n, v in phase_variants.items() if v},
                "edge_variants": edge_variants, "sass": kd_sass}
               if kid == "KD" else {}),
            "timing_ratio": oblivious[kid][2] if kid in oblivious else None,
            # (NB, S or P, K, B, L) of the launch the times are from
            "shape": f"{pick[kid]} {row[1]}",
            "batch_ms": {n: r["batch_ms"] for n, r in reports.items()},
            "device_busy_share": {n: r["busy_share"]
                                  for n, r in reports.items()},
            # each row: (label, (NB, S|P, K, B, L), device ms, call ms,
            # plain ms, bound ms, bound by), capture shapes included
            "shapes": [list(r) for r in rows[kid]],
        })
    log("replay: " + json.dumps({
        "captures": {a: {k: v for k, v in r.items() if k != "launches"}
                     for a, r in captures.items()},
        "legacy_timing": legacy["timing"], "blob_route": legacy["blob"],
        "batch_device_kernels": {n: r["device_kernels"]
                                 for n, r in reports.items()},
        "card": card}))
    log("serve: " + json.dumps(report))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        rc = 1
    sys.exit(rc)
