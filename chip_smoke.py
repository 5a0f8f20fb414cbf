"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero before the result line):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the hand-written kernels (KD, K1, K2) from
   ``cilium_tpu_torch/engine/csrc`` — one nvcc per source, in parallel —
   and check in their SASS (``cuobjdump``) that every instantiation of
   K1 and K2 issues tensor-core instructions (HMMA, HGMMA);
3. kernel phase: each kernel against its plain PyTorch version on the
   card, exactly, on random banks (0/1/128 positions, 128 states,
   zero-length rows, batches that are not a multiple of the block), on
   the tile edges of the tensor-core kernels K1 and K2 (with random,
   all-zero and all-full lengths) and on the http-1000 policy's own
   banks; then K2 and K1 timed at the http-1000 host shape on random
   bytes and on one repeated byte at full length: their times must
   agree within 1.25x (the data-oblivious property of the reference
   kernels);
4. main path: the http scenario at 1000 rules x 10000 flows, bank size
   128, batches of 8192, under ``auto``, ``nfa-bitset`` and the
   oblivious DFA. Each configuration is verdicted once with every
   launch count set to 0 just before and read just after (a kernel of
   the configuration's path that never launched fails the run); all ten
   output lanes are held equal to the port's plain-version path
   (``device="cpu"``) on the same batches; the verdict mix must be a
   plausible allow/deny split; then the median batch time over 25
   timed batches after warm-up, and each kernel's time for one launch
   at the shapes of every field it scans;
5. one JSON line ``{"kernels": [...]}``, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX. Run it from the root of a checkout: it
imports ``cilium_tpu_torch`` from the directory it lives in.
"""

from __future__ import annotations

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


def kernel_phase(errs, field_inputs):
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
        e = max_err(got, want)
        errs[kid] = max(errs.get(kid, 0.0), e)
        check(e == 0.0, f"{kid} disagrees with its plain version on "
                        f"{what}: max abs err {e}")
        log(f"  {kid} {what}: exact")

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
            "batches": batches, "full": batches[0]}


def drive_config(name, setup, n_flows, card):
    """One configuration of the main path; returns its report."""
    import numpy as np
    import torch

    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.engine.verdict import OUTPUT_LANES, batch_to_device

    _, dfa_impl, path_kernels = CONFIGS[name]
    engine, plain = setup["engine"], setup["plain"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        # the main path's run: counts to 0 just before, read just after
        _build.reset_launches()
        outs = [engine.verdict_batch_arrays(b) for b in setup["batches"]]
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in _build.KERNELS.items()}
        want = [plain.verdict_batch_arrays(batch_to_device(h, "cpu"))
                for h in setup["host"]]
    log(f"[{name}] impl_plan {json.dumps(engine.impl_plan, sort_keys=True)}"
        f" CILIUM_TPU_DFA_IMPL={dfa_impl} launches {launches}")
    for kid in path_kernels:
        check(launches[kid] > 0,
              f"[{name}] kernel {kid} never launched on the main path")
    if dfa_impl == "pallas":
        check(any("constant-time guarantee" in str(w.message)
                  for w in caught),
              f"[{name}] the >128-state path stack must warn on fallback")
    for lane in OUTPUT_LANES:
        got = np.concatenate([o[lane].cpu().numpy() for o in outs])
        ref = np.concatenate([o[lane].numpy() for o in want])
        check(got.shape == (n_flows,) and got.dtype == ref.dtype,
              f"[{name}] lane {lane}: shape {got.shape} dtype {got.dtype}")
        check(np.array_equal(got, ref),
              f"[{name}] lane {lane} differs from the plain-version path "
              f"in {int((got != ref).sum())} flows")
    verdicts = np.concatenate([o["verdict"].cpu().numpy() for o in outs])
    mix = np.bincount(verdicts, minlength=6).tolist()
    log(f"[{name}] all 10 lanes equal to the plain path on "
        f"{len(verdicts)} flows; verdict mix [code 0..5] {mix}")
    check(mix[5] > 0.2 * n_flows and mix[2] > 0.2 * n_flows,
          f"[{name}] implausible verdict mix {mix} (identity wiring?)")

    full = setup["full"]
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
    med = statistics.median(samples)
    log(f"[{name}] batch {BATCH}: median {med:.4f} ms over "
        f"{TIMED_BATCHES} batches (min {min(samples):.4f}, max "
        f"{max(samples):.4f}) = {BATCH / med * 1e3:.0f} verdicts/s "
        f"on {card}")
    # a separate traced run: device kernel time and launches per batch
    reps = 5
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        kern = profile_kernels(lambda: engine.verdict_batch_arrays(full),
                               reps)
    busy = None
    if kern:
        dev_ms = sum(ms for _, ms in kern.values()) / reps
        n_launch = sum(n for n, _ in kern.values()) / reps
        ours = {sym: round(sum(ms for k, (_, ms) in kern.items()
                               if sym in k) / reps, 5)
                for sym in ("dfa_dense_kernel", "nfa_scan_kernel",
                            "dfa_oblivious_kernel")}
        busy = dev_ms / med
        log(f"[{name}] traced: {n_launch:.0f} device kernels per batch, "
            f"{dev_ms:.4f} ms of device time per batch (busy share "
            f"{busy:.3f} of the untraced median); hand-written kernels "
            f"ms/batch {ours}")
    else:
        log(f"[{name}] traced: the profiler saw no device time "
            f"(device busy share not measured)")
    return {"launches": launches, "batch_ms": med, "mix": mix,
            "busy_share": busy}


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


def kernel_times(fields_dense, fields_nfa, card):
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
    for prefix, (arr, data, lens) in fields_dense.items():
        live = lens.clamp(0, data.shape[1]).to(torch.int64)
        a = (arr[f"{prefix}_trans"], arr[f"{prefix}_byteclass"],
             arr[f"{prefix}_start"], data, lens)
        NB = a[0].shape[0]
        acc = arr[f"{prefix}_accept"]
        extra = arr.get("rp_path_gaccept") if prefix == "path" else None
        steps = NB * int(live.sum())
        tables = nbytes(*a[:3]) + flow_bytes(data, lens)
        out = dfa_dense_cuda.dense_scan_cuda(*a, accept=acc, extra=extra)
        kd_bytes = tables + nbytes(acc, extra, *(out if extra is not None
                                                 else (out,)))
        def kd():
            return dfa_dense_cuda.dense_scan_cuda(*a, accept=acc,
                                                  extra=extra)
        rows["KD"].append((prefix, tuple(a[0].shape),
                           kernel_device_ms(kd, "dfa_dense_kernel"),
                           time_launch(kd),
                           time_launch(lambda: dfa_dense_cuda.dense_scan_plain(
                               *a, accept=acc, extra=extra), reps=3),
                           *bound(kd_bytes, 2 * steps)))
        if a[0].shape[1] <= 128:
            def k2():
                return dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*a)
            fin = k2()
            rows["K2"].append((prefix, tuple(a[0].shape),
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
        rows["K1"].append((prefix, (NB, P, n[1].shape[2]),
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
            log(f"  {kid} {prefix:6s} {str(shape):16s} device "
                f"{dev_ms:.5f} ms, "
                f"call {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
                f"{bms:.6f} ms by {by}) B={BATCH} on {card}")
    return rows


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

    log("set-up: the http-1000 policy, staged under each configuration")
    per_identity, scenario, cfg = build_policy()
    setups = {name: setup_config(name, per_identity, scenario, cfg)
              for name in CONFIGS}

    log("phase 3: kernels against their plain versions (exact)")
    errs = {}
    dense_fields = field_inputs_of(setups["auto"]["engine"],
                                   setups["auto"]["full"])
    nfa_fields = field_inputs_of(setups["nfa-bitset"]["engine"],
                                 setups["nfa-bitset"]["full"])
    kernel_phase(errs, {**dense_fields,
                        **{p: v for p, v in nfa_fields.items()
                           if f"{p}_nfa_follow" in v[0]}})
    log("phase 3: K2 and K1 timing against the input (data-oblivious)")
    oblivious = timing_independence(dense_fields, nfa_fields, card)

    reports = {}
    for name in CONFIGS:
        log(f"phase 4: main path [{name}]")
        reports[name] = drive_config(name, setups[name],
                                     len(scenario.flows), card)

    log("phase 4: one launch per kernel at the http-1000 shapes")
    rows = kernel_times(dense_fields, nfa_fields, card)
    # the JSON line reports each kernel at its largest main-path shape
    pick = {"KD": "path", "K1": "host", "K2": "host"}
    kernels = []
    for kid, k in _build.KERNELS.items():
        row = next(r for r in rows[kid] if r[0] == pick[kid])
        kernels.append({
            "name": f"{kid}:{k.name}", "route": "cuda",
            "source": f"cilium_tpu_torch/engine/csrc/{k.source}",
            "replaces": k.replaces,
            "launches": sum(r["launches"][kid] for r in reports.values()),
            "phases": {n: r["launches"][kid] for n, r in reports.items()
                       if r["launches"][kid]},
            "max_abs_err": errs[kid],
            # ms: device time of one launch (profiler); call_ms: wall
            # time per call from Python, wrapper included
            "ms": row[2],
            "call_ms": row[3], "plain_ms": row[4], "bound_ms": row[5],
            "bound_by": row[6], "library_ms": None,
            "bound_ops": BOUND_OPS[kid],
            "sass_tensor_ops": tensor_ops.get(kid),
            "timing_ratio": oblivious[kid][2] if kid in oblivious else None,
            "shape": f"{pick[kid]} {row[1]} B={BATCH}",
            "batch_ms": {n: r["batch_ms"] for n, r in reports.items()},
            "device_busy_share": {n: r["busy_share"]
                                  for n, r in reports.items()},
        })
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
