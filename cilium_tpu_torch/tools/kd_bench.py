"""Measure kernel KD's wrapper and the blob route on one GPU, for one
checkout of the repo.

    python3 cilium_tpu_torch/tools/kd_bench.py [--tree DIR]

``--tree`` names the checkout whose ``cilium_tpu_torch`` is measured
(default: the one this file lives in), so one command can measure a
parent commit and its change in turns. On the http-1000 policy
(1000 rules, 10000 flows, bank size 128, batches of 8192; the main path
of ``chip_smoke.py``) it prints:

* KD's call at the batch's path field: wall ms per call by CUDA events
  over 200 calls (the wrapper included, as ``chip_smoke.py``'s
  ``call_ms``), the host's enqueue time per call, and that time split
  into the wrapper's parts (argument checks, output allocation, the
  stream handle, the launch plan, the ``ctypes`` call and launch), each
  timed alone over 2000 repetitions;
* the device kernels and device ms per batch of the packed route
  (``verdict_batch_arrays``) and of the blob route (``unpack_blob`` of
  a staged [B, W] u8 blob, then the step), by ``torch.profiler``.

The last line is one JSON object with every number, the card's name
and its power limit. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import array
import json
import os
import statistics
import subprocess
import sys
import time

N_RULES, N_FLOWS, BATCH, BANK_SIZE = 1000, 10000, 8192, 128


def _events_ms(fn, reps: int) -> float:
    import torch

    for _ in range(3):
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


def _host_ms(fn, reps: int) -> float:
    """Host ms per call of ``fn`` (median of 5 runs of ``reps``)."""
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        runs.append((time.perf_counter() - t0) * 1e3 / reps)
        torch.cuda.synchronize()
    return statistics.median(runs)


def _profile(fn, reps: int):
    """{kernel name: (launches, device ms)} over ``reps`` calls."""
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
        if "CUDA" in str(getattr(e, "device_type", "")):
            out[e.key] = (e.count, getattr(e, "self_device_time_total",
                                           0.0) / 1e3)
    return out


def _kd_device_ms(fn, reps: int = 20):
    for _ in range(3):
        hits = [(n, ms) for k, (n, ms) in _profile(fn, reps).items()
                if "dfa_dense_kernel" in k]
        if hits:
            return sum(h[1] for h in hits) / sum(h[0] for h in hits)
    return None


def _setup():
    import torch

    from cilium_tpu_torch.core.config import EngineConfig
    from cilium_tpu_torch.engine.compiled import (
        CompiledPolicy,
        encode_flows,
        flowbatch_to_host_dict,
        pack_blob_host,
    )
    from cilium_tpu_torch.engine.verdict import (
        TorchVerdictEngine,
        batch_field,
        batch_to_device,
        unpack_batch,
    )
    from cilium_tpu_torch.ingest import synth

    os.environ["CILIUM_TPU_DFA_IMPL"] = "gather"
    per_identity, scenario = synth.realize_scenario(
        synth.scenario_by_name("http", N_RULES, N_FLOWS))
    cfg = EngineConfig()
    cfg.bank_size = BANK_SIZE
    policy = CompiledPolicy.build(per_identity, cfg)
    engine = TorchVerdictEngine(policy, device="cuda", cfg=cfg)
    host = flowbatch_to_host_dict(
        encode_flows(scenario.flows[:BATCH], policy.kafka_interns, cfg))
    batch = batch_to_device(host, "cuda")
    blob, layout = pack_blob_host(host)
    blob = torch.from_numpy(blob).cuda()
    data, lens, _ = batch_field(unpack_batch(batch), "path")
    torch.cuda.synchronize()
    return engine, batch, blob, layout, data, lens


def wrapper_parts(kd, build, arrays, data, lens):
    """ms per call of each part of KD's wrapper at this shape, each
    timed alone; which parts exist depends on the checkout."""
    import torch

    a = [arrays[f"path_{k}"] for k in ("trans", "byteclass", "start")]
    acc, ext = arrays["path_accept"], arrays["rp_path_gaccept"]
    NB, S, K = a[0].shape
    B, L = data.shape
    W, Wg = acc.shape[2], ext.shape[2]
    i32 = torch.int32
    dev = data.device
    planned = hasattr(kd, "plan_launch")
    parts = {}
    if planned:
        def checks():
            for t in (*a, acc, ext):
                kd._table(t, i32, "t")
            build.cuda_check(data, torch.uint8, "data")
            build.cuda_check(lens, i32, "lengths")
            data.stride(), lens.stride()
    else:
        def checks():
            for t in (*a, acc, ext, lens):
                build.cuda_arg(t, i32, "t")
            build.cuda_arg(data, torch.uint8, "data")
    parts["argument checks"] = checks

    def alloc():
        if planned:
            data.new_empty((B, NB, W), dtype=i32)
            data.new_empty((B, NB, Wg), dtype=i32)
        else:
            torch.empty((B, NB, W), dtype=i32, device=dev)
            torch.empty((B, NB, Wg), dtype=i32, device=dev)
    parts["output allocation"] = alloc
    if planned:
        parts["stream handle"] = lambda: build.stream_ptr(data.get_device())
        dptr = data.data_ptr()
        parts["launch plan"] = lambda: kd.plan_launch(
            NB, S, K, B, L, W, Wg, data.data_ptr() % 16,
            data.stride()[0] % 16, kd._sm_count(data.get_device()))
        plan = kd.plan_launch(NB, S, K, B, L, W, Wg, dptr % 16,
                              data.stride(0) % 16, kd._sm_count(dev.index))
        words = torch.empty((B, NB, W), dtype=i32, device=dev)
        xwords = torch.empty((B, NB, Wg), dtype=i32, device=dev)
        ptrs = (*(t.data_ptr() for t in a), acc.data_ptr(), ext.data_ptr(),
                dptr, lens.data_ptr(), words.data_ptr(), xwords.data_ptr(), 0)
        stream = build.stream_ptr(dev.index)

        def launch():
            args = array.array("q", (
                *ptrs, NB, S, K, W, Wg, B, L, data.stride(0),
                lens.stride(0), plan.variant == "smem", plan.words_smem,
                plan.grid[0], plan.smem, plan.vec, stream))
            kd.KERNEL.launch(args.buffer_info()[0], variant=plan.variant)
        parts["ctypes call and launch"] = launch
    else:
        parts["stream handle"] = build.stream_ptr
        c = [t.contiguous() for t in (*a, acc, ext, data, lens)]
        words = torch.empty((B, NB, W), dtype=i32, device=dev)
        xwords = torch.empty((B, NB, Wg), dtype=i32, device=dev)
        args = (*(t.data_ptr() for t in c[:5]), c[5].data_ptr(),
                c[6].data_ptr(), words.data_ptr(), xwords.data_ptr(), None,
                NB, S, K, W, Wg, B, L, build.stream_ptr())
        parts["ctypes call and launch"] = lambda: kd.KERNEL.launch(*args)
    return {name: _host_ms(fn, 2000) for name, fn in parts.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("kd_bench: no CUDA device", file=sys.stderr)
        return 2
    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.engine import dfa_dense_cuda as kd
    from cilium_tpu_torch.engine.verdict import unpack_blob

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"tree {args.tree}; card {card}; torch {torch.__version__}",
          flush=True)
    _build.build([kd.KERNEL])
    engine, batch, blob, layout, data, lens = _setup()
    arrays = engine._arrays
    acc, ext = arrays["path_accept"], arrays["rp_path_gaccept"]
    tables = [arrays[f"path_{k}"] for k in ("trans", "byteclass", "start")]

    def call():
        return kd.dense_scan_cuda(*tables, data, lens, accept=acc,
                                  extra=ext)

    out = {"tree": args.tree, "card": card,
           "shape": list(tables[0].shape) + list(data.shape),
           "call_ms": _events_ms(call, 200), "host_ms": _host_ms(call, 200),
           "device_ms": _kd_device_ms(call),
           "parts_ms": wrapper_parts(kd, _build, arrays, data, lens)}
    print(f"KD path {tuple(out['shape'])}: call {out['call_ms']:.5f} ms, "
          f"host {out['host_ms']:.5f} ms, device {out['device_ms']:.5f} ms;"
          f" parts {json.dumps({k: round(v, 5) for k, v in out['parts_ms'].items()})}",
          flush=True)

    routes = {"packed": lambda: engine.verdict_batch_arrays(batch),
              "blob": lambda: engine.verdict_batch_arrays(
                  unpack_blob(blob, layout))}
    out["routes"] = {}
    for name, fn in routes.items():
        kern = _profile(fn, 5)
        out["routes"][name] = {
            "kernels": sum(n for n, _ in kern.values()) / 5,
            "device_ms": sum(ms for _, ms in kern.values()) / 5,
            "kd_launches": sum(n for k, (n, _) in kern.items()
                               if "dfa_dense_kernel" in k) / 5}
        log = out["routes"][name]
        print(f"[{name} route] batch {BATCH}: {log['kernels']:.0f} device "
              f"kernels, {log['kd_launches']:.0f} of them KD, "
              f"{log['device_ms']:.4f} ms of device time", flush=True)

    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
