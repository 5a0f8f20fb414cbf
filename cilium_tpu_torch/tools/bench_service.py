#!/usr/bin/env python
"""Service-level tail-latency benchmark: Unix socket → MicroBatcher →
the port's engine on the card, under concurrent load (the counterpart
of the reference's ``bench_service.py``).

* **Closed loop**: N client threads each run a think-time-free request
  loop; throughput is coupled to latency (one request in flight a
  thread), so it measures the lightly loaded latency floor.
* **Open loop**: requests arrive on a seeded Poisson schedule at a
  FIXED offered rate, independent of responses; latency is measured
  from the SCHEDULED arrival (no coordinated omission). The sweep
  raises the offered load until saturation (achieved < 90 % of
  offered).
* **Stream** (``--stream``): capture-image chunks over the chunked
  binary stream transport (``runtime/stream.py``) on a Poisson
  schedule of records; per-chunk latency from the scheduled send.

Every sample is client-observed wall time over the service's Unix
socket (length-prefixed JSON). Each point prints one
provenance-stamped JSON line; ``--out`` writes the whole sweep.

    python -m cilium_tpu_torch.tools.bench_service [--rules 1000]
        [--deadlines 0.5,2,8] [--open-rates R,...] [--stream]
        [--device cpu] [--out FILE]

Runs on ``cuda`` unless ``--device`` names another device. The
reference's ``--shim`` lane (the C++ shim's Kafka records) has no
counterpart yet.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import sys
import tempfile
import threading
import time

import numpy as np

from cilium_tpu_torch.runtime.metrics import MICROBATCH_SIZE, METRICS


def build_engine(n_rules: int, device=None, cache_dir=None,
                 n_flows: int = 2000):
    """The http scenario at ``n_rules`` through the port's ``Loader`` on
    ``device`` (default ``cuda``) → (loader, scenario)."""
    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.ingest import synth
    from cilium_tpu_torch.runtime.loader import Loader

    scenario = synth.synth_http_scenario(n_rules=n_rules, n_flows=n_flows)
    per_identity, scenario = synth.realize_scenario(scenario)
    cfg = Config.from_env()
    cfg.enable_tpu_offload = True
    if cache_dir is not None:
        cfg.loader.cache_dir = cache_dir
    loader = Loader(cfg, device=device)
    loader.regenerate(per_identity, revision=1)
    return loader, scenario


def _prewarm(service, scenario, batch_max: int) -> None:
    """Run every pow2 batch shape the padded flush can produce once, so
    no first launch (and no allocator growth) lands in a timed
    window."""
    size = 1
    while size <= batch_max:
        service.bridge._verdicts(scenario.flows[:size])
        size *= 2


def _hist_mark():
    """(count, sum, buckets) of the micro-batch size histogram."""
    return (METRICS.histo_count(MICROBATCH_SIZE),
            METRICS.histo_sum(MICROBATCH_SIZE),
            METRICS.histogram(MICROBATCH_SIZE))


def _batches_since(mark) -> dict:
    """The micro-batches flushed since ``mark``: their count, mean size
    and the upper bound of the largest size bucket that gained one."""
    n0, s0, b0 = mark
    n1, s1, b1 = _hist_mark()
    grew = [k for k, v in b1.items() if v > b0.get(k, 0)]
    bounds = [float("inf") if k == "+Inf" else float(k) for k in grew]
    return {"batches": n1 - n0,
            "mean": round((s1 - s0) / (n1 - n0), 1) if n1 > n0 else 0,
            "max_bucket": max(bounds) if bounds else 0}


def _quantiles(latencies: list) -> dict:
    """samples/p50/p95/p99/max in ms (sorts in place); zeros when no
    samples landed so every point carries the same schema."""
    latencies.sort()
    n = len(latencies)
    if n == 0:
        return {"samples": 0, "p50_ms": 0.0, "p95_ms": 0.0,
                "p99_ms": 0.0, "max_ms": 0.0}

    def q(p: float) -> float:
        return round(latencies[min(n - 1, int(n * p))] * 1e3, 3)

    return {"samples": n, "p50_ms": q(0.50), "p95_ms": q(0.95),
            "p99_ms": q(0.99),
            "max_ms": round(latencies[-1] * 1e3, 3)}


def run_point(loader, scenario, deadline_ms: float, batch_max: int,
              threads: int, per_thread: int, warmup: int,
              sock_dir: str) -> dict:
    from cilium_tpu_torch.ingest.hubble import flow_to_dict
    from cilium_tpu_torch.runtime.service import VerdictClient, VerdictService

    sock = os.path.join(sock_dir, f"svc_{deadline_ms}.sock")
    service = VerdictService(loader, sock, batch_max=batch_max,
                             deadline_ms=deadline_ms)
    service.start()
    _prewarm(service, scenario, batch_max)
    # distinct request templates per thread, pre-serialized
    reqs = [{"op": "check", "flow": flow_to_dict(f)}
            for f in scenario.flows[:threads * 64]]
    n_batches_before = _hist_mark()

    lat_lock = threading.Lock()
    latencies: list = []
    errors = [0]
    start_barrier = threading.Barrier(threads + 1)
    done_barrier = threading.Barrier(threads + 1)

    def worker(tid: int):
        # EVERY exit path must pass both barriers or main blocks
        # forever waiting for threads+1 parties
        client = None
        mine = reqs[tid::threads] or reqs
        try:
            client = VerdictClient(sock)
            for i in range(warmup):
                client.call(mine[i % len(mine)])
        except Exception:
            with lat_lock:
                errors[0] += 1
            client = None
        start_barrier.wait()
        out = []
        try:
            if client is not None:
                for i in range(per_thread):
                    t0 = time.perf_counter()
                    resp = client.call(mine[i % len(mine)])
                    dt = time.perf_counter() - t0
                    if "verdict" not in resp:
                        with lat_lock:
                            errors[0] += 1
                    out.append(dt)
        except Exception:
            with lat_lock:
                errors[0] += 1
        with lat_lock:
            latencies.extend(out)
        done_barrier.wait()
        if client is not None:
            client.close()

    workers = [threading.Thread(target=worker, args=(t,), daemon=True)
               for t in range(threads)]
    for w in workers:
        w.start()
    start_barrier.wait()
    t_wall0 = time.perf_counter()
    done_barrier.wait()
    t_wall = time.perf_counter() - t_wall0
    for w in workers:
        w.join(timeout=30)
    service.stop()

    sizes = _batches_since(n_batches_before)
    qs = _quantiles(latencies)
    return {
        "deadline_ms": deadline_ms,
        "batch_max": batch_max,
        "threads": threads,
        "errors": errors[0],
        "throughput_rps": round(qs["samples"] / t_wall, 1)
        if qs["samples"] else 0.0,
        **qs,
        "mean_batch_size": sizes["mean"],
    }


def run_open_point(loader, scenario, deadline_ms: float, batch_max: int,
                   rate_rps: float, duration_s: float, conns: int,
                   warmup: int, sock_dir: str,
                   drain_workers: int = 1) -> dict:
    """One open-loop point: a Poisson arrival schedule at
    ``rate_rps`` drives ``conns`` connections; workers pull the next
    scheduled arrival from a shared cursor, sleep until it, send, and
    record latency FROM THE SCHEDULED TIME — a worker that falls
    behind charges the backlog to the measurement instead of silently
    thinning the offered load (coordinated omission)."""
    from cilium_tpu_torch.ingest.hubble import flow_to_dict
    from cilium_tpu_torch.runtime.service import VerdictClient, VerdictService

    sock = os.path.join(sock_dir, f"svc_open_{deadline_ms}.sock")
    service = VerdictService(loader, sock, batch_max=batch_max,
                             deadline_ms=deadline_ms,
                             drain_workers=drain_workers)
    service.start()
    try:
        _prewarm(service, scenario, batch_max)
        reqs = [{"op": "check", "flow": flow_to_dict(f)}
                for f in scenario.flows[:512]]
        # fixed-seed Poisson schedule (reproducible offered load)
        rng = random.Random(1234)
        arrivals = []
        t = 0.0
        while t < duration_s:
            t += rng.expovariate(rate_rps)
            arrivals.append(t)

        cursor = [0]
        lock = threading.Lock()
        latencies: list = []
        errors = [0]
        base_time = [0.0]
        ready = threading.Barrier(conns + 1)
        done = threading.Barrier(conns + 1)

        def worker(tid: int):
            # EVERY exit path passes BOTH barriers: main sorts the
            # latency list after `done`, so a straggler extending it
            # later would corrupt the sort
            client = None
            try:
                client = VerdictClient(sock)
                for i in range(warmup):
                    client.call(reqs[(tid + i) % len(reqs)])
            except Exception:
                with lock:
                    errors[0] += 1
                if client is not None:
                    client.close()  # don't leak the connected fd
                client = None
            ready.wait()
            out = []
            try:
                if client is not None:
                    base = base_time[0]
                    while True:
                        with lock:
                            i = cursor[0]
                            cursor[0] += 1
                        if i >= len(arrivals):
                            break
                        sched = base + arrivals[i]
                        now = time.perf_counter()
                        if sched > now:
                            time.sleep(sched - now)
                        resp = client.call(reqs[i % len(reqs)])
                        dt = time.perf_counter() - sched
                        if "verdict" not in resp:
                            with lock:
                                errors[0] += 1
                        out.append(dt)
            except Exception:
                with lock:
                    errors[0] += 1
            with lock:
                latencies.extend(out)
            done.wait()
            if client is not None:
                client.close()

        workers = [threading.Thread(target=worker, args=(c,),
                                    daemon=True) for c in range(conns)]
        for w in workers:
            w.start()
        # workers block on the barrier until base_time is set; warmup
        # has fully finished once every worker reaches the barrier, so
        # the histogram mark taken HERE excludes warmup batches from
        # the reported batch-size distribution
        base_time[0] = time.perf_counter() + 0.05
        ready.wait()
        n_before = _hist_mark()
        done.wait()
        # wall from the SCHEDULE ORIGIN, not barrier release: the
        # 50ms lead-in must not dilute achieved_rps into a false
        # saturation verdict at short durations
        wall = time.perf_counter() - base_time[0]
        for w in workers:
            w.join(timeout=30)
    finally:
        service.stop()

    sizes = _batches_since(n_before)
    qs = _quantiles(latencies)
    return {
        "deadline_ms": deadline_ms,
        "offered_rps": rate_rps,
        "achieved_rps": round(qs["samples"] / max(wall, 1e-9), 1)
        if qs["samples"] else 0.0,
        "errors": errors[0],
        **qs,
        "mean_batch_size": sizes["mean"],
        # the upper bound of the largest size bucket that filled
        "max_batch_size_bucket": sizes["max_bucket"],
        "batch_max": batch_max,
        "conns": conns,
        "drain_workers": drain_workers,
    }


def _device_rtt_ms(loader, probes: int = 10) -> float:
    """Median ms of a tiny host → device → host round trip on the
    loader's device: the floor every device-verdict batch pays at least
    once. The stream lane's p99 is read against it."""
    import torch

    device = loader.engine.device
    xs = torch.zeros(16, dtype=torch.int32)
    times = []
    for _ in range(probes):
        t0 = time.perf_counter()
        xs.to(device).cpu()
        times.append(time.perf_counter() - t0)
    times.sort()
    return round(times[len(times) // 2] * 1e3, 3)


def run_stream_point(loader, scenario, chunk_records: int,
                     rate_records_s: float, duration_s: float,
                     sock_dir: str, pipeline_depth: int = 8) -> dict:
    """Open-loop point over the chunked binary STREAM transport
    (runtime/stream.py): capture-image chunks are sent on a Poisson
    schedule at a fixed offered record rate; per-chunk latency is
    measured from the SCHEDULED send time (coordinated-omission-safe,
    like run_open_point). This is the serving-path answer to the
    request-response protocol's one-RTT-per-batch floor: with D chunks
    in flight the round trip amortizes D ways. Each answered chunk is
    held against its image's warm-up verdicts (``stale`` counts those
    that differ) and ``lost`` counts chunks sent and never answered."""
    from cilium_tpu_torch.ingest.binary import (
        capture_field_widths,
        capture_from_bytes,
        capture_to_bytes,
    )
    from cilium_tpu_torch.runtime.service import VerdictService
    from cilium_tpu_torch.runtime.stream import StreamClient

    sock = os.path.join(sock_dir, f"svc_stream_{int(rate_records_s)}.sock")
    service = VerdictService(loader, sock)
    service.start()
    try:
        # pre-serialized chunk pool (client-side encode cost is real
        # but belongs to the traffic source, not the measured service).
        # Tile the scenario's flows so every image carries EXACTLY
        # chunk_records — a short flow pool must not silently shrink
        # the chunks (and the reported per-chunk record rate)
        flows = list(scenario.flows)
        while len(flows) < chunk_records * 4:
            flows = flows + flows
        images = []
        for i in range(0, len(flows) - chunk_records + 1,
                       chunk_records):
            images.append(capture_to_bytes(flows[i:i + chunk_records]))
            if len(images) >= 16:
                break
        _, l7, offsets, _blob, _gen = capture_from_bytes(images[0])
        widths = capture_field_widths(l7, offsets)
        client = StreamClient(sock, widths=widths,
                              timeout=max(120.0, duration_s * 3),
                              pipeline_depth=pipeline_depth)
        # prewarm with EVERY image: runs the padded chunk bucket once
        # AND settles the incremental session's tables (string/row
        # interning + growth flushes happen here, not in the measured
        # window — the window then measures steady-state serving, the
        # regime the criterion is about; cold-session cost is its own
        # number, reported as warmup_s)
        t_warm = time.perf_counter()
        want = [client.result(client.send_image(img)) for img in images]
        warmup_s = time.perf_counter() - t_warm

        chunk_rate = rate_records_s / chunk_records
        rng = random.Random(99)
        arrivals, t = [], 0.0
        while t < duration_s:
            t += rng.expovariate(chunk_rate)
            arrivals.append(t)
        sched_of: dict = {}
        lock = threading.Lock()
        done_recv = threading.Event()
        completions: list = []
        n_records = [0]
        errors = [0]
        #: chunks answered with other verdicts than their image's at
        #: warm-up (the policy does not change during the point)
        stale = [0]

        def collector():
            try:
                for seq, verdicts in client.results():
                    now = time.perf_counter()
                    with lock:
                        sched = sched_of.pop(seq, None)
                        if isinstance(verdicts, Exception):
                            errors[0] += 1  # failed seq; keep draining
                        elif sched is not None:
                            completions.append(now - sched[0])
                            n_records[0] += len(verdicts)
                            if not np.array_equal(verdicts, want[sched[1]]):
                                stale[0] += 1
            except Exception:
                with lock:
                    errors[0] += 1
            done_recv.set()

        col = threading.Thread(target=collector, daemon=True)
        col.start()
        base = time.perf_counter() + 0.05
        for i, a in enumerate(arrivals):
            sched = base + a
            now = time.perf_counter()
            if sched > now:
                time.sleep(sched - now)
            img = i % len(images)
            # send + register under ONE lock hold: the collector can
            # receive the verdict on its thread before we register the
            # seq, but it can't pop it until we release
            with lock:
                sched_of[client.send_image(images[img])] = (sched, img)
        client.finish()
        done_recv.wait(timeout=60)
        wall = time.perf_counter() - base
        with lock:
            lost = len(sched_of)  # sent, never answered
        client.close()
    finally:
        service.stop()

    qs = _quantiles(completions)
    return {
        "lane": "stream",
        "warmup_s": round(warmup_s, 2),
        "chunk_records": chunk_records,
        "offered_records_s": rate_records_s,
        "achieved_records_s": round(n_records[0] / max(wall, 1e-9), 1),
        "offered_chunks_s": round(chunk_rate, 2),
        "pipeline_depth": pipeline_depth,
        "errors": errors[0],
        "stale": stale[0],
        "lost": lost,
        **qs,
    }


_TRANSIENT_RE = re.compile(
    r"connection|reset|refused|broken ?pipe|timed out|unavailable|"
    r"read body|EOF", re.I)


def _safe_point(lane: str, fn, *a, **kw):
    """Lane isolation: a sweep point that dies on a
    transient connection error gets exactly ONE retry; a second (or
    non-transient) failure records a structured failure point —
    ``{lane, failed, error, attempts}`` — and the sweep continues
    instead of losing the whole artifact."""
    for attempt in (1, 2):
        try:
            return fn(*a, **kw)
        except Exception as e:  # noqa: BLE001 — any point death must
            # degrade to a structured record, not kill the sweep
            err = f"{type(e).__name__}: {e}"
            if attempt == 1 and _TRANSIENT_RE.search(err):
                print(f"[{lane}] transient point failure, one retry: "
                      f"{err[:200]}", file=sys.stderr)
                continue
            print(f"[{lane}] point failed ({attempt} attempt(s)): "
                  f"{err[:200]}", file=sys.stderr)
            return {"lane": lane, "failed": True, "error": err[:500],
                    "attempts": attempt}


def _emit(line: dict, out_lines: list) -> None:
    from cilium_tpu_torch.runtime.provenance import stamp

    line = stamp(line)
    out_lines.append(line)
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cilium_tpu_torch.tools.bench_service")
    ap.add_argument("--rules", type=int, default=1000)
    ap.add_argument("--deadlines", default="0.5,2,8",
                    help="comma-separated MicroBatcher deadlines (ms) of "
                         "the closed loop ('' skips it)")
    ap.add_argument("--threads", type=int, default=16)
    ap.add_argument("--per-thread", type=int, default=50,
                    help="timed requests per thread (keep threads x "
                         "this >= 200 for a real p99)")
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--batch-max", type=int, default=256)
    ap.add_argument("--no-open", action="store_true",
                    help="skip the open-loop (Poisson fixed-rate) sweep")
    ap.add_argument("--open-rates", default=None,
                    help="comma-separated offered rates (rps); default "
                         "doubles from 500 until saturation")
    ap.add_argument("--open-deadline", type=float, default=8.0)
    ap.add_argument("--open-duration", type=float, default=3.0)
    ap.add_argument("--drain-workers", type=int, default=1)
    ap.add_argument("--open-conns", type=int, default=256)
    ap.add_argument("--stream", action="store_true",
                    help="add the chunked-binary-stream open-loop sweep")
    ap.add_argument("--stream-rates", default=None,
                    help="comma-separated offered record rates; default "
                         "doubles from 100000 until saturation")
    ap.add_argument("--stream-chunk", type=int, default=4096)
    ap.add_argument("--stream-duration", type=float, default=5.0)
    ap.add_argument("--stream-depth", type=int, default=8)
    ap.add_argument("--stream-only", action="store_true",
                    help="skip the closed/open JSON-protocol sweeps")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the "
                         "plain versions)")
    ap.add_argument("--out", default=None,
                    help="write the full sweep JSON here")
    ap.add_argument("--trace", action="store_true",
                    help="leave the flight recorder on during the sweep")
    args = ap.parse_args(argv)

    from cilium_tpu_torch.runtime.provenance import stamp
    from cilium_tpu_torch.runtime.tracing import TRACER

    TRACER.configure(enabled=bool(args.trace))
    loader, scenario = build_engine(args.rules, device=args.device)
    sock_dir = tempfile.mkdtemp(prefix="ct_svcbench_")
    points, lines = [], []
    try:
        if args.stream:
            rtt = _device_rtt_ms(loader)
            _emit({"metric": "device_rtt_probe", "value": rtt,
                   "unit": "ms median", "vs_baseline": 0.0}, lines)
            if args.stream_rates:
                rates = [float(x) for x in args.stream_rates.split(",")]
                adaptive = False
            else:
                rates, adaptive = [100_000.0], True
            i = 0
            while i < len(rates):
                rate = rates[i]
                pt = _safe_point(
                    "stream", run_stream_point, loader, scenario,
                    args.stream_chunk, rate, args.stream_duration,
                    sock_dir, pipeline_depth=args.stream_depth)
                points.append(pt)
                i += 1
                if pt.get("failed"):
                    continue
                pt["device_rtt_ms"] = rtt
                _emit({"metric": f"service_stream_{int(rate)}rps_"
                                 f"{args.rules}rules",
                       "value": pt["achieved_records_s"],
                       "unit": "verdicts/s online (stream)",
                       "vs_baseline": round(
                           pt["achieved_records_s"] / 1e5, 3), **pt},
                      lines)
                saturated = (pt["achieved_records_s"] < 0.9 * rate
                             or pt["samples"] == 0)
                if adaptive and not saturated and rate < 5e7:
                    rates.append(rate * 2)
        if not args.stream_only:
            for d in (float(x) for x in args.deadlines.split(",") if x):
                pt = _safe_point("closed", run_point, loader, scenario,
                                 d, args.batch_max, args.threads,
                                 args.per_thread, args.warmup, sock_dir)
                points.append(pt)
                if pt.get("failed"):
                    continue
                _emit({"metric": f"service_check_latency_d{d}ms_"
                                 f"{args.rules}rules",
                       "value": pt["p99_ms"],
                       "unit": "ms p99 (client-observed)",
                       "vs_baseline": 0.0, **pt}, lines)
            if not args.no_open:
                d = args.open_deadline
                if args.open_rates:
                    rates = [float(x) for x in args.open_rates.split(",")]
                    adaptive = False
                else:
                    rates, adaptive = [500.0], True
                i = 0
                while i < len(rates):
                    rate = rates[i]
                    pt = _safe_point(
                        "open_loop", run_open_point, loader, scenario, d,
                        args.batch_max, rate, args.open_duration,
                        args.open_conns, args.warmup, sock_dir,
                        drain_workers=args.drain_workers)
                    i += 1
                    if pt.get("failed"):
                        points.append(pt)
                        continue
                    pt["lane"] = "open_loop"
                    points.append(pt)
                    _emit({"metric": f"service_open_loop_d{d}ms_"
                                     f"{int(rate)}rps_{args.rules}rules",
                           "value": pt["p99_ms"],
                           "unit": "ms p99 (from scheduled arrival)",
                           "vs_baseline": 0.0, **pt}, lines)
                    saturated = (pt["achieved_rps"] < 0.9 * rate
                                 or pt["samples"] == 0)
                    if adaptive and not saturated and rate < 65536:
                        rates.append(rate * 2)
    finally:
        loader.close()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(stamp({"rules": args.rules, "points": points}),
                      f, indent=1)
    return 1 if any(p.get("failed") for p in points) else 0


if __name__ == "__main__":
    sys.exit(main())
