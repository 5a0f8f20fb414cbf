"""The traced sub-window: a few chunks under ``torch.profiler`` (CPU and
CUDA), each inside a ``benchmark.chunk`` range, reduced from the Chrome
trace to what the per-layer metrics read.

Device time is the union of the kernel, copy and fill intervals on the
card. An idle gap on the card is cut by what the host was doing, and
each piece labelled: ``upload`` in a chunk until its first copy call
has returned, ``readback`` from its last copy call on, ``step`` in
between, and ``between chunks`` outside every chunk.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

CHUNK_RANGE = "benchmark.chunk"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
COPY_CALLS = ("cudaMemcpyAsync", "cudaMemcpy")


@dataclasses.dataclass
class Reading:
    chunks: int
    window_s: float                 # first chunk's start → last one's end
    busy_s: float                   # union of device intervals
    kernel_s: float                 # summed kernel durations
    kernels: int                    # kernel launches
    copy_s: float                   # summed device copies (HtoD + DtoH)
    #: (name, seconds) summed by device operation, longest first
    device_ops: List[Tuple[str, float]]
    #: (label, seconds) of every idle gap, longest first
    gaps: List[Tuple[str, float]]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce(events: Sequence[Dict]) -> Optional[Reading]:
    """A Chrome trace's events → a :class:`Reading`; None when the
    trace holds no chunk range or no device operation."""
    xs = [e for e in events if e.get("ph") == "X"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in xs if e.get("name") == CHUNK_RANGE
                   and e.get("cat") != "gpu_user_annotation")
    if not spans:
        return None
    lo, hi = spans[0][0], spans[-1][1]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and lo <= float(e["ts"]) <= hi]
    if not dev:
        return None
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev])
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += float(e["dur"]) * 1e-6
    kernels = [e for e in dev if e["cat"] == "kernel"]
    copies = [e for e in dev if e["cat"] == "gpu_memcpy"]
    calls = sorted(float(e["ts"]) for e in xs
                   if e.get("cat") == "cuda_runtime"
                   and e.get("name") in COPY_CALLS)
    call_end = {float(e["ts"]): float(e["ts"]) + float(e["dur"])
                for e in xs if e.get("cat") == "cuda_runtime"
                and e.get("name") in COPY_CALLS}

    phases: List[Tuple[float, float, str]] = []
    prev_end = lo
    for a, b in spans:
        if a > prev_end:
            phases.append((prev_end, a, "between chunks"))
        inside = [t for t in calls if a <= t <= b]
        up_end = call_end[inside[0]] if inside else a
        back_start = inside[-1] if len(inside) > 1 else b
        phases += [(a, up_end, "upload"), (up_end, back_start, "step"),
                   (back_start, b, "readback")]
        prev_end = b

    gaps = []
    edge = lo
    for a, b in busy + [(hi, hi)]:
        if a > edge:
            # an idle gap, cut where the host's phase changes
            for p0, p1, name in phases:
                cut = min(a, p1) - max(edge, p0)
                if cut > 0:
                    gaps.append((name, cut * 1e-6))
        edge = max(edge, b)
    gaps.sort(key=lambda g: -g[1])
    return Reading(
        chunks=len(spans), window_s=(hi - lo) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        kernel_s=sum(float(e["dur"]) for e in kernels) * 1e-6,
        kernels=len(kernels),
        copy_s=sum(float(e["dur"]) for e in copies) * 1e-6,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1]),
        gaps=gaps)


def trace_chunks(entry: Callable[[int, int], object], starts: Sequence[int],
                 chunk: int, tmpdir: str, cycles: int = 3,
                 tries: int = 3) -> Reading:
    """Replay ``cycles`` times over ``starts`` under the profiler and
    reduce the trace. A first profiled call, thrown away, starts the
    profiler's tracing before the traced chunks; the profiler now and
    then returns a trace without device events, so it is run again,
    ``tries`` times at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        entry(starts[0], chunk)
        torch.cuda.synchronize()
    path = os.path.join(tmpdir, "trace.json")
    for _ in range(tries):
        with profile(activities=acts) as prof:
            for start in list(starts) * cycles:
                with record_function(CHUNK_RANGE):
                    entry(start, chunk)
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
        os.remove(path)
        reading = reduce(events)
        if reading is not None:
            return reading
    raise RuntimeError("the profiler's trace held no device operation")
