"""The program's own spans in the traced chunks.

``cilium_tpu_torch`` opens a ``record_function`` range for each of its
spans while a profiler collects (``CaptureReplay.verdict_chunk``:
``replay.upload``, ``replay.step`` with ``step.gather``,
``step.lookup``, ``step.resolve`` and ``step.assemble``,
``replay.readback`` with ``readback.copy`` and ``readback.split``).
:func:`reduce` takes the same Chrome events as :func:`trace.reduce` and
gives, inside the chunk ranges of the replaying thread:

* each span name's host seconds;
* each span name's kernel seconds and launches: a kernel belongs to the
  innermost program span that holds its launch call, matched by the
  ``correlation`` id the launch and the kernel share;
* the card's idle seconds under each innermost span, and under none
  (the key ``""``).

A trace without program ranges (a program that opens none) gives a
reading with empty tables.

    python3 -m benchmark.spans --workload http-1k.replay-unique \\
        --seed 7 --seconds 10

runs the cell once with ``--trace 1``, as ``benchmark.run`` does, and
prints its result line with the reading of its traced chunks beside it,
and the synchronizing calls torch's sync debug mode reports in one
window chunk.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import sys
import warnings
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.trace import CHUNK_RANGE, DEVICE_CATS, _union

#: what a program range is in the profiler's Chrome trace (its copy on
#: the device's timeline is ``gpu_user_annotation``)
SPAN_CAT = "user_annotation"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class SpanReading:
    chunks: int
    #: span name → seconds on the host inside the chunk ranges
    host_s: Dict[str, float]
    #: innermost span name → summed durations of the kernels it launched
    kernel_s: Dict[str, float]
    #: innermost span name → kernels it launched
    launches: Dict[str, int]
    #: innermost span name (``""``: none) → the card's idle seconds
    idle_s: Dict[str, float]
    #: kernels whose launch lay in no program span, or was not found
    unattributed: int

    def per_chunk_ms(self, table: Dict[str, float], name: str
                     ) -> Optional[float]:
        if name not in table or self.chunks == 0:
            return None
        return table[name] * 1e3 / self.chunks


def _innermost(spans: List[Tuple[float, float, str]], starts: List[float],
               t: float) -> str:
    """The innermost span holding ``t`` (``spans`` nested and sorted by
    start): the latest-starting one that has not ended."""
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(spans[:i]):
        if a <= t < b:
            return name
    return ""


def reduce(events: Sequence[Dict]) -> Optional[SpanReading]:
    """A Chrome trace's events → a :class:`SpanReading`; None when the
    trace holds no chunk range."""
    xs = [e for e in events if e.get("ph") == "X"]
    chunks = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e.get("tid")) for e in xs
                    if e.get("name") == CHUNK_RANGE
                    and e.get("cat") != "gpu_user_annotation")
    if not chunks:
        return None
    tid = chunks[0][2]
    windows = [(a, b) for a, b, _ in chunks]
    lo, hi = windows[0][0], windows[-1][1]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in xs
                   if e.get("cat") == SPAN_CAT and e.get("tid") == tid
                   and e.get("name") != CHUNK_RANGE
                   and any(a <= float(e["ts"]) <= b for a, b in windows))
    starts = [a for a, _, _ in spans]

    host: Dict[str, float] = defaultdict(float)
    for a, b, name in spans:
        host[name] += (b - a) * 1e-6

    launched = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                if e.get("cat") in LAUNCH_CATS and e.get("tid") == tid
                and "correlation" in e.get("args", {})}
    kernel: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    unattributed = 0
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and lo <= float(e["ts"]) <= hi]
    for e in dev:
        if e["cat"] != "kernel":
            continue
        t = launched.get(e.get("args", {}).get("correlation"))
        name = "" if t is None else _innermost(spans, starts, t)
        if not name:
            unattributed += 1
            continue
        kernel[name] += float(e["dur"]) * 1e-6
        launches[name] += 1

    # the card's idle pieces inside the chunk ranges, each cut where
    # the host's innermost span changes
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev])
    idle: List[Tuple[float, float]] = []
    edge = lo
    for a, b in busy + [(hi, hi)]:
        if a > edge:
            for w0, w1 in windows:
                if min(a, w1) > max(edge, w0):
                    idle.append((max(edge, w0), min(a, w1)))
        edge = max(edge, b)
    cuts = sorted({t for a, b, _ in spans for t in (a, b)})
    idle_s: Dict[str, float] = defaultdict(float)
    for a, b in idle:
        points = [a] + [t for t in cuts if a < t < b] + [b]
        for p0, p1 in zip(points, points[1:]):
            name = _innermost(spans, starts, (p0 + p1) / 2)
            idle_s[name] += (p1 - p0) * 1e-6
    return SpanReading(chunks=len(windows), host_s=dict(host),
                       kernel_s=dict(kernel), launches=dict(launches),
                       idle_s=dict(idle_s), unattributed=unattributed)


def _sync_counter(site_calls: List[List[str]]):
    """A wrapper of the timed entry that runs its ``n``-th call under
    torch's sync debug mode and appends the synchronizing calls' sites
    to ``site_calls``."""
    def wrap(entry, at: int):
        calls = [0]

        def counted(start, n):
            calls[0] += 1
            if calls[0] != at:
                return entry(start, n)
            import torch

            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                first = len(caught)
                try:
                    return entry(start, n)
                finally:
                    last = len(caught)
                    torch.cuda.set_sync_debug_mode(0)
                    site_calls.append(
                        [f"{w.filename}:{w.lineno}: "
                         f"{str(w.message).splitlines()[0]}"
                         for w in caught[first:last]
                         if "synchroniz" in str(w.message)])
        return counted
    return wrap


def main(argv=None) -> int:
    from benchmark import registry, run, trace

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    bench = registry.load_benchmark()
    cell = registry.workload(bench, args.workload)
    tr = registry.traffic_path(cell["traffic"])
    with open(tr) as fh:
        spec = json.load(fh)
    first_window_call = -(-int(spec["records"]) // int(spec["chunk"])) + 1
    seen: List[Sequence[Dict]] = []
    reduce_trace = trace.reduce

    def keep(events):
        seen.append(events)
        return reduce_trace(events)

    site_calls: List[List[str]] = []
    wrap = _sync_counter(site_calls)
    trace.reduce = keep
    try:
        res = run.run_cell(bench, cell, args.seed, args.seconds, True,
                           t_start=run.T_START,
                           wrap=lambda e: wrap(e, first_window_call))
    finally:
        trace.reduce = reduce_trace
    reading = reduce(seen[-1]) if seen else None
    r = res["reading"]
    out = {"result": run.result_line(bench, cell, res),
           "kernel_s": r.kernel_s, "kernels": r.kernels,
           "chunks": r.chunks, "window_s": r.window_s,
           "busy_s": r.busy_s,
           "spans": dataclasses.asdict(reading) if reading else None,
           "sync_debug_sites": site_calls}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
