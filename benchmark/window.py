"""The measured window: one caller, chunk after chunk, each call timed
from the hand-off of its chunk to its host lanes returned.

``verdicts_per_s`` is every record whose verdicts reached the host over
the whole window's seconds, and ``chunk_p95_ms`` the 95th percentile of
every call's time: neither is a median of sub-windows, so a stall in
any call shows in both.

Between calls each chunk's kept lanes are held against the lanes the
same chunk gave in the warm-up (its twin): an equal chunk is recorded
as its twin, and only a chunk that differs is copied. So the window
frees every lane it is handed, as a consumer does (holding them grows
the heap under the program's allocations), while every chunk is still
judged after the window: as its twin, or as its own copy.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

#: the lanes kept from each call for the comparison with the reference
KEPT_LANES = ("verdict", "l3l4_allowed", "redirect")


@dataclasses.dataclass
class Window:
    seconds: float                         # first hand-off → last return
    records: int                           # records whose lanes came back
    latencies: List[float]                 # seconds, one per call
    #: (start, records asked, {lane: array}) per call, in order
    kept: List[Tuple[int, int, Dict[str, np.ndarray]]]

    @property
    def chunks(self) -> int:
        return len(self.latencies)

    def verdicts_per_s(self) -> float:
        return self.records / self.seconds

    def p95_ms(self) -> float:
        return percentile(self.latencies, 95) * 1e3

    def median_ms(self) -> float:
        return statistics.median(self.latencies) * 1e3


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest rank: the smallest value with at least ``q`` % of the
    values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def keep(out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A copy of the kept lanes of one call's output."""
    return {k: np.array(out[k]) for k in KEPT_LANES if k in out}


def same(out: Dict[str, np.ndarray], twin: Dict[str, np.ndarray]) -> bool:
    return (all(k in out for k in twin)
            and all(np.array_equal(out[k], v) for k, v in twin.items()))


def run_window(entry: Callable[[int, int], Dict[str, np.ndarray]],
               starts: Sequence[int], chunk: int, seconds: float,
               twins: Dict[int, Dict[str, np.ndarray]],
               clock: Callable[[], float] = time.perf_counter) -> Window:
    """Call ``entry(start, chunk)`` over ``starts`` in turn, cycling,
    until ``seconds`` have passed since the first call; the call that
    crosses the end finishes and counts. ``twins`` holds each start's
    kept lanes from the warm-up."""
    lat: List[float] = []
    kept = []
    records = 0
    t0 = clock()
    c = 0
    while True:
        start = starts[c % len(starts)]
        a = clock()
        out = entry(start, chunk)
        b = clock()
        lat.append(b - a)
        records += len(out["verdict"])
        twin = twins[start]
        kept.append((start, chunk, twin if same(out, twin) else keep(out)))
        del out
        c += 1
        if b - t0 >= seconds:
            return Window(seconds=b - t0, records=records, latencies=lat,
                          kept=kept)
