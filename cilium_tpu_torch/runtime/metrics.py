"""The metric families the port's capture replay and verdict memo
report, under the reference's names (``runtime/metrics.py``), and the
part of its registry they use: counters (``inc``/``get``) and
histograms (``observe``/``histo_sum``). No exporter.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Optional, Tuple

#: capture-replay session staging seconds, by phase (tables /
#: featurize / dedup / table-h2d / memo-fill)
CAPTURE_STAGE_SECONDS = "cilium_tpu_capture_stage_seconds"
#: replay rows served from the device verdict memo
VERDICT_MEMO_HITS = "cilium_tpu_verdict_memo_hits_total"
#: unique rows verdicted and inserted into the memo
VERDICT_MEMO_MISSES = "cilium_tpu_verdict_memo_misses_total"
#: verdict-memo drops, by reason
VERDICT_MEMO_INVALIDATIONS = "cilium_tpu_verdict_memo_invalidations_total"

#: the reference's boundaries for the staging histogram (seconds)
_BUCKETS: Dict[str, Tuple[float, ...]] = {
    CAPTURE_STAGE_SECONDS: (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                            2.5, 5.0, 10.0, 30.0, 60.0, 120.0)}
#: latency-shaped default boundaries (seconds)
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class _Histogram:
    """One series: cumulative fixed buckets + count/sum."""

    __slots__ = ("buckets", "counts", "count", "sum")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # +1: the +Inf bucket
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, value)] += 1
        self.count += 1
        self.sum += value


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple], float] = {}
        self._histos: Dict[Tuple[str, Tuple], _Histogram] = {}

    @staticmethod
    def _key(name: str, labels: Optional[Dict[str, str]]):
        return (name, tuple(sorted((labels or {}).items())))

    def inc(self, name: str, value: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        k = self._key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def get(self, name: str, labels: Optional[Dict[str, str]] = None
            ) -> float:
        with self._lock:
            return self._counters.get(self._key(name, labels), 0.0)

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        k = self._key(name, labels)
        with self._lock:
            h = self._histos.get(k)
            if h is None:
                h = self._histos[k] = _Histogram(
                    _BUCKETS.get(name, DEFAULT_BUCKETS))
            h.observe(value)

    def histo_sum(self, name: str,
                  labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            h = self._histos.get(self._key(name, labels))
            return float(h.sum) if h is not None else 0.0


#: the process's registry
METRICS = Metrics()
