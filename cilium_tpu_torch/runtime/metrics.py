"""The metric families the port's capture replay, verdict memo and
online serving path report, under the reference's names
(``runtime/metrics.py``), and the part of its registry they use:
counters (``inc``/``get``), gauges (``set_gauge``) and histograms
(``observe``/``histo_sum``). No exporter.
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

#: faults fired by an armed FaultPlan, by injection point
FAULTS_INJECTED = "cilium_tpu_faults_injected_total"
#: spans recorded by the flight recorder (runtime/tracing.py), by phase
TRACE_SPANS = "cilium_tpu_trace_spans_total"
#: requests admitted past the gate, by surface + class
ADMISSION_ADMITTED = "cilium_tpu_admission_admitted_total"
#: requests shed at (or behind) the gate, by surface/class/reason
ADMISSION_SHED = "cilium_tpu_admission_shed_total"
#: queued entries dropped before dispatch (abandoned or expired)
ADMISSION_REAPED = "cilium_tpu_admission_reaped_total"
#: gauge: verdict-queue occupancy sampled at each admission decision
ADMISSION_QUEUE_DEPTH = "cilium_tpu_admission_queue_depth"

# -- the serving loop (runtime/serveloop.py + engine/ring.py)
#: gauge: stream slots currently leased in the verdict ring
SERVE_RING_OCCUPANCY = "cilium_tpu_serve_ring_occupancy"
#: slot leases granted (a reconnect-with-resume that finds its lease
#: alive does not grant again)
SERVE_LEASE_GRANTS = "cilium_tpu_serve_lease_grants_total"
#: leases expired by TTL
SERVE_LEASE_EXPIRIES = "cilium_tpu_serve_lease_expiries_total"
#: leases released cleanly (stream end / drain)
SERVE_LEASE_RELEASES = "cilium_tpu_serve_lease_releases_total"
#: host-to-device bytes that never crossed because the row was already
#: ring-resident: featurized row bytes minus the 4-byte id shipped
SERVE_MEMO_BYPASS_BYTES = "cilium_tpu_serve_memo_bypass_bytes_total"
#: records per pack-cycle dispatch
SERVE_PACK_RECORDS = "cilium_tpu_serve_pack_records"
#: distinct streams contributing to one pack-cycle dispatch
SERVE_PACK_STREAMS = "cilium_tpu_serve_pack_streams"
#: submit→verdict latency through the serving loop (installed clock)
SERVE_LATENCY = "cilium_tpu_serve_latency_seconds"
#: wall seconds one pack cycle spent in its dispatch
SERVE_PACK_DISPATCH_SECONDS = "cilium_tpu_serve_pack_dispatch_seconds"
#: leased-slot occupancy sampled once per pack cycle
SERVE_PACK_OCCUPANCY = "cilium_tpu_serve_pack_occupancy"

# -- provenance and SLO telemetry (engine/attribution.py,
# runtime/explain.py, runtime/slo.py, hubble/flowagg.py)
#: gauge: error-budget burn rate, by slo and trailing window
SLO_BURN_RATE = "cilium_tpu_slo_burn_rate"
#: verdicts through provenance recording, by result
PROVENANCE_RECORDS = "cilium_tpu_provenance_records_total"
#: served records fed to the per-host flow aggregator, by host
HUBBLE_FLOW_RECORDS = "cilium_tpu_hubble_flow_records_total"
#: aggregation keys dropped at the aggregator's bound
HUBBLE_FLOW_OVERFLOW = "cilium_tpu_hubble_flow_overflow_total"

#: latency-shaped default boundaries (seconds)
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
#: count-shaped boundaries (records, streams): powers of two
SIZE_BUCKETS: Tuple[float, ...] = tuple(float(1 << i) for i in range(15))
#: the reference's explicit boundaries, by family
_BUCKETS: Dict[str, Tuple[float, ...]] = {
    CAPTURE_STAGE_SECONDS: (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                            2.5, 5.0, 10.0, 30.0, 60.0, 120.0),
    SERVE_PACK_RECORDS: SIZE_BUCKETS, SERVE_PACK_STREAMS: SIZE_BUCKETS,
    SERVE_PACK_OCCUPANCY: SIZE_BUCKETS}


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
        self._gauges: Dict[Tuple[str, Tuple], float] = {}
        self._histos: Dict[Tuple[str, Tuple], _Histogram] = {}

    @staticmethod
    def _key(name: str, labels: Optional[Dict[str, str]]):
        return (name, tuple(sorted((labels or {}).items())))

    def inc(self, name: str, value: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        k = self._key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def set_gauge(self, name: str, value: float,
                  labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._gauges[self._key(name, labels)] = value

    def get(self, name: str, labels: Optional[Dict[str, str]] = None
            ) -> float:
        """A counter's value, else a gauge's (0 when neither exists)."""
        k = self._key(name, labels)
        with self._lock:
            if k in self._counters:
                return self._counters[k]
            return self._gauges.get(k, 0.0)

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
