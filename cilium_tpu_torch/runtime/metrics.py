"""The metric families the port's capture replay, verdict memo,
online serving path, loader plane, verdict service, stream and serving
fleet, the scan-arm autotuner, the DNS proxy, the engine's phase
probes, the parallel layer's collective ledger and the cluster state
planes (kvstore, identities, clustermesh, tenant quotas) report, under
the reference's names (``runtime/metrics.py``), and the part of its
registry they use: counters (``inc``/``get``), gauges (``set_gauge``),
histograms (``observe``/``histo_sum``/``histo_count``/``histogram``),
:class:`SpanStat`, and the Prometheus text the service's ``metrics``
op returns (``expose``, with the reference's ``# HELP`` text for every
family of the catalog that :meth:`Metrics.describe` declares at the
end of this module, :data:`HELP`).
"""

from __future__ import annotations

import bisect
import threading
import time
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

# -- the TPU-lane circuit breaker (runtime/service.py)
#: breaker CLOSED->OPEN transitions (N consecutive device failures)
BREAKER_TRIPS = "cilium_tpu_breaker_trips_total"
#: breaker HALF_OPEN->CLOSED transitions (a probe succeeded)
BREAKER_RECOVERIES = "cilium_tpu_breaker_recoveries_total"
#: verdicts served by the CPU oracle because the device lane was
#: tripped or the dispatch failed (correct-but-slower path)
BREAKER_FALLBACK_VERDICTS = "cilium_tpu_breaker_fallback_verdicts_total"
#: gauge: 0 = CLOSED (device serving), 1 = OPEN (oracle serving),
#: 2 = HALF_OPEN (probe in flight)
BREAKER_STATE = "cilium_tpu_breaker_state"
#: graceful drains completed (admission stopped, pending flushed)
DRAINS = "cilium_tpu_drains_total"

# -- the verdict service and the chunked stream (runtime/service.py,
# runtime/stream.py)
#: records per MicroBatcher flush
MICROBATCH_SIZE = "cilium_tpu_microbatch_size"
#: MicroBatcher flush wall seconds
MICROBATCH_SECONDS = "cilium_tpu_microbatch_seconds"
#: flows verdicted via the bulk service op
SERVICE_VERDICTS = "cilium_tpu_service_verdicts_total"
#: verdicts returned over the chunked binary stream
STREAM_VERDICTS = "cilium_tpu_stream_verdicts_total"
#: stream chunks answered, by route (session / ring / oracle /
#: fallback) — a port addition: which path a chunk took is otherwise
#: invisible, since every route answers the same verdicts
STREAM_CHUNKS = "cilium_tpu_stream_chunks_total"
#: stream frames a client dropped for an unknown kind
STREAM_UNKNOWN_FRAMES = "cilium_tpu_stream_unknown_frames_total"
#: stream-client sends that blocked at zero credit (backpressure)
STREAM_CREDIT_WAITS = "cilium_tpu_stream_credit_waits_total"
#: credit grants sent by stream servers (one per answered chunk)
STREAM_CREDITS_GRANTED = "cilium_tpu_stream_credits_granted_total"
#: stream-client reconnect attempts that re-established the session
STREAM_RECONNECTS = "cilium_tpu_stream_reconnects_total"
#: NPDS mapstate pulls served to shims
NPDS_PULLS = "cilium_tpu_npds_pulls_total"
#: L7 proxy policy checks, by proto and verdict
POLICY_L7 = "cilium_tpu_policy_l7_total"

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

# -- the loader plane (runtime/loader.py, runtime/checkpoint.py)
#: regenerations rolled back mid-swap (previous table kept serving)
LOADER_ROLLBACKS = "cilium_tpu_loader_swap_rollbacks_total"
#: loader restorations from a warm-restart snapshot (no recompile)
WARM_RESTORES = "cilium_tpu_warm_restores_total"
#: corrupt artifact-cache entries deleted on read (recompile follows)
ARTIFACT_CACHE_CORRUPT = "cilium_tpu_artifact_cache_corrupt_total"
#: on-disk artifact-cache entries evicted by the byte-bound LRU
ARTIFACT_CACHE_EVICTIONS = "cilium_tpu_artifact_cache_evictions_total"

# -- content-addressed banks (policy/compiler/bankplan.py)
#: bank groups compiled (a registry miss), by field
BANK_REBUILDS = "cilium_tpu_bank_rebuilds_total"
#: bank groups quarantined after a compile failure, by field
BANK_QUARANTINED = "cilium_tpu_bank_quarantined_total"
#: bank groups hot-swapped into the serving plan by a commit, by field
BANK_HOTSWAPS = "cilium_tpu_bank_hotswaps_total"
#: banks served from their cover while their compile was still pending
BANK_PENDING_SERVES = "cilium_tpu_bank_pending_serves_total"
#: compiled-bank artifact fetches, by result (hit / miss / corrupt)
BANK_ARTIFACT_FETCHES = "cilium_tpu_bank_artifact_fetches_total"
#: bank groups evicted from the byte-bounded registry shards
REGISTRY_SHARD_EVICTIONS = "cilium_tpu_registry_shard_evictions_total"
#: identity-fingerprint bundles evicted from the sharded store
FP_CACHE_EVICTIONS = "cilium_tpu_fp_cache_evictions_total"

# -- the compile queue (policy/compiler/compilequeue.py)
#: compile tasks submitted, by priority class
COMPILE_QUEUE_SUBMITTED = "cilium_tpu_compile_queue_submitted_total"
#: submits coalesced onto an in-flight task with the same work key
COMPILE_QUEUE_DEDUP = "cilium_tpu_compile_queue_dedup_total"
#: tasks completed (success or permanent failure)
COMPILE_QUEUE_COMPLETED = "cilium_tpu_compile_queue_completed_total"
#: in-queue retries (worker death re-queues with backoff)
COMPILE_QUEUE_RETRIES = "cilium_tpu_compile_queue_retries_total"
#: serving-blocking waits that hit the per-bank compile deadline
COMPILE_DEADLINE_LAPSES = "cilium_tpu_compile_deadline_lapses_total"
#: worker threads killed (the ``compile.worker`` fault point)
COMPILE_WORKER_DEATHS = "cilium_tpu_compile_worker_deaths_total"
#: gauge: pending + running compile tasks
COMPILE_QUEUE_DEPTH = "cilium_tpu_compile_queue_depth"
#: compile results that landed after their waiter lapsed
COMPILE_LATE_RESULTS = "cilium_tpu_compile_late_results_total"

# -- the explain plane and the canary (runtime/explain.py,
# runtime/canary.py)
#: explain-plane queries, by result (hit / miss)
EXPLAIN_QUERIES = "cilium_tpu_explain_queries_total"
#: canary double-dispatch samples, by result (match / diff)
CANARY_SAMPLES = "cilium_tpu_canary_samples_total"
#: canary commit attempts, by result (committed / refused / aborted)
CANARY_COMMITS = "cilium_tpu_canary_commits_total"
#: gauge: observed verdict-diff fraction of the active canary
CANARY_DIFF_FRACTION = "cilium_tpu_canary_diff_fraction"

# -- the serving fleet (runtime/fleetserve.py): stream-affinity routing,
# host-death failover, the fleet-coherent shedding ledger and the fleet
# observability plane
#: stream leases migrated off a dead/partitioned host and re-granted
#: on a survivor (one per stream that moved)
FLEET_HANDOFFS = "cilium_tpu_fleet_handoffs_total"
#: hosts declared dead by the suspicion state machine (missed
#: heartbeats past the TTL) or killed outright
FLEET_HOST_DEATHS = "cilium_tpu_fleet_host_deaths_total"
#: dead hosts warm-restored back into the placement ring
FLEET_REJOINS = "cilium_tpu_fleet_rejoins_total"
#: new streams the router placed AWAY from their rendezvous owner
#: because the owner was past its spill headroom
FLEET_SPILLED_STREAMS = "cilium_tpu_fleet_spilled_streams_total"
#: gauge: leased-slot occupancy per host, by host — the occupancy
#: digest the fleet-coherent shed/spill decision reads
FLEET_HOST_OCCUPANCY = "cilium_tpu_fleet_host_occupancy"
#: gauge: fleet-wide burn-rate roll-up over the per-replica SLO
#: trackers, by slo, trailing window, and view (``worst`` = the worst
#: single host; ``weighted`` = fleet-weighted by request volume)
FLEET_SLO_BURN_RATE = "cilium_tpu_fleet_slo_burn_rate"
#: failover latency per handoff, by stage: ``death-to-regrant``,
#: ``regrant-to-verdict``, ``death-to-verdict``
FLEET_FAILOVER_SECONDS = "cilium_tpu_fleet_failover_seconds"
#: fleet event-journal entries appended, by kind
FLEET_JOURNAL_EVENTS = "cilium_tpu_fleet_journal_events_total"
#: handoff-replayed chunks that resolved with a STITCHED trace — one
#: trace id spanning spans from both the dead host and the survivor
FLEET_TRACE_STITCHES = "cilium_tpu_fleet_trace_stitches_total"

# -- the scan-arm autotuner (engine/megakernel.py): dense DFA against
# bitset NFA, measured per bank shape at engine staging
#: autotuner decisions, by winning impl and field (cache misses only: a
#: shape-key hit serves the recorded pick without measuring again)
KERNEL_AUTOTUNE_PICKS = "cilium_tpu_kernel_autotune_picks_total"
#: wall seconds spent measuring one bank shape (both arms)
KERNEL_AUTOTUNE_SECONDS = "cilium_tpu_kernel_autotune_seconds"

# -- the DNS proxy (fqdn/dnsproxy.py, fqdn/server.py)
#: banked-DFA DNS batches degraded to the regex path
DNSPROXY_FALLBACKS = "cilium_tpu_dnsproxy_fallback_total"
#: proxied queries answered, by verdict (allow / deny)
FQDN_QUERIES = "cilium_tpu_fqdn_queries_total"
#: queries from a source address no endpoint owns (REFUSED)
FQDN_UNKNOWN_CLIENT = "cilium_tpu_fqdn_unknown_client_total"
#: queries too malformed to answer
FQDN_MALFORMED_QUERIES = "cilium_tpu_fqdn_malformed_queries_total"
#: allowed queries whose upstream did not answer in time (SERVFAIL)
FQDN_UPSTREAM_TIMEOUTS = "cilium_tpu_fqdn_upstream_timeouts_total"
#: queries a raising callback dropped (the serve loop goes on)
FQDN_HANDLER_ERRORS = "cilium_tpu_fqdn_handler_errors_total"

# -- device-time attribution (engine/phases.py)
#: engine phase probe seconds, by phase (mapstate / dfa-scan / resolve /
#: gather / h2d / featurize / compile / execute ...)
ENGINE_PHASE_SECONDS = "cilium_tpu_engine_phase_seconds"
#: intentional host-device sync points executed, by site (phase-probe
#: completion forcing)
ENGINE_HOST_SYNCS = "cilium_tpu_engine_host_syncs_total"

# -- the cluster state planes (kvstore.py, identity_kvstore.py,
# clustermesh.py, runtime/tenant.py)
#: watch callbacks that raised and were isolated (kvstore.py)
KVSTORE_WATCH_ERRORS = "cilium_tpu_kvstore_watch_errors_total"
#: undecodable remote-cluster kvstore events, by cluster
CLUSTERMESH_DECODE_ERRORS = "cilium_tpu_clustermesh_decode_errors_total"
#: gauge: 1 while a remote cluster's session is live, by cluster
CLUSTERMESH_READY = "cilium_tpu_clustermesh_ready"
#: gauge: identities known to the cluster-scope cache
IDENTITIES_CLUSTER = "cilium_tpu_identities_cluster"
#: orphan kvstore identities the operator's GC reaped
IDENTITY_GC = "cilium_tpu_operator_identities_gc_total"
#: identity-churn events a debounce window absorbed
IDENTITY_REGEN_COALESCED = "cilium_tpu_identity_regen_coalesced_total"
#: per-tenant quota-store reads, by result (``live`` = an unexpired
#: declared share, ``lapsed`` = TTL expiry fell back to the
#: conservative default, ``fault-default`` = the ``tenant.quota``
#: read was lost and the conservative default applied)
TENANT_QUOTA_READS = "cilium_tpu_tenant_quota_reads_total"

# -- the collective ledger (parallel/collectives.py)
#: collective ops recorded at trace time, by site/op/axis (count per
#: compiled block) — in the port, per executed lane call
COLLECTIVE_OPS = "cilium_tpu_collective_ops_total"
#: collective payload bytes (as-traced shapes), by site/op/axis
COLLECTIVE_BYTES = "cilium_tpu_collective_bytes_total"

#: ``# HELP`` text by family (the reference's words) and explicit
#: histogram boundaries, filled by :meth:`Metrics.describe` — the family
#: catalog at the end of this module. Process-wide: every registry's
#: exposition reads them.
HELP: Dict[str, str] = {}
_BUCKETS: Dict[str, Tuple[float, ...]] = {}
_CATALOG_LOCK = threading.Lock()

#: latency-shaped default boundaries (seconds)
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
#: count-shaped boundaries (records, streams): powers of two
SIZE_BUCKETS: Tuple[float, ...] = tuple(float(1 << i) for i in range(15))


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

    def describe(self, name: str, help_text: str,
                 buckets: Optional[Tuple[float, ...]] = None) -> None:
        """Declare a family: its ``# HELP`` text and, for a histogram
        with explicit boundaries, those (the reference's call; the
        catalog is module-wide, :data:`HELP`)."""
        with _CATALOG_LOCK:
            # ctlint: disable=unbounded-registry  # bounded by declared metric families (metric-registry enforces the catalog)
            HELP[name] = help_text
            if buckets is not None:
                # ctlint: disable=unbounded-registry  # one entry per declared histogram family
                _BUCKETS[name] = tuple(sorted(float(b) for b in buckets))

    @staticmethod
    def _key(name: str, labels: Optional[Dict[str, str]]):
        return (name, tuple(sorted((labels or {}).items())))

    def inc(self, name: str, value: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        k = self._key(name, labels)
        with self._lock:
            # ctlint: disable=unbounded-registry  # keyed by declared family x finite label enums
            self._counters[k] = self._counters.get(k, 0.0) + value

    def set_gauge(self, name: str, value: float,
                  labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            # ctlint: disable=unbounded-registry  # keyed by declared family x finite label enums
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

    def histo_count(self, name: str,
                    labels: Optional[Dict[str, str]] = None) -> int:
        """Cumulative observation count of a histogram series."""
        with self._lock:
            h = self._histos.get(self._key(name, labels))
            return int(h.count) if h is not None else 0

    def histogram(self, name: str,
                  labels: Optional[Dict[str, str]] = None
                  ) -> Dict[str, int]:
        """One series' observations per bucket, keyed by the bucket's
        upper bound (``"+Inf"`` last); empty when never observed."""
        with self._lock:
            h = self._histos.get(self._key(name, labels))
            if h is None:
                return {}
            return dict(zip([_num(b) for b in h.buckets] + ["+Inf"],
                            h.counts))

    def expose(self) -> str:
        """Prometheus text format: one ``# TYPE`` line per family
        (after its ``# HELP`` line, where :data:`HELP` has one),
        cumulative ``_bucket{le=...}`` series ending ``+Inf`` plus
        ``_count``/``_sum`` per histogram series."""
        out = []
        with self._lock:
            series = [(sorted(self._counters.items()), "counter"),
                      (sorted(self._gauges.items()), "gauge")]
            histos = sorted(self._histos.items(), key=lambda kv: kv[0])
        for items, typ in series:
            last = None
            for (name, labels), v in items:
                if name != last:
                    if name in HELP:
                        out.append(f"# HELP {name} {HELP[name]}")
                    out.append(f"# TYPE {name} {typ}")
                    last = name
                out.append(f"{_fmt(name, labels)} {_num(v)}")
        last = None
        for (name, labels), h in histos:
            if name != last:
                out.append(f"# TYPE {name} histogram")
                last = name
            cum = 0
            for bound, n in zip(h.buckets, h.counts):
                cum += n
                le = labels + (("le", _num(bound)),)
                out.append(f"{_fmt(name + '_bucket', le)} {cum}")
            le = labels + (("le", "+Inf"),)
            out.append(f"{_fmt(name + '_bucket', le)} {h.count}")
            out.append(f"{_fmt(name + '_count', labels)} {h.count}")
            out.append(f"{_fmt(name + '_sum', labels)} {_num(h.sum)}")
        return "\n".join(out) + "\n"


def _num(v: float) -> str:
    """Integers without a trailing .0 (the Prometheus convention)."""
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _escape_label(v) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(name: str, labels: Tuple) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)
    return f"{name}{{{inner}}}"


#: the process's registry
METRICS = Metrics()

# -- family catalog ---------------------------------------------------------
# ctlint (analysis/registry.py, rule metric-registry) requires every
# family written anywhere in the package to be declared here exactly
# once: the declaration is what turns a typo'd producer name into a
# lint error instead of a silently-dead series, and it gives every
# exposed family its # HELP text (the reference's words).
METRICS.describe(MICROBATCH_SIZE, "records per MicroBatcher flush",
                 buckets=SIZE_BUCKETS)
METRICS.describe(MICROBATCH_SECONDS, "MicroBatcher flush wall seconds")
METRICS.describe("cilium_tpu_span_seconds",
                 "SpanStat duration spans, labelled by span")
METRICS.describe(BREAKER_STATE,
                 "0=closed (device), 1=open (oracle), 2=half-open")
METRICS.describe(TRACE_SPANS, "flight-recorder spans recorded, by phase")
METRICS.describe(BREAKER_TRIPS, "breaker CLOSED->OPEN transitions")
METRICS.describe(BREAKER_RECOVERIES, "breaker HALF_OPEN->CLOSED transitions")
METRICS.describe(BREAKER_FALLBACK_VERDICTS,
                 "verdicts served by the CPU oracle while degraded")
METRICS.describe(FAULTS_INJECTED,
                 "faults fired by an armed FaultPlan, by point")
METRICS.describe(LOADER_ROLLBACKS, "regenerations rolled back mid-swap")
METRICS.describe(STREAM_RECONNECTS,
                 "stream-client reconnects that resumed the session")
METRICS.describe(KVSTORE_WATCH_ERRORS,
                 "kvstore watch callbacks that raised and were "
                 "isolated")
METRICS.describe(DNSPROXY_FALLBACKS,
                 "banked-DFA DNS batches degraded to the regex path")
METRICS.describe("cilium_tpu_accesslog_decode_errors_total",
                 "undecodable access-log records")
METRICS.describe("cilium_tpu_accesslog_records_total",
                 "access-log records ingested, by proto")
METRICS.describe("cilium_tpu_api_requests_total", "REST API requests served")
METRICS.describe("cilium_tpu_auth_pairs",
                 "mutual-auth pairs currently authenticated")
METRICS.describe(CLUSTERMESH_DECODE_ERRORS,
                 "undecodable remote-cluster kvstore events")
METRICS.describe(CLUSTERMESH_READY,
                 "1 when the remote cluster's session is live")
METRICS.describe("cilium_tpu_compile_seconds",
                 "policy snapshot compile wall seconds")
METRICS.describe("cilium_tpu_controller_runs_total",
                 "controller loop runs, by name and status")
METRICS.describe("cilium_tpu_endpoint_regenerations_total",
                 "per-endpoint regeneration completions, by status")
METRICS.describe(IDENTITY_REGEN_COALESCED,
                 "identity-churn events absorbed by an already-armed "
                 "regeneration debounce window (storm size minus the "
                 "one regeneration that covered it)")
METRICS.describe("cilium_tpu_endpoints", "endpoints currently managed")
METRICS.describe("cilium_tpu_endpoints_restored_total",
                 "endpoints restored from the state dir at startup")
METRICS.describe("cilium_tpu_frontend_rules",
                 "protocol-frontend rules in the serving compiled "
                 "policy, by proto (policy/compiler/frontends)")
METRICS.describe(FQDN_HANDLER_ERRORS, "DNS proxy handler threads that raised")
METRICS.describe(FQDN_MALFORMED_QUERIES,
                 "DNS queries that failed wire parsing")
METRICS.describe(FQDN_QUERIES, "DNS proxy queries, by verdict")
METRICS.describe(FQDN_UNKNOWN_CLIENT,
                 "DNS queries from unmapped client addresses")
METRICS.describe(FQDN_UPSTREAM_TIMEOUTS,
                 "upstream DNS resolutions that timed out")
METRICS.describe("cilium_tpu_health_probe_seconds",
                 "node-to-node health probe latency, by peer")
METRICS.describe("cilium_tpu_health_reachable",
                 "1 when the peer's last health probe succeeded")
METRICS.describe(IDENTITIES_CLUSTER,
                 "identities known to the cluster-scope cache")
METRICS.describe("cilium_tpu_ipam_endpoints_outside_cidr",
                 "restored endpoints whose IP is outside the node "
                 "CIDR")
METRICS.describe("cilium_tpu_ipam_ips_allocated",
                 "IPs currently allocated from the node CIDR")
METRICS.describe("cilium_tpu_ipam_node_cidrs",
                 "node CIDRs carved from the cluster pool")
METRICS.describe("cilium_tpu_k8s_cnp_parse_errors_total",
                 "CNP/CCNP objects that failed rule parsing")
METRICS.describe("cilium_tpu_lb_services", "load-balancer services installed")
METRICS.describe("cilium_tpu_leader",
                 "1 while this process holds the named leader lock")
METRICS.describe("cilium_tpu_monitor_events_total",
                 "monitor socket events fanned out, by type")
METRICS.describe(NPDS_PULLS, "NPDS mapstate pulls served to shims")
METRICS.describe("cilium_tpu_operator_cidrs_quarantined_total",
                 "pod CIDRs quarantined pending release confirmation")
METRICS.describe("cilium_tpu_operator_cidrs_reclaimed_total",
                 "pod CIDRs reclaimed from departed nodes")
METRICS.describe(IDENTITY_GC, "kvstore identities garbage-collected")
METRICS.describe("cilium_tpu_operator_pool_exhausted_total",
                 "node CIDR requests refused: cluster pool exhausted")
METRICS.describe(POLICY_L7, "L7 proxy policy checks, by proto and verdict")
METRICS.describe("cilium_tpu_policy_watch_ops_total",
                 "policy-directory watch operations applied")
METRICS.describe("cilium_tpu_policy_watch_parse_errors_total",
                 "policy-directory files that failed YAML parsing")
METRICS.describe("cilium_tpu_proxy_redirects",
                 "proxy redirects currently installed")
METRICS.describe("cilium_tpu_proxy_redirects_created_total",
                 "proxy redirects created")
METRICS.describe("cilium_tpu_proxy_redirects_released_total",
                 "proxy redirects released")
METRICS.describe("cilium_tpu_regenerations_total",
                 "policy snapshot regenerations committed, by "
                 "backend")
METRICS.describe(SERVICE_VERDICTS, "flows verdicted via the bulk service op")
METRICS.describe(STREAM_UNKNOWN_FRAMES,
                 "stream frames dropped for an unknown kind")
METRICS.describe(STREAM_VERDICTS,
                 "verdicts returned over the chunked binary stream")
METRICS.describe(ADMISSION_ADMITTED,
                 "requests admitted past the gate, by surface/class")
METRICS.describe(ADMISSION_SHED, "requests shed, by surface/class/reason")
METRICS.describe(ADMISSION_REAPED,
                 "queued entries dropped before dispatch (abandoned "
                 "caller or expired deadline)")
METRICS.describe(ADMISSION_QUEUE_DEPTH,
                 "verdict-queue occupancy at the admission decision")
METRICS.describe(DRAINS, "graceful drains completed")
METRICS.describe(WARM_RESTORES,
                 "loader restorations from a warm-restart snapshot")
METRICS.describe(ARTIFACT_CACHE_CORRUPT,
                 "corrupt artifact-cache entries deleted on read")
METRICS.describe(STREAM_CREDIT_WAITS,
                 "stream-client sends that blocked at zero credit")
METRICS.describe(STREAM_CREDITS_GRANTED,
                 "credit grants sent by stream servers")
METRICS.describe(ENGINE_PHASE_SECONDS, "engine phase probe seconds, by phase",
                 buckets=(1e-5, 5e-5, 1e-4, 5e-4, 0.001, 0.0025,
                          0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                          1.0, 2.5))
METRICS.describe(ENGINE_HOST_SYNCS,
                 "intentional host-device sync points executed, by "
                 "site (phase-probe completion forcing)")
METRICS.describe(CAPTURE_STAGE_SECONDS,
                 "capture-replay session staging seconds, by phase",
                 buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                          2.5, 5.0, 10.0, 30.0, 60.0, 120.0))
METRICS.describe(COLLECTIVE_OPS,
                 "collective ops recorded at trace time, by "
                 "site/op/axis (count per compiled block)")
METRICS.describe(COLLECTIVE_BYTES,
                 "collective payload bytes (as-traced shapes), by "
                 "site/op/axis")
METRICS.describe(VERDICT_MEMO_HITS,
                 "replay rows served from the device verdict memo")
METRICS.describe(VERDICT_MEMO_MISSES,
                 "unique rows verdicted and inserted into the memo")
METRICS.describe(VERDICT_MEMO_INVALIDATIONS,
                 "verdict-memo drops, by reason (policy-swap / "
                 "auth-change / session-reset / bank-swap)")
METRICS.describe(BANK_REBUILDS, "automaton bank groups compiled, by field")
METRICS.describe(BANK_QUARANTINED,
                 "bank groups quarantined after compile failure, by "
                 "field")
METRICS.describe(BANK_HOTSWAPS,
                 "bank groups hot-swapped by a committed revision, "
                 "by field")
METRICS.describe(COMPILE_QUEUE_SUBMITTED,
                 "bank-compile tasks submitted, by priority class "
                 "(serving / background)")
METRICS.describe(COMPILE_QUEUE_DEDUP,
                 "compile submits coalesced onto an in-flight task "
                 "with the same work key")
METRICS.describe(COMPILE_QUEUE_COMPLETED,
                 "compile tasks completed (success or permanent "
                 "failure)")
METRICS.describe(COMPILE_QUEUE_RETRIES,
                 "in-queue compile retries (worker-death backoff "
                 "re-queues)")
METRICS.describe(COMPILE_DEADLINE_LAPSES,
                 "serving-blocking compile waits that hit the "
                 "per-bank deadline (bank rides its cover)")
METRICS.describe(COMPILE_WORKER_DEATHS,
                 "compile worker threads that died mid-task (pool "
                 "respawns)")
METRICS.describe(COMPILE_QUEUE_DEPTH,
                 "pending + running compile tasks in the work queue")
METRICS.describe(COMPILE_LATE_RESULTS,
                 "compile results stored after their waiter's "
                 "deadline lapsed")
METRICS.describe(BANK_PENDING_SERVES,
                 "banks served from their last-good cover while "
                 "their compile was still pending")
METRICS.describe(BANK_ARTIFACT_FETCHES,
                 "compiled-bank artifact fetches, by result (hit / "
                 "miss / corrupt)")
METRICS.describe(REGISTRY_SHARD_EVICTIONS,
                 "bank groups evicted from the byte-bounded registry "
                 "shards")
METRICS.describe(FP_CACHE_EVICTIONS,
                 "identity-fingerprint bundles evicted from the "
                 "sharded store")
METRICS.describe(ARTIFACT_CACHE_EVICTIONS,
                 "artifact-cache entries evicted by the byte-bound "
                 "LRU (serving + warm keys protected)")
METRICS.describe(KERNEL_AUTOTUNE_PICKS,
                 "megakernel scan-impl autotune decisions, by impl "
                 "and field")
METRICS.describe(KERNEL_AUTOTUNE_SECONDS,
                 "seconds measuring dense vs bitset-NFA for one bank "
                 "shape")
METRICS.describe(SERVE_RING_OCCUPANCY,
                 "stream slots currently leased in the verdict ring")
METRICS.describe(SERVE_LEASE_GRANTS, "verdict-ring slot leases granted")
METRICS.describe(SERVE_LEASE_EXPIRIES,
                 "slot leases expired by TTL without renewal")
METRICS.describe(SERVE_LEASE_RELEASES,
                 "slot leases released cleanly (stream end / drain)")
METRICS.describe(SERVE_MEMO_BYPASS_BYTES,
                 "H2D bytes saved by ring-resident rows (memo/dedup "
                 "hits ship a 4-byte id, not the featurized row)")
METRICS.describe(SERVE_PACK_RECORDS, "records per pack-cycle fused dispatch",
                 buckets=SIZE_BUCKETS)
METRICS.describe(SERVE_PACK_STREAMS,
                 "distinct streams contributing to one pack-cycle "
                 "dispatch",
                 buckets=SIZE_BUCKETS)
METRICS.describe(SERVE_LATENCY,
                 "submit-to-verdict latency through the serving loop "
                 "(installed-clock seconds)")
METRICS.describe(SERVE_PACK_DISPATCH_SECONDS,
                 "wall seconds per pack-cycle fused dispatch")
METRICS.describe(SERVE_PACK_OCCUPANCY,
                 "leased-slot occupancy sampled per pack cycle",
                 buckets=SIZE_BUCKETS)
METRICS.describe(SLO_BURN_RATE,
                 "error-budget burn rate, by slo and trailing window "
                 "(1.0 = spending budget exactly as declared)")
METRICS.describe(PROVENANCE_RECORDS,
                 "verdicts through provenance recording, by result "
                 "(explained / unexplained)")
METRICS.describe(EXPLAIN_QUERIES,
                 "explain-plane queries, by result (hit / miss)")
METRICS.describe(FLEET_HANDOFFS,
                 "stream leases migrated off a dead host and "
                 "re-granted on a survivor")
METRICS.describe(FLEET_HOST_DEATHS,
                 "hosts declared dead (missed heartbeats past the "
                 "suspicion TTL, or killed)")
METRICS.describe(FLEET_REJOINS, "dead hosts warm-restored back into rotation")
METRICS.describe(FLEET_SPILLED_STREAMS,
                 "new streams placed away from their rendezvous "
                 "owner for headroom")
METRICS.describe(FLEET_HOST_OCCUPANCY,
                 "leased-slot occupancy per fleet host, by host")
METRICS.describe(FLEET_SLO_BURN_RATE,
                 "fleet burn-rate roll-up, by slo, window, and view "
                 "(worst single host / fleet-weighted)")
METRICS.describe(FLEET_FAILOVER_SECONDS,
                 "failover latency per handoff, by stage "
                 "(death-to-regrant / regrant-to-verdict / "
                 "death-to-verdict)")
METRICS.describe(FLEET_JOURNAL_EVENTS,
                 "fleet event-journal entries appended, by kind")
METRICS.describe(FLEET_TRACE_STITCHES,
                 "handoff-replayed chunks resolved under a stitched "
                 "cross-host trace")
METRICS.describe(HUBBLE_FLOW_RECORDS,
                 "flow records fed into the per-host Hubble flow "
                 "aggregator, by host")
METRICS.describe(HUBBLE_FLOW_OVERFLOW,
                 "flow aggregation keys dropped at the aggregator's "
                 "key bound")
METRICS.describe(TENANT_QUOTA_READS,
                 "per-tenant quota-store reads, by result (live / "
                 "lapsed / fault-default)")
METRICS.describe(CANARY_SAMPLES,
                 "canary double-dispatch samples, by result (match / "
                 "diff)")
METRICS.describe(CANARY_COMMITS,
                 "canary commit attempts, by result (committed / "
                 "refused / aborted)")
METRICS.describe(CANARY_DIFF_FRACTION,
                 "observed verdict-diff fraction of the active "
                 "canary")
# ctlint: disable=obs-doc-parity  # the port's own family (the stream's chunks by route); docs/ is the reference's catalog, README's port section documents it
METRICS.describe(STREAM_CHUNKS, "stream chunks answered, by route")


class SpanStat:
    """Duration span: ``with SpanStat("compile"): ...`` records seconds
    into the histogram ``cilium_tpu_span_seconds{span=...}``."""

    def __init__(self, span: str, metrics: Metrics = METRICS):
        self.span = span
        self.metrics = metrics
        self.seconds = 0.0

    def __enter__(self) -> "SpanStat":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        self.metrics.observe("cilium_tpu_span_seconds", self.seconds,
                             {"span": self.span})
