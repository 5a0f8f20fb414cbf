"""Configuration tree: the reference's ``core/config.py`` field for
field — typed dataclasses, environment overrides (``from_env``) and one
master feature gate ``enable_tpu_offload``.

Every section and every root field of the reference is here: the
verdict engine and the loader plane (``engine``, ``loader``,
``compile``, ``tenant``, ``canary``), the serving plane
(``provenance``, ``slo``, ``admission``, ``breaker``, ``serve``), the
fleet, the mesh (``parallel``), the fault-schedule search (``dst``),
the flight recorder (``tracing``, which ``Agent`` hands to
``TRACER.configure``) and the agent's own fields (``cluster_name``,
``node_name``, ``ipam_mode``, ``identity_allocation_mode``,
``pod_cidr``, ``kube_apiserver_ips``, ``k8s_api_socket``,
``log_level``, ``monitor_aggregation``, ``configure_logging``,
``enable_metrics``), and the reference's TOML reader (``from_toml``:
its sections and keys, a list read as a tuple), which the daemon's
``--config`` reads.

Two deliberate deviations from the reference, each tested
(``tests/test_torch_loader.py``; the first also for a TOML file that
does not set the gate, ``tests/test_torch_daemon.py``):

* ``Config.enable_tpu_offload`` defaults to **True**: the port's
  loader stages a ``TorchVerdictEngine`` on the card by default. The
  CPU oracle stays reachable with the gate set off explicitly
  (``CILIUM_TPU_ENABLE_OFFLOAD=0`` or ``Config(enable_tpu_offload=
  False)``).
* ``LoaderConfig.cache_dir`` defaults to ``~/.cache/cilium_tpu``:
  the two packages compute the same bank keys, so they must never
  share a cache directory.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from typing import Optional, Tuple



@dataclasses.dataclass
class EngineConfig:
    """Verdict-engine (datapath) knobs."""

    # Automaton packing. 128 patterns per bank benches ~10% faster than
    # 64 on v5e at the 1k-rule shape (fewer, larger gathers). Fewer
    # banks also means EP sharding needs bank_count % expert_axis == 0
    # — sharding warns and replicates when it doesn't; shrink this to
    # restore EP for small rule sets.
    bank_size: int = 128           # patterns per DFA bank (EP shard unit)
    max_dfa_states: int = 8192     # per-bank subset-construction cap
    max_quantifier: int = 64       # {m,n} expansion cap (sanitize rejects above)
    # Input bucketing (variable-length strings → fixed buckets)
    dns_name_len: int = 256        # DNS names are ≤255 bytes + NUL
    http_path_buckets: Tuple[int, ...] = (32, 64, 128, 256)
    http_host_len: int = 128
    http_method_len: int = 16
    # (kafka topic/client-id length caps were removed by the ctlint
    # config-surface sweep: Kafka fields match by exact interned id,
    # never through a length-bucketed automaton, so the knobs were
    # dead the day they landed)
    #: generic (l7proto) records: max fields per record the engine
    #: encodes pair slots for (our parsers emit ≤4; truncation beyond
    #: this could only false-DENY, never false-allow)
    max_generic_fields: int = 16
    #: protocol-frontend records (policy/compiler/frontends/): byte
    #: cap on the canonical serialized record the ``l7g`` banked
    #: automaton scans. A record serializing past it is marked
    #: invalid — zero match words, so truncation can only false-DENY,
    #: never false-allow (same contract as every other byte bucket)
    l7g_len: int = 256
    #: replay/featurize chunk unit — the batch shape the jitted step
    #: compiles for (``cilium-tpu replay`` and the bench sweeps)
    batch_size: int = 8192
    #: capture-replay dedup heuristic: past this unique/total ratio
    #: the staged unique-row table is discarded (the id stream would
    #: move MORE bytes than plain rows, and the table ≈ a full copy of
    #: the capture in host memory) and replay streams full rows.
    #: 1.0 = always keep the table; see CaptureReplay.stage_unique.
    stage_unique_drop_ratio: float = 0.5
    #: device-resident verdict memo over the deduped replay rows
    #: (engine/memo.py): unique rows are verdicted once per policy
    #: revision, chunks then gather memoized outputs on device.
    #: Invalidated on every Loader revision commit — disable to force
    #: every chunk through the full verdict step.
    verdict_memo: bool = True
    #: verdict-step kernel selection (engine/megakernel.py):
    #: "auto" = fused megakernel, heuristic per-bank-shape scan pick;
    #: "autotune" = fused, dense vs bitset-NFA measured per bank shape
    #: at staging; "dfa-dense"/"nfa-bitset" = fused with the arm
    #: forced; "legacy" = the pre-megakernel three-family step. Every
    #: value is verdict-bit-equal — this knob only moves time.
    kernel_impl: str = "auto"


@dataclasses.dataclass
class LoaderConfig:
    """Tensor staging / artifact cache (analog of pkg/datapath/loader)."""

    #: the port's own directory (the reference's is
    #: ``~/.cache/cilium_tpu``): both packages compute the same bank
    #: keys, so a shared directory would make one unpickle the other's
    #: banks
    cache_dir: str = os.path.expanduser("~/.cache/cilium_tpu_torch")
    enable_cache: bool = True
    #: restore the last drain's warm snapshot (revision + compiled
    #: policy + oracle snapshot) at Agent.start when no policy has
    #: been loaded yet — the restarted service answers its first
    #: request verdict-identically without recompilation
    warm_restore: bool = False
    #: content-addressed automaton banks (policy/compiler/bankplan.py):
    #: CNP/FQDN churn recompiles only the banks whose pattern
    #: membership changed, a per-bank compile failure quarantines only
    #: that bank (old cover keeps serving), and committed revisions
    #: carry bank-scoped memo invalidation instead of a global drop.
    #: Off = the pre-bank positional grouping + full-drop epochs.
    bank_isolation: bool = True
    #: how long a quarantined bank serves its stale cover before the
    #: next regeneration retries its compile
    bank_quarantine_ttl_s: float = 30.0
    #: identity-churn regeneration debounce (identity_kvstore
    #: .RegenDebouncer): remote identity add/delete events re-arm a
    #: quiet window this long before ONE regeneration covers the
    #: burst, so a 100-event churn storm costs O(1) regenerations.
    #: 0 = regenerate per event (the pre-debounce behavior).
    identity_regen_debounce_s: float = 0.05
    #: on-disk artifact-cache byte bound: past it, least-recently-used
    #: entries are evicted (counted on
    #: ``cilium_tpu_artifact_cache_evictions_total``). The currently-
    #: serving policy's artifact and the warm-restart snapshot are
    #: protected — never evicted. 0 = unbounded (the pre-bound
    #: behavior: the dir grows without limit under churn).
    artifact_cache_max_bytes: int = 2 << 30


@dataclasses.dataclass
class CompileConfig:
    """Fleet-scale bank-compile plane
    (policy/compiler/compilequeue.py): the parallel work queue behind
    ``BankRegistry.compile_field``, the sharded registry bounds, and
    the compiled-bank artifact distribution. Every knob only moves
    time/memory — failure semantics stay fixed (pending or failed
    banks serve the last-good cover, uncovered patterns fail
    CLOSED)."""

    #: bank-compile worker threads. 0 = inline serial compiles (the
    #: pre-queue loop); 1 = queued but strictly ordered (per-bank
    #: fault attribution is deterministic); >1 = parallel compiles
    workers: int = 2
    #: per-bank compile deadline: a serving-blocking compile still
    #: running this long after submit stops blocking the regeneration —
    #: the bank serves its last-good cover (uncovered patterns fail
    #: closed) and the compile finishes in the background
    deadline_s: float = 30.0
    #: in-queue retry budget for WORKER DEATH (the ``compile.worker``
    #: fault point): a task whose worker dies re-queues with backoff
    #: up to this many times, then fails into quarantine. Compile
    #: exceptions (bad pattern, ``loader.bank_compile`` faults) are
    #: deterministic and quarantine immediately — retrying them is
    #: wasted work; the quarantine TTL is their retry schedule.
    max_retries: int = 3
    #: exponential-backoff base for in-queue retries (doubles per
    #: attempt, deterministic ±10% jitter from the work key)
    backoff_base_s: float = 0.25
    #: backoff ceiling
    backoff_max_s: float = 8.0
    #: bounded in-flight memory: pending + running compile tasks the
    #: queue holds before ``submit`` blocks the producer
    max_pending: int = 256
    #: byte-bounded LRU shards of the bank registry (the 5k-CNP
    #: pattern universe serves in bounded memory; eviction recompiles
    #: or re-fetches on next use)
    registry_shards: int = 8
    #: total byte bound across registry shards
    registry_max_bytes: int = 256 << 20
    #: per-identity fingerprint store byte bound (sharded LRU;
    #: eviction recomputes — never changes a delta, only its cost)
    fp_cache_max_bytes: int = 64 << 20
    #: publish compiled bank groups into the loader's ArtifactCache
    #: (sha256-checksummed) and fetch them on registry miss — compiled
    #: banks become location-transparent artifacts (compile anywhere,
    #: distribute; a corrupt/lost artifact degrades to recompile)
    bank_artifacts: bool = True


@dataclasses.dataclass
class AdmissionConfig:
    """Overload admission control (runtime/admission.py): bounded
    verdict-queue occupancy with explicit sheds, two priority classes
    (control traffic never sheds behind data-path verdicts), deadline
    feasibility, and the drain/warm-restart sequence's knobs."""

    enabled: bool = True
    #: verdict-queue occupancy bound: data-path requests shed here
    max_pending: int = 1024
    #: control-class headroom above max_pending (policy/config/drain/
    #: health ops admitted while data traffic sheds)
    control_reserve: int = 64
    #: deadline assigned to requests that carry none (deadline_ms on
    #: the wire overrides per request)
    default_deadline_ms: float = 5000.0
    #: per-session chunk credits a stream server advertises (0
    #: disables credit flow control)
    stream_credit_window: int = 32
    #: drain flush budget: pending verdicts still unflushed after this
    #: resolve as ERROR (the abort tail of a stuck drain)
    drain_timeout_s: float = 30.0
    #: REST API bound: concurrent in-flight handlers before 503 sheds
    api_max_inflight: int = 64


@dataclasses.dataclass
class BreakerConfig:
    """TPU-lane circuit breaker (runtime/service.py): after
    ``failure_threshold`` consecutive device-dispatch failures the
    verdict path trips to the CPU oracle (correct but slower) and
    half-open probes the device lane every ``probe_interval`` seconds
    until a probe succeeds. Mirrors pkg/controller's backoff
    discipline applied to the datapath itself: degrade gracefully,
    never wrongly."""

    enabled: bool = True
    failure_threshold: int = 3
    probe_interval: float = 5.0


@dataclasses.dataclass
class ServeConfig:
    """Continuously-batched serving loop (runtime/serveloop.py +
    engine/ring.py): streams are admitted into verdict-ring slot
    leases and whatever slots have pending chunks are packed into one
    fused dispatch per ``pack_interval_ms``. Off by default — the
    stream path then uses its per-session dispatch (the pre-ring
    behavior); both are verdict-bit-equal."""

    enabled: bool = False
    #: verdict-ring slots (= concurrently admitted streams); a new
    #: stream past this sheds with reason ``ring-full``
    slot_capacity: int = 1024
    #: idle lease lifetime: a stream silent this long loses its slot
    #: (reconnect-with-resume re-grants)
    lease_ttl_s: float = 30.0
    #: continuous-batching cadence: the pack thread drains pending
    #: slots into one fused dispatch this often
    pack_interval_ms: float = 2.0
    #: per-slot pending-chunk bound: a producer outrunning the pack
    #: cycle sheds (``queue-full``) instead of buffering forever
    max_slot_pending: int = 64


@dataclasses.dataclass
class SLOConfig:
    """Declared service-level objectives (runtime/slo.py): the serve
    loop tracks multi-window error-budget burn rates against these
    targets and publishes them as
    ``cilium_tpu_slo_burn_rate{slo,window}`` gauges + the `status`
    op. Targets declare intent — changing them never changes serving
    behavior, only what counts as budget spend."""

    enabled: bool = True
    #: latency SLO: 99% of served chunks complete under this
    #: submit→verdict latency (the p99 target `make serve-soak` holds)
    serve_p99_ms: float = 200.0
    #: availability SLO: the explicit-shed fraction stays under this
    shed_rate: float = 1e-3
    #: trailing burn-rate windows, seconds (multi-window alerting:
    #: a fast page window and a slow ticket window)
    windows_s: Tuple[float, ...] = (300.0, 3600.0)


@dataclasses.dataclass
class ProvenanceConfig:
    """Verdict provenance & the explain plane (engine/attribution.py,
    runtime/explain.py): the attribution output lane rides the fused
    dispatch, memo rows remember the generation they were computed
    under, and sampled (traced) verdicts record bounded explain
    entries queryable via ``GET /v1/explain`` / ``cilium-tpu
    explain``. Disabling drops the ServedPack bundling on the serve
    path (the attribution LANE itself is part of the verdict step and
    costs the same either way)."""

    enabled: bool = True
    #: bounded explain store: trace ids retained (LRU)
    explain_capacity: int = 1024
    #: flows per traced chunk reconstructed for the explain store
    sample_per_chunk: int = 8


@dataclasses.dataclass
class TracingConfig:
    """Flight-recorder knobs (``runtime/tracing.py``): per-request phase
    attribution into a bounded ring, exported by ``GET /v1/trace``.
    ``sample_rate`` admits every ceil(1/rate)-th ingress
    deterministically; ``enabled=False`` reduces every probe to one
    attribute read."""

    enabled: bool = True
    sample_rate: float = 1.0
    ring_capacity: int = 4096


@dataclasses.dataclass
class DSTConfig:
    """Deterministic simulation testing (runtime/dst.py): seeded
    fault-schedule search over the serving plane under virtual time
    (runtime/simclock.py). ``seed`` pins one schedule for replay —
    the same seed reproduces a byte-identical event trace; the sweep
    (``python -m cilium_tpu_torch.runtime.dst``) runs ``schedules``
    seeds of up to ``max_events`` events each and fails on any
    invariant violation. ``mutation`` arms a known-fixed planted bug
    (faults.MUTATIONS) so the lane can prove the search catches it."""

    seed: int = 0
    schedules: int = 200
    max_events: int = 12
    mutation: str = ""


@dataclasses.dataclass
class FleetConfig:
    """Horizontal serving fleet (runtime/fleetserve.py): N agent
    replicas behind a stream-affinity rendezvous router with per-host
    heartbeats. A host that misses heartbeats past ``suspicion_ttl_s``
    is declared dead and FAILS CLOSED (stops serving rather than
    answer from stale policy); the router re-grants its leases on
    survivors and clients replay in-flight chunks through the resume
    protocol. Every knob moves placement/failover timing only —
    verdicts stay bit-equal to a single host."""

    #: simulated/managed serving replicas the fleet lane runs
    replicas: int = 4
    #: seconds between per-host heartbeats on the installed clock
    heartbeat_interval_s: float = 1.0
    #: missed-heartbeat budget: a host silent this long is suspected,
    #: declared dead, and handed off (it fail-closes itself on the
    #: same budget, so a partitioned host stops serving first)
    suspicion_ttl_s: float = 5.0
    #: occupancy fraction kept free per host: past ``1 - headroom``
    #: the router spills NEW streams to emptier hosts, and a host
    #: with no spill target sheds ``host-overloaded``
    spill_headroom: float = 0.1


@dataclasses.dataclass
class TenantConfig:
    """Multi-tenant control plane (runtime/tenant.py): identity
    ranges partition the policy plane into tenant namespaces carried
    through bank keys (one tenant's churn/quarantine never recompiles
    another's banks), the AdmissionGate and CompileQueue run
    weighted-fair per-tenant quanta with per-tenant occupancy bounds
    (a storming tenant sheds ``tenant-quota``; everyone else stays in
    SLO), and the serve/SLO/explain planes carry the tenant label."""

    enabled: bool = False
    #: the namespace of identities matching no declared range (and of
    #: requests that carry no tenant)
    default_tenant: str = "default"
    #: identity-range → tenant declarations, ``"name:lo-hi"`` each
    #: (inclusive numeric identity bounds); first match wins
    ranges: Tuple[str, ...] = ()
    #: per-tenant fair-queueing weights, ``"name:weight"`` each;
    #: undeclared tenants weigh 1.0
    weights: Tuple[str, ...] = ()
    #: per-tenant occupancy ceiling as a fraction of each bounded
    #: surface (admission window, compile-queue pending): one tenant
    #: can burst into idle capacity but never squat past this share
    #: while others are waiting
    max_share: float = 0.5
    #: fairness quantum: the admission fair-share window rotates every
    #: this many virtual seconds (exact-tick boundary)
    quantum_s: float = 1.0
    #: quota-store entry TTL: a per-tenant share not refreshed within
    #: this lapses to the conservative default (``tenant.quota`` fault
    #: point models the read loss)
    quota_ttl_s: float = 60.0


@dataclasses.dataclass
class CanaryConfig:
    """Shadow/canary policy rollout (runtime/canary.py): generation
    N+1 stages alongside the serving N, a sample fraction of ring
    traffic double-dispatches through both in the same pack cycle,
    and commit is REFUSED when the verdict-diff fraction exceeds the
    declared budget — a bad rollout is caught by the diff, not by
    dropped traffic."""

    enabled: bool = False
    #: fraction of ring chunks double-dispatched through the staged
    #: engine (deterministic counter-based selection — no RNG)
    sample_fraction: float = 0.25
    #: commit gate: the observed verdict-diff fraction must stay at or
    #: under this for ``commit`` to proceed (0.0 = any diff refuses)
    diff_budget: float = 0.0
    #: minimum sampled verdicts before the gate will pass a commit
    #: (an unsampled canary never auto-passes)
    min_samples: int = 64


@dataclasses.dataclass
class ParallelConfig:
    """Mesh / sharding layout (the reference's ``ParallelConfig``)."""

    data_axis: str = "data"        # DP over the flow batch
    expert_axis: str = "expert"    # EP over DFA banks
    mesh_shape: Optional[Tuple[int, ...]] = None  # None → all ranks on data
    use_expert_axis: bool = False
    #: sharded verdict lane ``parallel.sharding.stage_for_lane``
    #: builds: "auto" (DP — zero collectives at verdict batch shapes),
    #: "dp", "ep" (bank-sharded one-shot all-to-all re-shard), "cp"
    #: (payload-sharded blockwise scan, one carry exchange per sharded
    #: field). Every lane is verdict-bit-equal — the knob only moves
    #: time and memory.
    lane: str = "auto"
    #: CP inner composition block (bytes per blockwise-SP block inside
    #: each rank's payload shard — parallel/cp.py)
    cp_block: int = 256


@dataclasses.dataclass
class Config:
    """Root config (DaemonConfig analog)."""

    #: master feature gate: True stages a TorchVerdictEngine (on
    #: ``cuda`` unless the loader is given another device), False
    #: serves the CPU oracle. The reference defaults to False (the
    #: oracle); the port defaults to True, so ``Loader()`` serves on the
    #: card unless the gate is set off explicitly
    enable_tpu_offload: bool = True
    #: ``--policy-audit-mode`` analog (reference pkg/option): policy is
    #: evaluated and reported but NOT enforced — flows that would be
    #: denied forward with verdict AUDIT (4) instead of DROPPED, so a
    #: ruleset can be rolled out observe-only before enforcement
    policy_audit_mode: bool = False
    cluster_name: str = "default"      # clustermesh local cluster name
    node_name: str = "node-0"          # this node's name (operator key)
    #: "static" uses pod_cidr as-is; "cluster-pool" registers with the
    #: operator and receives this node's podCIDR from the cluster pool
    ipam_mode: str = "static"
    #: "local" = single-process allocator; "kvstore" = cluster-wide
    #: allocation through the shared store, so every node maps the same
    #: labels to the same identity; "crd" = CiliumIdentity objects in
    #: the k8s apiserver (needs ``k8s_api_socket``)
    identity_allocation_mode: str = "local"
    pod_cidr: str = "10.0.0.0/24"      # this node's IPAM podCIDR (static)
    #: IPs of the kube-apiserver: the agent upserts each into the
    #: ipcache under the reserved kube-apiserver identity, which is what
    #: the `kube-apiserver` entity selects
    kube_apiserver_ips: tuple = ()
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    loader: LoaderConfig = dataclasses.field(default_factory=LoaderConfig)
    breaker: BreakerConfig = dataclasses.field(default_factory=BreakerConfig)
    admission: AdmissionConfig = dataclasses.field(
        default_factory=AdmissionConfig)
    compile: CompileConfig = dataclasses.field(
        default_factory=CompileConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)
    provenance: ProvenanceConfig = dataclasses.field(
        default_factory=ProvenanceConfig)
    dst: DSTConfig = dataclasses.field(default_factory=DSTConfig)
    fleet: FleetConfig = dataclasses.field(default_factory=FleetConfig)
    tenant: TenantConfig = dataclasses.field(default_factory=TenantConfig)
    canary: CanaryConfig = dataclasses.field(default_factory=CanaryConfig)
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig)
    tracing: TracingConfig = dataclasses.field(default_factory=TracingConfig)
    log_level: str = "info"
    #: ``--k8s-api-socket``: CNP/CCNP informers and CiliumEndpoint /
    #: CiliumNode status over a k8s API socket
    k8s_api_socket: str = ""
    #: ``--monitor-aggregation``: none/low emit per-flow TraceNotify
    #: events; medium/maximum suppress them to verdict/drop events. The
    #: agent's default; monitor-socket subscribers pick their own level
    monitor_aggregation: str = "medium"
    #: ``Agent.start()`` installs the JSONL log handler (daemon
    #: behaviour); hosts embedding the agent that own process logging
    #: set False
    configure_logging: bool = True
    enable_metrics: bool = True

    @classmethod
    def from_env(cls, env=os.environ) -> "Config":
        cfg = cls()
        gate = env.get("CILIUM_TPU_ENABLE_OFFLOAD", "").lower()
        if gate in ("1", "true", "yes"):
            cfg.enable_tpu_offload = True
        elif gate in ("0", "false", "no", "off"):
            cfg.enable_tpu_offload = False
        if env.get("CILIUM_TPU_POLICY_AUDIT_MODE", "").lower() in (
                "1", "true", "yes"):
            cfg.policy_audit_mode = True
        if "CILIUM_TPU_BANK_SIZE" in env:
            cfg.engine.bank_size = int(env["CILIUM_TPU_BANK_SIZE"])
        if "CILIUM_TPU_BATCH_SIZE" in env:
            cfg.engine.batch_size = int(env["CILIUM_TPU_BATCH_SIZE"])
        if "CILIUM_TPU_L7G_LEN" in env:
            cfg.engine.l7g_len = int(env["CILIUM_TPU_L7G_LEN"])
        if "CILIUM_TPU_STAGE_UNIQUE_DROP_RATIO" in env:
            cfg.engine.stage_unique_drop_ratio = float(
                env["CILIUM_TPU_STAGE_UNIQUE_DROP_RATIO"])
        if env.get("CILIUM_TPU_VERDICT_MEMO", "").lower() in (
                "0", "false", "no", "off"):
            cfg.engine.verdict_memo = False
        if env.get("CILIUM_TPU_KERNEL_IMPL", "") in (
                "auto", "autotune", "dfa-dense", "nfa-bitset", "legacy"):
            cfg.engine.kernel_impl = env["CILIUM_TPU_KERNEL_IMPL"]
        if "CILIUM_TPU_CACHE_DIR" in env:
            cfg.loader.cache_dir = env["CILIUM_TPU_CACHE_DIR"]
        if env.get("CILIUM_TPU_BANK_ISOLATION", "").lower() in (
                "0", "false", "no", "off"):
            cfg.loader.bank_isolation = False
        if "CILIUM_TPU_BANK_QUARANTINE_TTL_S" in env:
            cfg.loader.bank_quarantine_ttl_s = float(
                env["CILIUM_TPU_BANK_QUARANTINE_TTL_S"])
        if "CILIUM_TPU_ARTIFACT_CACHE_MAX_BYTES" in env:
            cfg.loader.artifact_cache_max_bytes = int(
                env["CILIUM_TPU_ARTIFACT_CACHE_MAX_BYTES"])
        if "CILIUM_TPU_IDENTITY_REGEN_DEBOUNCE_S" in env:
            cfg.loader.identity_regen_debounce_s = float(
                env["CILIUM_TPU_IDENTITY_REGEN_DEBOUNCE_S"])
        if "CILIUM_TPU_COMPILE_WORKERS" in env:
            cfg.compile.workers = int(env["CILIUM_TPU_COMPILE_WORKERS"])
        if "CILIUM_TPU_COMPILE_DEADLINE_S" in env:
            cfg.compile.deadline_s = float(
                env["CILIUM_TPU_COMPILE_DEADLINE_S"])
        if "CILIUM_TPU_COMPILE_MAX_RETRIES" in env:
            cfg.compile.max_retries = int(
                env["CILIUM_TPU_COMPILE_MAX_RETRIES"])
        if "CILIUM_TPU_COMPILE_REGISTRY_MAX_BYTES" in env:
            cfg.compile.registry_max_bytes = int(
                env["CILIUM_TPU_COMPILE_REGISTRY_MAX_BYTES"])
        if env.get("CILIUM_TPU_COMPILE_BANK_ARTIFACTS", "").lower() in (
                "0", "false", "no", "off"):
            cfg.compile.bank_artifacts = False
        if "CILIUM_TPU_ADMISSION_MAX_PENDING" in env:
            cfg.admission.max_pending = int(
                env["CILIUM_TPU_ADMISSION_MAX_PENDING"])
        if "CILIUM_TPU_STREAM_CREDIT_WINDOW" in env:
            cfg.admission.stream_credit_window = int(
                env["CILIUM_TPU_STREAM_CREDIT_WINDOW"])
        if env.get("CILIUM_TPU_SERVE_LOOP", "").lower() in (
                "1", "true", "yes"):
            cfg.serve.enabled = True
        if "CILIUM_TPU_SERVE_SLOT_CAPACITY" in env:
            cfg.serve.slot_capacity = int(
                env["CILIUM_TPU_SERVE_SLOT_CAPACITY"])
        if "CILIUM_TPU_SERVE_LEASE_TTL_S" in env:
            cfg.serve.lease_ttl_s = float(
                env["CILIUM_TPU_SERVE_LEASE_TTL_S"])
        if "CILIUM_TPU_SERVE_PACK_INTERVAL_MS" in env:
            cfg.serve.pack_interval_ms = float(
                env["CILIUM_TPU_SERVE_PACK_INTERVAL_MS"])
        if "CILIUM_TPU_NODE_NAME" in env:
            cfg.node_name = env["CILIUM_TPU_NODE_NAME"]
        if "CILIUM_TPU_IPAM_MODE" in env:
            cfg.ipam_mode = env["CILIUM_TPU_IPAM_MODE"]
        if env.get("CILIUM_TPU_TRACING", "").lower() in ("0", "false",
                                                         "no", "off"):
            cfg.tracing.enabled = False
        if "CILIUM_TPU_TRACE_SAMPLE_RATE" in env:
            cfg.tracing.sample_rate = float(
                env["CILIUM_TPU_TRACE_SAMPLE_RATE"])
        if "CILIUM_TPU_SLO_SERVE_P99_MS" in env:
            cfg.slo.serve_p99_ms = float(
                env["CILIUM_TPU_SLO_SERVE_P99_MS"])
        if "CILIUM_TPU_SLO_SHED_RATE" in env:
            cfg.slo.shed_rate = float(env["CILIUM_TPU_SLO_SHED_RATE"])
        if env.get("CILIUM_TPU_PROVENANCE", "").lower() in (
                "0", "false", "no", "off"):
            cfg.provenance.enabled = False
        if "CILIUM_TPU_EXPLAIN_CAPACITY" in env:
            cfg.provenance.explain_capacity = int(
                env["CILIUM_TPU_EXPLAIN_CAPACITY"])
        if env.get("CILIUM_TPU_PARALLEL_LANE", "") in (
                "auto", "dp", "ep", "cp"):
            cfg.parallel.lane = env["CILIUM_TPU_PARALLEL_LANE"]
        if "CILIUM_TPU_CP_BLOCK" in env:
            cfg.parallel.cp_block = int(env["CILIUM_TPU_CP_BLOCK"])
        if "CILIUM_TPU_DST_SEED" in env:
            cfg.dst.seed = int(env["CILIUM_TPU_DST_SEED"])
        if "CILIUM_TPU_DST_MUTATION" in env:
            cfg.dst.mutation = env["CILIUM_TPU_DST_MUTATION"]
        if "CILIUM_TPU_FLEET_REPLICAS" in env:
            cfg.fleet.replicas = int(env["CILIUM_TPU_FLEET_REPLICAS"])
        if "CILIUM_TPU_FLEET_HEARTBEAT_INTERVAL_S" in env:
            cfg.fleet.heartbeat_interval_s = float(
                env["CILIUM_TPU_FLEET_HEARTBEAT_INTERVAL_S"])
        if "CILIUM_TPU_FLEET_SUSPICION_TTL_S" in env:
            cfg.fleet.suspicion_ttl_s = float(
                env["CILIUM_TPU_FLEET_SUSPICION_TTL_S"])
        if "CILIUM_TPU_FLEET_SPILL_HEADROOM" in env:
            cfg.fleet.spill_headroom = float(
                env["CILIUM_TPU_FLEET_SPILL_HEADROOM"])
        if env.get("CILIUM_TPU_TENANT_ISOLATION", "").lower() in (
                "1", "true", "yes"):
            cfg.tenant.enabled = True
        if "CILIUM_TPU_TENANT_RANGES" in env:
            cfg.tenant.ranges = tuple(
                s for s in env["CILIUM_TPU_TENANT_RANGES"].split(",")
                if s)
        if "CILIUM_TPU_TENANT_WEIGHTS" in env:
            cfg.tenant.weights = tuple(
                s for s in env["CILIUM_TPU_TENANT_WEIGHTS"].split(",")
                if s)
        if "CILIUM_TPU_TENANT_MAX_SHARE" in env:
            cfg.tenant.max_share = float(
                env["CILIUM_TPU_TENANT_MAX_SHARE"])
        if "CILIUM_TPU_TENANT_QUANTUM_S" in env:
            cfg.tenant.quantum_s = float(
                env["CILIUM_TPU_TENANT_QUANTUM_S"])
        if "CILIUM_TPU_TENANT_QUOTA_TTL_S" in env:
            cfg.tenant.quota_ttl_s = float(
                env["CILIUM_TPU_TENANT_QUOTA_TTL_S"])
        if env.get("CILIUM_TPU_CANARY", "").lower() in (
                "1", "true", "yes"):
            cfg.canary.enabled = True
        if "CILIUM_TPU_CANARY_SAMPLE_FRACTION" in env:
            cfg.canary.sample_fraction = float(
                env["CILIUM_TPU_CANARY_SAMPLE_FRACTION"])
        if "CILIUM_TPU_CANARY_DIFF_BUDGET" in env:
            cfg.canary.diff_budget = float(
                env["CILIUM_TPU_CANARY_DIFF_BUDGET"])
        if "CILIUM_TPU_CANARY_MIN_SAMPLES" in env:
            cfg.canary.min_samples = int(
                env["CILIUM_TPU_CANARY_MIN_SAMPLES"])
        return cfg

    @classmethod
    def from_toml(cls, path: str) -> "Config":
        """The reference's reader: root keys, then each section's keys
        that the section's dataclass has (a list becomes a tuple). A
        file that does not set ``enable_tpu_offload`` keeps the port's
        default (True)."""
        with open(path, "rb") as f:
            data = tomllib.load(f)
        cfg = cls()
        cfg.enable_tpu_offload = bool(data.get("enable_tpu_offload",
                                               cfg.enable_tpu_offload))
        for key in ("cluster_name", "node_name", "ipam_mode", "pod_cidr",
                    "identity_allocation_mode", "log_level",
                    "monitor_aggregation"):
            if key in data:
                setattr(cfg, key, data[key])
        if "kube_apiserver_ips" in data:
            cfg.kube_apiserver_ips = tuple(data["kube_apiserver_ips"])
        for section, target in (("engine", cfg.engine),
                                ("loader", cfg.loader),
                                ("parallel", cfg.parallel),
                                ("breaker", cfg.breaker),
                                ("tracing", cfg.tracing),
                                ("admission", cfg.admission),
                                ("compile", cfg.compile),
                                ("serve", cfg.serve),
                                ("slo", cfg.slo),
                                ("provenance", cfg.provenance),
                                ("dst", cfg.dst),
                                ("fleet", cfg.fleet),
                                ("tenant", cfg.tenant),
                                ("canary", cfg.canary)):
            for k, v in data.get(section, {}).items():
                if hasattr(target, k):
                    setattr(target, k, tuple(v) if isinstance(v, list) else v)
        return cfg
