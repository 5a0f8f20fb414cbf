"""Loader: compile → stage → hot-swap, behind the feature gate (the
port's copy of the reference's ``runtime/loader.py``).

Rule sets compile to numpy arrays (``CompiledPolicy.build``, through
the content-addressed :class:`~cilium_tpu_torch.policy.compiler.
bankplan.BankRegistry` by default), stage as a
:class:`~cilium_tpu_torch.engine.verdict.TorchVerdictEngine` on the
loader's device, and the active engine swaps atomically. The
``enable_tpu_offload`` gate selects the staged engine (the port's
default) or the CPU oracle.

``device`` is ``cuda`` unless the caller passes another one (the tests
pass ``"cpu"``, which routes every kernel wrapper to its plain
version); with the gate on and no CUDA, construction raises. A stage
or swap failure rolls back and raises — the oracle is never swapped in
for a failed stage (``fallback_engine`` is built only when asked for).

The reference enables a persistent XLA compilation cache here
(``runtime/xla_cache.py``); the port has no counterpart: its CUDA
kernels are built once per source and cached by ``engine/_build.py``.
The engine-type checks of the no-change and warm-restore fast paths
test ``isinstance(..., TorchVerdictEngine)``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from cilium_tpu_torch.core.config import Config
from cilium_tpu_torch.core.device import resolve_device
from cilium_tpu_torch.core.labels import LabelSet
from cilium_tpu_torch.policy.mapstate import MapState, PolicyResolver
from cilium_tpu_torch.policy.oracle import OracleVerdictEngine
from cilium_tpu_torch.policy.repository import Repository
from cilium_tpu_torch.policy.selectorcache import SelectorCache
from cilium_tpu_torch.runtime.checkpoint import ArtifactCache, ruleset_fingerprint
from cilium_tpu_torch.runtime import faults
from cilium_tpu_torch.runtime.logging import get_logger, span as _log_span
from cilium_tpu_torch.runtime.metrics import (
    BANK_HOTSWAPS,
    LOADER_ROLLBACKS,
    METRICS,
    SpanStat,
    WARM_RESTORES,
)
from cilium_tpu_torch.runtime.tracing import PHASE_HOST, TRACER

LOG = get_logger("loader")

#: fires between stage and commit: a crash here must leave the
#: PREVIOUS revision serving
SWAP_POINT = faults.register_point(
    "loader.swap", "revision swap in Loader.regenerate")

#: artifact-cache key of the warm-restart snapshot (graceful drain
#: writes it; a restarted loader restores from it). Versioned like
#: the policy fingerprint epochs — bump on layout change so stale
#: snapshots read as a clean miss, never as a misparse.
WARM_STATE_KEY = "warm-state-v1"


def _identity_entry_tuple(ms) -> tuple:
    """The verdict-relevant content of one identity's MapState — every
    key/entry field that can change a verdict must appear here, or two
    policies differing only in that field would share a fingerprint."""
    return (
        tuple(sorted(
            (k.identity, k.dport, k.proto, k.direction, k.port_plen,
             e.is_deny, e.l7_wildcard, e.auth_required,
             tuple(sorted(repr(lr) for lr in e.l7_rules)))
            for k, e in ms.entries.items()
        )),
        ms.ingress_enforced,
        ms.egress_enforced,
        getattr(ms, "audit", False),
    )


def identity_fingerprints(per_identity: Dict[int, "MapState"]
                          ) -> Dict[int, str]:
    """Per-identity content fingerprints — the unit of the bank-scoped
    invalidation delta. Cross-process-stable (pickle+sha, like every
    checkpoint fingerprint): a CNP add/delete changes exactly the
    fingerprints of the identities it selects, so a committed revision
    can tell memo owners WHICH rows may have moved."""
    return {ep: ruleset_fingerprint(_identity_entry_tuple(ms))
            for ep, ms in per_identity.items()}


#: rule-family accessors of one L7Rules object — the split behind the
#: family-granular (bank-reference) invalidation delta. The generic
#: accessor splits further at runtime: ``l7proto`` rules whose proto
#: has a registered engine frontend fingerprint under that frontend's
#: family name (cassandra/memcache/r2d2), so a cassandra-rule change
#: refills only cassandra memo rows.
_L7_FAMILIES = (("http", "http"), ("kafka", "kafka"), ("dns", "dns"),
                ("generic", "l7"))


def _l7_family_names() -> tuple:
    """Every family name the split can produce: the static four plus
    the registered frontend families (policy/compiler/frontends)."""
    from cilium_tpu_torch.policy.compiler import frontends as _fe

    return tuple(name for name, _ in _L7_FAMILIES) + tuple(
        sorted(set(_fe.family_names().values())))


def _family_port_of(key) -> int:
    """The bank-reference port bucket of one MapState entry key:
    its exact dport for an exact-port entry, PORT_ALL for wildcard/
    range entries (a row on ANY port may route through them)."""
    from cilium_tpu_torch.engine.memo import PORT_ALL

    plen = getattr(key, "port_plen", None)
    if plen is None:
        plen = 0 if key.dport == 0 else 16
    if key.dport == 0 or plen != 16:
        return PORT_ALL
    return int(key.dport)


def _identity_family_tuples(ms) -> Dict[str, object]:
    """One identity's MapState, split into the independently-
    fingerprintable pieces a verdict reads: ``struct`` (keys, deny/
    auth/wildcard bits, enforcement flags, which entries carry L7
    rules at all — what EVERY row of the identity reads through the
    mapstate gather) plus, per rule family, a PER-PORT split of the
    entries carrying that family's rules (what only rows of that L7
    type AND that destination port read — a row reads a bank only
    through its own entry's ruleset). A path-bank swap on port 8080
    moves only the ``http``/8080 tuple, so the identity's DNS/kafka
    rows — and its port-80 HTTP rows — keep serving."""
    from cilium_tpu_torch.policy.compiler import frontends as _fe

    struct = []
    fam: Dict[str, Dict[int, list]] = {name: {}
                                       for name in _l7_family_names()}
    for k, e in sorted(ms.entries.items(),
                       key=lambda kv: repr(kv[0])):
        key = (k.identity, k.dport, k.proto, k.direction, k.port_plen)
        struct.append((key, e.is_deny, e.l7_wildcard, e.auth_required,
                       bool(e.l7_rules)))
        port = _family_port_of(k)
        for name, attr in _L7_FAMILIES[:3]:
            rules = tuple(sorted(
                repr(r) for lr in e.l7_rules
                for r in getattr(lr, attr)))
            if rules:
                fam[name].setdefault(port, []).append((key, rules))
        # generic/frontend split: each l7proto rule set fingerprints
        # under its FRONTEND family when one is registered, so a
        # cassandra-only change never refills generic (or memcache)
        # rows — the frontend half of the bank-reference granularity
        by_fam: Dict[str, list] = {}
        for lr in e.l7_rules:
            if not lr.l7proto:
                continue
            name = _fe.family_name_of(lr.l7proto) or "generic"
            by_fam.setdefault(name, []).append(
                (lr.l7proto, tuple(sorted(repr(r) for r in lr.l7))))
        for name, rules in by_fam.items():
            fam[name].setdefault(port, []).append(
                (key, tuple(sorted(rules))))
    out: Dict[str, object] = {
        "struct": (tuple(struct), ms.ingress_enforced,
                   ms.egress_enforced, getattr(ms, "audit", False))}
    out.update({name: {port: tuple(v) for port, v in ports.items()}
                for name, ports in fam.items()})
    return out


def identity_family_fingerprints(per_identity: Dict[int, "MapState"]
                                 ) -> Dict[int, Dict[str, object]]:
    """Per-identity per-family-per-port fingerprints: ``{identity:
    {"struct": fp, "http": {port: fp, ...}, "kafka": {...}, "dns":
    {...}, "generic": {...}}}`` — the inputs of the bank-reference
    :class:`PolicyDelta` narrowing (engine/memo.py). A commit whose
    only difference is one family's rules on one port produces a
    delta that refills ONLY that family's rows on that port, counted
    honestly as misses. Port :data:`~cilium_tpu_torch.engine.memo.PORT_ALL`
    buckets wildcard/range entries."""
    return {ep: _family_fps_of_tuples(_identity_family_tuples(ms))
            for ep, ms in per_identity.items()}


def _family_fps_of_tuples(tuples: Dict[str, object]
                          ) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for name, t in tuples.items():
        if name == "struct":
            out[name] = ruleset_fingerprint(t)
        else:
            out[name] = {port: ruleset_fingerprint(v)
                         for port, v in t.items()}
    return out


def _identity_bundle(ms) -> tuple:
    """(whole-identity fp, family/port fps) of one MapState in ONE
    entry walk — the unit the sharded FingerprintStore caches so a
    10k-identity regeneration fingerprints only the identities whose
    resolved state actually changed."""
    return (ruleset_fingerprint(_identity_entry_tuple(ms)),
            _family_fps_of_tuples(_identity_family_tuples(ms)))


def _referenced_secret_values(per_identity, secrets) -> tuple:
    """(namespace, name, value) for every secret referenced by a
    header match in the snapshot — the slice of the secret store that
    affects compiled requirements."""
    refs = set()
    for ms in per_identity.values():
        for entry in ms.entries.values():
            for lr in entry.l7_rules:
                for h in lr.http:
                    for hm in h.header_matches:
                        if hm.secret is not None:
                            refs.add(hm.secret)
    if not refs or secrets is None:
        return ()
    return tuple(sorted(
        (ns, name, secrets.lookup(ns, name) or "") for ns, name in refs))


class Loader:
    """Owns the active engine; single-writer regeneration (the
    reference's endpoint-regeneration queue is serialized per endpoint;
    our unit of regeneration is the whole policy snapshot)."""

    def __init__(self, config: Optional[Config] = None, device=None,
                 secrets=None):
        self.config = config or Config()
        #: the staged engine's device: ``cuda`` unless the caller names
        #: another (raises without CUDA); the oracle needs none
        self.device = (resolve_device(device)
                       if self.config.enable_tpu_offload else device)
        #: optional SecretStore: secret-backed header-match values
        #: resolve against it at compile (both engines see the same
        #: snapshot; its fingerprint enters the artifact key so secret
        #: rotation recompiles)
        self.secrets = secrets
        self._lock = threading.Lock()
        self._engine = None
        self._revision = 0
        #: declared tenant partition (None = tenant-blind): built once
        #: from [tenant] config — the bank namer, the compile queue's
        #: fair-share weights, and the admission plane all read it
        if self.config.tenant.enabled:
            from cilium_tpu_torch.runtime.tenant import TenantMap

            self.tenant_map: Optional[TenantMap] = \
                TenantMap.from_config(self.config)
        else:
            self.tenant_map = None
        #: staged generation N+1 (shadow engine + snapshot) while a
        #: canary rollout samples — NEVER the serving engine until
        #: commit_canary() promotes it through the normal regenerate
        self._canary_engine = None
        self._canary_snapshot: Optional[Dict[int, MapState]] = None
        self._canary_revision = 0
        #: the staged snapshot (identity → MapState); the proxy bridge
        #: walks it host-side for per-request header-rewrite ops (the
        #: winning entry's HTTP rules carry the mismatch actions)
        self.per_identity: Dict[int, MapState] = {}
        self._cache = ArtifactCache(
            self.config.loader.cache_dir,
            self.config.loader.enable_cache,
            max_bytes=self.config.loader.artifact_cache_max_bytes)
        self._cache.set_protected({WARM_STATE_KEY})
        # per-loader DFA bank cache (the positional path): incremental
        # rule updates recompile only the banks whose pattern group
        # changed
        from cilium_tpu_torch.policy.compiler.dfa import BankCache

        self.bank_cache = BankCache()
        #: sharded per-identity fingerprint store: the 10k-identity
        #: fingerprint walk is O(Δ) when the caller reuses unchanged
        #: MapState objects (runtime/fingerprints.py)
        from cilium_tpu_torch.runtime.fingerprints import FingerprintStore

        self._fp_store = FingerprintStore(
            max_bytes=self.config.compile.fp_cache_max_bytes)
        # content-addressed bank registry (policy/compiler/bankplan):
        # the churn-proof compile path — content-defined partition, per-
        # bank quarantine, O(Δ) rebuilds. Supersedes bank_cache when on.
        # The fleet-scale plane rides it: a parallel compile queue
        # ([compile] workers > 0), byte-bounded registry shards, and
        # distributable checksum-verified bank artifacts.
        if self.config.loader.bank_isolation:
            from cilium_tpu_torch.policy.compiler.bankplan import BankRegistry
            from cilium_tpu_torch.policy.compiler.compilequeue import (
                CompileQueue,
            )
            from cilium_tpu_torch.runtime.checkpoint import BankArtifactStore

            ccfg = self.config.compile
            queue = None
            if ccfg.workers > 0:
                # tenant-aware fair queueing: weights + the per-tenant
                # occupancy bound come from the declared partition, so
                # one tenant's compile storm queues against itself
                weight_of = (self.tenant_map.weight_of
                             if self.tenant_map is not None else None)
                tenant_share = (self.config.tenant.max_share
                                if self.tenant_map is not None else 1.0)
                queue = CompileQueue(
                    workers=ccfg.workers,
                    deadline_s=ccfg.deadline_s,
                    max_retries=ccfg.max_retries,
                    backoff_base_s=ccfg.backoff_base_s,
                    backoff_max_s=ccfg.backoff_max_s,
                    max_pending=ccfg.max_pending,
                    weight_of=weight_of,
                    tenant_max_share=tenant_share)
            artifacts = None
            if ccfg.bank_artifacts and self.config.loader.enable_cache:
                artifacts = BankArtifactStore(self._cache)
            self.bank_registry = BankRegistry(
                quarantine_ttl_s=self.config.loader.bank_quarantine_ttl_s,
                max_bytes=ccfg.registry_max_bytes,
                shards=ccfg.registry_shards,
                queue=queue, artifacts=artifacts)
        else:
            self.bank_registry = None
        #: per-identity fingerprints + bank plan of the SERVING policy
        #: (None/empty until the first staged commit): the inputs of the
        #: bank-scoped PolicyDelta a commit hands to memo owners
        self._identity_fps: Optional[Dict[int, str]] = None
        #: per-identity per-family fingerprints of the serving policy
        #: (identity_family_fingerprints) — the family-granular half
        #: of the delta; None whenever _identity_fps is
        self._identity_family_fps: Optional[
            Dict[int, Dict[str, str]]] = None
        self._globals_fp: Optional[str] = None
        self._bank_plan: Dict[str, tuple] = {}
        #: True while the serving policy contains quarantined banks —
        #: degraded builds are never cached, never warm-snapshotted,
        #: and always commit a FULL delta
        self._degraded = False
        self._warned_oracle_scale = False
        # lazily-built CPU oracle over the ACTIVE snapshot: the circuit
        # breaker's fallback lane (runtime/service.py). Cached per
        # revision; invalidated by _commit.
        self._fallback = None
        self._fallback_revision = -1
        #: artifact-cache key of the ACTIVE compiled policy (None on
        #: the oracle backend) — what the warm-restart snapshot points
        #: at so a restarted loader skips fingerprint + compile
        self._last_artifact_key: Optional[str] = None

    @property
    def revision(self) -> int:
        return self._revision

    @property
    def engine(self):
        with self._lock:
            return self._engine

    @property
    def fallback_engine(self):
        """CPU oracle over the currently-serving snapshot — the
        circuit breaker's degraded lane. When the active engine IS the
        oracle (gate off) it is returned directly; otherwise an
        OracleVerdictEngine is built lazily and cached until the next
        revision commit. Always correct, never fast."""
        with self._lock:
            engine = self._engine
            revision = self._revision
            per_identity = self.per_identity
            if engine is None or isinstance(engine, OracleVerdictEngine):
                return engine
            if self._fallback is not None \
                    and self._fallback_revision == revision:
                return self._fallback
        secret_lookup = (self.secrets.lookup
                         if self.secrets is not None else None)
        fallback = OracleVerdictEngine(
            per_identity, secret_lookup=secret_lookup,
            audit=self.config.policy_audit_mode)
        with self._lock:
            # only install if no newer revision committed meanwhile
            if self._revision == revision:
                self._fallback = fallback
                self._fallback_revision = revision
        return fallback

    def _commit(self, engine, revision: int,
                per_identity: Dict[int, MapState], backend: str,
                delta=None):
        """The revision swap — ONE critical section, so a reader sees
        either the old (engine, revision, snapshot) triple or the new
        one, never a mix. The loader.swap injection point fires just
        before: a fault here models a crash mid-swap, and regenerate's
        rollback guarantees the previous table keeps serving.

        ``delta`` (engine.memo.PolicyDelta, default FULL) tells memo
        owners what this commit actually changed: a bank-scoped delta
        lets sessions drop only the rows touching a changed bank, and
        a no-change delta (same artifact key) drops nothing."""
        faults.maybe_fail(SWAP_POINT)
        with self._lock:
            self._engine = engine
            self._revision = revision
            self.per_identity = per_identity
            self._fallback = None
            self._fallback_revision = -1
        # every committed revision — regenerate, warm restore, oracle
        # alike — bumps the process-global policy generation so
        # device-resident verdict memos (engine/memo.py) can never
        # serve a verdict computed under a previous revision. The
        # import stays lazy: memo.py is jax-free at module level, and
        # the oracle-only loader path must remain so too.
        from cilium_tpu_torch.engine.memo import POLICY_GENERATION

        POLICY_GENERATION.bump(delta)
        METRICS.inc("cilium_tpu_regenerations_total",
                    labels={"backend": backend})
        return engine

    def regenerate(self, per_identity: Dict[int, MapState],
                   revision: int = 0):
        """Compile + stage a policy snapshot; atomic swap on success
        (old engine keeps serving until then — the reference's datapath
        likewise keeps enforcing during regeneration). Any failure
        before or during the swap ROLLS BACK: the previous
        (engine, revision, snapshot) triple is restored verbatim and
        keeps serving, the rollback is counted, and the error
        propagates to the caller."""
        with self._lock:
            prev = (self._engine, self._revision, self.per_identity,
                    self._last_artifact_key, self._identity_fps,
                    self._globals_fp, self._bank_plan, self._degraded,
                    self._identity_family_fps)
        # regeneration is its own ingress: a root trace per attempt, so
        # compile/stage cost and rollbacks are attributable like any
        # request (and the staged-revision log line carries the id)
        with TRACER.trace("loader.regenerate", revision=revision):
            try:
                return self._regenerate(per_identity, revision)
            except Exception as e:
                with self._lock:
                    # ctlint: disable=thread-safety  # rollback restores the pre-attempt snapshot verbatim under the lock; regenerate() is the only writer between read and restore and it is the frame raising here
                    self._engine, self._revision, self.per_identity = \
                        prev[:3]
                    # the artifact pointer rolls back WITH the triple:
                    # a compile that succeeded before the failed swap
                    # already moved it, and a later snapshot_warm /
                    # restore_warm would otherwise restage the ABORTED
                    # revision's policy under the serving revision's
                    # name. The "rollback-artifact-key" mutation
                    # re-plants exactly that bug.
                    if not faults.mutation_active("rollback-artifact-key"):
                        self._last_artifact_key = prev[3]
                        self._update_protected()
                    # ...and so do the delta inputs: fingerprints/plan
                    # of the ABORTED build must not seed the next
                    # commit's bank-scoped invalidation
                    self._identity_fps = prev[4]
                    self._globals_fp = prev[5]
                    # ctlint: disable=thread-safety  # same rollback window as above: the snapshot is restored wholesale, racing writers rolled back with it
                    self._bank_plan = prev[6]
                    self._degraded = prev[7]
                    self._identity_family_fps = prev[8]
                    self._fallback = None
                    self._fallback_revision = -1
                # a rollback is a serving-state change too: memos
                # filled against the aborted revision's partial state
                # (the swap point fires between stage and commit)
                # must drop, exactly like a successful commit
                from cilium_tpu_torch.engine.memo import POLICY_GENERATION

                POLICY_GENERATION.bump()
                METRICS.inc(LOADER_ROLLBACKS)
                TRACER.event("loader.rollback", revision=revision,
                             serving_revision=prev[1],
                             error=f"{type(e).__name__}: {e}")
                LOG.error("regeneration rolled back",
                          extra={"fields": {
                              "revision": revision,
                              "serving_revision": prev[1],
                              "error": f"{type(e).__name__}: {e}"}})
                raise

    def _regenerate(self, per_identity: Dict[int, MapState],
                    revision: int = 0):
        secret_lookup = (self.secrets.lookup
                         if self.secrets is not None else None)
        if not self.config.enable_tpu_offload:
            # the oracle is a correctness reference, not a fast path:
            # at headline scale (1k-rule policies) its per-request
            # regex scan has seconds-scale batch latency. Warn ONCE
            # per loader instead of letting a production-sized policy
            # silently crawl.
            n_l7 = 0 if self._warned_oracle_scale else sum(
                len(lr.http) + len(lr.kafka) + len(lr.dns) + len(lr.l7)
                for ms in per_identity.values()
                for e in ms.entries.values() for lr in e.l7_rules)
            if n_l7 >= 200:
                self._warned_oracle_scale = True
                LOG.warning(
                    "oracle backend with %d L7 rules: the CPU matcher "
                    "is the correctness reference, not a fast path — "
                    "expect seconds-scale batch latency; enable the "
                    "staged engine (enable_tpu_offload) for production "
                    "rule counts", n_l7)
            engine = OracleVerdictEngine(
                per_identity, secret_lookup=secret_lookup,
                audit=self.config.policy_audit_mode)
            # delta inputs move under the loader lock: bank_status /
            # _delta_for read them from other threads mid-regeneration
            with self._lock:
                self._last_artifact_key = None
                self._identity_fps = None
                self._identity_family_fps = None
                self._globals_fp = None
                self._bank_plan = {}
                self._degraded = False
            return self._commit(engine, revision, per_identity, "oracle")

        from cilium_tpu_torch.engine.memo import PolicyDelta
        from cilium_tpu_torch.engine.compiled import CompiledPolicy
        from cilium_tpu_torch.engine.verdict import TorchVerdictEngine

        # "policy-v11": v2 gained the ms_auth array; v3 port-range prefix
        # keys (ms_plens + the w2 repack); v4 the audit_mode scalar; v5
        # the per-endpoint audit bit (enf_flags grew a column); v6 the
        # distillery template dedup (ms_tmpl_ids; key_w0 holds template
        # ids); v7 the content-addressed bank partition (lane layout
        # differs from the positional grouping); v8 the megakernel
        # resolve plan (rp_* group arrays + resolve_meta on the
        # artifact); v9 kafka/generic predicate groups joined the plan
        # (rp_k_*/rp_gen_*); v10 the attribution lane's rule→group
        # maps (rp_rule_group/rp_k_rule_group/rp_gen_rule_group +
        # group-member meta); v11 the protocol-frontend compiler plane
        # (fe rule tables + l7g automaton stack + rp_fe_* groups +
        # frontend enum predicates in the gen pair interns, l7-type
        # lanes normalized to frontend families) — each bump
        # invalidates older cached artifacts.
        # The key is now derived from the per-identity fingerprints +
        # a globals fingerprint, so the SAME inputs also seed the
        # bank-scoped invalidation delta. Both fingerprint views come
        # from ONE walk through the sharded store: identities whose
        # resolved MapState object is unchanged since the last
        # regeneration don't re-fingerprint (O(Δ) at 10k identities).
        bundles = self._fp_store.bundle(per_identity, _identity_bundle)
        fps = {ep: b[0] for ep, b in bundles.items()}
        fam_fps_all = {ep: b[1] for ep, b in bundles.items()}
        globals_fp = ruleset_fingerprint(
            self.config.policy_audit_mode,
            repr(self.config.engine),
            bool(self.config.loader.bank_isolation),
            # the tenant partition shapes the bank order (and thus the
            # compiled lane layout): flipping/redeclaring it must read
            # as a different policy, never as a stale-artifact hit
            (self.config.tenant.enabled, self.config.tenant.ranges,
             self.config.tenant.default_tenant),
            # only secrets actually REFERENCED by this snapshot's
            # header matches enter the key: rotating an unrelated
            # secret must not invalidate every cached artifact
            _referenced_secret_values(per_identity, self.secrets),
        )
        key = ruleset_fingerprint(
            "policy-v11", globals_fp, tuple(sorted(fps.items())))
        with self._lock:
            serving_engine = self._engine
            serving_key = self._last_artifact_key
            serving_degraded = self._degraded
        if (key == serving_key and not serving_degraded
                and isinstance(serving_engine, TorchVerdictEngine)):
            # byte-identical policy re-committed (identity churn that
            # netted out, a redundant update): keep the serving engine,
            # advance the revision, and tell memo owners NOTHING
            # changed — the add-then-delete case of the churn plane
            with self._lock:
                self._identity_fps = fps
                self._identity_family_fps = fam_fps_all
            return self._commit(serving_engine, revision, per_identity,
                                "torch", delta=PolicyDelta.none())
        policy = self._cache.get(key)
        cached = policy is not None
        if policy is None:
            if self.bank_registry is not None:
                # install THIS snapshot's pattern → namespace map
                # before compiling: the partition splits by namespace
                # first, so tenant A's churn can only perturb banks
                # inside A's namespace (or the shared one)
                self.bank_registry.namer = \
                    self._tenant_namer(per_identity)
            with SpanStat("policy_compile") as span, \
                    TRACER.span("policy.compile", phase=PHASE_HOST,
                                identities=len(per_identity)):
                policy = CompiledPolicy.build(
                    per_identity, self.config.engine, revision=revision,
                    secret_lookup=secret_lookup,
                    bank_cache=self.bank_cache,
                    bank_registry=self.bank_registry,
                    audit=self.config.policy_audit_mode)
            quarantined = tuple(getattr(policy, "bank_quarantined",
                                        ()) or ())
            if not quarantined:
                # degraded builds (quarantined banks serving stale
                # covers) are never cached: the clean key must keep
                # reading as a miss so the TTL retry recompiles
                self._cache.put(key, policy)
            METRICS.observe("cilium_tpu_compile_seconds", span.seconds)
        else:
            quarantined = tuple(getattr(policy, "bank_quarantined",
                                        ()) or ())
        with _log_span(LOG, "policy staged", revision=revision,
                       identities=len(per_identity), cache_hit=cached):
            with SpanStat("policy_stage"), \
                    TRACER.span("policy.stage", cache_hit=cached):
                engine = TorchVerdictEngine(policy, device=self.device,
                                            cfg=self.config.engine)
        self._record_kernel_plan(policy, engine)
        # serving frontend-rule counts per proto (zeroed protos stop
        # being reported)
        fe_counts: Dict[str, int] = {}
        for proto, _pairs in getattr(policy, "fe_rules", ()) or ():
            fe_counts[proto] = fe_counts.get(proto, 0) + 1
        for proto, n in fe_counts.items():
            METRICS.set_gauge("cilium_tpu_frontend_rules", n,
                              labels={"proto": proto})
        new_plan = dict(getattr(policy, "bank_plan", {}) or {})
        fam_fps = fam_fps_all
        delta = self._delta_for(fps, globals_fp, new_plan,
                                bool(quarantined), fam_fps)
        with self._lock:
            self._last_artifact_key = key if not quarantined else None
            self._identity_fps = fps
            self._identity_family_fps = fam_fps
            self._globals_fp = globals_fp
            self._bank_plan = new_plan
            self._degraded = bool(quarantined)
        # the cache has its own lock — keep it out of ours so the
        # loader lock never nests into the artifact-cache lock
        self._update_protected()
        return self._commit(engine, revision, per_identity, "torch",
                            delta=delta)

    def _delta_for(self, fps: Dict[int, str], globals_fp: str,
                   new_plan: Dict[str, tuple], degraded: bool,
                   fam_fps: Optional[Dict[int, Dict[str, str]]] = None):
        """Bank-scoped PolicyDelta of this commit vs the serving
        state; conservative FULL whenever the serving state can't
        vouch for unchanged rows (first commit, globals change,
        quarantine involved on either side). With family fingerprints
        on both sides the delta narrows to true bank-REFERENCE
        granularity: per changed identity, the (identity, family)
        pairs whose rule family actually moved — FAMILY_ALL when the
        structural MapState did — and, per moved family, the exact
        ports whose entry rule sets changed (PORT_ALL for wildcard/
        range entries)."""
        from cilium_tpu_torch.engine.memo import FAMILY_ALL, PolicyDelta

        # one coherent snapshot of the serving-side delta inputs: a
        # concurrent commit/rollback must not swap them out between
        # the bank diff and the fingerprint diff below
        with self._lock:
            old_plan = dict(self._bank_plan)
            prev_fps = self._identity_fps
            prev_globals_fp = self._globals_fp
            prev_degraded = self._degraded
            prev_fams = self._identity_family_fps
        changed_banks = set()
        for field in set(old_plan) | set(new_plan):
            old_keys = set(old_plan.get(field, ()))
            new_keys = set(new_plan.get(field, ()))
            changed_banks |= old_keys ^ new_keys
            swapped_in = len(new_keys - old_keys)
            if swapped_in:
                METRICS.inc(BANK_HOTSWAPS, swapped_in,
                            labels={"field": field})
        if (prev_fps is None or prev_globals_fp != globals_fp
                or degraded or prev_degraded):
            return PolicyDelta(full=True)
        changed_ids = {ep for ep in set(prev_fps) | set(fps)
                       if prev_fps.get(ep) != fps.get(ep)}
        families: set = set()
        family_ports: set = set()
        if prev_fams is not None and fam_fps is not None:
            for ep in changed_ids:
                old_f = prev_fams.get(ep)
                new_f = fam_fps.get(ep)
                if old_f is None or new_f is None or \
                        old_f.get("struct") != new_f.get("struct"):
                    # appeared/vanished/structural: everything moved
                    families.add((ep, FAMILY_ALL))
                    continue
                moved = [name for name in new_f
                         if name != "struct"
                         and old_f.get(name) != new_f.get(name)]
                if moved:
                    for name in moved:
                        families.add((ep, name))
                        # bank-reference narrowing: the exact entry
                        # ports whose rule sets moved (symmetric diff
                        # of the per-port fingerprints — non-empty by
                        # construction when the family dict differs)
                        oldp = old_f.get(name) or {}
                        newp = new_f.get(name) or {}
                        for port in set(oldp) | set(newp):
                            if oldp.get(port) != newp.get(port):
                                family_ports.add((ep, name, port))
                else:
                    # whole-identity fp moved but neither struct nor
                    # any family tuple did (fingerprint formulation
                    # drift): never narrow past what we can prove
                    families.add((ep, FAMILY_ALL))
        return PolicyDelta.banks(changed_ids, changed_banks,
                                 identity_families=families,
                                 identity_family_ports=family_ports)

    def _record_kernel_plan(self, policy, engine) -> None:
        """Push the staged engine's per-bank kernel picks into the
        bank registry (content-addressed banks carry their kernel
        choice across regenerations) and onto the serving plan the
        `status` op exposes."""
        picks = dict(getattr(engine, "impl_plan", {}) or {})
        self._kernel_plan = picks
        if self.bank_registry is None or not picks:
            return
        field_of_prefix = {"path": "path", "method": "method",
                           "host": "host", "hdr": "hdr", "dns": "dns"}
        for prefix, impl in picks.items():
            field = field_of_prefix.get(prefix, prefix)
            for key in getattr(policy, "bank_plan", {}).get(field, ()):
                self.bank_registry.kernel_picks[key] = impl

    def _update_protected(self) -> None:
        """Keep the byte-bounded artifact cache's eviction-exempt set
        pointing at what we actually serve: the active compiled
        policy's artifact + the warm-restart snapshot."""
        self._cache.set_protected(
            {self._last_artifact_key, WARM_STATE_KEY})

    def kick_expired_bank_rebuilds(self) -> int:
        """Proactively re-submit expired-quarantine banks at
        BACKGROUND priority through the compile queue (the repair
        compiles between regenerations, off the serving critical
        path). Returns the number submitted; 0 when the fleet compile
        plane is off."""
        if self.bank_registry is None:
            return 0
        return self.bank_registry.kick_expired_rebuilds()

    def close(self) -> None:
        """Tear down the owned compile plane (worker threads). The
        loader stays queryable — only background compiles stop; tests
        call this when replacing a loader so abandoned workers never
        outlive their world."""
        if self.bank_registry is not None:
            self.bank_registry.close()

    def bank_status(self) -> Dict[str, object]:
        """Bank registry + serving-plan snapshot (the service `status`
        op's churn-plane face)."""
        if self.bank_registry is None:
            return {"enabled": False}
        with self._lock:
            degraded = self._degraded
            plan = {f: len(k) for f, k in self._bank_plan.items()}
        out: Dict[str, object] = {"enabled": True, "degraded": degraded}
        out.update(self.bank_registry.status())
        out["plan"] = plan
        out["kernel_plan"] = dict(getattr(self, "_kernel_plan", {}))
        out["fp_store"] = self._fp_store.status()
        return out

    # -- tenant namespaces ------------------------------------------------
    def _tenant_namer(self, per_identity: Dict[int, MapState]):
        """Pattern → tenant namespace for THIS snapshot, or None when
        tenancy is off. Walks the snapshot exactly the way the compiler
        extracts pattern text (h.path / h.method / h.host, header
        requirement regexes, DNS matchpattern regexes), claiming each
        pattern for the tenant of the identity carrying it. A pattern
        claimed by two tenants — or one the walk can't attribute
        (kafka/generic/frontend predicates) — lands in the SHARED
        namespace: its banks are common infrastructure, attributable
        to every claimant, and recompiling them isolates no one."""
        if self.tenant_map is None:
            return None
        from cilium_tpu_torch.engine.compiled import header_requirement_regex
        from cilium_tpu_torch.policy.compiler import matchpattern
        from cilium_tpu_torch.runtime.tenant import SHARED_NAMESPACE
        from cilium_tpu_torch.secrets import resolve_header_value

        secret_lookup = (self.secrets.lookup
                         if self.secrets is not None else None)
        claims: Dict[str, str] = {}

        def claim(pat: str, tenant: str) -> None:
            if not pat:
                return
            prev = claims.get(pat)
            if prev is None:
                claims[pat] = tenant
            elif prev != tenant:
                claims[pat] = SHARED_NAMESPACE

        for ep, ms in per_identity.items():
            tenant = self.tenant_map.tenant_of(ep)
            for entry in ms.entries.values():
                for lr in entry.l7_rules:
                    for h in lr.http:
                        claim(h.path, tenant)
                        claim(h.method, tenant)
                        claim(h.host, tenant)
                        for hdr in h.headers:
                            if ":" in hdr:
                                name, value = hdr.split(":", 1)
                            else:
                                name, value = hdr, ""
                            claim(header_requirement_regex(name, value),
                                  tenant)
                        for hm in h.header_matches:
                            value = resolve_header_value(hm,
                                                         secret_lookup)
                            if value is not None:
                                claim(header_requirement_regex(
                                    hm.name, value), tenant)
                    for d in lr.dns:
                        if d.match_name:
                            claim(matchpattern.name_to_regex(
                                d.match_name), tenant)
                        else:
                            claim(matchpattern.to_regex(
                                d.match_pattern), tenant)

        def namer(pattern: str) -> str:
            return claims.get(pattern, SHARED_NAMESPACE)

        return namer

    # -- shadow/canary staging --------------------------------------------
    def stage_canary(self, per_identity: Dict[int, MapState],
                     revision: int = 0):
        """Stage generation N+1 ALONGSIDE the serving generation N.

        The shadow is the CPU oracle over the N+1 snapshot — bit-equal
        to the compiled engine by the repo's core invariant (the
        oracle IS the correctness reference the engine is pinned
        against), so a verdict diff between serving and shadow
        measures the POLICY change, never a backend artifact. The
        expensive compile happens once, at :meth:`commit_canary`,
        after the verdict-diff gate passed — a refused canary costs
        zero compile work and never touches the serving triple."""
        secret_lookup = (self.secrets.lookup
                         if self.secrets is not None else None)
        shadow = OracleVerdictEngine(
            per_identity, secret_lookup=secret_lookup,
            audit=self.config.policy_audit_mode)
        # the shadow's regex compiles belong to staging, not to the
        # first sampled dispatch in a pack cycle
        shadow.precompile()
        with self._lock:
            self._canary_engine = shadow
            self._canary_snapshot = per_identity
            self._canary_revision = revision
        return shadow

    @property
    def canary_engine(self):
        """The staged shadow engine, or None when no canary is live."""
        with self._lock:
            return self._canary_engine

    @property
    def canary_revision(self) -> int:
        with self._lock:
            return self._canary_revision

    def clear_canary(self) -> None:
        """Drop the staged generation (abort/refuse path): the serving
        triple is untouched by construction — the shadow never entered
        it."""
        with self._lock:
            self._canary_engine = None
            self._canary_snapshot = None
            self._canary_revision = 0

    def commit_canary(self):
        """Promote the staged snapshot to the serving generation via
        the normal :meth:`regenerate` (compile → stage → atomic swap,
        rollback on failure). Only the verdict-diff gate
        (runtime/canary.py) calls this, and only after it passed."""
        with self._lock:
            snap = self._canary_snapshot
            revision = self._canary_revision
        if snap is None:
            raise RuntimeError("no canary generation staged")
        engine = self.regenerate(snap, revision=revision)
        self.clear_canary()
        return engine

    # -- warm restart -----------------------------------------------------
    def snapshot_warm(self) -> bool:
        """Persist the serving state — revision, the compiled policy's
        artifact key, and the resolved snapshot (from which the oracle
        fallback rebuilds) — through the artifact cache. The graceful
        drain calls this last, so a restarted service can
        :meth:`restore_warm` and answer its first request
        verdict-identically without recompilation."""
        with self._lock:
            engine = self._engine
            revision = self._revision
            per_identity = self.per_identity
            key = self._last_artifact_key
        if engine is None or not self._cache.enable:
            return False
        from cilium_tpu_torch.engine.megakernel import (
            autotune_cache_snapshot,
        )

        self._cache.put(WARM_STATE_KEY, {
            "format": 1,
            "revision": revision,
            "artifact_key": key,
            "per_identity": per_identity,
            "offload": bool(self.config.enable_tpu_offload),
            "audit": bool(self.config.policy_audit_mode),
            # per-bank-shape kernel picks survive the restart: the
            # restaged engine re-plans against a warm autotune cache
            # instead of re-benching every shape
            "kernel_autotune": autotune_cache_snapshot(),
        })
        return True

    def restore_warm(self) -> bool:
        """Rebuild the serving state from the last drain's snapshot.
        Fast path (gate unchanged, compiled artifact still cached):
        stage the cached policy directly — no fingerprint walk, no
        compile. Degraded path (artifact evicted/corrupt, or the
        feature gate flipped since the snapshot): full
        :meth:`regenerate` from the snapshot's resolved policy — still
        no caller-side policy replay needed. Returns False on a clean
        miss (no/stale snapshot); the caller then boots cold."""
        state = self._cache.get(WARM_STATE_KEY)
        if not isinstance(state, dict) or state.get("format") != 1:
            return False
        from cilium_tpu_torch.engine.megakernel import autotune_cache_adopt

        autotune_cache_adopt(state.get("kernel_autotune"))
        try:
            revision = int(state["revision"])
            per_identity = state["per_identity"]
            key = state.get("artifact_key")
            offload = bool(state.get("offload"))
        except (KeyError, TypeError, ValueError):
            return False
        if self.config.enable_tpu_offload and offload and key:
            from cilium_tpu_torch.engine.memo import PolicyDelta
            from cilium_tpu_torch.engine.verdict import TorchVerdictEngine

            with self._lock:
                serving_engine = self._engine
                serving_key = self._last_artifact_key
                serving_degraded = self._degraded
            if (key == serving_key and not serving_degraded
                    and isinstance(serving_engine, TorchVerdictEngine)):
                # the snapshot IS the serving policy (drain → restore
                # without an intervening change): keep the staged
                # engine, commit the snapshot's revision, and drop
                # NOTHING — replay memos and unique-row buffers stay
                # hot across the warm restart (the
                # old unconditional drop cost the whole memo hit
                # ratio on every restart)
                fps = identity_fingerprints(per_identity)
                fam = identity_family_fingerprints(per_identity)
                with self._lock:
                    self._identity_fps = fps
                    self._identity_family_fps = fam
                self._commit(serving_engine, revision, per_identity,
                             "warm", delta=PolicyDelta.none())
                METRICS.inc(WARM_RESTORES)
                return True
            policy = self._cache.get(key)
            if policy is not None:
                with _log_span(LOG, "warm restore", revision=revision,
                               identities=len(per_identity)):
                    with SpanStat("policy_stage"), \
                            TRACER.span("policy.stage",
                                        cache_hit=True, warm=True):
                        engine = TorchVerdictEngine(
                            policy, device=self.device,
                            cfg=self.config.engine)
                self._record_kernel_plan(policy, engine)
                # a real fingerprint change (or an unknown serving
                # state): hand memo owners the identity-scoped delta
                # when the serving fingerprints can vouch for it
                fps = identity_fingerprints(per_identity)
                fam_fps = identity_family_fingerprints(per_identity)
                new_plan = dict(getattr(policy, "bank_plan", {}) or {})
                with self._lock:
                    globals_fp = self._globals_fp
                delta = self._delta_for(fps, globals_fp or "",
                                        new_plan, False, fam_fps) \
                    if globals_fp is not None \
                    else PolicyDelta(full=True)
                with self._lock:
                    self._last_artifact_key = key
                    self._identity_fps = fps
                    self._identity_family_fps = fam_fps
                    self._bank_plan = new_plan
                    self._degraded = False
                self._update_protected()
                self._commit(engine, revision, per_identity, "warm",
                             delta=delta)
                METRICS.inc(WARM_RESTORES)
                return True
        if not self.config.enable_tpu_offload and not offload:
            secret_lookup = (self.secrets.lookup
                             if self.secrets is not None else None)
            engine = OracleVerdictEngine(
                per_identity, secret_lookup=secret_lookup,
                audit=self.config.policy_audit_mode)
            with self._lock:
                self._last_artifact_key = None
            self._commit(engine, revision, per_identity, "warm")
            METRICS.inc(WARM_RESTORES)
            return True
        # artifact evicted or the gate flipped since the snapshot:
        # regenerate from the snapshot's resolved policy (may compile,
        # but the caller still needn't replay policy sources)
        self.regenerate(per_identity, revision=revision)
        METRICS.inc(WARM_RESTORES)
        return True

    def regenerate_from_repo(self, repo: Repository, cache: SelectorCache,
                             endpoint_labels: Dict[int, LabelSet]):
        """Resolve + regenerate for a set of endpoint identities
        (§3.2's regeneration fan-out, collapsed to one snapshot)."""
        resolver = PolicyResolver(repo, cache)
        per_identity = {
            ep: resolver.resolve(lbls)
            for ep, lbls in endpoint_labels.items()
        }
        return self.regenerate(per_identity, revision=repo.revision)
