"""Content-addressed automaton banks: stable partition + failure-
isolated compile (a copy of the reference's
``policy/compiler/bankplan.py``).

The positional grouping (``patterns[i : i + bank_size]``) shifts every
later group's membership when one CNP is deleted, so a single rule
delete recompiles O(policy) banks. This module uses a
**content-defined partition** (the rsync/LBFS chunking trick applied
to the sorted pattern universe): a pattern is a bank boundary iff a
pure hash of the pattern says so, which makes bank membership a pure
function of the pattern SET — an add/delete perturbs only the bank(s)
around the touched patterns and every other bank's membership (and
therefore its content-addressed key) is byte-identical. Compile work
under churn is O(Δ banks), not O(policy).

Bank keys are :func:`ruleset_fingerprint` hashes of the bank's pattern
tuple + compile options — cross-process-stable like the checkpoint
fingerprints, so a restarted daemon, a bench process and the serving
agent agree on which banks changed — and so do the two packages.

:class:`BankRegistry` adds **per-bank failure isolation**: a bank
whose compile fails (the ``loader.bank_compile`` injection point, a
pathological pattern, a transient toolchain error) is *quarantined* —
counted, TTL-stamped, and retried by a later regeneration — instead
of aborting the whole policy swap. While quarantined, the bank's
patterns are served from the last-good compiled bank that covered
them (bit-identical for every other bank; stale-but-bounded for the
quarantined one), and patterns with no prior compiled cover fail
CLOSED through a dead bank (L7 rules are allow-lists — a lane that
never matches can only deny more, never less).

Fleet scale: the registry is **sharded** into byte-bounded
LRU shards (5k-CNP pattern universes serve in bounded memory; an
evicted group recompiles — or re-fetches — on next use), compiles run
through the **parallel work queue**
(:mod:`~cilium_tpu_torch.policy.compiler.compilequeue`: bounded workers,
per-bank deadline, worker-death retry with backoff, priority
classes), and compiled groups are **distributable artifacts**
(:class:`~cilium_tpu_torch.runtime.checkpoint.BankArtifactStore`:
checksum-verified fetch on miss; corruption degrades to a counted
recompile). A bank whose compile is still PENDING at its deadline
serves exactly like a quarantined one — cover for covered patterns,
fail-closed for the rest — and the late result lands in the registry
for the next regeneration. Repeated failures escalate the quarantine
TTL exponentially (with deterministic jitter) — the bank-level
backoff schedule.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cilium_tpu_torch.policy.compiler import regex_parser as rp
from cilium_tpu_torch.policy.compiler.compilequeue import (
    PRIO_BACKGROUND,
    PRIO_SERVING,
    CompileQueue,
    QueueDraining,
    work_key,
)
from cilium_tpu_torch.policy.compiler.dfa import (
    BankOverflow,
    BankedDFA,
    DFABank,
    compile_bank,
)
from cilium_tpu_torch.runtime import faults, simclock
from cilium_tpu_torch.runtime.checkpoint import (
    BankArtifactStore,
    ruleset_fingerprint,
)
from cilium_tpu_torch.runtime.logging import get_logger
from cilium_tpu_torch.runtime.metrics import (
    BANK_PENDING_SERVES,
    BANK_QUARANTINED,
    BANK_REBUILDS,
    METRICS,
    REGISTRY_SHARD_EVICTIONS,
)

LOG = get_logger("bankplan")

#: fires once per bank-group compile attempt: a fired fault models a
#: per-bank compile failure and must quarantine ONLY that bank — the
#: rest of the regeneration proceeds
BANK_COMPILE_POINT = faults.register_point(
    "loader.bank_compile", "per-bank DFA compile in BankRegistry")

#: bank-key format epoch — bump on any change to partitioning, key
#: derivation, or DFABank layout so stale registries/artifacts read as
#: clean misses, never as a misparse
BANK_FORMAT = "bank-v1"

#: a run of non-boundary patterns longer than this is force-split —
#: bounds the membership ripple of a pathological hash run to the run
#: itself (the partition stays a pure function of the pattern set)
_HARD_CAP_FACTOR = 4

#: quarantine-TTL escalation cap: repeated failures back the retry
#: schedule off exponentially, but never past this multiple of the
#: base TTL (a bank must stay retryable within bounded virtual time)
_TTL_ESCALATION_CAP = 8.0


def bank_boundary(pattern: str, target: int) -> bool:
    """Pure per-pattern boundary predicate of the content-defined
    partition: True ≈ 1/target of the time, independent of every other
    pattern."""
    return zlib.crc32(pattern.encode("utf-8")) % max(1, target) == 0


def partition_patterns(patterns: Sequence[str], target: int,
                       namer=None) -> List[Tuple[str, ...]]:
    """Content-defined partition of a pattern set into bank groups.

    A pure function of ``set(patterns)`` and ``target`` (sorted walk +
    per-pattern hash boundaries): add-then-delete of any subset returns
    the exact original groups, and an add/delete perturbs only the
    group(s) adjacent to the touched patterns.

    With a ``namer`` (pattern → tenant namespace) the
    universe is first split by namespace and each namespace partitions
    INDEPENDENTLY — a tenant's pattern add/delete can only perturb
    groups inside its own namespace, so no tenant's churn ever shifts
    another tenant's bank membership. Namespace order is sorted, so
    the overall group list stays a pure function of the set."""
    if namer is not None:
        by_ns: Dict[str, List[str]] = {}
        for p in set(patterns):
            by_ns.setdefault(namer(p), []).append(p)
        groups: List[Tuple[str, ...]] = []
        for ns in sorted(by_ns):
            groups.extend(partition_patterns(by_ns[ns], target))
        return groups
    if faults.mutation_active("positional-banks"):
        # the planted positional-grouping bug (faults.MUTATION_ENV): one
        # delete shifts every later bank → O(policy) recompiles per
        # update
        uniq = sorted(set(patterns))
        step = max(1, target)
        return [tuple(uniq[i:i + step])
                for i in range(0, len(uniq), step)]
    uniq = sorted(set(patterns))
    hard_cap = max(1, target) * _HARD_CAP_FACTOR
    groups: List[Tuple[str, ...]] = []
    cur: List[str] = []
    for p in uniq:
        cur.append(p)
        if bank_boundary(p, target) or len(cur) >= hard_cap:
            groups.append(tuple(cur))
            cur = []
    if cur:
        groups.append(tuple(cur))
    return groups


def bank_key(patterns: Tuple[str, ...], opts: Tuple,
             namespace: str = "") -> str:
    """Cross-process-stable content address of one bank group (pattern
    tuple + compile options), like the checkpoint fingerprints. A
    tenant NAMESPACE folds into the key only when non-empty, so
    single-tenant deployments keep their pre-tenant keys (pinned
    registries/artifacts stay warm across the upgrade) while two
    tenants sharing a pattern text still own distinct banks —
    quarantining one can never serve or invalidate the other's."""
    if namespace:
        return ruleset_fingerprint(BANK_FORMAT, patterns, opts,
                                   ("ns", namespace))
    return ruleset_fingerprint(BANK_FORMAT, patterns, opts)


def registry_shard_of(key: str, n_shards: int) -> int:
    """Shard index of one bank key — a pure function of the key (hex
    prefix), cross-process-stable under any PYTHONHASHSEED like the
    key itself, so every host of
    a fleet places a bank in the same shard."""
    return int(key[:8], 16) % max(1, n_shards)


def _dead_bank(n_patterns: int) -> DFABank:
    """A bank whose every lane never accepts — the fail-CLOSED home of
    patterns whose compile is quarantined with no prior cover. Safe by
    the allow-list property: an L7 lane that never matches can only
    deny more."""
    n_words = max(1, (max(1, n_patterns) + 31) // 32)
    return DFABank(
        trans=np.zeros((2, 1), dtype=np.int32),
        byteclass=np.zeros(256, dtype=np.int32),
        accept=np.zeros((2, n_words), dtype=np.uint32),
        start=1,
        n_patterns=n_patterns,
    )


@dataclasses.dataclass(frozen=True)
class FieldBankStats:
    """One field's build outcome, for the loader's plan diff and the
    churn soak's O(Δ) assertions."""

    field: str
    #: content-addressed keys of the groups serving their CURRENT
    #: membership, in partition order (quarantined groups excluded —
    #: they serve stale covers, and the loader treats any quarantine
    #: as a full-invalidation commit)
    bank_keys: Tuple[str, ...]
    rebuilt: Tuple[str, ...]       # keys compiled by THIS build
    reused: int                    # groups served from the registry
    quarantined: Tuple[str, ...]   # keys serving a stale cover
    #: keys whose compile was still in flight at the deadline (subset
    #: of ``quarantined`` semantics: cover + fail-closed, but NOT
    #: TTL-stamped — the late result clears them)
    pending: Tuple[str, ...] = ()
    #: keys served from a fetched (checksum-verified) bank artifact
    #: instead of a compile
    fetched: Tuple[str, ...] = ()


class _Quarantine:
    __slots__ = ("until", "failures", "error", "group", "opts",
                 "field")

    def __init__(self, until: float, failures: int, error: str,
                 group: Optional[Tuple[str, ...]] = None,
                 opts: Optional[Tuple] = None, field: str = ""):
        self.until = until
        self.failures = failures
        self.error = error
        #: the group's membership/opts at quarantine time — what the
        #: background TTL rebuild recompiles
        self.group = group
        self.opts = opts
        self.field = field


class _Shard:
    """One byte-bounded LRU shard of the group store."""

    __slots__ = ("lock", "groups", "group_bytes", "bytes")

    def __init__(self):
        self.lock = threading.Lock()
        self.groups: "collections.OrderedDict[str, List[Tuple[DFABank, Tuple[str, ...]]]]" = \
            collections.OrderedDict()
        self.group_bytes: Dict[str, int] = {}
        self.bytes = 0


class BankRegistry:
    """Sharded, byte-bounded store of compiled bank groups,
    content-addressed, with quarantine. The regeneration path is
    single-writer per loader, but queue WORKERS store completions
    concurrently — shard locks (plus a meta lock for quarantine/cover
    bookkeeping) make every insert atomic; the work-queue dedup map
    guarantees one insert per content key however many compilers
    race."""

    def __init__(self, quarantine_ttl_s: float = 30.0,
                 max_groups: int = 4096, max_bytes: int = 256 << 20,
                 clock=None, shards: int = 1,
                 queue: Optional[CompileQueue] = None,
                 artifacts: Optional[BankArtifactStore] = None):
        self.n_shards = max(1, int(shards))
        self._shards = [_Shard() for _ in range(self.n_shards)]
        #: per-shard bounds (the totals divide evenly; a shard is the
        #: unit of memory isolation, so one hot shard can't starve
        #: the rest)
        self._shard_max_groups = max(1, max_groups // self.n_shards)
        self._shard_max_bytes = max(1, max_bytes // self.n_shards)
        #: cover index + quarantine + counters share one meta lock
        #: (never held across a compile or a shard insert)
        self._meta = threading.Lock()
        #: (opts, pattern) → key of the last-GOOD group containing it
        #: (the quarantine fallback's cover index)
        self._cover: Dict[Tuple, str] = {}
        self._quarantine: Dict[str, _Quarantine] = {}
        #: keys whose serving-blocking compile lapsed its deadline and
        #: is still in flight (cover serves; late completion clears)
        self._pending_keys: set = set()
        self.quarantine_ttl_s = quarantine_ttl_s
        self.max_groups = max_groups
        self.max_bytes = max_bytes
        # quarantine TTLs ride the process clock (simclock) unless a
        # test injects its own — virtual time expires them instantly
        self.clock = clock if clock is not None else simclock.now
        #: the parallel compile plane (None = inline serial compiles,
        #: the pre-queue behavior direct constructions get)
        self.queue = queue
        #: distributable compiled-bank artifacts (None = local-only)
        self.artifacts = artifacts
        #: lifetime counters (the churn soak's O(Δ) ledger)
        self.compiles = 0          # group compiles that succeeded
        self.bank_compiles = 0     # individual DFA banks built
        self.reuses = 0
        self.artifact_hits = 0     # groups served from a fetched artifact
        self.quarantine_events = 0
        self.quarantined_serves = 0
        self.pending_serves = 0
        self.evictions = 0
        #: bank key → scan-impl pick ("dfa-dense" / "nfa-bitset") the
        #: megakernel autotuner recorded at staging — content-addressed
        #: banks carry their kernel choice across regenerations (the
        #: loader writes it after every successful stage; pruned to
        #: live groups so it can't outgrow the bounded store)
        self.kernel_picks: Dict[str, str] = {}
        #: pattern → tenant namespace (None = tenant-blind): the
        #: loader installs it from the TenantMap before a regeneration
        #: so the partition, the bank keys, and the queue's fair-share
        #: attribution all see the same namespace split
        self.namer = None
        #: bank key → tenant namespace, the attribution index the
        #: tenant-isolation invariant reads; pruned alongside
        #: kernel_picks so it can't outgrow the bounded store
        self.namespaces: Dict[str, str] = {}

    @property
    def bytes(self) -> int:
        return sum(s.bytes for s in self._shards)

    def close(self) -> None:
        """Tear down the owned compile plane (tests, schedule
        teardown, loader replacement)."""
        if self.queue is not None:
            self.queue.close()

    # -- bookkeeping ------------------------------------------------------
    @staticmethod
    def _bytes_of(group: List[Tuple[DFABank, Tuple[str, ...]]]) -> int:
        return sum(int(b.trans.nbytes + b.accept.nbytes
                       + b.byteclass.nbytes) for b, _ in group)

    def _shard(self, key: str) -> _Shard:
        return self._shards[registry_shard_of(key, self.n_shards)]

    def _store(self, key: str, group, opts: Tuple,
               only_if_absent: bool = False) -> bool:
        """Insert one compiled group; returns True when THIS call
        inserted it. ``only_if_absent`` is the queue-completion path:
        two racing compiles of one content key (the dedup window
        between task completion and a fresh submit) must produce
        exactly ONE registry insert — the second completion finds the
        key resident and only refreshes its LRU position."""
        nbytes = self._bytes_of(group)
        sh = self._shard(key)
        evicted: List[str] = []
        with sh.lock:
            if only_if_absent and key in sh.groups:
                sh.groups.move_to_end(key)
                return False
            old = sh.groups.pop(key, None)
            if old is not None:
                sh.bytes -= sh.group_bytes.pop(key, 0)
            sh.groups[key] = group
            sh.group_bytes[key] = nbytes
            sh.bytes += nbytes
            while sh.groups and (len(sh.groups) > self._shard_max_groups
                                 or sh.bytes > self._shard_max_bytes):
                k, _ = sh.groups.popitem(last=False)
                sh.bytes -= sh.group_bytes.pop(k, 0)
                evicted.append(k)
        if evicted:
            self.evictions += len(evicted)
            METRICS.inc(REGISTRY_SHARD_EVICTIONS, len(evicted))
        with self._meta:
            for _, pats in group:
                for p in pats:
                    self._cover[(opts, p)] = key
            # the cover index tracks deleted patterns too — prune
            # entries whose group was evicted once it outgrows the
            # group store
            if len(self._cover) > 16 * max(1024, self.max_groups):
                live = set()
                for s in self._shards:
                    with s.lock:
                        live |= set(s.groups)
                self._cover = {ck: k for ck, k in self._cover.items()
                               if k in live}
                self.kernel_picks = {
                    k: v for k, v in self.kernel_picks.items()
                    if k in live}
                self.namespaces = {
                    k: v for k, v in self.namespaces.items()
                    if k in live}
        return True

    def _get(self, key: str):
        sh = self._shard(key)
        with sh.lock:
            g = sh.groups.get(key)
            if g is not None:
                sh.groups.move_to_end(key)
            return g

    def _group_count(self) -> int:
        return sum(len(s.groups) for s in self._shards)

    # -- compile ----------------------------------------------------------
    def _compile_group(self, group: Tuple[str, ...], opts: Tuple):
        """Compile one group (deterministic halving on state-cap
        overflow). The injection point fires once per group, so a
        forced failure quarantines the group as a unit."""
        max_states, max_quantifier, case_insensitive = opts
        faults.maybe_fail(BANK_COMPILE_POINT)
        out: List[Tuple[DFABank, Tuple[str, ...]]] = []

        def rec(pats: Tuple[str, ...]) -> None:
            asts = [rp.parse(p, max_quantifier=max_quantifier,
                             case_insensitive=case_insensitive)
                    for p in pats]
            try:
                bank = compile_bank(asts, max_states=max_states)
            except BankOverflow:
                if len(pats) == 1:
                    raise rp.RegexError(
                        f"pattern too large for state cap: {pats[0]!r}")
                mid = len(pats) // 2
                rec(pats[:mid])
                rec(pats[mid:])
                return
            out.append((bank, pats))

        rec(tuple(group))
        return out

    def _compile_or_resident(self, key: str, group: Tuple[str, ...],
                             opts: Tuple):
        """The queued compile closure: a racer that lost the dedup
        window (the first task completed and left the map before this
        submit) finds the key already resident and returns it instead
        of recompiling — idempotent by content addressing."""
        cached = self._get(key)
        if cached is not None:
            return cached
        return self._compile_group(group, opts)

    def _quarantine_key(self, key: str, field: str,
                        group: Tuple[str, ...], opts: Tuple,
                        exc: BaseException) -> None:
        """TTL-stamp one failed bank. The FIRST failure quarantines
        for exactly ``quarantine_ttl_s`` (the boundary suite pins
        at-tick retry semantics); repeated failures escalate the TTL
        exponentially with deterministic jitter — the bank-level
        retry-backoff schedule of the fleet plane."""
        now = self.clock()
        with self._meta:
            q = self._quarantine.get(key)
            failures = (q.failures + 1) if q is not None else 1
            ttl = self.quarantine_ttl_s
            if failures >= 2:
                ttl *= min(2.0 ** (failures - 1), _TTL_ESCALATION_CAP)
                frac = (zlib.crc32(f"{key}:{failures}".encode())
                        % 2001 - 1000) / 10000.0
                ttl *= (1.0 + frac)
            self._quarantine[key] = _Quarantine(
                now + ttl, failures, f"{type(exc).__name__}: {exc}",
                group=group, opts=opts, field=field)
            self._pending_keys.discard(key)
            self.quarantine_events += 1
        METRICS.inc(BANK_QUARANTINED, labels={"field": field})
        LOG.error("bank compile quarantined",
                  extra={"fields": {
                      "field": field, "bank": key,
                      "patterns": len(group),
                      "failures": failures,
                      "ttl_s": round(ttl, 3),
                      "error": f"{type(exc).__name__}: {exc}"}})

    def _task_done(self, key: str, field: str,
                   group: Tuple[str, ...], opts: Tuple, task) -> None:
        """Queue completion callback (worker thread): the ONE place a
        queued compile's outcome lands — success stores into the shard
        (and publishes the artifact), permanent failure quarantines.
        Runs before the waiter wakes, so a woken waiter always
        observes the outcome; runs identically for a LATE completion
        whose waiter already lapsed."""
        if task.error is None:
            inserted = self._store(key, task.result, opts,
                                   only_if_absent=True)
            with self._meta:
                self._quarantine.pop(key, None)
                self._pending_keys.discard(key)
                if inserted:
                    self.compiles += 1
                    self.bank_compiles += len(task.result)
            if inserted:
                if self.artifacts is not None:
                    try:
                        self.artifacts.put(key, task.result)
                    except OSError:
                        pass  # publishing best-effort; serving is not
                METRICS.inc(BANK_REBUILDS, labels={"field": field})
        elif isinstance(task.error, QueueDraining):
            with self._meta:
                self._pending_keys.discard(key)
        else:
            self._quarantine_key(key, field, group, opts, task.error)

    def kick_expired_rebuilds(self) -> int:
        """Proactively re-submit expired-quarantine banks at
        BACKGROUND priority, so the repair compiles between
        regenerations instead of on the next one's critical path.
        Never delays serving-class work (strict priority). Returns the
        number of rebuilds submitted (dedup absorbs re-kicks)."""
        if self.queue is None:
            return 0
        now = self.clock()
        with self._meta:
            expired = [(k, q) for k, q in self._quarantine.items()
                       if now >= q.until and q.group is not None]
        n = 0
        for key, q in expired:
            fn = functools.partial(self._compile_group, q.group,
                                   q.opts)
            with self._meta:
                ns = self.namespaces.get(key, "")
            try:
                self.queue.submit(
                    work_key(key), fn, prio=PRIO_BACKGROUND,
                    on_done=functools.partial(
                        self._task_done, key, q.field, q.group,
                        q.opts),
                    payload_bytes=sum(len(p) for p in q.group),
                    tenant=ns)
            except QueueDraining:
                break
            n += 1
        return n

    def compile_field(self, field: str, patterns: Sequence[str],
                      cfg, case_insensitive: bool = False
                      ) -> Tuple[BankedDFA, FieldBankStats]:
        """Compile one field's pattern universe through the
        content-addressed partition. Reuses unchanged groups, fetches
        distributable artifacts, compiles the rest (through the work
        queue when one is wired), quarantines (never raises past)
        per-group failures, and serves deadline-lapsed compiles from
        their cover."""
        opts = (cfg.max_dfa_states, cfg.max_quantifier,
                bool(case_insensitive))
        now = self.clock()
        namer = self.namer
        groups = partition_patterns(patterns, cfg.bank_size,
                                    namer=namer)

        #: per-partition-slot outcome — assembly happens strictly in
        #: partition order afterwards, so the bank stack, lane
        #: assignment, and plan key order are identical however many
        #: workers raced and whichever order they finished in
        LIVE, COVER = "live", "cover"
        slots: List[Optional[Tuple]] = [None] * len(groups)
        #: (slot, key, group, task) awaiting queued compiles
        to_wait: List[Tuple[int, str, Tuple[str, ...], object]] = []

        for si, group in enumerate(groups):
            # every pattern of a group shares one namespace (the
            # partition split by namespace first), so the first
            # member names the group
            ns = namer(group[0]) if namer is not None else ""
            key = bank_key(group, opts, namespace=ns)
            if ns:
                with self._meta:
                    self.namespaces[key] = ns
            cached = self._get(key)
            if cached is not None:
                slots[si] = (LIVE, key, cached, "reused")
                self.reuses += 1
                continue
            with self._meta:
                q = self._quarantine.get(key)
            if q is not None and now < q.until:
                # still serving the outage: don't re-attempt yet
                slots[si] = (COVER, key, group, "quarantined")
                self.quarantined_serves += 1
                continue
            if self.artifacts is not None:
                art = self.artifacts.fetch(key)
                if art is not None:
                    # another compiler already built this content:
                    # adopt it (checksum-verified) instead of
                    # compiling — the location-transparent path
                    self._store(key, art, opts)
                    with self._meta:
                        self._quarantine.pop(key, None)
                        self.artifact_hits += 1
                    slots[si] = (LIVE, key, art, "fetched")
                    continue
            if self.queue is not None:
                try:
                    task = self.queue.submit(
                        work_key(key),
                        functools.partial(self._compile_or_resident,
                                          key, group, opts),
                        prio=PRIO_SERVING,
                        on_done=functools.partial(
                            self._task_done, key, field, group, opts),
                        payload_bytes=sum(len(p) for p in group),
                        tenant=ns)
                except QueueDraining as e:
                    self._quarantine_key(key, field, group, opts, e)
                    slots[si] = (COVER, key, group, "quarantined")
                    continue
                to_wait.append((si, key, group, task))
                continue
            # inline serial path (no queue wired): compile here
            try:
                compiled = self._compile_group(group, opts)
            except Exception as e:  # per-bank isolation: quarantine,
                # keep regenerating — the old cover serves this group
                self._quarantine_key(key, field, group, opts, e)
                slots[si] = (COVER, key, group, "quarantined")
                continue
            self._store(key, compiled, opts)
            if self.artifacts is not None:
                try:
                    self.artifacts.put(key, compiled)
                except OSError:
                    pass
            with self._meta:
                self._quarantine.pop(key, None)
                self.compiles += 1
                self.bank_compiles += len(compiled)
            slots[si] = (LIVE, key, compiled, "rebuilt")
            METRICS.inc(BANK_REBUILDS, labels={"field": field})

        # -- wait phase: queued compiles land (or lapse) --------------
        for si, key, group, task in to_wait:
            done = self.queue.wait(task)
            compiled = self._get(key)
            if done and task.error is None and compiled is not None:
                slots[si] = (LIVE, key, compiled, "rebuilt")
            elif done:
                # permanent failure / retry exhaustion: the callback
                # already quarantined it
                slots[si] = (COVER, key, group, "quarantined")
            else:
                # deadline lapse with the compile still in flight:
                # serve the cover NOW; the late result lands for the
                # next regeneration (counted, never wasted)
                with self._meta:
                    self._pending_keys.add(key)
                    self.pending_serves += 1
                METRICS.inc(BANK_PENDING_SERVES)
                slots[si] = (COVER, key, group, "pending")

        # -- assembly, strictly in partition order --------------------
        live_keys: List[str] = []
        rebuilt: List[str] = []
        quarantined: List[str] = []
        pending: List[str] = []
        fetched: List[str] = []
        reused = 0
        banks: List[Tuple[DFABank, Tuple[str, ...]]] = []
        fallback_pats: List[str] = []
        for slot in slots:
            state, key, payload, kind = slot
            if state == LIVE:
                banks.extend(payload)
                live_keys.append(key)
                if kind == "rebuilt":
                    rebuilt.append(key)
                elif kind == "fetched":
                    fetched.append(key)
                else:
                    reused += 1
            else:
                quarantined.append(key)
                if kind == "pending":
                    pending.append(key)
                fallback_pats.extend(payload)

        # -- quarantine fallback: last-good covers, then fail closed --
        if fallback_pats:
            cover_keys: List[str] = []
            seen = set()
            uncovered: List[str] = []
            with self._meta:
                cover_of = {p: self._cover.get((opts, p))
                            for p in fallback_pats}
            for p in fallback_pats:
                ck = cover_of[p]
                if ck is not None:
                    cg = self._get(ck)
                else:
                    cg = None
                if cg is not None:
                    if ck not in seen:
                        seen.add(ck)
                        cover_keys.append(ck)
                else:
                    uncovered.append(p)
            for ck in cover_keys:
                cg = self._get(ck)
                if cg is not None:
                    banks.extend(cg)
            if uncovered:
                banks.append((_dead_bank(len(uncovered)),
                              tuple(uncovered)))

        banked = self._assemble(patterns, banks)
        stats = FieldBankStats(
            field=field, bank_keys=tuple(live_keys),
            rebuilt=tuple(rebuilt), reused=reused,
            quarantined=tuple(quarantined),
            pending=tuple(pending), fetched=tuple(fetched))
        return banked, stats

    @staticmethod
    def _assemble(patterns: Sequence[str],
                  banks: List[Tuple[DFABank, Tuple[str, ...]]]
                  ) -> BankedDFA:
        """(bank, member patterns) list → BankedDFA over the INPUT
        pattern order. A pattern present in several banks (its current
        bank plus a stale cover carrying it for a different
        quarantined group) binds to its FIRST bank in order — current
        banks are appended before covers, so live compiles win."""
        if not banks:
            banks = [(_dead_bank(1), ("",))]
        assign: Dict[str, Tuple[int, int]] = {}
        for bid, (_, pats) in enumerate(banks):
            for lane, p in enumerate(pats):
                assign.setdefault(p, (bid, lane))
        pattern_bank = np.zeros(len(patterns), dtype=np.int32)
        pattern_lane = np.zeros(len(patterns), dtype=np.int32)
        for i, p in enumerate(patterns):
            bid, lane = assign[p]
            pattern_bank[i] = bid
            pattern_lane[i] = lane
        return BankedDFA(
            banks=[b for b, _ in banks],
            pattern_bank=pattern_bank,
            pattern_lane=pattern_lane,
            patterns=tuple(patterns),
        )

    # -- introspection ----------------------------------------------------
    def expired_quarantines(self, now: Optional[float] = None
                            ) -> Tuple[str, ...]:
        """Keys whose quarantine TTL has lapsed — the next regenerate
        retries their compile."""
        now = self.clock() if now is None else now
        with self._meta:
            return tuple(k for k, q in self._quarantine.items()
                         if now >= q.until)

    def keys_in_namespace(self, namespace: str) -> Tuple[str, ...]:
        """Bank keys attributed to one tenant namespace, sorted — what
        the tenant-isolation invariant snapshots for tenant B
        before storming tenant A."""
        with self._meta:
            return tuple(sorted(k for k, ns in self.namespaces.items()
                                if ns == namespace))

    def status(self) -> Dict:
        out = {
            "groups": self._group_count(),
            "bytes": self.bytes,
            "shards": self.n_shards,
            "compiles": self.compiles,
            "bank_compiles": self.bank_compiles,
            "reuses": self.reuses,
            "artifact_hits": self.artifact_hits,
            "quarantined": len(self._quarantine),
            "quarantine_events": self.quarantine_events,
            "quarantined_serves": self.quarantined_serves,
            "pending": len(self._pending_keys),
            "pending_serves": self.pending_serves,
            "evictions": self.evictions,
            "kernel_picks": dict(self.kernel_picks),
        }
        if self.queue is not None:
            out["queue"] = self.queue.status()
        return out
