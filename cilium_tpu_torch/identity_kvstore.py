"""Cluster-wide identity allocation through the shared kvstore
(counterpart of the reference's ``identity_kvstore.py``, copied).

Cilium's ``pkg/allocator`` + ``pkg/identity/cache`` in kvstore mode
(SURVEY.md §2.1 "label-set → identity allocation via kvstore or
CiliumIdentity CRD") — every node must map the same label set to the
same numeric identity, or cross-node policy is meaningless. The etcd
layout is mirrored:

  cilium/state/identities/v1/id/<id>       → {"labels": [...], "ts": t}
  cilium/state/identities/v1/value/<enc>   → "<id>"

Allocation claims an id with ``create`` (etcd CreateOnly), then
publishes the labels→id mapping the same way; losing either race means
adopting the winner's id. A prefix watch (replay-then-follow) keeps a
local cache hot and feeds remote allocations to the agent via
``on_change`` — that's how a selector cache learns about identities
allocated by *other* nodes. Reserved identities and node-local CIDR
identities never touch the store (the reference scopes CIDR identities
node-locally too).

Orphan id keys (a claim whose mapping write lost the race, or a crash
between the two writes) are garbage-collected by the Operator after a
grace period — the ``cilium-operator`` identity-GC duty.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Iterable, Optional

from cilium_tpu_torch.core.identity import (
    IDENTITY_SCOPE_LOCAL,
    IDENTITY_USER_MAX,
    NumericIdentity,
)
from cilium_tpu_torch.core.identity_cache import IdentityCacheBase
from cilium_tpu_torch.core.labels import LabelSet
from cilium_tpu_torch.kvstore import EVENT_DELETE, Event
from cilium_tpu_torch.runtime import faults, simclock
from cilium_tpu_torch.runtime.logging import get_logger
from cilium_tpu_torch.runtime.metrics import (
    IDENTITY_GC,
    IDENTITY_REGEN_COALESCED,
    METRICS,
)

LOG = get_logger("identity")

#: fires per identity-churn event delivery (the add/delete stream a
#: churn storm floods): a fired fault LOSES that delivery — the
#: kvstore watch isolates it — modelling burst churn overwhelming a
#: watcher. The chaos suite pins that local allocations (and their
#: verdicts) survive, and that a fresh replay-then-follow converges.
CHURN_POINT = faults.register_point(
    "kvstore.churn_storm",
    "burst identity add/delete delivery in ClusterIdentityAllocator")

ID_PREFIX = "cilium/state/identities/v1/id/"
VALUE_PREFIX = "cilium/state/identities/v1/value/"

#: GC grace: an unreferenced id key younger than this may be a claim
#: whose labels→id mapping write is still in flight — never collect it.
GC_GRACE_S = 60.0


def _encode_labels(labels: LabelSet) -> str:
    # key-safe, stable: sorted canonical label strings joined by ';'
    return ";".join(sorted(labels.format()))


def _decode_labels(enc: Iterable[str]) -> LabelSet:
    return LabelSet.parse(enc)


def _decode_enc(enc: str) -> LabelSet:
    return LabelSet() if enc == "" else _decode_labels(enc.split(";"))


class ClusterIdentityAllocator(IdentityCacheBase):
    """Duck-type of :class:`~cilium_tpu_torch.core.identity.IdentityAllocator`
    whose user-scope allocations are cluster-global via the kvstore.
    Cache + ordered on_change delivery live in
    :class:`~cilium_tpu_torch.core.identity_cache.IdentityCacheBase`; this
    class owns the etcd-layout claim protocol and the prefix watch."""

    def __init__(self, store,
                 on_change: Optional[Callable[[NumericIdentity,
                                               Optional[LabelSet]],
                                              None]] = None):
        super().__init__(on_change=on_change)
        self.store = store
        self._watch = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ClusterIdentityAllocator":
        """Replay existing identities, then follow the cluster.

        The watch follows the **value** (labels→id) keys — the only
        authoritative mapping. Following the id claims instead would
        let a concurrently-losing claim transiently poison every
        node's label resolution. Idempotent: a retried Agent.start()
        must not stack a second watch.
        """
        if self._watch is None:
            self._watch = self.store.watch_prefix(VALUE_PREFIX,
                                                  self._on_event)
        return self

    def close(self) -> None:
        if self._watch is not None:
            self._watch.stop()
            self._watch = None

    def _on_event(self, ev: Event) -> None:
        faults.maybe_fail(CHURN_POINT)
        try:
            labels = _decode_enc(ev.key[len(VALUE_PREFIX):])
            nid = int(ev.value)  # previous value on deletes, new else
        except ValueError:
            return  # corrupt entry; the operator GC will reap it
        if ev.typ == EVENT_DELETE:
            self._remote_delete(nid, labels)
        else:
            self._remote_upsert(nid, labels)

    # -- allocation (etcd CreateOnly claim protocol) ----------------------
    def _allocate_global(self, labels: LabelSet) -> NumericIdentity:
        enc = _encode_labels(labels)
        value_key = VALUE_PREFIX + enc
        payload = json.dumps({"labels": sorted(labels.format()),
                              "ts": simclock.wall()})
        for _ in range(64):
            gen = self._gen_of(labels)  # before ANY store read/write
            existing = self.store.get(value_key)
            if existing is not None:
                nid = int(existing)
                self._adopt(nid, labels, gen)
                return nid
            candidate = self._next_candidate()
            if candidate >= IDENTITY_USER_MAX:
                raise RuntimeError("user identity space exhausted")
            if not self.store.create(ID_PREFIX + str(candidate), payload):
                with self._lock:  # claimed by a peer we haven't seen
                    self._candidate_floor = candidate + 1
                continue  # re-read and retry
            if self.store.create(value_key, str(candidate)):
                self._adopt(candidate, labels, gen)
                return candidate
            # Lost the mapping race — unless the mapping IS ours (a
            # retried create whose first attempt landed but whose
            # response was lost reports False): re-read before
            # releasing the claim, or we'd delete a live identity.
            winner = self.store.get(value_key)
            if winner == str(candidate):
                self._adopt(candidate, labels, gen)
                return candidate
            self.store.delete(ID_PREFIX + str(candidate))
            if winner is not None:
                nid = int(winner)
                self._adopt(nid, labels, gen)
                return nid
        raise RuntimeError("identity allocation did not converge")

    # -- lookups (IdentityAllocator contract) -----------------------------
    def lookup(self, nid: NumericIdentity) -> Optional[LabelSet]:
        with self._lock:
            labels = self._by_id.get(nid)
        if labels is not None:
            return labels
        if nid < IDENTITY_SCOPE_LOCAL:  # cache miss: ask the store
            raw = self.store.get(ID_PREFIX + str(int(nid)))
            if raw is not None:
                try:
                    labels = _decode_labels(json.loads(raw)["labels"])
                except (ValueError, KeyError, TypeError):
                    return None
                # cache only if the authoritative labels→id mapping
                # confirms this claim won — a losing claim's labels
                # must never enter _by_labels
                gen = self._gen_of(labels)
                winner = self.store.get(
                    VALUE_PREFIX + _encode_labels(labels))
                if winner == str(int(nid)):
                    self._adopt(int(nid), labels, gen)
                return labels
        return None

    def lookup_by_labels(self, labels: LabelSet) -> Optional[NumericIdentity]:
        with self._lock:
            nid = self._by_labels.get(labels)
        if nid is not None:
            return nid
        gen = self._gen_of(labels)
        raw = self.store.get(VALUE_PREFIX + _encode_labels(labels))
        if raw is not None:
            self._adopt(int(raw), labels, gen)
            return int(raw)
        return None


def gc_orphan_identities(store, grace_s: float = GC_GRACE_S) -> int:
    """Operator duty: delete id keys no labels→id mapping references —
    claims whose second write lost the race or crashed — once older
    than ``grace_s`` (an in-flight claim must never be collected).
    Returns the number reaped."""
    referenced = set(store.list_prefix(VALUE_PREFIX).values())
    now = simclock.wall()
    reaped = 0
    for key, raw in store.list_prefix(ID_PREFIX).items():
        nid = key[len(ID_PREFIX):]
        if nid in referenced:
            continue
        try:
            ts = float(json.loads(raw).get("ts", 0))
        except (ValueError, TypeError, AttributeError):
            # undecodable or non-object payload: treat as ts=0 so the
            # corrupt entry is reaped once, instead of crash-looping
            # the operator's reconcile controller forever
            ts = 0.0
        if now - ts < grace_s:
            continue
        store.delete(key)
        reaped += 1
        METRICS.inc(IDENTITY_GC, 1)
        LOG.info("reaped orphan identity", extra={"fields": {"id": nid}})
    return reaped


class RegenDebouncer:
    """Coalesce a burst of identity-churn events into O(1)
    regenerations.

    The churn-storm postmortem: every remote identity add/delete
    reaching ``Agent._on_cluster_identity`` queued a full-policy
    regeneration, so a 100-event storm (a node rebooting, a namespace
    rollout) cost O(events) regenerations even though the *last* one
    covers them all. This debouncer sits between the watch callback
    and ``regenerate_all``: selector-cache updates stay synchronous
    (policy correctness never waits), but the regeneration fires once
    per quiet ``window_s`` — re-armed by each event, bounded by
    ``max_delay_s`` so a sustained storm still regenerates at a
    bounded staleness, never at event rate.

    Clock-driven (runtime/simclock.py): under a VirtualClock the
    window is an ``advance()`` away, so the churn soak proves the
    O(1) property without sleeping through it. ``window_s<=0``
    degrades to the old synchronous behavior (the knob's off switch).
    """

    def __init__(self, fire: Callable[[], None],
                 window_s: float = 0.05, max_delay_s: float = 0.5):
        self.fire = fire
        self.window_s = float(window_s)
        self.max_delay_s = max(float(max_delay_s), self.window_s)
        self._lock = threading.Lock()
        self._kick = simclock.event()
        self._pending = 0
        self._first: Optional[float] = None
        self._deadline = 0.0
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        #: lifetime fires — the churn-soak O(1) assertion reads this
        self.fires = 0

    def note(self) -> None:
        """One churn event. Coalesces with neighbors inside the
        window; the (count-1) events a fire absorbs are counted on
        ``cilium_tpu_identity_regen_coalesced_total``."""
        if self.window_s <= 0.0:
            self.fires += 1
            self.fire()
            return
        with self._lock:
            if self._closed:
                return
            now = simclock.now()
            self._pending += 1
            self._deadline = now + self.window_s
            if self._first is None:
                self._first = now
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name="identity-regen-debounce")
                self._thread.start()
        self._kick.set()

    def _take_due(self) -> int:
        """(pending count if the window closed, else 0); resets state
        on a take."""
        with self._lock:
            if self._pending == 0:
                return 0
            now = simclock.now()
            target = min(self._deadline,
                         (self._first or now) + self.max_delay_s)
            if now < target and not self._closed:
                return 0
            n, self._pending, self._first = self._pending, 0, None
            self._kick.clear()
            return n

    def _wait_s(self) -> Optional[float]:
        with self._lock:
            if self._pending == 0:
                return None  # idle: park on the kick event
            target = min(self._deadline,
                         (self._first or 0.0) + self.max_delay_s)
            return max(0.0, target - simclock.now())

    def _run(self) -> None:
        while True:
            if self._closed and self._pending == 0:
                return
            n = self._take_due()
            if n:
                METRICS.inc(IDENTITY_REGEN_COALESCED, n - 1)
                self.fires += 1
                try:
                    self.fire()
                except Exception:  # noqa: BLE001 — a failed regen is
                    # logged by the regeneration path itself; the
                    # debouncer must keep serving later windows
                    LOG.error("debounced regeneration failed",
                              exc_info=True)
                continue
            wait = self._wait_s()
            simclock.wait_on(self._kick, wait)
            if wait is None:
                self._kick.clear()

    def flush(self) -> None:
        """Synchronously fire any pending coalesced regeneration (the
        deterministic face for tests and shutdown)."""
        with self._lock:
            n, self._pending, self._first = self._pending, 0, None
        if n:
            METRICS.inc(IDENTITY_REGEN_COALESCED, n - 1)
            self.fires += 1
            self.fire()

    def close(self, flush: bool = False) -> None:
        with self._lock:
            self._closed = True
        self._kick.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if flush:
            self.flush()
