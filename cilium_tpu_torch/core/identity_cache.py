"""Shared machinery for cluster-wide identity allocator backends
(counterpart of the reference's ``core/identity_cache.py``, copied).

Cilium's ``pkg/identity/cache`` + ``pkg/allocator`` support two
backing stores — kvstore (etcd) and CiliumIdentity CRDs — behind one
cache/notification contract (SURVEY §2.1). This base class carries the
parts both backends need, including the delivery-ordering discipline
that several review rounds hardened for the kvstore backend:

* a labels↔id cache preloaded with the reserved identities, with CIDR
  label sets allocating in the node-local scope (never shared);
* **ordered on_change delivery**: every notification — remote watch
  events and local read-through adoptions alike — fires under one
  RLock, so consumers (the selector cache) observe adds/removes for an
  identity coherently; an adoption's add racing a remote delete's
  remove could otherwise land last and resurrect a retired identity
  forever;
* **deletion-generation tombstones**: read-through adoptions snapshot
  a per-labels generation BEFORE their store read (fed from a global
  never-reused sequence — a restarting per-labels counter would ABA
  across tombstone pruning) and announce only if no delete intervened,
  retracting their insert otherwise;
* both-direction ``known`` checks, so one-sided residue of a retracted
  adoption can't mask a genuine create's announcement.

Subclasses implement the store protocol: ``_allocate_global`` (claim an
id in the backing store) and the remote-event wiring, which feeds
:meth:`_remote_upsert` / :meth:`_remote_delete`.

One departure, with the same results: the next id to claim reads the
largest cached user-scope id off a max-heap kept beside the cache
(stale entries dropped as they surface), where the reference takes the
max over the whole cache on every claim — which makes allocating n
identities O(n²).
"""

from __future__ import annotations

import heapq
import threading
from typing import Callable, Dict, Iterable, List, Optional

from cilium_tpu_torch.runtime import simclock
from cilium_tpu_torch.core.identity import (
    IDENTITY_SCOPE_LOCAL,
    IDENTITY_USER_MAX,
    IDENTITY_USER_MIN,
    RESERVED_LABELS,
    NumericIdentity,
)
from cilium_tpu_torch.core.labels import LabelSet
from cilium_tpu_torch.runtime.metrics import IDENTITIES_CLUSTER, METRICS

OnChange = Callable[[NumericIdentity, Optional[LabelSet]], None]


class IdentityCacheBase:
    """Cache + ordered-notification core shared by the kvstore and CRD
    identity allocator backends."""

    #: Prometheus gauge tracking the cached cluster identity count
    gauge_name = IDENTITIES_CLUSTER

    def __init__(self, on_change: Optional[OnChange] = None):
        #: called as on_change(nid, labels) for identities appearing
        #: remotely or via read-through (labels=None on deletion); the
        #: agent points it at its SelectorCache
        self.on_change = on_change
        self._lock = threading.Lock()
        self._by_labels: Dict[LabelSet, NumericIdentity] = {}
        self._by_id: Dict[NumericIdentity, LabelSet] = {}
        #: negated user-scope ids cached at some point (a max-heap);
        #: an entry whose id left ``_by_id`` is dropped when it surfaces
        self._user_heap: List[int] = []
        self._next_local = IDENTITY_SCOPE_LOCAL
        #: lower bound for the next id claim; bumped past every failed
        #: create so contended allocation converges without re-listing
        #: the whole id table from the store each attempt
        self._candidate_floor = IDENTITY_USER_MIN
        #: per-labels (generation, monotonic-ts) deletion tombstones
        self._del_gen: Dict[LabelSet, tuple] = {}
        self._del_gen_pruned = 0.0  # monotonic ts of last prune pass
        #: global sequence feeding every tombstone's generation; values
        #: are never reused, even after a tombstone is pruned
        self._gen_seq = 0
        #: serializes EVERY on_change delivery (see module docstring).
        #: RLock: a consumer callback may itself allocate/look up
        #: identities on the same thread.
        self._notify_lock = threading.RLock()
        for rid, lbls in RESERVED_LABELS.items():
            self._by_labels[lbls] = int(rid)
            self._by_id[int(rid)] = lbls

    # -- cache plumbing ---------------------------------------------------
    def _gauge_locked(self) -> None:
        METRICS.set_gauge(self.gauge_name, float(len(self._by_id)))

    def _gen_of(self, labels: LabelSet) -> int:
        """Deletion generation for `labels`; read-through callers MUST
        snapshot this BEFORE their store read — a DELETE whose remote
        event lands entirely between the read and the adoption is only
        visible as a generation bump."""
        with self._lock:
            return self._del_gen.get(labels, (0,))[0]

    def _insert(self, nid: int, labels: LabelSet,
                clobber: bool = True) -> bool:
        """Cache a labels↔id mapping; returns whether consumers already
        know it (both directions present — a one-sided residue means
        some transition was never announced, so it must NOT suppress
        the announcement; duplicate adds are idempotent downstream).

        ``clobber=False`` (read-through adoptions) refuses — atomically
        — to overwrite a live mapping for the same labels with a
        DIFFERENT id: the cached one came from the serialized remote
        stream and is newer than the caller's point-in-time store read
        (delete + re-create while the reader stalled). Reported as
        known so the caller neither announces nor undoes anything."""
        with self._lock:
            cur = self._by_labels.get(labels)
            if not clobber and cur is not None and cur != nid:
                return True
            known = (self._by_id.get(nid) == labels and cur == nid)
            self._by_labels[labels] = nid
            self._by_id[nid] = labels
            if IDENTITY_USER_MIN <= nid < IDENTITY_USER_MAX:
                self._push_user_locked(int(nid))
            self._gauge_locked()
        return known

    def _adopt(self, nid: int, labels: LabelSet, gen: int) -> None:
        """Adopt a mapping read through from the backing store (`gen`
        = the deletion generation snapshotted before that read).

        Read-through adoptions must notify like remote events do: the
        remote create that later arrives for this mapping sees it as
        `known` and stays silent, so skipping on_change here would
        leave e.g. a selector cache permanently blind to an identity
        whenever a store lookup races ahead of the event stream."""
        known = self._insert(nid, labels, clobber=False)
        if known:
            return
        # Announce under the notify lock, but only if the mapping is
        # still current (no remote DELETE bumped the generation since
        # before our store read, and the cache entry is still ours).
        # If a delete committed but its event hasn't arrived yet, the
        # announce is transiently stale — and the DELETE's remove,
        # serialized behind us on the notify lock, retires it. If the
        # generation HAS moved, the remote stream already owns this
        # label set: retract our residue (guarded per entry) so a dead
        # adoption can't linger in the cache — no future remote event
        # would ever retire it — and can't make the next genuine
        # create look already-known.
        with self._notify_lock:
            with self._lock:
                current = (self._del_gen.get(labels, (0,))[0] == gen
                           and self._by_labels.get(labels) == nid)
                if not current:
                    if self._by_labels.get(labels) == nid:
                        self._by_labels.pop(labels)
                    if self._by_id.get(nid) == labels:
                        self._by_id.pop(nid)
                    self._gauge_locked()
            if current and self.on_change is not None:
                self.on_change(nid, labels)

    # -- remote event application (subclass wiring calls these) -----------
    def _remote_upsert(self, nid: int, labels: LabelSet) -> None:
        """A remote create/update for (nid, labels)."""
        with self._notify_lock:
            known = self._insert(nid, labels)
            if not known and self.on_change is not None:
                self.on_change(nid, labels)

    def _remote_delete(self, nid: int, labels: LabelSet) -> None:
        """A remote deletion of (nid, labels)."""
        with self._notify_lock:
            with self._lock:
                now = simclock.now()
                self._gen_seq += 1
                self._del_gen[labels] = (self._gen_seq, now)
                if (len(self._del_gen) > 1024
                        and now - self._del_gen_pruned > 5.0):
                    # bound churn growth: tombstones older than a
                    # minute can no longer be raced by any adoption.
                    # Rate-limited: during a churn storm where all
                    # entries are young, the rebuild frees nothing, so
                    # don't pay the O(n) scan on every DELETE.
                    self._del_gen_pruned = now
                    self._del_gen = {
                        k: v for k, v in self._del_gen.items()
                        if now - v[1] < 60.0}
                # guard both pops: a stale delete must not evict a
                # newer winning mapping
                if self._by_labels.get(labels) == nid:
                    self._by_labels.pop(labels)
                    self._relink_locked(labels, nid)
                dropped = self._by_id.get(nid) == labels
                if dropped:
                    self._by_id.pop(nid)
                self._gauge_locked()
            if dropped and self.on_change is not None:
                self.on_change(nid, None)

    def _relink_locked(self, labels: LabelSet, gone: int) -> None:
        """Hook (caller holds self._lock): after `gone` was unmapped
        from `labels`, a backend that tolerates duplicate identities
        for one label set may remap to a surviving duplicate. The
        unique-mapping kvstore backend needs nothing here."""

    # -- allocation -------------------------------------------------------
    def allocate(self, labels: LabelSet) -> NumericIdentity:
        with self._lock:
            nid = self._by_labels.get(labels)
            if nid is not None:
                return nid
            if any(lbl.source == "cidr" for lbl in labels):
                # CIDR identities are node-local-scoped (SURVEY §2.1):
                # they never enter the shared store
                nid = self._next_local
                self._next_local += 1
                self._by_labels[labels] = nid
                self._by_id[nid] = labels
                return nid
        return self._allocate_global(labels)

    def _allocate_global(self, labels: LabelSet) -> NumericIdentity:
        raise NotImplementedError

    def _next_candidate(self) -> int:
        """Next id to claim, from the event-mirrored cache — no
        full-table round trip per attempt. Ids claimed by peers but not
        yet visible here just fail the create, bumping the floor."""
        with self._lock:
            heap = self._user_heap
            while heap and -heap[0] not in self._by_id:
                heapq.heappop(heap)
            cache_max = -heap[0] if heap else IDENTITY_USER_MIN - 1
            return max(cache_max + 1, self._candidate_floor)

    def _push_user_locked(self, nid: int) -> None:
        """Note a cached user-scope id on the max-heap (caller holds
        ``_lock``); rebuilt from the cache once re-announced ids have
        piled up duplicates, so the heap stays O(cache)."""
        heap = self._user_heap
        heapq.heappush(heap, -nid)
        if len(heap) > 2 * len(self._by_id) + 64:
            heap[:] = [-int(n) for n in self._by_id
                       if IDENTITY_USER_MIN <= n < IDENTITY_USER_MAX]
            heapq.heapify(heap)

    # -- IdentityAllocator contract ---------------------------------------
    def release(self, nid: NumericIdentity) -> None:
        """Forget locally. Store entries are shared cluster state; the
        operator's identity GC — not any one agent — retires ids no
        endpoint references (the reference's CiliumIdentity GC)."""
        with self._lock:
            labels = self._by_id.pop(nid, None)
            if labels is not None and self._by_labels.get(labels) == nid:
                self._by_labels.pop(labels, None)

    def identities(self) -> Iterable[NumericIdentity]:
        with self._lock:
            return list(self._by_id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_id)
