"""Key-value store: the clustermesh/identity state backbone
(counterpart of the reference's ``kvstore.py``, copied onto the port's
``simclock``, ``faults`` and ``metrics``).

Cilium's ``pkg/kvstore`` is an etcd-backed store used for identity
allocation and clustermesh state, with prefix watches
(create/modify/delete events) and TTL leases whose expiry removes the
keys of a crashed agent. This is a single-process registry with the
same observable contract — linearizable set/get/delete,
`list_prefix`, replay-then-follow prefix watches, leases with
keepalive — behind a small interface so an etcd-backed implementation
can slot in without touching clustermesh.

One departure, with the same observable behaviour: the store keeps an
index of the keys that carry a lease, so the opportunistic
``expire_leases`` every read and claim runs costs the leased keys, not
the whole store (the reference scans every key on every ``get`` and
``create``, which makes allocating n identities O(n²)). Expired keys
are still deleted, and their events delivered, in the store's
insertion order.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from cilium_tpu_torch.runtime import faults, simclock
from cilium_tpu_torch.runtime.logging import get_logger
from cilium_tpu_torch.runtime.metrics import KVSTORE_WATCH_ERRORS, METRICS

LOG = get_logger("kvstore")

#: fires per watch-event delivery — a session fault must cost ONE
#: watcher ONE event, never the committing writer or its siblings
WATCH_POINT = faults.register_point(
    "kvstore.watch", "per-watch event delivery in KVStore")

#: Watch event types, mirroring the reference's kvstore EventType.
EVENT_CREATE = "create"
EVENT_MODIFY = "modify"
EVENT_DELETE = "delete"


@dataclasses.dataclass(frozen=True)
class Event:
    typ: str  # EVENT_CREATE | EVENT_MODIFY | EVENT_DELETE
    key: str
    value: str  # previous value for deletes, new value otherwise


class Lease:
    """A TTL lease; keys attached to it vanish when it expires.

    The reference uses etcd leases so a dead agent's identity/ipcache
    keys are garbage-collected; `keepalive()` is the heartbeat.
    """

    def __init__(self, ttl: float) -> None:
        self.ttl = ttl
        self.deadline = simclock.now() + ttl
        self.revoked = False

    def keepalive(self) -> None:
        self.deadline = simclock.now() + self.ttl

    def expired(self, now: Optional[float] = None) -> bool:
        return self.revoked or (now or simclock.now()) > self.deadline


class Watch:
    """Handle for a prefix watch; `stop()` detaches the callback."""

    def __init__(self, store: "KVStore", prefix: str,
                 callback: Callable[[Event], None]) -> None:
        self._store = store
        self.prefix = prefix
        self.callback = callback
        self.stopped = False

    def stop(self) -> None:
        # Taking the dispatch lock means stop() returns only after any
        # in-flight callback delivery has finished — a caller may then
        # tear down the state the callback feeds (clustermesh
        # disconnect) without racing a half-delivered event.
        with self._store._dispatch_lock:
            self.stopped = True
            self._store._remove_watch(self)


class KVStore:
    """In-memory store with etcd-like semantics.

    Thread-safe. Watch callbacks run synchronously under the caller's
    thread after the mutation commits (events are ordered per store —
    the reference serializes events per watcher the same way).
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        # Serializes ALL event deliveries (replay and live) so a watch
        # registered mid-set never sees the live MODIFY before its own
        # replay CREATE. RLock: a callback may re-enter the store.
        self._dispatch_lock = threading.RLock()
        self._data: Dict[str, Tuple[str, Optional[Lease]]] = {}
        #: key → lease, for the keys of ``_data`` that carry one
        self._leased: Dict[str, Lease] = {}
        self._watches: List[Watch] = []
        self._revision = 0

    # -- leases ----------------------------------------------------------
    def lease(self, ttl: float) -> Lease:
        return Lease(ttl)

    def revoke(self, lease: Lease) -> None:
        lease.revoked = True
        self.expire_leases()

    def expire_leases(self) -> int:
        """Drop keys whose lease has expired; returns count removed.

        Called opportunistically (and by clustermesh's heartbeat
        controller) instead of a dedicated expiry thread — keeps the
        store deterministic under test.
        """
        now = simclock.now()
        with self._lock:
            expired = {k for k, l in self._leased.items() if l.expired(now)}
            dead = [k for k in self._data if k in expired] if expired else []
        removed = 0
        for k in dead:
            # re-check under the commit lock: the key may have been
            # re-set with a fresh lease (or no lease) since the scan —
            # deleting unconditionally would drop a live entry
            with self._dispatch_lock:
                with self._lock:
                    entry = self._data.get(k)
                    if (entry is None or entry[1] is None
                            or not entry[1].expired()):
                        continue
                    self._data.pop(k)
                    self._leased.pop(k, None)
                    self._revision += 1
                    ev = Event(EVENT_DELETE, k, entry[0])
                    watches = list(self._watches)
                self._dispatch(watches, ev)
            removed += 1
        return removed

    # -- kv --------------------------------------------------------------
    def set(self, key: str, value: str, lease: Optional[Lease] = None) -> None:
        # dispatch lock is taken BEFORE the commit so watchers observe
        # mutations in commit order (commit and delivery serialize on
        # the same lock; releasing _lock first would let a later write
        # deliver ahead of an earlier one)
        with self._dispatch_lock:
            with self._lock:
                existed = key in self._data
                self._data[key] = (value, lease)
                self._index_lease(key, lease)
                self._revision += 1
                ev = Event(EVENT_MODIFY if existed else EVENT_CREATE,
                           key, value)
                watches = list(self._watches)
            self._dispatch(watches, ev)

    def create(self, key: str, value: str,
               lease: Optional[Lease] = None) -> bool:
        """Set only if absent (the reference's etcd ``CreateOnly``) —
        the atomic claim primitive distributed identity allocation
        builds on. Returns False when the key already exists."""
        self.expire_leases()  # an expired-lease leftover counts as absent
        with self._dispatch_lock:
            with self._lock:
                if key in self._data:
                    return False
                self._data[key] = (value, lease)
                self._index_lease(key, lease)
                self._revision += 1
                ev = Event(EVENT_CREATE, key, value)
                watches = list(self._watches)
            self._dispatch(watches, ev)
        return True

    def _index_lease(self, key: str, lease: Optional[Lease]) -> None:
        """Keep ``_leased`` in step with ``_data`` (caller holds the
        lock)."""
        if lease is None:
            self._leased.pop(key, None)
        else:
            self._leased[key] = lease

    def get(self, key: str) -> Optional[str]:
        self.expire_leases()
        with self._lock:
            entry = self._data.get(key)
        return entry[0] if entry is not None else None

    def delete(self, key: str) -> bool:
        with self._dispatch_lock:
            with self._lock:
                entry = self._data.pop(key, None)
                if entry is None:
                    return False
                self._leased.pop(key, None)
                self._revision += 1
                ev = Event(EVENT_DELETE, key, entry[0])
                watches = list(self._watches)
            self._dispatch(watches, ev)
        return True

    def delete_prefix(self, prefix: str) -> int:
        with self._lock:
            keys = [k for k in self._data if k.startswith(prefix)]
        return sum(self.delete(k) for k in keys)

    def list_prefix(self, prefix: str) -> Dict[str, str]:
        self.expire_leases()
        with self._lock:
            return {k: v for k, (v, _) in self._data.items()
                    if k.startswith(prefix)}

    @property
    def revision(self) -> int:
        with self._lock:
            return self._revision

    # -- watches ---------------------------------------------------------
    def watch_prefix(self, prefix: str,
                     callback: Callable[[Event], None],
                     replay: bool = True) -> Watch:
        """Subscribe to events under `prefix`. With `replay`, current
        keys are delivered first as CREATE events (the reference's
        ListAndWatch contract) before any live event."""
        self.expire_leases()  # dead-agent keys must not replay: no
        w = Watch(self, prefix, callback)  # DELETE would ever follow
        with self._dispatch_lock:
            with self._lock:
                now = simclock.now()
                snapshot = [(k, v) for k, (v, l) in self._data.items()
                            if k.startswith(prefix)
                            and (l is None or not l.expired(now))
                            ] if replay else []
                self._watches.append(w)
            # any set() that committed before registration is in the
            # snapshot; any later one blocks on the dispatch lock until
            # the replay below has been delivered
            for k, v in snapshot:
                self._deliver(w, Event(EVENT_CREATE, k, v))
        return w

    def _remove_watch(self, w: Watch) -> None:
        with self._lock:
            if w in self._watches:
                self._watches.remove(w)

    def _deliver(self, w: Watch, ev: Event) -> None:
        """One watcher, one event — isolated. A raising callback (or
        an injected session fault) must cost that watcher that event,
        never propagate into the committing writer: the reference
        serializes and logs per-watcher errors the same way."""
        try:
            faults.maybe_fail(WATCH_POINT)
            w.callback(ev)
        except Exception as e:  # noqa: BLE001 — isolate the watcher
            METRICS.inc(KVSTORE_WATCH_ERRORS)
            LOG.error("watch callback failed",
                      extra={"fields": {
                          "prefix": w.prefix, "key": ev.key,
                          "event": ev.typ,
                          "error": f"{type(e).__name__}: {e}"}})

    def _dispatch(self, watches: List[Watch], ev: Event) -> None:
        with self._dispatch_lock:
            for w in watches:
                if not w.stopped and ev.key.startswith(w.prefix):
                    self._deliver(w, ev)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __iter__(self) -> Iterator[str]:
        with self._lock:
            return iter(list(self._data))
