"""Lease-backed service advertisement in the kvstore.

The recurring pattern behind peer discovery (hubble observers, health
endpoints; the reference publishes the analogous per-node state as
CiliumNode/peer entries): publish a key under a TTL lease, heartbeat
it, and let the lease age the entry out if the publisher dies. The
heartbeat is authoritative on KEY PRESENCE, not the lease object — the
in-process store's keepalive never fails, and a >TTL stall must
re-publish rather than silently extend a lease whose key was GC'd.
"""

from __future__ import annotations


class Advertisement:
    """Publish ``key = value`` under a TTL lease; heartbeat keeps it
    alive, re-publishing after any lapse; ``withdraw()`` removes it
    immediately (clean departure)."""

    def __init__(self, store, key: str, value: str, ttl: float = 60.0):
        self.store = store
        self.key = key
        self.value = value
        self.ttl = ttl
        self._lease = None
        self.publish()

    def publish(self) -> None:
        self._lease = self.store.lease(self.ttl)
        self.store.set(self.key, self.value, lease=self._lease)

    def heartbeat(self) -> None:
        if self._lease.expired() or self.store.get(self.key) is None:
            self.publish()
            return
        try:
            self._lease.keepalive()
        except KeyError:  # remote store: server-side expiry is an error
            self.publish()
            return
        if self.store.get(self.key) is None:  # lapsed in the window
            self.publish()

    def withdraw(self) -> None:
        try:
            self.store.delete(self.key)
            if self._lease is not None:
                self.store.revoke(self._lease)
        # ctlint: disable=swallowed-exception  # withdraw is best-effort
        except Exception:
            pass  # store gone first: the lease ages the entry out
