"""Leader election over the kvstore (operator HA).

Reference: cilium-operator runs replicas behind leader election (a
k8s Lease; ``operator/cmd`` leaderelection) so exactly one instance
reconciles while standbys wait to take over. Same contract here on the
kvstore's primitives: the lock is a create-only key under a TTL lease —
holding it means leading, losing the lease (crash, partition, clean
resign) frees the lock for a standby within the TTL.

Split-brain guard: a leader that can no longer confirm it holds the
key (keepalive fails, or the key no longer carries its identity)
demotes itself FIRST (``on_stopped_leading``) and only then
re-campaigns — the reference's leaderelection does the same
release-before-retry dance so two reconcilers never run concurrently.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from cilium_tpu_torch.runtime.logging import get_logger
from cilium_tpu_torch.runtime import simclock
from cilium_tpu_torch.runtime.metrics import METRICS

LOG = get_logger("leader")

LEADER_PREFIX = "cilium/leader/"


class LeaderElector:
    """Campaign for ``cilium/leader/<name>``; drive the caller's
    started/stopped callbacks as leadership comes and goes."""

    def __init__(self, store, name: str, identity: str,
                 on_started_leading: Callable[[], None],
                 on_stopped_leading: Callable[[], None],
                 ttl: float = 15.0):
        self.store = store
        self.key = LEADER_PREFIX + name
        self.identity = identity
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.ttl = ttl
        self.is_leader = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- campaign loop ----------------------------------------------------
    def start(self) -> "LeaderElector":
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"leader-{self.key.rsplit('/', 1)[-1]}")
        self._thread.start()
        return self

    def _run(self) -> None:
        interval = max(0.05, self.ttl / 3.0)
        while not self._stop.is_set():
            # EVERY store call in the campaign cycle is an RPC that
            # can fail transiently; none may kill this thread — a dead
            # campaign thread is a standby that silently never takes
            # over (2-replica HA degraded to 1 with no error)
            try:
                lease = self.store.lease(self.ttl)
            except Exception:  # store briefly unreachable: retry
                if simclock.wait_on(self._stop, interval):
                    return
                continue
            try:
                won = self.store.create(self.key, self.identity,
                                        lease=lease)
            except Exception:
                won = False
            if not won:
                try:
                    self.store.revoke(lease)
                # ctlint: disable=swallowed-exception  # best-effort revoke of a lost campaign; the lease ages out
                except Exception:  # noqa: BLE001
                    pass
                if simclock.wait_on(self._stop, interval):
                    return
                continue
            self._lead(lease, interval)
            if self._stop.is_set():
                # resign path: drop our key via lease revocation — the
                # key is attached to OUR lease, so this can never
                # delete a lock a standby re-acquired in the meantime
                # (the unconditional get-then-delete could)
                try:
                    self.store.revoke(lease)
                # ctlint: disable=swallowed-exception  # resign is best-effort; the lease ages the key out
                except Exception:  # noqa: BLE001 — lease ages out
                    pass
                return
            try:  # leadership lost mid-stint: release our leftovers
                self.store.revoke(lease)
            # ctlint: disable=swallowed-exception  # best-effort cleanup; the lease ages the key out
            except Exception:  # noqa: BLE001
                pass

    def _lead(self, lease, interval: float) -> None:
        """One leadership stint: callbacks, keepalive, demotion."""
        self.is_leader = True
        METRICS.set_gauge("cilium_tpu_leader", 1.0,
                          labels={"name": self.key})
        LOG.info("started leading",
                 extra={"fields": {"key": self.key,
                                   "identity": self.identity}})
        # the startup callback (e.g. Operator adopting persisted
        # assignments over a slow remote store) can outlast the TTL:
        # a ticker keeps the lease alive while it runs, or a standby
        # would win the lock mid-startup and reconcile concurrently
        ka_stop = threading.Event()

        def ticker() -> None:
            while not simclock.wait_on(ka_stop, interval):
                try:
                    lease.keepalive()
                except Exception:  # lost anyway; main loop detects
                    return

        t = threading.Thread(target=ticker, daemon=True,
                             name="leader-keepalive")
        t.start()
        try:
            try:
                self.on_started_leading()
            finally:
                ka_stop.set()
                t.join(timeout=5.0)
            while not simclock.wait_on(self._stop, interval):
                try:
                    lease.keepalive()
                    if self.store.get(self.key) != self.identity:
                        raise KeyError("lock lost")
                except Exception:  # expired / lost / unreachable
                    LOG.warning("leadership lost",
                                extra={"fields": {
                                    "key": self.key,
                                    "identity": self.identity}})
                    break
        except Exception:  # noqa: BLE001 — startup failed: demote,
            LOG.exception("leadership stint failed")  # then re-campaign
        finally:
            # demote BEFORE any re-campaign: no window where two
            # instances both believe they lead
            self.is_leader = False
            METRICS.set_gauge("cilium_tpu_leader", 0.0,
                              labels={"name": self.key})
            try:
                self.on_stopped_leading()
            except Exception:  # noqa: BLE001 — must keep cycling
                LOG.exception("on_stopped_leading failed")

    def stop(self) -> None:
        """Resign: stop campaigning, release the lock if held (clean
        handover — standbys take over immediately instead of waiting
        out the TTL)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(5.0, self.ttl))
            if self._thread.is_alive():
                # teardown still in flight (a reconcile stuck on a
                # slow RPC): do NOT hand the lock to a standby while
                # this instance may still be acting on it — the lease
                # ages the key out once the straggler stops
                # keepaliving, which is the safe, slower handover
                LOG.warning("resign timed out; leaving lock to lapse",
                            extra={"fields": {"key": self.key}})
                return
            self._thread = None
