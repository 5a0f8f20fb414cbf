"""Operator: cluster-wide orchestration (the `operator/` analog).

Reference: ``cilium-operator`` (SURVEY.md §2.4) — one per cluster, it
owns cluster-scoped work the per-node agents must not race on. The
north-star-relevant slice is **cluster-pool IPAM**: the operator carves
a podCIDR per node out of the cluster pool and publishes it; agents
watch for their assignment and run their :class:`NodeAllocator` inside
it. State flows through the kvstore (the reference uses CiliumNode CRD
status; our kvstore plays the CRD-store role, as it does for
clustermesh), with lease-based liveness: a node whose registration
lease lapses gets its CIDR reclaimed — the operator's garbage-collection
duty.

Keys:
  cilium/nodes/<name>          agent-owned, lease-backed registration
  cilium/podcidrs/<name>       operator-owned CIDR assignment
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional

from cilium_tpu_torch.ipam import ClusterPool, PoolExhausted
from cilium_tpu_torch.kvstore import EVENT_DELETE, KVStore, Lease
from cilium_tpu_torch.runtime import simclock
from cilium_tpu_torch.runtime.controller import Controller
from cilium_tpu_torch.runtime.logging import get_logger
from cilium_tpu_torch.runtime.metrics import METRICS

LOG = get_logger("operator")

NODES_PREFIX = "cilium/nodes/"
CIDRS_PREFIX = "cilium/podcidrs/"


class Operator:
    """Watches node registrations; assigns/reclaims per-node podCIDRs."""

    def __init__(self, store: KVStore, pool_cidr: str = "10.0.0.0/8",
                 node_mask_size: int = 24, k8s_api_socket: str = "",
                 leader_election: bool = False,
                 instance: str = "", election_ttl: float = 15.0):
        self.store = store
        self.pool = ClusterPool(pool_cidr, node_mask_size=node_mask_size)
        self._lock = threading.Lock()
        self._watch = None
        self._controller: Optional[Controller] = None
        #: when set, reconcile also runs the CiliumIdentity CRD GC
        #: (identity-allocation-mode=crd deployments)
        self._k8s_client = None
        if k8s_api_socket:
            from cilium_tpu_torch.k8s.apiserver import K8sClient

            self._k8s_client = K8sClient(k8s_api_socket)
        #: HA mode (reference: cilium-operator replicas behind leader
        #: election): only the elected instance reconciles; standbys
        #: campaign and take over within the election TTL
        self._leader_election = leader_election
        self._instance = instance or f"operator-{os.getpid()}"
        self._election_ttl = election_ttl
        self._elector = None

    def _persisted_assignments(self) -> Dict[str, str]:
        """node → CIDR from the store, quarantining corrupt entries.

        A single undecodable/unfitting value (mask-size change across
        restarts, a foreign CIDR, an external writer's partial write —
        the store is pluggable-etcd by contract) must degrade only that
        one entry, never crash-loop start() or the reconcile
        controller: the bad key is deleted so reconcile issues a fresh
        assignment, and a metric records the quarantine.
        """
        out: Dict[str, str] = {}
        for key, value in self.store.list_prefix(CIDRS_PREFIX).items():
            try:
                out[key[len(CIDRS_PREFIX):]] = json.loads(value)["cidr"]
            except (ValueError, KeyError, TypeError) as e:
                self.store.delete(key)
                # no-op unless the pool holds an adoption for this node
                # (corruption after adopt): without it the subnet leaks
                self.pool.release_node_cidr(key[len(CIDRS_PREFIX):])
                LOG.warning("quarantined corrupt podCIDR assignment",
                            extra={"fields": {
                                "node": key[len(CIDRS_PREFIX):],
                                "error": f"{type(e).__name__}: {e}"}})
                METRICS.inc(
                    "cilium_tpu_operator_cidrs_quarantined_total", 1)
        return out

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "Operator":
        """Without leader election: lead immediately (the single-
        replica deployment). With it: campaign, and reconcile only
        while elected — a standby replica parks here until the
        leader's lock lapses or is released."""
        if not self._leader_election:
            self._start_leading()
            return self
        from cilium_tpu_torch.runtime.leader import LeaderElector

        self._elector = LeaderElector(
            self.store, "cilium-operator", self._instance,
            on_started_leading=self._start_leading,
            on_stopped_leading=self._stop_leading,
            ttl=self._election_ttl).start()
        return self

    def _start_leading(self) -> None:
        # adopt existing assignments first (operator restart/failover
        # must not re-carve CIDRs out from under live nodes — §5.4
        # resume; the pool is rebuilt fresh from the persisted store
        # state, which also discards any stale carvings a previous
        # leadership stint of THIS instance left in memory)
        self.pool = ClusterPool(str(self.pool.pool),
                                node_mask_size=self.pool.node_mask_size)
        for node, cidr in self._persisted_assignments().items():
            try:
                self.pool.adopt_node_cidr(node, cidr)
            except (ValueError, TypeError):
                self.store.delete(CIDRS_PREFIX + node)
                METRICS.inc(
                    "cilium_tpu_operator_cidrs_quarantined_total", 1)
        self.reconcile()
        # Reconcile runs on its own controller thread; the watch
        # callback only trigger()s it. Reconciling synchronously inside
        # the callback would deadlock: list_prefix → expire_leases
        # dispatches a DELETE to our own watch under the store's
        # dispatch lock, re-entering reconcile on self._lock.
        self._controller = Controller(
            "operator-reconcile", lambda: self.reconcile(),
            interval=30.0).start()
        self._watch = self.store.watch_prefix(
            NODES_PREFIX, lambda ev: self._controller.trigger())

    def _stop_leading(self) -> None:
        if self._watch is not None:
            self._watch.stop()
            self._watch = None
        if self._controller is not None:
            self._controller.stop()
            self._controller = None

    @property
    def is_leader(self) -> bool:
        if not self._leader_election:
            return True
        return self._elector is not None and self._elector.is_leader

    def stop(self) -> None:
        if self._elector is not None:
            self._elector.stop()  # resigns; drove _stop_leading
            self._elector = None
            return
        self._stop_leading()

    # -- reconciliation ---------------------------------------------------
    def reconcile(self) -> Dict[str, str]:
        """One idempotent pass: every registered node has a CIDR; every
        CIDR belongs to a registered node. Returns the assignment map."""
        with self._lock:
            nodes = {
                key[len(NODES_PREFIX):]
                for key in self.store.list_prefix(NODES_PREFIX)
            }
            assigned = self._persisted_assignments()
            # reclaim: assignment whose node is gone (lease expired/
            # deregistered) — the operator's GC duty
            for node in list(assigned):
                if node not in nodes:
                    self.store.delete(CIDRS_PREFIX + node)
                    self.pool.release_node_cidr(node)
                    LOG.info("reclaimed podCIDR from departed node",
                             extra={"fields": {"node": node,
                                               "cidr": assigned[node]}})
                    del assigned[node]
                    METRICS.inc("cilium_tpu_operator_cidrs_reclaimed_total",
                                1)
            # assign: registered node without a CIDR
            for node in sorted(nodes - set(assigned)):
                try:
                    cidr = self.pool.allocate_node_cidr(node)
                except PoolExhausted:
                    METRICS.inc("cilium_tpu_operator_pool_exhausted_total",
                                1)
                    continue
                self.store.set(CIDRS_PREFIX + node,
                               json.dumps({"cidr": cidr}))
                assigned[node] = cidr
            # identity GC (the reference operator's CiliumIdentity GC
            # duty): reap orphaned allocation claims past their grace
            from cilium_tpu_torch.identity_kvstore import gc_orphan_identities

            gc_orphan_identities(self.store)
            if self._k8s_client is not None:
                from cilium_tpu_torch.k8s.identity_crd import gc_crd_identities

                gc_crd_identities(self._k8s_client)
            return assigned


class NodeRegistration:
    """Agent-side: register this node, await its podCIDR assignment.

    ``on_cidr_change(old, new)`` (optional) fires whenever the
    operator rewrites or deletes this node's assignment — the agent
    must then rebuild its :class:`NodeAllocator` on the new CIDR
    instead of allocating pod IPs from a range it no longer owns
    (e.g. after an operator restart with a changed ``node_mask_size``
    quarantined and re-carved the old assignment). `new` is ``None``
    on deletion.
    """

    def __init__(self, store: KVStore, node_name: str,
                 lease_ttl: float = 60.0,
                 on_cidr_change=None):
        self.store = store
        self.node_name = node_name
        self.lease: Lease = store.lease(lease_ttl)
        self._key = NODES_PREFIX + node_name
        self._registration = json.dumps({"name": node_name})
        self._cidr_watch = None
        if on_cidr_change is not None:
            self._last_cidr: Optional[str] = None
            cidr_key = CIDRS_PREFIX + node_name

            def _notify(ev) -> None:
                # watch_prefix matches by prefix: without the exact-key
                # check, node "worker-1" would receive (and act on)
                # "worker-10"'s assignments
                if ev.key != cidr_key:
                    return
                if ev.typ == EVENT_DELETE:
                    new = None
                else:
                    try:
                        new = json.loads(ev.value).get("cidr")
                    except (ValueError, AttributeError):
                        return  # corrupt write: the operator will
                        # quarantine it; crashing the store's dispatch
                        # here would starve every later watcher
                old, self._last_cidr = self._last_cidr, new
                if old != new:
                    on_cidr_change(old, new)

            self._cidr_watch = store.watch_prefix(cidr_key, _notify)
        store.set(self._key, self._registration, lease=self.lease)

    def heartbeat(self) -> None:
        """Keep the registration lease alive (controller duty).

        A keepalive after the lease already lapsed must NOT silently
        resurrect it: the store has (or will have) GC'd the node key,
        the operator may have reclaimed — even reassigned — our CIDR,
        and extending the dead lease's deadline would leave this agent
        deregistered forever while believing it is healthy (the
        reference's etcd keepalive fails with ErrLeaseNotFound and the
        agent re-registers). Re-register with a fresh lease instead;
        the caller should then re-read `pod_cidr()` before trusting a
        previously cached assignment.
        """
        if (not self.lease.expired()
                and self.store.get(self._key) is not None):
            try:
                self.lease.keepalive()
            except KeyError:
                # remote store: the server is authoritative and answers
                # a keepalive on an already-expired lease with an error
                # (etcd's ErrLeaseNotFound) — fall through and
                # re-register
                pass
            else:
                # Re-verify AFTER the keepalive: the lease may have
                # lapsed between the check and the extension
                # (check-then-act window), in which case GC already
                # deleted the key and a resurrected deadline would mask
                # the deregistration.
                if self.store.get(self._key) is not None:
                    return
        self.lease = self.store.lease(self.lease.ttl)
        self.store.set(self._key, self._registration, lease=self.lease)

    def pod_cidr(self) -> Optional[str]:
        raw = self.store.get(CIDRS_PREFIX + self.node_name)
        if not raw:
            return None
        try:
            return json.loads(raw)["cidr"]
        except (ValueError, KeyError, TypeError):
            # transiently corrupt assignment (operator quarantines it on
            # its next reconcile): report "not assigned yet" so
            # wait_for_cidr keeps polling instead of aborting start()
            return None

    def wait_for_cidr(self, timeout: float = 5.0,
                      interval: float = 0.05) -> str:
        
        deadline = simclock.now() + timeout
        while simclock.now() < deadline:
            cidr = self.pod_cidr()
            if cidr:
                return cidr
            simclock.sleep(interval)
        raise TimeoutError(
            f"no podCIDR assigned to {self.node_name} within {timeout}s")

    def close(self) -> None:
        """Stop watching, but stay registered: used on agent shutdown
        so the node keeps its CIDR across a restart (the lease lapses
        only if the agent stays down past the TTL)."""
        if self._cidr_watch is not None:
            self._cidr_watch.stop()
            self._cidr_watch = None

    def deregister(self) -> None:
        self.close()
        self.store.revoke(self.lease)
        self.store.delete(self._key)


def main(argv=None) -> int:  # pragma: no cover - thin wrapper
    """``cilium-operator`` entrypoint: run against a socket-served
    kvstore (``python -m cilium_tpu_torch.kvstore_service``)."""
    import argparse
    import signal
    import threading

    ap = argparse.ArgumentParser(
        prog="cilium-tpu-operator",
        description="run the cluster operator (cilium-operator analog)")
    ap.add_argument("--kvstore", required=True,
                    help="kvstore server unix socket")
    ap.add_argument("--pool-cidr", default="10.0.0.0/8")
    ap.add_argument("--node-mask", type=int, default=24)
    ap.add_argument("--k8s-api-socket", default="",
                    help="fake-apiserver socket: also run the "
                         "CiliumIdentity CRD GC (crd identity mode)")
    ap.add_argument("--leader-election", action="store_true",
                    help="HA mode: campaign for the operator lock; "
                         "reconcile only while elected (run several "
                         "replicas, reference leader election)")
    ap.add_argument("--election-ttl", type=float, default=15.0)
    args = ap.parse_args(argv)

    from cilium_tpu_torch.kvstore_service import RemoteKVStore
    from cilium_tpu_torch.runtime.logging import setup as setup_logging

    setup_logging()
    kv = RemoteKVStore(args.kvstore)
    op = Operator(kv, pool_cidr=args.pool_cidr,
                  node_mask_size=args.node_mask,
                  k8s_api_socket=args.k8s_api_socket,
                  leader_election=args.leader_election,
                  election_ttl=args.election_ttl).start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    op.stop()
    kv.close()
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
