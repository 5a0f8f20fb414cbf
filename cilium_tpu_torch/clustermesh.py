"""Clustermesh: multi-cluster identity and ipcache synchronisation
(counterpart of the reference's ``clustermesh.py``, copied; it runs
over the port's ``IPCache`` and ``loadbalancer.service``).

Cilium's ``pkg/clustermesh`` + ``clustermesh-apiserver`` — each
agent watches remote clusters' kvstores for identities, endpoint IPs,
and nodes, making remote workloads matchable by local policy. Key layout mirrors the reference's shared-state paths
(``cilium/state/{identities,ip,nodes}/v1/...``, unverified per the
SURVEY provenance note).

Design differences from the reference, deliberate:

- Remote label sets are **re-allocated through the local
  IdentityAllocator** rather than trusting remote numeric IDs — local
  numeric identities stay dense, which keeps the compiled policy
  tensors small (remote IDs from k clusters would otherwise fragment
  the identity axis the TPU engine gathers over).
- Every remote entry is tagged with a ``cluster=<name>`` label
  (reference: ``io.cilium.k8s.policy.cluster``) so policies can select
  by cluster.
- A `LocalStatePublisher` mirrors the local agent's ipcache into its
  own kvstore under a TTL lease, so a crashed agent's state ages out
  of peer clusters (reference: etcd lease GC).
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Dict, List, Optional

from cilium_tpu_torch.core.identity import IdentityAllocator, NumericIdentity
from cilium_tpu_torch.core.labels import Label, LabelSet, SOURCE_K8S
from cilium_tpu_torch.kvstore import Event, EVENT_DELETE, KVStore, Watch
from cilium_tpu_torch.runtime import faults
from cilium_tpu_torch.runtime.metrics import (
    CLUSTERMESH_DECODE_ERRORS,
    CLUSTERMESH_READY,
    METRICS,
)

#: fires per remote-cluster event ingest: a session fault costs one
#: event (isolated by the kvstore's per-watcher delivery), and the
#: next announcement of the key repairs the entry
SESSION_POINT = faults.register_point(
    "clustermesh.session", "remote-cluster event ingest")
#: fires in the publisher heartbeat: the owning Controller's
#: exponential backoff (runtime/controller.py) absorbs it and the
#: lease keeps published state alive until the next beat lands
HEARTBEAT_POINT = faults.register_point(
    "clustermesh.heartbeat", "local-state publisher heartbeat")

IP_PREFIX = "cilium/state/ip/v1/default/"
IDENTITY_PREFIX = "cilium/state/identities/v1/id/"
NODES_PREFIX = "cilium/state/nodes/v1/"
SERVICES_PREFIX = "cilium/state/services/v1/"

#: Label key marking which cluster an identity/IP came from
#: (reference's ``io.cilium.k8s.policy.cluster``; the namespaced key
#: cannot collide with ordinary workload labels like ``cluster=c0``).
#: Shared with the policy layer: the `cluster` entity selects on it.
from cilium_tpu_torch.policy.api.rule import CLUSTER_LABEL_KEY  # noqa: E402


def _encode_labels(labels: LabelSet) -> List[str]:
    return list(labels.format())


def _decode_labels(items: List[str]) -> LabelSet:
    return LabelSet.parse(items)


class LocalStatePublisher:
    """Mirror the local ipcache (IP → identity labels) into a kvstore.

    The reference's agent writes its ipcache/identity state into the
    shared etcd (or the clustermesh-apiserver proxies it); peers watch
    it. Keys live under a lease refreshed by `heartbeat()` — wire that
    to a ControllerManager interval so agent death expires the state.
    """

    def __init__(self, store: KVStore, cluster_name: str,
                 allocator: IdentityAllocator, ipcache,
                 lease_ttl: float = 60.0, services=None) -> None:
        self.store = store
        self.cluster_name = cluster_name
        self._allocator = allocator
        self._lease = store.lease(lease_ttl)
        self._ipcache = ipcache
        #: optional ServiceManager — SHARED services are exported for
        #: peers' global-service merge (reference: the clustermesh
        #: apiserver exports services annotated service.cilium.io/global)
        self._services = services
        self._published_services: Dict[str, str] = {}  # key → value
        ipcache.subscribe(self._on_ipcache)

    def _key(self, prefix: str) -> str:
        return f"{IP_PREFIX}{self.cluster_name}/{prefix}"

    def _on_ipcache(self, prefix: str, nid: NumericIdentity,
                    upsert: bool) -> None:
        labels = self._allocator.lookup(nid)
        # Never re-export state learned FROM another cluster — in a
        # full mesh (A watches B, B watches A) re-publishing remote
        # entries under our own prefix would echo them back forever.
        if labels is not None:
            tag = labels.get(CLUSTER_LABEL_KEY, SOURCE_K8S)
            if tag is not None and tag.value != self.cluster_name:
                return
        if not upsert:
            self.store.delete(self._key(prefix))
            return
        self.store.set(
            self._key(prefix),
            json.dumps({"prefix": prefix, "identity": int(nid),
                        "labels": _encode_labels(labels) if labels else [],
                        "cluster": self.cluster_name}),
            lease=self._lease)

    def publish_services(self) -> None:
        """Export SHARED services (+ their active local backends) under
        the services prefix; un-shared/deleted ones are withdrawn.
        Reconcile-style (called from heartbeat): eventual consistency
        under a lease, like the rest of the published state."""
        if self._services is None:
            return
        current: Dict[str, str] = {}
        for svc in self._services.list():
            if not svc.shared:
                continue
            key = (f"{SERVICES_PREFIX}{self.cluster_name}/"
                   f"{svc.namespace}/{svc.name}")
            current[key] = json.dumps({
                "cluster": self.cluster_name,
                "namespace": svc.namespace,
                "name": svc.name,
                "shared": True,
                "backends": [{"ip": b.ip, "port": b.port,
                              "weight": b.weight}
                             for b in svc.active_backends()],
            }, sort_keys=True)
            # re-setting an unchanged value every heartbeat would emit
            # MODIFY to every watching peer → full policy regeneration
            # mesh-wide every 15s; only publish real changes (the
            # lease keepalive keeps unchanged keys alive)
            if self._published_services.get(key) != current[key]:
                self.store.set(key, current[key], lease=self._lease)
        for key in self._published_services.keys() - current.keys():
            self.store.delete(key)
        self._published_services = current

    def heartbeat(self) -> None:
        faults.maybe_fail(HEARTBEAT_POINT)
        self._lease.keepalive()
        self.publish_services()
        self.store.expire_leases()


class RemoteCluster:
    """Watch one remote cluster's kvstore; feed local ipcache/selectors.

    Mirrors ``pkg/clustermesh ·remoteCluster``: ListAndWatch the remote
    ip/identity prefixes; each remote IP is upserted into the local
    ipcache under a locally-allocated identity for its labels (plus the
    cluster label). Deleting/disconnecting removes everything again.
    """

    def __init__(self, name: str, store: KVStore,
                 allocator: IdentityAllocator, ipcache,
                 selector_cache=None, services=None) -> None:
        self.name = name
        self.store = store
        self._allocator = allocator
        self._ipcache = ipcache
        self._selector_cache = selector_cache
        #: optional ServiceManager: remote GLOBAL services feed its
        #: clustermesh overlay (pkg/clustermesh services sync)
        self._services = services
        self._lock = threading.Lock()
        # remote key → (local prefix, local nid); nid refcounted so the
        # selector cache drops a remote identity when its last IP goes
        self._prefixes: Dict[str, tuple] = {}
        self._nid_refs: Dict[NumericIdentity, int] = {}
        #: remote service key → (namespace, name) for delete events
        self._service_keys: Dict[str, tuple] = {}
        self._watch: Optional[Watch] = None
        self._svc_watch: Optional[Watch] = None
        self.ready = False

    def connect(self) -> "RemoteCluster":
        self._watch = self.store.watch_prefix(IP_PREFIX, self._on_event,
                                              replay=True)
        if self._services is not None:
            self._svc_watch = self.store.watch_prefix(
                SERVICES_PREFIX, self._on_service_event, replay=True)
        self.ready = True
        METRICS.set_gauge(CLUSTERMESH_READY, 1.0,
                          labels={"cluster": self.name})
        return self

    def disconnect(self) -> None:
        if self._watch is not None:
            self._watch.stop()
            self._watch = None
        if self._svc_watch is not None:
            self._svc_watch.stop()
            self._svc_watch = None
        with self._lock:
            entries = list(self._prefixes.values())
            nids = list(self._nid_refs)
            self._prefixes.clear()
            self._nid_refs.clear()
            self._service_keys.clear()
        for prefix, _ in entries:
            self._ipcache.delete(prefix)
        for nid in nids:
            self._release_identity(nid)
        if self._services is not None:
            self._services.remove_remote_cluster(self.name)
        self.ready = False
        METRICS.set_gauge(CLUSTERMESH_READY, 0.0,
                          labels={"cluster": self.name})

    def _on_service_event(self, ev: Event) -> None:
        from cilium_tpu_torch.loadbalancer.service import Backend

        if ev.typ == EVENT_DELETE:
            with self._lock:
                ns_name = self._service_keys.pop(ev.key, None)
            if ns_name is not None:
                self._services.set_remote_backends(
                    self.name, ns_name[0], ns_name[1], [])
            return
        try:
            entry = json.loads(ev.value)
            namespace = entry["namespace"]
            name = entry["name"]
            backends = [Backend(ip=b["ip"], port=int(b["port"]),
                                weight=int(b.get("weight", 1)))
                        for b in entry.get("backends", ())]
        except (ValueError, KeyError, TypeError):
            METRICS.inc(CLUSTERMESH_DECODE_ERRORS,
                        labels={"cluster": self.name})
            return
        # accept only the watched cluster's own announcements: in a
        # shared-store topology another cluster's keys would otherwise
        # be double-ingested under the wrong cluster tag
        if entry.get("cluster") not in (None, self.name):
            return
        with self._lock:
            self._service_keys[ev.key] = (namespace, name)
        self._services.set_remote_backends(self.name, namespace, name,
                                           backends)

    def _release_identity(self, nid: NumericIdentity) -> None:
        from cilium_tpu_torch.core.identity import IDENTITY_USER_MIN

        # a remote cluster's host maps to the reserved REMOTE_NODE
        # identity (core.identity allocate) — reserved registrations
        # are process invariants this refcount must never tear down
        if nid < IDENTITY_USER_MIN:
            return
        if self._selector_cache is not None:
            self._selector_cache.remove_identity(nid)
        self._allocator.release(nid)

    def _drop_key(self, key: str) -> None:
        with self._lock:
            entry = self._prefixes.pop(key, None)
            last = False
            if entry is not None:
                _, nid = entry
                self._nid_refs[nid] -= 1
                if self._nid_refs[nid] == 0:
                    del self._nid_refs[nid]
                    last = True
        if entry is not None:
            self._ipcache.delete(entry[0])
            if last:
                self._release_identity(entry[1])

    def _on_event(self, ev: Event) -> None:
        faults.maybe_fail(SESSION_POINT)
        if ev.typ == EVENT_DELETE:
            self._drop_key(ev.key)
            return
        try:
            entry = json.loads(ev.value)
            prefix = entry["prefix"]
            labels = _decode_labels(entry.get("labels", []))
        except (ValueError, KeyError):
            METRICS.inc(CLUSTERMESH_DECODE_ERRORS,
                        labels={"cluster": self.name})
            return
        tagged = LabelSet(list(labels) + [
            Label(key=CLUSTER_LABEL_KEY, value=self.name,
                  source=SOURCE_K8S)])
        nid = self._allocator.allocate(tagged)
        with self._lock:
            prev = self._prefixes.get(ev.key)
            if prev == (prefix, nid):
                return  # unchanged re-announce
            old_last = False
            if prev is not None:  # remapped prefix or labels
                _, old_nid = prev
                self._nid_refs[old_nid] -= 1
                if self._nid_refs[old_nid] == 0:
                    del self._nid_refs[old_nid]
                    old_last = True
            self._prefixes[ev.key] = (prefix, nid)
            self._nid_refs[nid] = self._nid_refs.get(nid, 0) + 1
        if prev is not None and prev[0] != prefix:
            self._ipcache.delete(prev[0])
        if self._selector_cache is not None:
            self._selector_cache.add_identity(nid, tagged)
        self._ipcache.upsert(prefix, nid)
        # release AFTER the new mapping is live, and never when the key
        # kept the same identity (old_nid == nid keeps a refcount)
        if prev is not None and old_last and prev[1] != nid:
            self._release_identity(prev[1])

    def num_entries(self) -> int:
        with self._lock:
            return len(self._prefixes)


class ClusterMesh:
    """The set of connected remote clusters (``pkg/clustermesh``)."""

    def __init__(self, allocator: IdentityAllocator, ipcache,
                 selector_cache=None,
                 on_change: Optional[Callable[[], None]] = None,
                 services=None) -> None:
        self._allocator = allocator
        self._ipcache = ipcache
        self._selector_cache = selector_cache
        self._on_change = on_change
        self._services = services
        self._clusters: Dict[str, RemoteCluster] = {}

    def connect(self, name: str, store: KVStore) -> RemoteCluster:
        old = self._clusters.pop(name, None)
        if old is not None:
            # reconnect: tear down without firing on_change — one
            # recompile after the new connection is live suffices, and
            # it never sees the torn-down intermediate state
            old.disconnect()
        rc = RemoteCluster(name, store, self._allocator, self._ipcache,
                           self._selector_cache,
                           services=self._services).connect()
        self._clusters[name] = rc
        if self._on_change is not None:
            self._on_change()
        return rc

    def disconnect(self, name: str) -> None:
        rc = self._clusters.pop(name, None)
        if rc is not None:
            rc.disconnect()
            if self._on_change is not None:
                self._on_change()

    def close(self) -> None:
        """Disconnect everything WITHOUT firing on_change — shutdown
        teardown must not queue policy recompiles that get discarded."""
        for name in list(self._clusters):
            rc = self._clusters.pop(name)
            rc.disconnect()

    def status(self) -> Dict[str, Dict]:
        return {
            name: {"ready": rc.ready, "num-entries": rc.num_entries()}
            for name, rc in self._clusters.items()
        }

    def __len__(self) -> int:
        return len(self._clusters)
