"""Services and backends: the kube-proxy-replacement model
(counterpart of the reference's ``loadbalancer/service.py``).

Reference: ``pkg/service`` + ``pkg/loadbalancer`` (SURVEY.md §2.4) —
frontends (VIP:port/proto) map to weighted backend sets with a service
type (ClusterIP/NodePort/LoadBalancer), optional ClientIP session
affinity, and consistent (Maglev) backend selection mirrored into the
BPF lbmap. Ours keeps the same model host-side; the datapath mirror is
``pack()`` → numpy arrays, staged by ``weights.lb_arrays_from_reference``
for the batched lookup (``loadbalancer.kernel.lb_lookup``).
"""

from __future__ import annotations

import dataclasses
import ipaddress
import threading
from enum import IntEnum
from typing import Dict, List, Optional, Tuple

import numpy as np

from cilium_tpu_torch.loadbalancer.maglev import (
    DEFAULT_TABLE_SIZE, fnv1a_words, maglev_table,
)
from cilium_tpu_torch.runtime.metrics import METRICS


class ServiceType(IntEnum):
    CLUSTER_IP = 0
    NODE_PORT = 1
    LOAD_BALANCER = 2


class BackendState(IntEnum):
    """Reference: ``lb.BackendState`` — terminating/quarantined backends
    stay registered but leave the selection table."""

    ACTIVE = 0
    TERMINATING = 1
    QUARANTINED = 2


@dataclasses.dataclass(frozen=True)
class Backend:
    ip: str
    port: int
    weight: int = 1
    state: BackendState = BackendState.ACTIVE

    @property
    def name(self) -> str:
        return f"{self.ip}:{self.port}"


@dataclasses.dataclass(frozen=True)
class Frontend:
    ip: str
    port: int
    proto: int = 6  # TCP

    @property
    def name(self) -> str:
        return f"{self.ip}:{self.port}/{self.proto}"


@dataclasses.dataclass
class Service:
    frontend: Frontend
    backends: List[Backend]
    svc_type: ServiceType = ServiceType.CLUSTER_IP
    #: ClientIP session affinity: selection hashes the source IP only,
    #: so one client sticks to one backend across connections.
    affinity: bool = False
    #: k8s object metadata — what policy `toServices` selects on
    name: str = ""
    namespace: str = "default"
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: global service (reference: ``service.cilium.io/global`` — the
    #: clustermesh-shared annotation): backends announced by remote
    #: clusters for the same (namespace, name) merge into this
    #: service's selection table, and the local publisher exports it
    shared: bool = False

    def active_backends(self) -> List[Backend]:
        """LOCAL active backends only — the merged (clustermesh) view
        lives on :meth:`ServiceManager.active_backends`."""
        return [b for b in self.backends if b.state == BackendState.ACTIVE]


def _ip_u32(ip: str) -> int:
    return int(ipaddress.IPv4Address(ip))


@dataclasses.dataclass
class PackedLB:
    """Host-side tensors for the batched kernel (loader stages them).

    Services sorted by (frontend ip, proto<<16|port) for binary search;
    ``tables`` stacks every service's Maglev table; ``backend_*`` are
    indexed by the global backend ids the tables store.
    """

    svc_ip: np.ndarray        # [S] uint32 frontend IPv4
    svc_l4: np.ndarray        # [S] uint32 (proto << 16) | port
    svc_affinity: np.ndarray  # [S] bool
    tables: np.ndarray        # [S, M] int32 global backend id, -1 empty
    backend_ip: np.ndarray    # [G] uint32 backend IPv4
    backend_port: np.ndarray  # [G] int32
    revision: int = 0

    @property
    def n_services(self) -> int:
        return len(self.svc_ip)


class ServiceManager:
    """Service table with Maglev selection (``pkg/service ·Service``).

    Thread-safe. ``pack()`` snapshots the whole table into tensors; the
    scalar ``select()`` is the oracle the kernel is differentially
    tested against (same FNV-1a word hash, same tables).
    """

    def __init__(self, table_size: int = DEFAULT_TABLE_SIZE) -> None:
        self._lock = threading.Lock()
        self._services: Dict[Frontend, Service] = {}
        self._tables: Dict[Frontend, np.ndarray] = {}
        #: clustermesh global-service overlay: (namespace, name) →
        #: cluster → remote backends (reference: pkg/clustermesh
        #: services sync feeding pkg/service)
        self._remote: Dict[Tuple[str, str], Dict[str, List[Backend]]] = {}
        #: per-frontend backend-state generation: lets table builds run
        #: OUTSIDE the lock and detect a concurrent change before swap
        self._gen: Dict[Frontend, int] = {}
        self._revision = 0
        self.table_size = table_size
        #: fired after every mutation commit — policy `toServices`
        #: resolution depends on the backend set, so the agent points
        #: this at endpoint regeneration (the reference's k8s service
        #: watcher likewise retriggers policy recomputation)
        self.on_change = None

    def _changed(self) -> None:
        if self.on_change is not None:
            self.on_change()

    # -- clustermesh merge ------------------------------------------------
    def _merged_active_locked(self, svc: Service) -> List[Backend]:
        """Active backends incl. the remote overlay for shared
        services; deterministic order (local, then clusters sorted)."""
        out = svc.active_backends()
        if svc.shared:
            per_cluster = self._remote.get((svc.namespace, svc.name), {})
            for cluster in sorted(per_cluster):
                out.extend(b for b in per_cluster[cluster]
                           if b.state == BackendState.ACTIVE)
        return out

    def active_backends(self, svc: Service) -> List[Backend]:
        """The selection view of a service's backends (merged across
        clusters for shared services) — what ``toServices`` resolution
        and the LB tables see."""
        with self._lock:
            return self._merged_active_locked(svc)

    def _build_table(self, active: List[Backend]) -> np.ndarray:
        """Pure maglev permutation — call OUTSIDE the lock (the
        table-size loop is the expensive part; holding the lock
        through it would stall concurrent select() datapath calls)."""
        return maglev_table(
            list(range(len(active))),
            [b.name for b in active],
            m=self.table_size,
            weights=[b.weight for b in active],
        )

    def _rebuild(self, fe: Frontend) -> None:
        """Build + swap one frontend's table with the maglev loop
        OUTSIDE the lock; retries if backend state moved underneath."""
        while True:
            with self._lock:
                svc = self._services.get(fe)
                if svc is None:
                    return
                gen = self._gen.get(fe, 0)
                active = self._merged_active_locked(svc)
            table = self._build_table(active)
            with self._lock:
                if fe not in self._services:
                    return
                if self._gen.get(fe, 0) == gen:
                    self._tables[fe] = table
                    return
            # a concurrent mutation bumped the generation: loop with a
            # fresh snapshot so the stale table never lands

    def set_remote_backends(self, cluster: str, namespace: str,
                            name: str, backends: List[Backend]) -> None:
        """Clustermesh ingest: replace ``cluster``'s announced backends
        for global service (namespace, name); selection tables of a
        matching local SHARED service rebuild immediately."""
        with self._lock:
            per = self._remote.setdefault((namespace, name), {})
            if per.get(cluster, []) == list(backends):
                if not per:
                    del self._remote[(namespace, name)]
                return  # unchanged re-announce: no rebuild, no regen
            if backends:
                per[cluster] = list(backends)
            else:
                per.pop(cluster, None)
                if not per:
                    del self._remote[(namespace, name)]
            stale = []
            for svc in self._services.values():
                if (svc.shared and svc.namespace == namespace
                        and svc.name == name):
                    self._gen[svc.frontend] = \
                        self._gen.get(svc.frontend, 0) + 1
                    stale.append(svc.frontend)
            if stale:
                self._revision += 1
        for fe in stale:
            self._rebuild(fe)
        if stale:
            self._changed()

    def remove_remote_cluster(self, cluster: str) -> None:
        """Drop every backend ``cluster`` announced (disconnect)."""
        with self._lock:
            stale = []
            for (namespace, name) in list(self._remote):
                per = self._remote[(namespace, name)]
                if cluster not in per:
                    continue
                del per[cluster]
                if not per:
                    del self._remote[(namespace, name)]
                for svc in self._services.values():
                    if (svc.shared and svc.namespace == namespace
                            and svc.name == name):
                        self._gen[svc.frontend] = \
                            self._gen.get(svc.frontend, 0) + 1
                        stale.append(svc.frontend)
            if stale:
                self._revision += 1
        for fe in stale:
            self._rebuild(fe)
        if stale:
            self._changed()

    # -- mutation ---------------------------------------------------------
    def upsert(self, svc: Service) -> None:
        with self._lock:
            self._services[svc.frontend] = svc
            self._gen[svc.frontend] = self._gen.get(svc.frontend, 0) + 1
            self._revision += 1
        self._rebuild(svc.frontend)
        METRICS.set_gauge("cilium_tpu_lb_services", float(len(self._services)))
        self._changed()

    def delete(self, frontend: Frontend) -> bool:
        with self._lock:
            existed = self._services.pop(frontend, None) is not None
            self._tables.pop(frontend, None)
            self._gen.pop(frontend, None)
            if existed:
                self._revision += 1
        METRICS.set_gauge("cilium_tpu_lb_services", float(len(self._services)))
        if existed:
            self._changed()
        return existed

    def get(self, frontend: Frontend) -> Optional[Service]:
        with self._lock:
            return self._services.get(frontend)

    def list(self) -> List[Service]:
        with self._lock:
            return list(self._services.values())

    @property
    def revision(self) -> int:
        with self._lock:
            return self._revision

    # -- selection (scalar oracle) ----------------------------------------
    def select(self, src_ip: str, src_port: int, dst_ip: str,
               dst_port: int, proto: int = 6) -> Optional[Backend]:
        """Pick the backend for one flow; None if no service matches."""
        fe = Frontend(dst_ip, dst_port, proto)
        with self._lock:
            svc = self._services.get(fe)
            table = self._tables.get(fe)
            active = (self._merged_active_locked(svc)
                      if svc is not None else [])
        if svc is None or table is None:
            return None
        if not active:
            return None
        words = self._hash_words(
            _ip_u32(src_ip), src_port, _ip_u32(dst_ip), dst_port, proto,
            affinity=svc.affinity)
        h = int(fnv1a_words(np.asarray(words, dtype=np.uint32)))
        bi = int(table[h % len(table)])
        # bi < 0: empty table (all backends weight 0). bi >= len: the
        # table is being rebuilt outside the lock and this select won
        # the race against the swap — treat as a miss, never index OOB
        if bi < 0 or bi >= len(active):
            return None
        return active[bi]

    @staticmethod
    def _hash_words(src_ip: int, src_port: int, dst_ip: int,
                    dst_port: int, proto: int,
                    affinity: bool) -> Tuple[int, ...]:
        if affinity:  # ClientIP affinity: source address only
            return (src_ip, 0, 0, 0, 0)
        return (src_ip, src_port, dst_ip, dst_port, proto)

    # -- datapath mirror ---------------------------------------------------
    def pack(self) -> PackedLB:
        with self._lock:
            items = sorted(
                self._services.items(),
                key=lambda kv: (_ip_u32(kv[0].ip),
                                (kv[0].proto << 16) | kv[0].port))
            tables = {fe: t for fe, t in self._tables.items()}
            merged = {fe: self._merged_active_locked(svc)
                      for fe, svc in items}
            revision = self._revision
        backend_ip: List[int] = []
        backend_port: List[int] = []
        svc_rows = []
        slab = []
        for fe, svc in items:
            active = merged[fe]
            base = len(backend_ip)
            backend_ip.extend(_ip_u32(b.ip) for b in active)
            backend_port.extend(b.port for b in active)
            t = tables[fe]
            slab.append(np.where(t >= 0, t + base, -1).astype(np.int32))
            svc_rows.append((_ip_u32(fe.ip), (fe.proto << 16) | fe.port,
                             svc.affinity))
        if not svc_rows:
            # sentinel that can never match: l4 word 0xFFFFFFFF is
            # unreachable (real probes have proto<<16|port < 2**24)
            svc_rows.append((0xFFFFFFFF, 0xFFFFFFFF, False))
            slab.append(np.full(self.table_size, -1, dtype=np.int32))
        if not backend_ip:
            backend_ip.append(0)
            backend_port.append(0)
        return PackedLB(
            svc_ip=np.array([r[0] for r in svc_rows], dtype=np.uint32),
            svc_l4=np.array([r[1] for r in svc_rows], dtype=np.uint32),
            svc_affinity=np.array([r[2] for r in svc_rows], dtype=bool),
            tables=np.stack(slab),
            backend_ip=np.array(backend_ip, dtype=np.uint32),
            backend_port=np.array(backend_port, dtype=np.int32),
            revision=revision,
        )
