"""Endpoints and the endpoint manager (regeneration state machine).

Reference: ``pkg/endpoint`` + ``pkg/endpointmanager`` (SURVEY.md §2.4,
§3.2): endpoints own labels→identity, move through a regeneration state
machine (``waiting-to-regenerate → regenerating → ready``) when policy
inputs change, persist state JSON for restart restore
(``pkg/endpoint/restore.go``), and a parallel regeneration queue
recomputes EndpointPolicy and pushes it to the datapath.

Ours collapses "write per-endpoint BPF policy maps" into one loader
snapshot regeneration (valid because verdict state is keyed by identity
— the same dedup the reference's ``distillery.go`` performs), plus
per-endpoint DNS-proxy allow-set updates.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Set

from cilium_tpu_torch.core.identity import IdentityAllocator, NumericIdentity
from cilium_tpu_torch.core.labels import Label, LabelSet, SOURCE_K8S, SOURCE_RESERVED
from cilium_tpu_torch.policy.api.rule import CLUSTER_LABEL_KEY


def with_cluster_label(labels: LabelSet, cluster_name: str) -> LabelSet:
    """Inject ``k8s:io.cilium.k8s.policy.cluster=<name>`` into a
    workload endpoint's labels (reference: every k8s endpoint identity
    carries it) — this is what the ``cluster`` entity selects, so it
    matches in-cluster workloads WITHOUT matching ``reserved:world``.
    Reserved-identity label sets (host/health/…) are left untouched:
    adding a k8s label would re-allocate them as user identities."""
    if labels.get(CLUSTER_LABEL_KEY) is not None or any(
            l.source in (SOURCE_RESERVED, "cidr") for l in labels):
        # reserved AND cidr label sets stay untouched: stamping a CIDR
        # peer as an in-cluster workload would make it match `cluster`
        # entity rules (policy trace passes such sets through here)
        return labels
    return LabelSet(list(labels) + [
        Label(key=CLUSTER_LABEL_KEY, value=cluster_name,
              source=SOURCE_K8S)])
from cilium_tpu_torch.core.flow import TrafficDirection
from cilium_tpu_torch.policy.mapstate import PolicyResolver
from cilium_tpu_torch.policy.repository import Repository
from cilium_tpu_torch.policy.selectorcache import SelectorCache
from cilium_tpu_torch.runtime.loader import Loader
from cilium_tpu_torch.runtime.metrics import METRICS, SpanStat


class EndpointState(str, enum.Enum):
    RESTORING = "restoring"
    WAITING_TO_REGENERATE = "waiting-to-regenerate"
    REGENERATING = "regenerating"
    READY = "ready"
    DISCONNECTED = "disconnected"


@dataclasses.dataclass
class Endpoint:
    endpoint_id: int
    labels: LabelSet
    identity: NumericIdentity = 0
    state: EndpointState = EndpointState.WAITING_TO_REGENERATE
    policy_revision: int = 0
    ipv4: str = ""
    #: container port names (k8s pod spec ports[].name analog): what
    #: NAMED toPorts entries resolve against at regeneration
    #: (reference: pkg/policy/l4.go named-port resolution)
    named_ports: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: per-endpoint PolicyAuditMode (reference endpoint option): this
    #: endpoint's would-be denials verdict AUDIT while the rest of the
    #: fleet enforces — the policy-rollout use-case
    policy_audit_mode: bool = False

    def to_json(self) -> Dict:
        return {
            "id": self.endpoint_id,
            "labels": list(self.labels.format()),
            "identity": self.identity,
            "policy_revision": self.policy_revision,
            "ipv4": self.ipv4,
            "named_ports": dict(self.named_ports),
            "policy_audit_mode": self.policy_audit_mode,
        }

    @classmethod
    def from_json(cls, d: Dict) -> "Endpoint":
        return cls(
            endpoint_id=int(d["id"]),
            labels=LabelSet.parse(d.get("labels", ())),
            identity=int(d.get("identity", 0)),
            policy_revision=int(d.get("policy_revision", 0)),
            ipv4=d.get("ipv4", ""),
            named_ports={str(k): int(v) for k, v in
                         (d.get("named_ports") or {}).items()},
            policy_audit_mode=bool(d.get("policy_audit_mode", False)),
            state=EndpointState.RESTORING,
        )


class EndpointManager:
    """Endpoint lifecycle + regeneration queue."""

    def __init__(self, repo: Repository, selector_cache: SelectorCache,
                 allocator: IdentityAllocator, loader: Loader,
                 dns_proxy=None, state_dir: Optional[str] = None,
                 regen_workers: int = 4,
                 services=None, backend_identity=None,
                 cluster_name: str = "default", group_cidrs=None,
                 cidr_group_cidrs=None, proxy_manager=None):
        self.repo = repo
        self.cache = selector_cache
        self.allocator = allocator
        self.loader = loader
        self.dns_proxy = dns_proxy
        self.state_dir = state_dir
        # `toServices` resolution context (ServiceManager + ip→identity
        # hook), threaded into every PolicyResolver this manager builds
        self.services = services
        self.backend_identity = backend_identity
        self.cluster_name = cluster_name
        self.group_cidrs = group_cidrs
        self.cidr_group_cidrs = cidr_group_cidrs
        #: optional ProxyManager: redirect lifecycle reconciles against
        #: every resolved snapshot (pkg/proxy during regeneration)
        self.proxy_manager = proxy_manager
        self._lock = threading.RLock()
        self._endpoints: Dict[int, Endpoint] = {}
        self._pool = ThreadPoolExecutor(max_workers=regen_workers,
                                        thread_name_prefix="regen")
        self._regen_lock = threading.Lock()
        # coalescing: queued regenerations for generations already
        # covered by a newer completed run return immediately
        self._gen_target = 0
        self._gen_done = 0
        # (endpoint_id → ports with DNS allow-sets installed) so revoked
        # rules are actively cleared from the proxy
        self._dns_ports: Dict[int, Set[int]] = {}
        # identity churn retriggers regeneration (SelectorCache → O(Δ))
        selector_cache.subscribe(self._on_selection_change)
        self._dirty = threading.Event()

    # -- lifecycle --------------------------------------------------------
    def add_endpoint(self, endpoint_id: int, labels: LabelSet,
                     ipv4: str = "", named_ports=None) -> Endpoint:
        labels = with_cluster_label(labels, self.cluster_name)
        ep = Endpoint(endpoint_id=endpoint_id, labels=labels, ipv4=ipv4,
                      named_ports=dict(named_ports or {}))
        ep.identity = self.allocator.allocate(labels)
        self.cache.add_identity(ep.identity, labels)
        with self._lock:
            self._endpoints[endpoint_id] = ep
        METRICS.set_gauge("cilium_tpu_endpoints", len(self._endpoints))
        self.regenerate_all()
        return ep

    def remove_endpoint(self, endpoint_id: int) -> None:
        with self._lock:
            ep = self._endpoints.pop(endpoint_id, None)
            still_used = ep is not None and any(
                e.identity == ep.identity
                for e in self._endpoints.values())
            dns_ports = self._dns_ports.pop(endpoint_id, set())
        if ep is None:
            return
        ep.state = EndpointState.DISCONNECTED
        if self.dns_proxy is not None:
            for port in dns_ports:
                self.dns_proxy.update_allowed(endpoint_id, port, [])
        if not still_used:
            self.cache.remove_identity(ep.identity)
        METRICS.set_gauge("cilium_tpu_endpoints", len(self._endpoints))
        self.regenerate_all()

    def update_named_ports(self, endpoint_id: int,
                           named_ports: Dict[str, int]) -> None:
        """Rename/remap an endpoint's container ports (k8s pod update):
        policies with named toPorts re-resolve on the next
        regeneration, which this triggers."""
        with self._lock:
            ep = self._endpoints.get(endpoint_id)
            if ep is None:
                return
            ep.named_ports = {str(k): int(v)
                              for k, v in named_ports.items()}
        self.regenerate_all(wait=True)

    def get(self, endpoint_id: int) -> Optional[Endpoint]:
        with self._lock:
            return self._endpoints.get(endpoint_id)

    def endpoints(self) -> List[Endpoint]:
        with self._lock:
            return list(self._endpoints.values())

    # -- regeneration -----------------------------------------------------
    def _on_selection_change(self, sel, added, deleted) -> None:
        self._dirty.set()
        self.regenerate_all()

    def regenerate_all(self, wait: bool = False):
        """Queue a full regeneration; queued triggers coalesce — a run
        that starts after my trigger covers it (the reference queues
        per-endpoint; our snapshot covers all endpoints at once)."""
        with self._lock:
            self._gen_target += 1
            my_gen = self._gen_target
        fut = self._pool.submit(self._regenerate, my_gen)
        if wait:
            fut.result()
        return fut

    def _regenerate(self, my_gen: int = 0) -> None:
        with self._regen_lock:
            if self._gen_done >= my_gen:
                return  # a newer run already covered this trigger
            with self._lock:
                target_gen = self._gen_target
            revision = self.repo.revision
            with self._lock:
                eps = list(self._endpoints.values())
                for ep in eps:
                    ep.state = EndpointState.REGENERATING
            with SpanStat("endpoint_regeneration"):
                # identity → merged named-port table (endpoints sharing
                # an identity share a pod template upstream; first
                # writer wins on a name conflict)
                np_of: Dict[int, Dict[str, int]] = {}
                for ep in eps:
                    table = np_of.setdefault(ep.identity, {})
                    for k, v in ep.named_ports.items():
                        table.setdefault(k, v)
                resolver = PolicyResolver(
                    self.repo, self.cache, services=self.services,
                    backend_identity=self.backend_identity,
                    cluster_name=self.cluster_name,
                    named_ports_of=lambda nid: np_of.get(nid, {}))
                resolver.group_cidrs = self.group_cidrs
                resolver.cidr_group_cidrs = self.cidr_group_cidrs
                per_identity = {}
                resolved = {}
                for ep in eps:
                    if ep.identity not in resolved:
                        resolved[ep.identity] = resolver.resolve(
                            ep.labels,
                            named_ports=np_of.get(ep.identity, {}))
                    per_identity[ep.identity] = resolved[ep.identity]
                    # per-endpoint PolicyAuditMode: our policy unit is
                    # the identity (endpoints sharing one share a
                    # MapState, like the reference's distillery), so
                    # any audit-mode endpoint audits its identity
                    if ep.policy_audit_mode:
                        per_identity[ep.identity].audit = True
                self.loader.regenerate(per_identity, revision=revision)
                if self.proxy_manager is not None:
                    self.proxy_manager.reconcile(per_identity)
                self._update_dns_proxy(eps, resolved)
            with self._lock:
                for ep in eps:
                    ep.state = EndpointState.READY
                    ep.policy_revision = revision
            self._gen_done = target_gen
            METRICS.inc("cilium_tpu_endpoint_regenerations_total",
                        len(eps))
            if self.state_dir:
                self.checkpoint()

    def _update_dns_proxy(self, eps, resolved) -> None:
        if self.dns_proxy is None:
            return
        for ep in eps:
            ms = resolved[ep.identity]
            by_port: Dict[int, list] = {}
            for key, entry in ms.entries.items():
                if key.direction != int(TrafficDirection.EGRESS):
                    continue
                for lr in entry.l7_rules:
                    for dr in lr.dns:
                        by_port.setdefault(key.dport, []).append(dr)
            with self._lock:
                stale = self._dns_ports.get(ep.endpoint_id, set()) - set(by_port)
                self._dns_ports[ep.endpoint_id] = set(by_port)
            for port in stale:  # revoked rules must actively clear
                self.dns_proxy.update_allowed(ep.endpoint_id, port, [])
            for port, rules in by_port.items():
                self.dns_proxy.update_allowed(ep.endpoint_id, port, rules)

    # -- checkpoint/restore (pkg/endpoint/restore.go analog) -------------
    def checkpoint(self) -> None:
        if not self.state_dir:
            return
        os.makedirs(self.state_dir, exist_ok=True)
        with self._lock:
            eps = [ep.to_json() for ep in self._endpoints.values()]
            # unique tmp per writer + replace under the lock: the
            # periodic checkpoint controller and an agent stop() may
            # checkpoint concurrently
            tmp = os.path.join(
                self.state_dir,
                f".endpoints.json.{os.getpid()}.{threading.get_ident()}.tmp")
            with open(tmp, "w") as f:
                json.dump(eps, f)
            os.replace(tmp, os.path.join(self.state_dir, "endpoints.json"))

    def restore(self) -> int:
        """Re-adopt persisted endpoints on start; returns count."""
        if not self.state_dir:
            return 0
        path = os.path.join(self.state_dir, "endpoints.json")
        if not os.path.exists(path):
            return 0
        with open(path) as f:
            eps = json.load(f)
        n = 0
        for d in eps:
            ep = Endpoint.from_json(d)
            # older checkpoints predate the cluster label — normalize so
            # restored endpoints land on the same identity a fresh add
            # would get
            ep.labels = with_cluster_label(ep.labels, self.cluster_name)
            ep.identity = self.allocator.allocate(ep.labels)
            self.cache.add_identity(ep.identity, ep.labels)
            with self._lock:
                self._endpoints[ep.endpoint_id] = ep
            n += 1
        if n:
            self.regenerate_all()
        return n

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)
