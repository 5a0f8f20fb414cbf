"""The agent: assembly of every subsystem (the reference's
``agent.py``, on the port's modules).

Reference: ``daemon/`` + ``pkg/hive`` — the agent is a
dependency-ordered assembly of cells. Ours wires, in dependency order:
identity allocator → selector cache → ipcache → policy repository →
FQDN (cache/NameManager/DNS proxy) → loader (feature-gated engine) →
endpoint manager → verdict service → controllers (DNS GC, checkpoint).
One object, explicit start/stop.

Where the port differs from the reference:

* ``device`` (default ``cuda``): the loader stages its engine and the
  DNS proxy scans there. Without CUDA the agent raises unless the
  caller passes ``device="cpu"`` (the plain versions, for tests); it
  never falls back to the CPU on its own. ``enable_tpu_offload`` off
  serves the CPU oracle, as in the reference, and on again serves the
  card;
* the cluster control plane (the ``crd`` identity allocation mode,
  ``k8s_api_socket``, the ``cluster-pool`` IPAM mode) runs on the
  port's control services: ``kvstore_service``, ``operator`` and
  ``k8s/``, which are host code and never touch the card;
* ``stop()`` also closes the loader's compile plane, so no thread the
  agent started outlives it.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

from cilium_tpu_torch.auth import AuthManager
from cilium_tpu_torch.clustermesh import ClusterMesh, LocalStatePublisher
from cilium_tpu_torch.core.config import Config
from cilium_tpu_torch.core.device import resolve_device
from cilium_tpu_torch.core.identity import IdentityAllocator, ReservedIdentity
from cilium_tpu_torch.kvstore import KVStore
from cilium_tpu_torch.core.labels import LabelSet
from cilium_tpu_torch.endpoint import EndpointManager
from cilium_tpu_torch.fqdn import DNSCache, DNSProxy, NameManager
from cilium_tpu_torch.health import HealthChecker
from cilium_tpu_torch.hubble import FlowMetrics, Observer, annotate_flows
from cilium_tpu_torch.ipam import NodeAllocator, PoolExhausted
from cilium_tpu_torch.ipcache import IPCache
from cilium_tpu_torch.loadbalancer import ServiceManager
from cilium_tpu_torch.monitor import AggregationLevel, MonitorAgent
from cilium_tpu_torch.policy.api import CiliumNetworkPolicy, load_cnp_yaml
from cilium_tpu_torch.policy.repository import Repository
from cilium_tpu_torch.policy.selectorcache import SelectorCache
from cilium_tpu_torch.runtime.controller import ControllerManager
from cilium_tpu_torch.runtime.loader import Loader
from cilium_tpu_torch.runtime.logging import get_logger, setup as setup_logging
from cilium_tpu_torch.runtime.metrics import METRICS
from cilium_tpu_torch.runtime.service import VerdictService

LOG = get_logger("daemon")


class Agent:
    def __init__(self, config: Optional[Config] = None,
                 state_dir: Optional[str] = None,
                 socket_path: Optional[str] = None,
                 api_socket_path: Optional[str] = None,
                 policy_dir: Optional[str] = None,
                 dns_proxy_bind: Optional[tuple] = None,
                 dns_upstream: tuple = ("127.0.0.53", 53),
                 dns_endpoint_of=None,
                 hubble_socket_path: Optional[str] = None,
                 accesslog_socket_path: Optional[str] = None,
                 monitor_socket_path: Optional[str] = None,
                 kvstore: Optional[KVStore] = None,
                 device=None):
        self.config = config or Config.from_env()
        #: where the loader stages its engine and the DNS proxy scans:
        #: ``cuda`` unless the caller names another (raises without
        #: CUDA — the agent never picks the CPU on its own)
        self.device = resolve_device(device)
        self.state_dir = state_dir
        # the flight recorder follows daemon config (the one knob set
        # per process, like the metrics registry): sampling/capacity
        # apply to every ingress this agent serves
        from cilium_tpu_torch.runtime.tracing import TRACER

        TRACER.configure(enabled=self.config.tracing.enabled,
                         sample_rate=self.config.tracing.sample_rate,
                         capacity=self.config.tracing.ring_capacity)
        # serializes compound mutations (endpoint/policy upserts) from
        # concurrent writers: REST API threads, watcher controller, CLI
        self.write_lock = threading.RLock()
        # the kvstore comes first: cluster-wide identity allocation and
        # cluster-pool IPAM both build on it
        self.kvstore = kvstore if kvstore is not None else KVStore()
        if self.config.identity_allocation_mode == "kvstore":
            from cilium_tpu_torch.identity_kvstore import (
                ClusterIdentityAllocator,
            )

            self.allocator = ClusterIdentityAllocator(self.kvstore)
        elif self.config.identity_allocation_mode == "crd":
            if not self.config.k8s_api_socket:
                raise ValueError(
                    "identity_allocation_mode=crd requires "
                    "k8s_api_socket (the CiliumIdentity store)")
            from cilium_tpu_torch.k8s.apiserver import K8sClient
            from cilium_tpu_torch.k8s.identity_crd import (
                CRDIdentityAllocator,
            )

            self.allocator = CRDIdentityAllocator(
                K8sClient(self.config.k8s_api_socket))
        else:
            self.allocator = IdentityAllocator()
        self.selector_cache = SelectorCache(self.allocator)
        self.ipcache = IPCache(self.allocator, self.selector_cache)
        self.repo = Repository()
        self.dns_cache = DNSCache()
        self.name_manager = NameManager(self.selector_cache, self.ipcache,
                                        self.dns_cache)
        self.dns_proxy = DNSProxy(self.name_manager,
                                  use_tpu=self.config.enable_tpu_offload,
                                  device=self.device)
        # k8s-Secret analog: secret-backed header-match values resolve
        # against this at compile (SecretStore docstring)
        from cilium_tpu_torch.secrets import SecretStore

        self.secrets = SecretStore()
        self.loader = Loader(self.config, secrets=self.secrets,
                             device=self.device)
        # services / kube-proxy replacement (§2.4): Maglev selection;
        # built before the endpoint manager so toServices policy rules
        # resolve against it (backend IPs → identities via the ipcache)
        self.services = ServiceManager()
        #: toGroups provider registry (reference pkg/policy/api/groups
        #: callbacks): name → fn(GroupsSpec) -> [cidr]; resolution
        #: happens at every regeneration so provider refreshes land via
        #: regenerate_all()
        self.group_providers = {}
        #: CiliumCIDRGroup registry (v2alpha1): name → member CIDRs;
        #: fed by the k8s bridge's ciliumcidrgroups informer (or
        #: set_cidr_group directly); resolved at every regeneration
        self.cidr_groups: Dict[str, Tuple[str, ...]] = {}
        # proxy-port allocation + redirect lifecycle (pkg/proxy role):
        # reconciled against every resolved snapshot at regeneration
        from cilium_tpu_torch.proxy_manager import ProxyManager

        self.proxy_manager = ProxyManager()
        self.endpoint_manager = EndpointManager(
            self.repo, self.selector_cache, self.allocator, self.loader,
            dns_proxy=self.dns_proxy, state_dir=state_dir,
            services=self.services,
            backend_identity=lambda ip: self.ipcache.lookup(ip),
            cluster_name=self.config.cluster_name,
            group_cidrs=self._resolve_group,
            cidr_group_cidrs=lambda name: self.cidr_groups.get(name, ()),
            proxy_manager=self.proxy_manager)
        # identity-churn regeneration debounce:
        # burst add/delete events from the cluster watch coalesce into
        # one regeneration per quiet window instead of one per event
        from cilium_tpu_torch.identity_kvstore import RegenDebouncer

        self._identity_debounce = RegenDebouncer(
            lambda: self.endpoint_manager.regenerate_all(),
            window_s=self.config.loader.identity_regen_debounce_s)
        # backend-set changes alter toServices resolution → regenerate,
        # but only when some rule actually uses toServices: routine
        # backend churn must not trigger full-policy recomputation in
        # clusters with no such rules
        self.services.on_change = self._on_service_change
        # clustermesh (§2.4): publish local state into our kvstore;
        # watch remote clusters' stores for their identities/IPs. A
        # caller-supplied store is how this agent shares state with an
        # Operator (cluster-pool IPAM) and other agents in-process.
        self.publisher = LocalStatePublisher(
            self.kvstore, self.config.cluster_name, self.allocator,
            self.ipcache, services=self.services)
        self.clustermesh = ClusterMesh(
            self.allocator, self.ipcache, self.selector_cache,
            on_change=lambda: self.endpoint_manager.regenerate_all(),
            services=self.services)
        # observability (§2.5): monitor event fan-out + hubble observer
        try:
            # `or`: a YAML null/"" means "use the dataclass default",
            # not AggregationLevel[str(None)] == NONE
            level = AggregationLevel[
                str(self.config.monitor_aggregation
                    or Config.monitor_aggregation).upper()]
        except KeyError:
            raise ValueError(
                f"monitor_aggregation "
                f"{self.config.monitor_aggregation!r} — expected one "
                f"of {[m.name.lower() for m in AggregationLevel]}"
            ) from None
        self.monitor = MonitorAgent(level=level)
        self.observer = Observer(handlers=[FlowMetrics()])
        # health probe mesh (§5.3); peers register via health.add_node
        # or kvstore discovery (HealthPeerWatcher at start())
        self.health = HealthChecker(node_name=self.config.node_name)
        self._hubble_ad = None
        self._health_ad = None
        self._health_watcher = None
        # IPAM (§2.4): endpoint IPs come from this node's podCIDR when
        # the caller doesn't pin one. In "cluster-pool" mode the CIDR
        # arrives from the operator at start(); until then the static
        # pod_cidr stands in so construction stays non-blocking.
        self.ipam = NodeAllocator(self.config.pod_cidr)
        self.node_registration = None
        # mutual-auth state: pairs that completed a handshake; entries
        # demanding auth DROP until their pair lands here (§2.1 AuthType)
        self.auth = AuthManager()
        self.controllers = ControllerManager()
        self.service: Optional[VerdictService] = None
        self.socket_path = socket_path
        # REST API (pkg/client-consumable; SURVEY.md §2.4) + the k8s
        # CNP-watcher analog (a policy directory watcher)
        self.api_server = None
        self.api_socket_path = api_socket_path
        self.policy_watcher = None
        self.policy_dir = policy_dir
        # pkg/k8s watcher-layer analog: CNP/CCNP informers feeding the
        # repo + CEP/CiliumNode status publication (config.k8s_api_socket)
        self.k8s_bridge = None
        # transparent DNS proxy UDP wire path (§3.5); endpoint resolved
        # from the client source address, as the reference's TPROXY does
        self.dns_server = None
        self.dns_proxy_bind = dns_proxy_bind
        self.dns_upstream = dns_upstream
        self.dns_endpoint_of = dns_endpoint_of  # client IP → endpoint id
        # hubble observer socket (GetFlows/ServerStatus analog)
        self.hubble_server = None
        self.hubble_socket_path = hubble_socket_path
        # proxy→agent L7 record channel (pkg/envoy accesslog server):
        # proxies write JSON records; parsed flows land in the observer
        self.accesslog_server = None
        self.accesslog_socket_path = accesslog_socket_path
        # monitor Unix socket (`cilium-dbg monitor` contract): second
        # processes stream PolicyVerdict/Drop/Trace events with
        # per-subscriber aggregation
        self.monitor_server = None
        self.monitor_socket_path = monitor_socket_path
        # FQDN updates retrigger regeneration (§3.2 tail)
        self.name_manager.on_update = (
            lambda sels: self.endpoint_manager.regenerate_all())

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "Agent":
        # the daemon owns process logging (reference: daemon_main
        # configures logrus); hosts that embed the agent and own their
        # process's logging opt out via configure_logging=False
        if self.config.configure_logging:
            setup_logging(self.config.log_level)
        if self.config.identity_allocation_mode in ("kvstore", "crd"):
            # remote allocations reach policy through the selector
            # cache (the reference's identity-cache events); start()
            # replays existing cluster identities before anything
            # resolves policy against them
            self.allocator.on_change = self._on_cluster_identity
            self.allocator.start()
        if self.config.ipam_mode == "cluster-pool":
            # register with the operator and adopt its assignment BEFORE
            # endpoint restore, so restored IPs re-adopt into the right
            # allocator (reference: agents block on IPAM readiness)
            from cilium_tpu_torch.operator import NodeRegistration

            self.node_registration = NodeRegistration(
                self.kvstore, self.config.node_name,
                on_cidr_change=self._on_pod_cidr_change)
            try:
                self.node_registration.wait_for_cidr(timeout=30.0)
            except TimeoutError:
                # don't leave a registered node (holding a reconcile
                # slot — it would be assigned a CIDR nobody consumes)
                # or live watches behind a failed start; a retry builds
                # fresh subscriptions instead of stacking them
                self.node_registration.deregister()
                self.node_registration = None
                if hasattr(self.allocator, "close"):
                    self.allocator.close()
                raise
            with self.write_lock:
                # fresh read, not the wait result: a re-carve landing
                # between the wait and this swap must not be reverted
                # (the watch event for it may have already fired)
                self.ipam = NodeAllocator(self.node_registration.pod_cidr())
            self.controllers.update(
                "node-registration", self.node_registration.heartbeat,
                interval=15.0)
        # tag kube-apiserver IPs with the reserved identity so the
        # `kube-apiserver` entity selects real traffic (flows from
        # these IPs resolve to ReservedIdentity.KUBE_APISERVER)
        import ipaddress as _ipaddress

        for ip in self.config.kube_apiserver_ips:
            if "/" not in ip:
                # family-aware host prefix: a bare IPv6 address must
                # become /128, not /32 (which would tag a 2^96 block)
                ip = f"{ip}/{_ipaddress.ip_address(ip).max_prefixlen}"
            self.ipcache.upsert(ip, int(ReservedIdentity.KUBE_APISERVER))
        restored = self.endpoint_manager.restore()
        if restored:
            METRICS.inc("cilium_tpu_endpoints_restored_total", restored)
            # re-adopt ip→identity mappings for restored endpoints (the
            # reference re-adopts the pinned ipcache BPF map on restart)
            for ep in self.endpoint_manager.endpoints():
                if ep.ipv4:
                    self.ipcache.upsert(f"{ep.ipv4}/32", ep.identity)
                    try:  # IPAM re-adopts restored addresses (§5.4)
                        self.ipam.allocate_ip(ep.ipv4)
                    except (ValueError, PoolExhausted):
                        # outside the re-carved node CIDR, or already
                        # taken: the ipam audit gauge surfaces it —
                        # restore must not abort over one address
                        pass
        if self.state_dir:
            dns_path = os.path.join(self.state_dir, "dnscache.json")
            if os.path.exists(dns_path):
                with open(dns_path) as f:
                    self.dns_cache = DNSCache.from_json(f.read())
                    self.name_manager.cache = self.dns_cache
        if self.config.loader.warm_restore and self.loader.revision == 0:
            # warm restart: rebuild the serving engine from the last
            # drain's snapshot BEFORE any server socket opens, so the
            # first request is answered verdict-identically with no
            # recompile (pinned-map restart discipline, SURVEY §5.3)
            if self.loader.restore_warm():
                LOG.info("warm state restored", extra={"fields": {
                    "revision": self.loader.revision}})
        if self.socket_path:
            self.service = VerdictService(self.loader, self.socket_path,
                                          agent=self)
            self.service.start()
        if self.api_socket_path:
            import json as _json

            from cilium_tpu_torch.health import PEERS_PREFIX, HealthPeerWatcher
            from cilium_tpu_torch.runtime.advertise import Advertisement
            from cilium_tpu_torch.runtime.api import APIServer

            self.api_server = APIServer(self, self.api_socket_path).start()
            # advertise the health endpoint and probe every other
            # advertised node (pkg/health's full probe mesh, §5.3)
            self._health_ad = Advertisement(
                self.kvstore, PEERS_PREFIX + self.config.node_name,
                _json.dumps({"socket": self.api_socket_path}))
            self.controllers.update("health-peer-heartbeat",
                                    self._health_ad.heartbeat,
                                    interval=15.0)
            self._health_watcher = HealthPeerWatcher(
                self.kvstore, self.health).start()
        if self.policy_dir:
            from cilium_tpu_torch.runtime.watcher import PolicyDirWatcher

            self.policy_watcher = PolicyDirWatcher(self, self.policy_dir)
            self.policy_watcher.register(self.controllers)
        if self.config.k8s_api_socket and self.k8s_bridge is None:
            # None-guard: a retried Agent.start() must not stack a
            # second set of informer threads (same rule as the
            # allocator watch above)
            from cilium_tpu_torch.k8s.agent_bridge import K8sWatcherBridge

            self.k8s_bridge = K8sWatcherBridge(
                self, self.config.k8s_api_socket).start()
        if self.hubble_socket_path:
            from cilium_tpu_torch.hubble.server import HubbleServer

            self.hubble_server = HubbleServer(
                self.observer, self.hubble_socket_path).start()
            # advertise this node's observer for relay discovery (the
            # Hubble Peer service analog), lease-backed so a dead
            # agent's entry ages out of the relay's peer set
            import json as _json

            from cilium_tpu_torch.hubble.relay import PeerDirectory
            from cilium_tpu_torch.runtime.advertise import Advertisement

            self._hubble_ad = Advertisement(
                self.kvstore,
                PeerDirectory.PREFIX + self.config.node_name,
                _json.dumps({"socket": self.hubble_socket_path}))
            self.controllers.update("hubble-peer-heartbeat",
                                    self._hubble_ad.heartbeat,
                                    interval=15.0)
        if self.accesslog_socket_path:
            from cilium_tpu_torch.hubble.accesslog_server import AccessLogServer

            self.accesslog_server = AccessLogServer(
                self.observer, self.accesslog_socket_path).start()
        if self.monitor_socket_path:
            from cilium_tpu_torch.monitor import MonitorServer

            self.monitor_server = MonitorServer(
                self.monitor, self.monitor_socket_path).start()
        if self.dns_proxy_bind is not None:
            from cilium_tpu_torch.fqdn.server import DNSProxyServer

            self.dns_server = DNSProxyServer(
                self.dns_proxy,
                self.dns_endpoint_of or self._endpoint_of_ip,
                upstream=self.dns_upstream,
                bind=self.dns_proxy_bind).start()
        self.controllers.update("dns-gc", self._dns_gc, interval=60.0)
        self.controllers.update("auth-gc", self.auth.expire, interval=60.0)
        self.controllers.update("clustermesh-heartbeat",
                                self.publisher.heartbeat, interval=15.0)
        self.controllers.update("health-probe", self.health.probe_all,
                                interval=60.0)
        if self.state_dir:
            self.controllers.update("checkpoint", self._checkpoint,
                                    interval=30.0)
        LOG.info("agent started", extra={"fields": {
            "backend": "tpu" if self.config.enable_tpu_offload
            else "oracle",
            "ipam_mode": self.config.ipam_mode,
            "pod_cidr": str(self.ipam.cidr),
            "endpoints_restored": restored,
        }})
        return self

    def drain(self) -> dict:
        """Graceful drain (SIGTERM / ``POST /v1/drain``): the verdict
        service stops admitting data-path work, flushes — not errors —
        pending batches, and snapshots warm-restart state. Control
        surfaces keep answering; ``stop()`` completes the shutdown."""
        if self.service is None:
            return {"ok": True, "flushed": 0, "warm_snapshot": False,
                    "revision": self.loader.revision}
        return self.service.drain()

    def stop(self) -> None:
        # close() skips the on_change regeneration hook — recompiling
        # policy for a shutdown teardown would be discarded work
        self.clustermesh.close()
        self.controllers.stop_all()
        if self.k8s_bridge is not None:
            self.k8s_bridge.stop()
        if self.node_registration is not None:
            # stop watching, but stay registered: the node keeps its
            # CIDR across an agent restart (the lease lapses only if we
            # stay down past the TTL — the reference's pinned-map
            # discipline, SURVEY.md §5.3/§5.4)
            self.node_registration.close()
        if hasattr(self.allocator, "close"):
            self.allocator.close()
        # after the watch is closed no new churn events arrive; a
        # pending debounced regeneration is discarded work on shutdown
        self._identity_debounce.close()
        if self._health_watcher is not None:
            self._health_watcher.stop()
        for ad in (self._hubble_ad, self._health_ad):
            if ad is not None:  # clean departure: peers drop us now
                ad.withdraw()  # instead of waiting out the lease
        if self.hubble_server is not None:
            self.hubble_server.stop()
        if self.accesslog_server is not None:
            self.accesslog_server.stop()
        if self.monitor_server is not None:
            self.monitor_server.stop()
        if self.dns_server is not None:
            self.dns_server.stop()
        if self.api_server is not None:
            self.api_server.stop()
        if self.service is not None:
            self.service.stop()
        if self.state_dir:
            self._checkpoint()
        self.endpoint_manager.shutdown()
        self.loader.close()
        LOG.info("agent stopped")

    def _dns_gc(self) -> None:
        self.name_manager.gc()

    def _on_service_change(self) -> None:
        if any(er.to_services for rule in self.repo.rules()
               for er in rule.egress):
            self.endpoint_manager.regenerate_all()

    def _on_cluster_identity(self, nid: int, labels) -> None:
        """A (possibly remote) cluster identity appeared or vanished in
        the kvstore: update selector resolution and regenerate, so
        policies selecting that identity's labels enforce on this node
        too (§3.2's incremental path for identity churn). The selector
        cache updates synchronously; the regeneration is DEBOUNCED —
        a churn storm of N events costs one selector pass per event
        but O(1) regenerations (identity_kvstore.RegenDebouncer)."""
        if labels is None:
            self.selector_cache.remove_identity(nid)
        else:
            self.selector_cache.add_identity(nid, labels)
        self._identity_debounce.note()

    def _checkpoint(self) -> None:
        self.endpoint_manager.checkpoint()
        if self.state_dir:
            os.makedirs(self.state_dir, exist_ok=True)
            tmp = os.path.join(self.state_dir, "dnscache.json.tmp")
            with open(tmp, "w") as f:
                f.write(self.dns_cache.to_json())
            os.replace(tmp, os.path.join(self.state_dir, "dnscache.json"))

    # -- policy API (PolicyAdd/PolicyDelete, §3.2) -----------------------
    def policy_add(self, cnp: CiliumNetworkPolicy, wait: bool = True) -> int:
        rev = self.repo.add(cnp.rules)
        self._register_fqdn_selectors(cnp)
        self.endpoint_manager.regenerate_all(wait=wait)
        return rev

    def policy_add_file(self, path: str, wait: bool = True) -> int:
        rev = 0
        for cnp in load_cnp_yaml(path):
            rev = self.policy_add(cnp, wait=False)
        self.endpoint_manager.regenerate_all(wait=wait)
        return rev

    def policy_delete(self, labels: List[str], wait: bool = True) -> int:
        n, rev = self.repo.delete_by_labels(labels)
        if n:
            self._gc_fqdn_selectors()
            self.endpoint_manager.regenerate_all(wait=wait)
        return n

    def _register_fqdn_selectors(self, cnp: CiliumNetworkPolicy) -> None:
        for rule in cnp.rules:
            for er in rule.egress:
                for fsel in er.to_fqdns:
                    self.name_manager.register_selector(fsel)

    def _gc_fqdn_selectors(self) -> None:
        """Unregister FQDN selectors no remaining rule references —
        otherwise deleted toFQDNs policies keep allocating CIDR
        identities and retriggering regeneration on every DNS answer."""
        active = {
            fsel
            for rule in self.repo.rules()
            for er in rule.egress
            for fsel in er.to_fqdns
        }
        for sel in self.name_manager.registered_selectors():
            if sel not in active:
                self.name_manager.unregister_selector(sel)

    def _on_pod_cidr_change(self, old: Optional[str],
                            new: Optional[str]) -> None:
        """The operator rewrote this node's assignment (re-carve after a
        pool reconfiguration, or reassignment after our lease lapsed).
        Rebuild the allocator on the new CIDR so fresh endpoint IPs come
        from a range we actually own; existing endpoints keep their
        addresses (pods can't be renumbered in place — the reference
        restarts them), counted so operators can see the skew. A delete
        (new=None) is left alone: the fresh assignment follows."""
        # write_lock: endpoint_add may be mid-allocation from the old
        # allocator on an API thread — swapping under it un-serialized
        # would hand out an address the new allocator never adopted
        with self.write_lock:
            if new is None or new == str(self.ipam.cidr):
                return
            alloc = NodeAllocator(new)
            stale = 0
            for ep in self.endpoint_manager.endpoints():
                if not ep.ipv4:
                    continue
                try:
                    alloc.allocate_ip(ep.ipv4)
                except Exception:
                    stale += 1
            self.ipam = alloc
            # unconditional: the gauge must drop back to 0 once the
            # skew clears, not report the last nonzero value forever
            METRICS.set_gauge("cilium_tpu_ipam_endpoints_outside_cidr",
                              float(stale))

    def _endpoint_of_ip(self, ip: str) -> Optional[int]:
        """Client source IP → endpoint id (DNS proxy's TPROXY role).
        Unknown sources get None → REFUSED; pass ``dns_endpoint_of`` to
        override the mapping (e.g. loopback harnesses)."""
        for ep in self.endpoint_manager.endpoints():
            if ep.ipv4 == ip:
                return ep.endpoint_id
        return None

    # -- endpoint API -----------------------------------------------------
    def endpoint_add(self, endpoint_id: int, labels: Dict[str, str],
                     ipv4: str = "", named_ports=None,
                     host: bool = False):
        # write_lock (reentrant — API handlers already hold it): the
        # allocate-then-register sequence is one step for concurrent
        # writers (REST threads, the watcher, CNI), and must not
        # interleave with a cluster-pool allocator swap
        # (_on_pod_cidr_change), which adopts only already-registered
        # endpoints' addresses
        with self.write_lock:
            ep = self._endpoint_add_locked(endpoint_id, labels, ipv4,
                                           named_ports=named_ports,
                                           host=host)
        if self.k8s_bridge is not None:  # outside the lock: socket IO
            self.k8s_bridge.publish_endpoint(ep)
        return ep

    def host_endpoint_add(self, labels: Dict[str, str],
                          ipv4: str = "", endpoint_id: int = 0):
        """Register THIS node's host endpoint: node labels +
        ``reserved:host`` → fixed identity 1, subject to CCNP
        nodeSelector policies only (reference: the host endpoint +
        host firewall)."""
        return self.endpoint_add(endpoint_id, labels, ipv4=ipv4,
                                 host=True)

    def _endpoint_add_locked(self, endpoint_id: int,
                             labels: Dict[str, str], ipv4: str = "",
                             named_ports=None, host: bool = False):
        old = self.endpoint_manager.get(endpoint_id)
        if old is not None and old.ipv4 and not ipv4:
            ipv4 = old.ipv4  # re-add (CNI ADD retry) keeps the IP
        if old is not None and named_ports is None:
            # same asymmetry guard as the IP: a re-add without
            # named_ports must not wipe the table (named toPorts rules
            # would silently resolve to nothing)
            named_ports = old.named_ports
        if old is not None and old.ipv4 and old.ipv4 == ipv4:
            pass  # unchanged — nothing to allocate or release
        else:
            # acquire the new address FIRST: if it is unavailable the
            # old pin must stay intact (no torn release-then-fail)
            if not ipv4:
                ipv4 = self.ipam.allocate()
            else:
                try:
                    self.ipam.allocate_ip(ipv4)
                except ValueError:
                    pass  # out-of-pool pin is fine; an in-pool duplicate
                          # (PoolExhausted) must raise, not silently share
            if old is not None and old.ipv4:
                self.ipcache.delete(f"{old.ipv4}/32")
                self.ipam.release(old.ipv4)
        label_set = LabelSet.from_dict(labels)
        if host:
            from cilium_tpu_torch.core.labels import SOURCE_RESERVED, Label

            label_set = LabelSet(
                list(label_set) + [Label(key="host", value="",
                                         source=SOURCE_RESERVED)])
        ep = self.endpoint_manager.add_endpoint(
            endpoint_id, label_set, ipv4=ipv4,
            named_ports=named_ports)
        self.ipcache.upsert(f"{ipv4}/32", ep.identity)
        return ep

    def register_group_provider(self, name: str, fn) -> None:
        """``fn(GroupsSpec) -> Iterable[str]`` (CIDRs). Registering
        re-resolves policies so existing toGroups rules pick it up."""
        self.group_providers[name] = fn
        self.endpoint_manager.regenerate_all(wait=True)

    def _resolve_group(self, spec):
        fn = self.group_providers.get(spec.provider)
        if fn is None:
            return ()
        try:
            return tuple(fn(spec))
        except Exception:
            LOG.warning("group provider %s failed; rule selects nothing",
                        spec.provider)
            return ()

    def secret_set(self, namespace: str, name: str, value: str) -> None:
        """Upsert a secret and re-resolve policies referencing it (the
        reference's secret-sync watcher triggers regeneration too)."""
        self.secrets.set(namespace, name, value)
        self.endpoint_manager.regenerate_all(wait=True)

    def secret_delete(self, namespace: str, name: str) -> None:
        self.secrets.delete(namespace, name)
        self.endpoint_manager.regenerate_all(wait=True)

    def endpoint_config(self, endpoint_id: int,
                        policy_audit_mode: Optional[bool] = None,
                        wait: bool = True):
        """Per-endpoint option surface (reference: ``cilium-dbg
        endpoint config <id> PolicyAuditMode=...``). Changing an
        option regenerates so the staged tables pick up the bit."""
        with self.write_lock:  # like every mutating entry point:
            # must not interleave with endpoint_remove / allocator swap
            ep = self.endpoint_manager.get(endpoint_id)
            if ep is None:
                raise KeyError(f"no endpoint {endpoint_id}")
            changed = False
            if policy_audit_mode is not None \
                    and ep.policy_audit_mode != policy_audit_mode:
                ep.policy_audit_mode = bool(policy_audit_mode)
                changed = True
        if changed:
            self.endpoint_manager.regenerate_all(wait=wait)
        return ep

    def endpoint_remove(self, endpoint_id: int) -> None:
        with self.write_lock:
            ep = self.endpoint_manager.get(endpoint_id)
            if ep is not None and ep.ipv4:
                self.ipcache.delete(f"{ep.ipv4}/32")
                self.ipam.release(ep.ipv4)
            self.endpoint_manager.remove_endpoint(endpoint_id)
        if self.k8s_bridge is not None:  # outside the lock: socket IO
            self.k8s_bridge.withdraw_endpoint(endpoint_id)

    # -- flow pipeline (engine → monitor → hubble, §3.6) -----------------
    def process_flows(self, flows: List) -> Dict:
        """Verdict a batch and fan it out to observability: monitor
        events (PolicyVerdict/Drop/Trace) and the hubble observer ring.
        Returns the output arrays as host numpy: the engine reads each
        lane back from the card once (``.cpu().numpy()``)."""
        import numpy as np


        engine = self.loader.engine
        if engine is None and self.endpoint_manager.endpoints():
            # endpoint_add queues its regeneration asynchronously; a
            # caller that verdicts immediately after adding endpoints
            # used to win that race only by scheduler luck — block on
            # the queued regeneration instead of failing on timing
            self.endpoint_manager.regenerate_all(wait=True)
            engine = self.loader.engine
        if engine is None:
            raise RuntimeError(
                "no policy staged — add an endpoint or policy first")
        # one device→host readback a lane, shared by monitor +
        # annotate (readbacks are the sync point)
        outputs = {
            k: np.asarray(v)
            for k, v in engine.verdict_flows(
                flows, authed_pairs=self.auth.pairs_array()).items()
        }
        self.fan_out(flows, outputs)
        return outputs

    def fan_out(self, flows: List, outputs: Dict) -> None:
        """Observability fan-out for one verdicted batch: monitor
        events (→ the monitor socket), verdict/match annotation
        (honest ``policy_match_type`` + provenance stamps when the
        engine outputs carry the attribution lane), and the hubble
        observer ring. The ONE place the sequence lives — the replay
        pipeline and the verdict service both call it."""
        self.monitor.notify_batch(flows, outputs)
        annotate_flows(flows, outputs,
                       amap=getattr(self.loader.engine, "attribution",
                                    None))
        self.observer.observe(flows)

    # -- introspection (cilium-dbg surface) ------------------------------
    def status(self) -> Dict:
        return {
            "revision": self.repo.revision,
            "rules": len(self.repo),
            "endpoints": len(self.endpoint_manager.endpoints()),
            "identities": len(self.allocator),
            "backend": ("tpu" if self.config.enable_tpu_offload
                        else "oracle"),
            "engine_revision": self.loader.revision,
            "controllers": self.controllers.status(),
            "clustermesh": self.clustermesh.status(),
            "health": {n: s.reachable
                       for n, s in self.health.status().items()},
            "ipam": {"mode": self.config.ipam_mode,
                     "node": self.config.node_name,
                     "cidr": str(self.ipam.cidr),
                     "available": self.ipam.available},
            "services": len(self.services.list()),
        }
