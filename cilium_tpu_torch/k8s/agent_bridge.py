"""Agent↔apiserver bridge: the ``pkg/k8s`` watcher layer analog.

Reference (SURVEY §2.4 "K8s layer"): resource watchers feed
CiliumNetworkPolicy / CiliumClusterwideNetworkPolicy objects from the
apiserver into the policy repository (§3.2's CNP-applied path), while
the agent publishes CiliumEndpoint and CiliumNode objects describing
local state back to the apiserver (what ``kubectl get cep,cn`` shows).

Semantics carried over:

* CNP add/update is an **upsert by provenance labels** (delete the old
  CNP's rules, add the new — the same replace-on-update the directory
  watcher and the reference perform);
* a CNP that fails to parse leaves the previously-applied state intact
  (a bad object must not wipe enforcement);
* CEP status is re-synced periodically by a controller, so policy
  revision / identity drift converges without hooking every
  regeneration (the reference's CEP update controller).
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

from cilium_tpu_torch.k8s.apiserver import Conflict, K8sClient, NotFound
from cilium_tpu_torch.k8s.informer import Informer
from cilium_tpu_torch.policy.api.cnp import parse_cnp
from cilium_tpu_torch.runtime.logging import get_logger
from cilium_tpu_torch.runtime.metrics import METRICS

LOG = get_logger("k8s-bridge")

CNP_PLURAL = "ciliumnetworkpolicies"
CCNP_PLURAL = "ciliumclusterwidenetworkpolicies"
CEP_PLURAL = "ciliumendpoints"
NODE_PLURAL = "ciliumnodes"
CIDRGROUP_PLURAL = "ciliumcidrgroups"


def _provenance(obj: Dict) -> Tuple[str, ...]:
    """The repository provenance labels for a CNP/CCNP object — must
    match CiliumNetworkPolicy.labels so delete-by-provenance finds the
    rules the parsed object installed."""
    meta = obj.get("metadata", {})
    name = meta.get("name", "unnamed")
    namespace = meta.get("namespace", "default")
    kind = obj.get("kind", "CiliumNetworkPolicy")
    # kind-discriminating label: without it a CNP default/X and a CCNP
    # named X share provenance, so deleting one wipes the other's rules
    # (upstream: io.cilium.k8s.policy.derived-from)
    return (f"k8s:io.cilium.k8s.policy.derived-from={kind}",
            f"k8s:io.cilium.k8s.policy.name={name}",
            f"k8s:io.cilium.k8s.policy.namespace={namespace}")


class K8sWatcherBridge:
    """Wire an Agent to a fake-apiserver socket."""

    def __init__(self, agent, socket_path: str,
                 cep_sync_interval: float = 30.0):
        self.agent = agent
        self.client = K8sClient(socket_path)
        self.cep_sync_interval = cep_sync_interval
        self._informers = []
        self._lock = threading.Lock()

    # -- policy ingest ----------------------------------------------------
    def _upsert(self, obj: Dict) -> None:
        try:
            cnp = parse_cnp(obj)
        except Exception as e:  # noqa: BLE001 — bad object, keep state
            METRICS.inc("cilium_tpu_k8s_cnp_parse_errors_total")
            LOG.warning("unparseable CNP left previous state applied",
                        extra={"fields": {
                            "name": obj.get("metadata", {}).get("name"),
                            "error": str(e)}})
            return
        with self.agent.write_lock:
            self.agent.policy_delete(list(cnp.labels), wait=False)
            self.agent.policy_add(cnp, wait=False)
        LOG.info("applied CNP", extra={"fields": {
            "name": cnp.name, "namespace": cnp.namespace}})

    def _remove(self, obj: Dict) -> None:
        self.agent.policy_delete(list(_provenance(obj)), wait=False)
        LOG.info("deleted CNP", extra={"fields": {
            "name": obj.get("metadata", {}).get("name")}})

    # -- CIDR groups -------------------------------------------------------
    def _cidr_group_upsert(self, obj: Dict) -> None:
        """CiliumCIDRGroup (v2alpha1): update the agent's group
        registry and regenerate — referencing policies re-expand the
        group on the next resolve (the reference re-translates
        referencing CNPs on group events; our resolve-time expansion
        needs only the regeneration)."""
        name = obj.get("metadata", {}).get("name", "")
        cidrs = tuple(str(c) for c in
                      (obj.get("spec", {}).get("externalCIDRs") or ()))
        with self.agent.write_lock:
            self.agent.cidr_groups[name] = cidrs
        self.agent.endpoint_manager.regenerate_all(wait=False)
        LOG.info("applied CiliumCIDRGroup", extra={"fields": {
            "name": name, "cidrs": len(cidrs)}})

    def _cidr_group_remove(self, obj: Dict) -> None:
        name = obj.get("metadata", {}).get("name", "")
        with self.agent.write_lock:
            self.agent.cidr_groups.pop(name, None)
        self.agent.endpoint_manager.regenerate_all(wait=False)

    # -- status publication ----------------------------------------------
    def _cep_name(self, endpoint_id: int) -> str:
        # endpoint ids are node-local (the host endpoint is id 0 on
        # EVERY node): the node name keeps CEPs from colliding when
        # multiple agents publish to one apiserver (the reference names
        # CEPs after the pod, which is cluster-unique)
        return f"{self.agent.config.node_name}-ep-{endpoint_id}"

    def _endpoint_object(self, ep) -> Dict:
        ident_labels = sorted(ep.labels.format()) if ep.labels else []
        return {
            "apiVersion": "cilium.io/v2",
            "kind": "CiliumEndpoint",
            "metadata": {"name": self._cep_name(ep.endpoint_id),
                         "namespace": "default"},
            "status": {
                "id": ep.endpoint_id,
                "state": str(ep.state.value),
                "identity": {"id": int(ep.identity),
                             "labels": ident_labels},
                "networking": {
                    "addressing": [{"ipv4": ep.ipv4}],
                    "node": self.agent.config.node_name,
                },
                "policy": {"revision": int(ep.policy_revision)},
                "named-ports": [
                    {"name": n, "port": p}
                    for n, p in sorted(
                        (ep.named_ports or {}).items())],
            },
        }

    def publish_endpoint(self, ep) -> None:
        try:
            self.client.apply(CEP_PLURAL, self._endpoint_object(ep))
        except (OSError, RuntimeError, Conflict) as e:
            # best-effort status: the periodic sync converges it
            LOG.warning("CEP publish failed", extra={"fields": {
                "endpoint": ep.endpoint_id, "error": str(e)}})

    def withdraw_endpoint(self, endpoint_id: int) -> None:
        try:
            self.client.delete(CEP_PLURAL, self._cep_name(endpoint_id))
        except (NotFound, OSError, RuntimeError):
            pass

    def publish_node(self) -> None:
        cfg = self.agent.config
        pod_cidr = ""
        if self.agent.node_registration is not None:
            pod_cidr = self.agent.node_registration.pod_cidr() or ""
        try:
            self.client.apply(NODE_PLURAL, {
                "apiVersion": "cilium.io/v2",
                "kind": "CiliumNode",
                "metadata": {"name": cfg.node_name},
                "spec": {"ipam": {"podCIDRs":
                                  [pod_cidr] if pod_cidr else []}},
            })
        except (OSError, RuntimeError, Conflict) as e:
            # best-effort like publish_endpoint: two publishers (the
            # periodic sync controller vs an explicit sync) can race
            # apply's get→update and the loser gets a Conflict the
            # next tick converges — it must not escape the caller
            LOG.warning("CiliumNode publish failed",
                        extra={"fields": {"error": str(e)}})

    def sync_endpoint_status(self) -> None:
        """Periodic controller body: converge every local endpoint's
        CEP (and prune CEPs of endpoints that no longer exist here),
        plus the CiliumNode object — a podCIDR re-carve after start
        must not leave stale node state published forever."""
        self.publish_node()
        eps = self.agent.endpoint_manager.endpoints()
        mine = set()
        for ep in eps:
            mine.add(self._cep_name(ep.endpoint_id))
            self.publish_endpoint(ep)
        try:
            listing = self.client.list(CEP_PLURAL, "default")
        except (OSError, RuntimeError):
            return
        for obj in listing["items"]:
            name = obj["metadata"]["name"]
            node = obj.get("status", {}).get(
                "networking", {}).get("node")
            if node == self.agent.config.node_name and name not in mine:
                try:
                    self.client.delete(CEP_PLURAL, name)
                except (NotFound, OSError, RuntimeError):
                    pass

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "K8sWatcherBridge":
        # policy informers: the initial list applies synchronously, so
        # an agent is enforcing its CNPs before start() returns (the
        # reference blocks on WaitForCacheSync before going Ready)
        # CIDR groups FIRST: a CNP referencing a group must find it
        # registered when the policy informer's initial list applies
        self._informers.append(Informer(
            self.client, CIDRGROUP_PLURAL,
            on_add=self._cidr_group_upsert,
            on_update=lambda old, new: self._cidr_group_upsert(new),
            on_delete=self._cidr_group_remove).start())
        for plural in (CNP_PLURAL, CCNP_PLURAL):
            self._informers.append(Informer(
                self.client, plural,
                on_add=self._upsert,
                on_update=lambda old, new: self._upsert(new),
                on_delete=self._remove).start())
        self.publish_node()
        self.agent.controllers.update(
            "k8s-cep-sync", lambda: self.sync_endpoint_status(),
            interval=self.cep_sync_interval)
        return self

    def stop(self) -> None:
        for inf in self._informers:
            inf.stop()
        self._informers = []
