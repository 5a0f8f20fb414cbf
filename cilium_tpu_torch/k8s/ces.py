"""CiliumEndpointSlice batching (v2alpha1, operator role).

Reference: at scale, per-pod CiliumEndpoint objects make every agent's
CEP watch O(pods); the operator's CES controller
(``operator/pkg/ciliumendpointslice``) coalesces CEPs into
CiliumEndpointSlice objects of up to N endpoints, so watchers scale
with slices. Same split here: :class:`CESBatcher` runs wherever the
operator does, watches CEPs through an informer, and reconciles slice
objects on the fake apiserver (FCFS slice mode — first slice with
room wins; the reference's default identity mode is a packing
heuristic over the same invariants).

Invariants (pinned by tests/test_cidrgroup_ces.py's churn test):
* every live CEP appears in EXACTLY one slice;
* no slice exceeds ``max_per_slice``;
* a slice whose last endpoint left is deleted, not left empty.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from cilium_tpu_torch.k8s.apiserver import Conflict, K8sClient, NotFound
from cilium_tpu_torch.k8s.informer import Informer
from cilium_tpu_torch.runtime.logging import get_logger

LOG = get_logger("ces")

CEP_PLURAL = "ciliumendpoints"
CES_PLURAL = "ciliumendpointslices"


def _slim(cep: Dict) -> Dict:
    """CEP → CoreCiliumEndpoint (the slice member shape): the slim
    subset agents need — name + namespace (CEPs are namespaced; a
    slice mixes namespaces, so members must disambiguate), numeric
    id, identity, networking, named ports."""
    status = cep.get("status", {})
    meta = cep.get("metadata", {})
    return {
        "name": meta.get("name", ""),
        "namespace": meta.get("namespace", "default"),
        "id": status.get("id", 0),
        "identity": status.get("identity", {}),
        "networking": status.get("networking", {}),
        "named-ports": status.get("named-ports", []),
    }


def _cep_key(cep: Dict):
    meta = cep.get("metadata", {})
    return (meta.get("namespace", "default"), meta.get("name", ""))


class CESBatcher:
    """Reconciles CiliumEndpointSlices from CiliumEndpoint churn."""

    def __init__(self, client: K8sClient, max_per_slice: int = 100,
                 prefix: str = "ces"):
        self.client = client
        self.max_per_slice = max_per_slice
        self.prefix = prefix
        self._lock = threading.Lock()
        #: (namespace, name) → slice name — CEPs are NAMESPACED;
        #: keying by bare name would collide same-named pods across
        #: namespaces (second one silently evicts the first)
        self._placement: Dict[tuple, str] = {}
        #: slice name → {(namespace, name) → slim endpoint}
        self._slices: Dict[str, Dict[tuple, Dict]] = {}
        self._counter = 0
        self._informer: Optional[Informer] = None

    # -- reconciliation ----------------------------------------------------
    def _apply_slice(self, name: str) -> None:
        members = self._slices.get(name, {})
        if not members:
            self._slices.pop(name, None)
            try:
                self.client.delete(CES_PLURAL, name)
            except (NotFound, OSError, RuntimeError):
                pass
            return
        obj = {
            "apiVersion": "cilium.io/v2alpha1",
            "kind": "CiliumEndpointSlice",
            "metadata": {"name": name},
            "endpoints": [members[k] for k in sorted(members)],
        }
        try:
            self.client.apply(CES_PLURAL, obj)
        except (Conflict, OSError, RuntimeError) as e:
            LOG.warning("CES apply failed", extra={"fields": {
                "slice": name, "error": str(e)}})

    def _pick_slice(self) -> str:
        for name, members in self._slices.items():
            if len(members) < self.max_per_slice:
                return name
        self._counter += 1
        name = f"{self.prefix}-{self._counter}"
        self._slices[name] = {}
        return name

    def _on_cep(self, cep: Dict) -> None:
        key = _cep_key(cep)
        if not key[1]:
            return
        with self._lock:
            slice_name = self._placement.get(key)
            if slice_name is None:
                slice_name = self._pick_slice()
                self._placement[key] = slice_name
            self._slices[slice_name][key] = _slim(cep)
            self._apply_slice(slice_name)

    def _on_cep_delete(self, cep: Dict) -> None:
        with self._lock:
            slice_name = self._placement.pop(_cep_key(cep), None)
            if slice_name is None:
                return
            self._slices.get(slice_name, {}).pop(_cep_key(cep), None)
            self._apply_slice(slice_name)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "CESBatcher":
        self._informer = Informer(
            self.client, CEP_PLURAL,
            on_add=self._on_cep,
            on_update=lambda old, new: self._on_cep(new),
            on_delete=self._on_cep_delete).start()
        return self

    def stop(self) -> None:
        if self._informer is not None:
            self._informer.stop()
            self._informer = None
