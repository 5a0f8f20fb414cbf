"""CRD-mode identity allocation: CiliumIdentity objects as the store.

Reference: ``pkg/allocator`` CRD backend + ``pkg/k8s`` CiliumIdentity
machinery (SURVEY §2.1 "label-set → identity allocation via kvstore or
CiliumIdentity CRD", §2.4 CRD row). Each cluster identity is one
cluster-scoped ``CiliumIdentity`` object whose **name is the numeric
id** and whose ``security-labels`` carry the label set; an informer
mirrors the table onto every node and feeds ``on_change``.

Faithful semantic differences from the kvstore backend, carried over
from the reference:

* there is no labels→id uniqueness constraint in the store — two nodes
  racing to allocate the same label set can create TWO CiliumIdentity
  objects. That is legal: policy matches by label, so every duplicate
  id carries the same selector behavior; lookups deterministically
  resolve to the LOWEST live id, and the operator's identity GC reaps
  duplicates once no endpoint references them (the reference has the
  same duplicate-tolerant design).
* deletion is the operator's GC duty; agents only ``release`` locally.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from cilium_tpu_torch.runtime import simclock
from cilium_tpu_torch.core.identity import (
    IDENTITY_SCOPE_LOCAL,
    IDENTITY_USER_MAX,
    NumericIdentity,
)
from cilium_tpu_torch.core.identity_cache import IdentityCacheBase
from cilium_tpu_torch.core.labels import LabelSet
from cilium_tpu_torch.k8s.apiserver import Conflict, K8sClient, NotFound
from cilium_tpu_torch.k8s.informer import Informer
from cilium_tpu_torch.runtime.logging import get_logger

LOG = get_logger("identity-crd")

PLURAL = "ciliumidentities"

#: GC grace: a CiliumIdentity younger than this may belong to an
#: endpoint whose CEP publish is still in flight — never collect it.
GC_GRACE_S = 60.0


def identity_object(nid: int, labels: LabelSet) -> Dict:
    return {
        "apiVersion": "cilium.io/v2",
        "kind": "CiliumIdentity",
        "metadata": {"name": str(int(nid))},
        # upstream stores map[label]→value; a sorted canonical list is
        # the same information in this codebase's label format
        "security-labels": sorted(labels.format()),
        "created-at": simclock.wall(),
    }


def _parse(obj: Dict) -> Optional[tuple]:
    try:
        nid = int(obj["metadata"]["name"])
        labels = LabelSet.parse(obj.get("security-labels", []))
    except (KeyError, ValueError, TypeError):
        return None  # corrupt object; the operator GC will reap it
    return nid, labels


class CRDIdentityAllocator(IdentityCacheBase):
    """Duck-type of the kvstore allocator, backed by CiliumIdentity
    CRDs through the fake-apiserver (``--identity-allocation-mode=crd``
    + ``--k8s-api-socket``)."""

    def __init__(self, client: K8sClient,
                 on_change: Optional[Callable[[NumericIdentity,
                                               Optional[LabelSet]],
                                              None]] = None):
        super().__init__(on_change=on_change)
        self.client = client
        self._informer: Optional[Informer] = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "CRDIdentityAllocator":
        """List existing identities (synchronously — policy must not
        resolve against a cold cache), then follow. Idempotent."""
        if self._informer is None:
            self._informer = Informer(
                self.client, PLURAL,
                on_add=self._on_obj,
                on_update=lambda old, new: self._on_obj(new),
                on_delete=self._on_delete).start()
        return self

    def close(self) -> None:
        if self._informer is not None:
            self._informer.stop()
            self._informer = None

    def _on_obj(self, obj: Dict) -> None:
        parsed = _parse(obj)
        if parsed is None:
            return
        self._crd_upsert(*parsed)

    def _crd_upsert(self, nid: int, labels: LabelSet) -> None:
        """Atomic min-wins upsert for a duplicate-tolerant store.

        Applied identically for informer events AND our own creates:
        the duplicate decision (keep the LOWEST id as the lookup
        winner, but cache and announce every duplicate — endpoints
        elsewhere may carry it, and selectors must match it) must
        happen under the cache lock. A check-then-act against a
        separately-read ``cur`` lets a racing peer's lower id slip in
        between and get clobbered, permanently breaking lowest-id
        convergence — that duplicate's event is never redelivered."""
        with self._notify_lock:
            with self._lock:
                cur = self._by_labels.get(labels)
                known = (self._by_id.get(nid) == labels and cur == nid)
                self._by_id[nid] = labels
                if cur is None or nid < cur:
                    self._by_labels[labels] = nid
                self._gauge_locked()
            if not known and self.on_change is not None:
                self.on_change(nid, labels)

    def _on_delete(self, obj: Dict) -> None:
        parsed = _parse(obj)
        if parsed is None:
            return
        self._remote_delete(*parsed)

    def _relink_locked(self, labels: LabelSet, gone: int) -> None:
        # duplicate-tolerant backend: after the mapped id was deleted,
        # a surviving duplicate (lowest) takes over label resolution
        alive = [nid for nid, lbls in self._by_id.items()
                 if lbls == labels and nid != gone]
        if alive:
            self._by_labels[labels] = min(alive)

    # -- allocation -------------------------------------------------------
    def _allocate_global(self, labels: LabelSet) -> NumericIdentity:
        for _ in range(64):
            with self._lock:
                existing = self._by_labels.get(labels)
            if existing is not None:
                return existing
            candidate = self._next_candidate()
            if candidate >= IDENTITY_USER_MAX:
                raise RuntimeError("user identity space exhausted")
            try:
                self.client.create(PLURAL,
                                   identity_object(candidate, labels))
            except Conflict:
                with self._lock:  # claimed by a peer we haven't seen
                    self._candidate_floor = candidate + 1
                continue
            # our create is authoritative for this id; announce through
            # the same atomic min-wins path informer events use (a
            # racing peer's lower id may have landed since our check)
            self._crd_upsert(candidate, labels)
            return candidate
        raise RuntimeError("identity allocation did not converge")

    # -- lookups ----------------------------------------------------------
    def lookup(self, nid: NumericIdentity) -> Optional[LabelSet]:
        with self._lock:
            labels = self._by_id.get(nid)
        if labels is not None:
            return labels
        if nid < IDENTITY_SCOPE_LOCAL:  # cache miss: ask the store
            try:
                obj = self.client.get(PLURAL, str(int(nid)))
            except (NotFound, OSError, RuntimeError):
                return None
            parsed = _parse(obj)
            if parsed is None:
                return None
            _, labels = parsed
            gen = self._gen_of(labels)
            self._adopt(int(nid), labels, gen)
            return labels
        return None

    def lookup_by_labels(self,
                         labels: LabelSet) -> Optional[NumericIdentity]:
        # no read-through: the informer's synchronous first list means
        # the cache IS the table; a store list per miss would rescan
        # every identity (the reference resolves from the informer
        # store for the same reason)
        with self._lock:
            return self._by_labels.get(labels)


def gc_crd_identities(client: K8sClient,
                      grace_s: float = GC_GRACE_S) -> int:
    """Operator duty (the reference's CiliumIdentity GC): delete
    CiliumIdentity objects no CiliumEndpoint references — including
    duplicate-allocation losers — once older than ``grace_s``.
    Returns the number reaped."""
    try:
        identities = client.list(PLURAL)["items"]
        ceps = client.list("ciliumendpoints")["items"]
    except (OSError, RuntimeError):
        return 0
    referenced = set()
    for cep in ceps:
        ident = cep.get("status", {}).get("identity", {})
        try:
            referenced.add(str(int(ident["id"])))
        except (KeyError, TypeError, ValueError):
            pass  # corrupt/foreign CEP must not kill the GC pass
    now = simclock.wall()
    reaped = 0
    for obj in identities:
        name = obj["metadata"]["name"]
        if name in referenced:
            continue
        try:
            age = now - float(obj.get("created-at", 0))
        except (TypeError, ValueError):
            age = grace_s + 1  # corrupt stamp: reap once past grace
        if age < grace_s:
            continue  # may be an allocation whose CEP is in flight
        try:
            client.delete(PLURAL, name)
            reaped += 1
        except (NotFound, OSError, RuntimeError):
            pass
    if reaped:
        LOG.info("identity GC reaped CiliumIdentities",
                 extra={"fields": {"count": reaped}})
    return reaped
