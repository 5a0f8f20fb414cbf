"""Numeric security identities.

Models the reference's ``pkg/identity``: a ``NumericIdentity`` is a u32
handle for a unique label set; well-known *reserved* identities live below
256; user identities are allocated from 256 upward; CIDR ("world" subset)
identities are local-scoped and carry a scope flag in the high bits
(reference: ``pkg/identity/identity.go``, ``pkg/identity/reserved_identity.go``
— unverified paths, SURVEY.md §2.1).
"""

from __future__ import annotations

import enum
import threading
from typing import Dict, Iterable, Optional

from cilium_tpu_torch.core.labels import (
    CLUSTER_LABEL_KEY,
    Label,
    LabelSet,
    SOURCE_RESERVED,
)

NumericIdentity = int  # u32

# Reserved numeric identities (reference values, pkg/identity).
class ReservedIdentity(enum.IntEnum):
    UNKNOWN = 0
    HOST = 1
    WORLD = 2
    UNMANAGED = 3
    HEALTH = 4
    INIT = 5
    REMOTE_NODE = 6
    KUBE_APISERVER = 7
    INGRESS = 8


#: First identity available to the user-scope allocator.
IDENTITY_USER_MIN = 256
#: Exclusive upper bound of the cluster-local user scope (24-bit space).
IDENTITY_USER_MAX = 1 << 24
#: Scope flag for node-local (CIDR) identities — high-bit scope, mirroring
#: the reference's local-identity flag.
IDENTITY_SCOPE_LOCAL = 1 << 24

RESERVED_LABELS: Dict[ReservedIdentity, LabelSet] = {
    rid: LabelSet([Label(key=rid.name.lower().replace("_", "-"),
                         source=SOURCE_RESERVED)])
    for rid in ReservedIdentity
    if rid != ReservedIdentity.UNKNOWN
}

#: Wildcard identity in policy-map keys (matches any identity).
IDENTITY_WILDCARD: NumericIdentity = 0


class IdentityAllocator:
    """Label-set → numeric identity allocation.

    The reference allocates via kvstore/CRD (``pkg/identity/cache``,
    ``pkg/allocator``); here a single-process allocator with the same
    observable contract: same label set ⇒ same identity; reserved label
    sets map to reserved identities; CIDR labels allocate in the local
    scope. Thread-safe (single-writer lock, mirroring the agent's
    allocator serialization).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_labels: Dict[LabelSet, NumericIdentity] = {}
        self._by_id: Dict[NumericIdentity, LabelSet] = {}
        self._next_user = IDENTITY_USER_MIN
        self._next_local = IDENTITY_SCOPE_LOCAL
        for rid, lbls in RESERVED_LABELS.items():
            self._by_labels[lbls] = int(rid)
            self._by_id[int(rid)] = lbls

    def allocate(self, labels: LabelSet) -> NumericIdentity:
        with self._lock:
            nid = self._by_labels.get(labels)
            if nid is not None:
                return nid
            # the host/remote-node endpoints keep their FIXED reserved
            # identity regardless of accompanying node labels
            # (reference: the host endpoint is always identity 1; node
            # labels vary per node but the datapath identity does not).
            # A clustermesh-synced set (cluster label present) is NEVER
            # the local host: another cluster's host maps to
            # REMOTE_NODE here, exactly as the reference treats peer
            # nodes — granting it HOST would extend host-entity trust
            # across the mesh.
            from_remote = any(l.key == CLUSTER_LABEL_KEY
                              for l in labels)
            for l in labels:
                if l.source != SOURCE_RESERVED:
                    continue
                if l.key == "host":
                    nid = int(ReservedIdentity.REMOTE_NODE if from_remote
                              else ReservedIdentity.HOST)
                    break
                if l.key == "remote-node":
                    nid = int(ReservedIdentity.REMOTE_NODE)
                    break
            if nid is not None:
                self._by_labels[labels] = nid
                if not from_remote:
                    # remote-tagged sets must not overwrite the
                    # canonical reserved label set in _by_id
                    self._by_id[nid] = labels
                return nid
            if any(l.source == "cidr" for l in labels):
                nid = self._next_local
                self._next_local += 1
            else:
                nid = self._next_user
                self._next_user += 1
                if nid >= IDENTITY_USER_MAX:
                    raise RuntimeError("user identity space exhausted")
            self._by_labels[labels] = nid
            self._by_id[nid] = labels
            return nid

    def lookup(self, nid: NumericIdentity) -> Optional[LabelSet]:
        return self._by_id.get(nid)

    def lookup_by_labels(self, labels: LabelSet) -> Optional[NumericIdentity]:
        return self._by_labels.get(labels)

    def release(self, nid: NumericIdentity) -> None:
        # reserved identities are process invariants — a refcounting
        # consumer (clustermesh) dropping its last reference to e.g.
        # REMOTE_NODE must not destroy the reserved registration
        if nid < IDENTITY_USER_MIN:
            return
        with self._lock:
            lbls = self._by_id.pop(nid, None)
            if lbls is not None:
                self._by_labels.pop(lbls, None)

    def identities(self) -> Iterable[NumericIdentity]:
        return list(self._by_id)

    def __len__(self) -> int:
        return len(self._by_id)
