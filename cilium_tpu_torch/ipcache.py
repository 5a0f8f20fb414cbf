"""ipcache: IP/CIDR → identity metadata store (counterpart of the
reference's ``ipcache.py``, copied).

The join point where FQDN-resolved IPs become matchable identities:
IPs/prefixes map to (usually local-scoped CIDR) identities, and the
SelectorCache is told of each new one so resolved policy stays
incremental. ``lookup`` is a longest-prefix match: one probe of the
prefix map a prefix length present, longest first (the reference scans
every entry; the answers are the same).
"""

from __future__ import annotations

import ipaddress
import threading
from typing import Callable, Dict, List, Optional, Tuple

from cilium_tpu_torch.core.identity import IdentityAllocator, NumericIdentity
from cilium_tpu_torch.core.labels import Label, LabelSet, SOURCE_RESERVED


def cidr_labels(prefix: str) -> LabelSet:
    """Label set for a CIDR identity: one ``cidr:`` label per COVERING
    prefix (/0 up to the prefix itself) plus ``reserved:world``
    (reference: ``pkg/labels/cidr ·GetCIDRLabels``). The ancestor chain
    is what makes containment matching work — a rule for 10.0.0.0/8
    selects the /32 identity of an IP inside it because that identity
    carries the 10.0.0.0/8 label; toCIDRSet ``except`` subtraction and
    the world entity (CIDR identities ARE world) both ride on this."""
    net = ipaddress.ip_network(prefix, strict=False)
    labels = [Label(key="world", source=SOURCE_RESERVED)]
    for plen in range(0, net.prefixlen + 1):
        labels.append(Label(key=str(net.supernet(new_prefix=plen)),
                            source="cidr"))
    return LabelSet(labels)


class IPCache:
    def __init__(self, allocator: IdentityAllocator,
                 selector_cache=None) -> None:
        self._lock = threading.Lock()
        self._allocator = allocator
        self._selector_cache = selector_cache
        # prefix → identity
        self._by_prefix: Dict[ipaddress._BaseNetwork, NumericIdentity] = {}
        # (IP version, prefix length) → entries of that length
        self._lengths: Dict[Tuple[int, int], int] = {}
        self._listeners: List[Callable[[str, NumericIdentity, bool], None]] = []

    def upsert(self, prefix: str,
               identity: Optional[NumericIdentity] = None) -> NumericIdentity:
        """Insert/refresh a prefix. Without an explicit identity a local
        CIDR identity is allocated from the ``cidr:<prefix>`` label set
        (reference: CIDR identities are node-local-scoped)."""
        net = ipaddress.ip_network(prefix, strict=False)
        with self._lock:
            nid = self._by_prefix.get(net)
            if nid is not None and (identity is None or identity == nid):
                return nid  # unchanged
            if identity is None:
                labels = cidr_labels(str(net))
                identity = self._allocator.allocate(labels)
                if self._selector_cache is not None:
                    self._selector_cache.add_identity(identity, labels)
            if nid is None:
                key = (net.version, net.prefixlen)
                self._lengths[key] = self._lengths.get(key, 0) + 1
            self._by_prefix[net] = identity  # insert or remap
        for fn in self._listeners:
            fn(str(net), identity, True)
        return identity

    def delete(self, prefix: str) -> None:
        net = ipaddress.ip_network(prefix, strict=False)
        with self._lock:
            nid = self._by_prefix.pop(net, None)
            if nid is not None:
                key = (net.version, net.prefixlen)
                self._lengths[key] -= 1
                if not self._lengths[key]:
                    del self._lengths[key]
        if nid is not None:
            for fn in self._listeners:
                fn(str(net), nid, False)

    def lookup(self, ip: str) -> Optional[NumericIdentity]:
        """Longest-prefix match (the BPF ipcache is an LPM trie)."""
        addr = ipaddress.ip_address(ip)
        with self._lock:
            for version, plen in sorted(self._lengths, reverse=True):
                if version == addr.version:
                    nid = self._by_prefix.get(ipaddress.ip_network(
                        (addr, plen), strict=False))
                    if nid is not None:
                        return nid
        return None

    def subscribe(self, fn: Callable[[str, NumericIdentity, bool], None]):
        self._listeners.append(fn)

    def dump(self) -> List[Dict]:
        """All entries, sorted by prefix (``cilium-dbg bpf ipcache
        list`` / REST ``GET /v1/ip`` analog)."""
        with self._lock:
            return [
                {"cidr": str(net), "identity": int(nid)}
                for net, nid in sorted(
                    self._by_prefix.items(),
                    key=lambda kv: (int(kv[0].network_address),
                                    kv[0].prefixlen))
            ]

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_prefix)
