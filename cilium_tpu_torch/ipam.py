"""IPAM: cluster-pool pod-IP allocation.

Reference: ``pkg/ipam`` (SURVEY.md §2.4) in its default *cluster-pool*
mode — the operator carves a per-node podCIDR out of the cluster-wide
pool; each agent then allocates endpoint IPs from its node's CIDR,
re-adopting restored endpoints' addresses on restart (the
checkpoint/resume discipline of §5.4). BGP/ENI/Azure modes are out of
north-star scope (docs/PARITY.md).
"""

from __future__ import annotations

import ipaddress
import threading
from typing import Dict, List, Set

from cilium_tpu_torch.runtime.metrics import METRICS


class PoolExhausted(Exception):
    pass


class ClusterPool:
    """Carve per-node podCIDRs from a cluster pool (operator side)."""

    def __init__(self, cidr: str = "10.0.0.0/8",
                 node_mask_size: int = 24) -> None:
        self.pool = ipaddress.ip_network(cidr)
        if node_mask_size < self.pool.prefixlen:
            raise ValueError(
                f"node mask /{node_mask_size} wider than pool {cidr}")
        self.node_mask_size = node_mask_size
        self._lock = threading.Lock()
        self._by_node: Dict[str, ipaddress.IPv4Network] = {}
        self._used: Set[ipaddress.IPv4Network] = set()
        # sequential cursor over subnet indices: avoids rescanning the
        # whole pool enumeration per allocation (same pattern as
        # NodeAllocator._cursor); wraps to reclaim released CIDRs
        self._cursor = 0
        self._n_subnets = 1 << (node_mask_size - self.pool.prefixlen)
        self._subnet_span = 1 << (32 - node_mask_size)

    def allocate_node_cidr(self, node: str) -> str:
        with self._lock:
            got = self._by_node.get(node)
            if got is not None:  # idempotent re-register
                return str(got)
            base = int(self.pool.network_address)
            for off in range(self._n_subnets):
                idx = (self._cursor + off) % self._n_subnets
                net = ipaddress.ip_network(
                    (base + idx * self._subnet_span, self.node_mask_size))
                if net not in self._used:
                    self._used.add(net)
                    self._by_node[node] = net
                    self._cursor = idx + 1
                    self._gauge()
                    return str(net)
        raise PoolExhausted(f"no /{self.node_mask_size} left in {self.pool}")

    def adopt_node_cidr(self, node: str, cidr: str) -> None:
        """Re-adopt a persisted assignment on operator restart (§5.4):
        restored CIDRs must win over fresh allocations, so adopt before
        the first reconcile pass."""
        net = ipaddress.ip_network(cidr)
        if net.prefixlen != self.node_mask_size or not net.subnet_of(
                self.pool):
            raise ValueError(f"{cidr} is not a /{self.node_mask_size} "
                             f"subnet of {self.pool}")
        with self._lock:
            held = self._by_node.get(node)
            if held == net:
                return
            if held is not None or net in self._used:
                raise ValueError(f"conflicting adoption of {cidr} for {node}")
            self._used.add(net)
            self._by_node[node] = net
            self._gauge()

    def release_node_cidr(self, node: str) -> None:
        with self._lock:
            net = self._by_node.pop(node, None)
            if net is not None:
                self._used.discard(net)
                self._gauge()

    def _gauge(self) -> None:
        METRICS.set_gauge("cilium_tpu_ipam_node_cidrs",
                          float(len(self._by_node)))


class NodeAllocator:
    """Per-endpoint IP allocation within one node's podCIDR (agent side).

    Network and broadcast addresses are reserved, like the reference's
    per-node allocator; ``allocate_ip`` re-adopts a restored endpoint's
    address (restore must win over fresh allocations, so run it first).
    """

    def __init__(self, cidr: str) -> None:
        self.cidr = ipaddress.ip_network(cidr)
        self._lock = threading.Lock()
        self._allocated: Set[ipaddress.IPv4Address] = set()
        # sequential cursor: avoids rescanning from the start each time
        self._cursor = 1

    def _reserved(self, addr: ipaddress.IPv4Address) -> bool:
        return addr in (self.cidr.network_address,
                        self.cidr.broadcast_address)

    def allocate(self) -> str:
        with self._lock:
            size = self.cidr.num_addresses
            base = int(self.cidr.network_address)
            for off in range(size):
                addr = ipaddress.IPv4Address(
                    base + (self._cursor + off) % size)
                if self._reserved(addr) or addr in self._allocated:
                    continue
                self._allocated.add(addr)
                self._cursor = int(addr) - base + 1
                self._gauge()
                return str(addr)
        raise PoolExhausted(f"{self.cidr} exhausted")

    def allocate_ip(self, ip: str) -> str:
        addr = ipaddress.ip_address(ip)
        with self._lock:
            if addr not in self.cidr:
                raise ValueError(f"{ip} outside node CIDR {self.cidr}")
            if self._reserved(addr) or addr in self._allocated:
                raise PoolExhausted(f"{ip} unavailable")
            self._allocated.add(addr)
            self._gauge()
        return str(addr)

    def release(self, ip: str) -> bool:
        with self._lock:
            try:
                self._allocated.remove(ipaddress.ip_address(ip))
            except KeyError:
                return False
            self._gauge()
        return True

    def _gauge(self) -> None:
        METRICS.set_gauge("cilium_tpu_ipam_ips_allocated",
                          float(len(self._allocated)))

    @property
    def available(self) -> int:
        with self._lock:
            return self.cidr.num_addresses - 2 - len(self._allocated)

    def dump(self) -> List[str]:
        with self._lock:
            return sorted(str(a) for a in self._allocated)
