"""Proxy manager: proxy-port allocation + redirect lifecycle.

Reference: ``pkg/proxy`` (SURVEY §2.2) — when an L4Filter carries L7
rules, the agent allocates a proxy port for the (parser, direction)
pair, installs a datapath redirect (TPROXY) steering matched traffic
into the proxy, and tracks the redirect's lifecycle across policy
regenerations (ref-counted; released when no filter needs it; ports
reused after release).

Port role: the datapath's ``proxy_port`` slot is our MapState
``is_redirect`` lane — flows the engine marks REDIRECTED are already
"in the proxy" (the shim/verdict service). What remains of pkg/proxy
is exactly this object: a stable proxy-port number per (l7proto,
direction) that the shim listens on, held while any resolved policy
references it and released afterwards, so external proxies (Envoy)
can bind deterministically.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from cilium_tpu_torch.runtime.metrics import METRICS

#: default allocation range (reference: proxy ports come from an
#: ephemeral range the datapath knows to trust)
PROXY_PORT_MIN = 10000
PROXY_PORT_MAX = 20000


class ProxyPortExhausted(RuntimeError):
    pass


class Redirect:
    """One live (l7proto, ingress) redirect: a bound proxy port plus
    the set of policy users holding it."""

    __slots__ = ("l7proto", "ingress", "proxy_port", "users")

    def __init__(self, l7proto: str, ingress: bool, proxy_port: int):
        self.l7proto = l7proto
        self.ingress = ingress
        self.proxy_port = proxy_port
        #: (endpoint_identity, dport) pairs whose policy references
        #: this redirect — lifecycle follows this set
        self.users: set = set()

    def to_dict(self) -> Dict:
        return {"l7proto": self.l7proto,
                "ingress": self.ingress,
                "proxy_port": self.proxy_port,
                "users": sorted(list(self.users))}


class ProxyManager:
    """Allocates proxy ports and reconciles redirects against each
    policy snapshot (the reference updates redirects during endpoint
    regeneration; ours reconciles per resolved snapshot)."""

    def __init__(self, port_min: int = PROXY_PORT_MIN,
                 port_max: int = PROXY_PORT_MAX) -> None:
        self._lock = threading.Lock()
        self._port_min = port_min
        self._port_max = port_max
        self._next = port_min
        self._free: List[int] = []          # released ports, reused LIFO
        self._redirects: Dict[Tuple[str, bool], Redirect] = {}

    # -- allocation -------------------------------------------------------
    def _alloc_port(self) -> int:
        if self._free:
            return self._free.pop()
        if self._next > self._port_max:
            raise ProxyPortExhausted(
                f"proxy port range {self._port_min}-{self._port_max} "
                "exhausted")
        port = self._next
        self._next += 1
        return port

    def acquire(self, l7proto: str, ingress: bool,
                user: Tuple[int, int]) -> Redirect:
        """Get-or-create the redirect for (l7proto, direction) and
        register ``user`` (endpoint identity, dport) on it."""
        with self._lock:
            key = (l7proto, ingress)
            r = self._redirects.get(key)
            if r is None:
                r = Redirect(l7proto, ingress, self._alloc_port())
                self._redirects[key] = r
                METRICS.inc("cilium_tpu_proxy_redirects_created_total",
                            labels={"l7proto": l7proto})
            r.users.add(user)
            self._set_gauge()
            return r

    def release(self, l7proto: str, ingress: bool,
                user: Tuple[int, int]) -> None:
        with self._lock:
            key = (l7proto, ingress)
            r = self._redirects.get(key)
            if r is None:
                return
            r.users.discard(user)
            if not r.users:
                del self._redirects[key]
                self._free.append(r.proxy_port)
                METRICS.inc("cilium_tpu_proxy_redirects_released_total",
                            labels={"l7proto": l7proto})
            self._set_gauge()

    def _set_gauge(self) -> None:
        METRICS.set_gauge("cilium_tpu_proxy_redirects",
                          len(self._redirects))

    # -- snapshot reconciliation -----------------------------------------
    @staticmethod
    def _snapshot_users(per_identity) -> Dict[Tuple[str, bool],
                                              set]:
        """(l7proto, ingress) → users demanded by a resolved snapshot:
        every redirect MapState entry contributes one user per
        protocol family its rule set carries."""
        from cilium_tpu_torch.core.flow import TrafficDirection

        want: Dict[Tuple[str, bool], set] = {}
        for ep_id, ms in per_identity.items():
            for key, entry in ms.entries.items():
                if not entry.is_redirect:
                    continue
                ingress = key.direction == int(TrafficDirection.INGRESS)
                protos = set()
                for lr in entry.l7_rules:
                    if lr.http:
                        protos.add("http")
                    if lr.kafka:
                        protos.add("kafka")
                    if lr.dns:
                        protos.add("dns")
                    if lr.l7proto:
                        protos.add(lr.l7proto)
                for proto in protos:
                    want.setdefault((proto, ingress), set()).add(
                        (ep_id, key.dport))
        return want

    def reconcile(self, per_identity) -> Dict[Tuple[str, bool], int]:
        """Sync redirects to a resolved policy snapshot: acquire what
        the snapshot demands, release what nothing references anymore.
        Returns the live (l7proto, ingress) → proxy_port map. Ports
        are STABLE across reconciles while any user persists (the
        reference keeps a redirect's port for its lifetime)."""
        want = self._snapshot_users(per_identity)
        with self._lock:
            # a redirect still demanded by the snapshot keeps its PORT
            # even when its user set is fully replaced (e.g. an
            # endpoint re-identified): release only keys nothing wants
            # — a delete-then-recreate could swap ports between live
            # redirects and misroute an externally-bound proxy
            for key in list(self._redirects):
                if key in want:
                    self._redirects[key].users = set(want[key])
                    continue
                r = self._redirects.pop(key)
                self._free.append(r.proxy_port)
                METRICS.inc(
                    "cilium_tpu_proxy_redirects_released_total",
                    labels={"l7proto": r.l7proto})
            for key, users in want.items():
                if key not in self._redirects:
                    r = Redirect(key[0], key[1], self._alloc_port())
                    r.users = set(users)
                    self._redirects[key] = r
                    METRICS.inc(
                        "cilium_tpu_proxy_redirects_created_total",
                        labels={"l7proto": key[0]})
            self._set_gauge()
            return {k: r.proxy_port
                    for k, r in self._redirects.items()}

    # -- introspection ----------------------------------------------------
    def lookup(self, l7proto: str, ingress: bool) -> Optional[int]:
        with self._lock:
            r = self._redirects.get((l7proto, ingress))
            return r.proxy_port if r else None

    def dump(self) -> List[Dict]:
        with self._lock:
            return [r.to_dict() for _, r in sorted(
                self._redirects.items())]
