"""Health: node-to-node probe mesh.

Reference: ``pkg/health`` (SURVEY.md §2.5, §5.3) — every node runs a
``cilium-health`` endpoint; each agent periodically probes every other
node (ICMP + TCP to the health endpoint) and reports per-node
connectivity + latency via ``cilium-health status``. Ours probes
registered peers by invoking their probe callable (in-process analog
of the TCP probe; a gRPC probe slots into the same Prober interface),
records latency into the shared metrics registry, and drives failure
detection: a peer failing `failure_threshold` consecutive probes is
reported unreachable until a probe succeeds again.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Callable, Dict, List

from cilium_tpu_torch.runtime import simclock
from cilium_tpu_torch.runtime.metrics import METRICS

#: kvstore prefix where agents advertise their health endpoint (the
#: per-node ``cilium-health`` listener analog): value = {"socket": api}
PEERS_PREFIX = "cilium/health/peers/"


@dataclasses.dataclass
class NodeStatus:
    name: str
    reachable: bool = True
    consecutive_failures: int = 0
    last_probe_ts: float = 0.0
    last_latency_s: float = 0.0
    last_error: str = ""


class HealthChecker:
    """Probe mesh over registered peers.

    `probe_all()` is wired to a ControllerManager interval by the agent
    (the reference's probe interval is 60s); tests call it directly.
    """

    def __init__(self, node_name: str = "local",
                 failure_threshold: int = 3) -> None:
        self.node_name = node_name
        self.failure_threshold = failure_threshold
        self._lock = threading.Lock()
        self._probes: Dict[str, Callable[[], None]] = {}
        self._status: Dict[str, NodeStatus] = {}

    def add_node(self, name: str, probe: Callable[[], None]) -> None:
        """Register a peer; `probe` raising means the probe failed."""
        with self._lock:
            self._probes[name] = probe
            self._status[name] = NodeStatus(name=name)

    def remove_node(self, name: str) -> None:
        with self._lock:
            self._probes.pop(name, None)
            self._status.pop(name, None)

    def probe_all(self) -> Dict[str, NodeStatus]:
        with self._lock:
            probes = list(self._probes.items())
        for name, probe in probes:
            t0 = time.perf_counter()
            err = ""
            try:
                probe()
                ok = True
            except Exception as e:
                ok = False
                err = f"{type(e).__name__}: {e}"
            latency = time.perf_counter() - t0
            with self._lock:
                st = self._status.get(name)
                if st is None:  # removed concurrently
                    continue
                st.last_probe_ts = simclock.wall()
                st.last_latency_s = latency
                st.last_error = err
                if ok:
                    st.consecutive_failures = 0
                    st.reachable = True
                else:
                    st.consecutive_failures += 1
                    if st.consecutive_failures >= self.failure_threshold:
                        st.reachable = False
                reachable = st.reachable
            METRICS.observe("cilium_tpu_health_probe_seconds", latency,
                            labels={"peer": name})
            # gauge follows the debounced state, not the single probe —
            # alerting on it must not flap below the failure threshold
            METRICS.set_gauge("cilium_tpu_health_reachable",
                              1.0 if reachable else 0.0,
                              labels={"peer": name})
        return self.status()

    def status(self) -> Dict[str, NodeStatus]:
        with self._lock:
            return {n: dataclasses.replace(s)
                    for n, s in self._status.items()}

    def unreachable(self) -> List[str]:
        with self._lock:
            return sorted(n for n, s in self._status.items()
                          if not s.reachable)


def socket_probe(api_socket_path: str,
                 timeout: float = 3.0) -> Callable[[], None]:
    """TCP-probe analog: GET the peer agent's ``/v1/healthz`` over its
    API socket; any connect/HTTP/decode failure raises = probe failed.
    Short timeout: probe_all is sequential, so one wedged peer must not
    stall the whole round (the reference probe is similarly bounded)."""

    def probe() -> None:
        from cilium_tpu_torch.runtime.api import APIClient

        resp = APIClient(api_socket_path, timeout=timeout).healthz()
        if not isinstance(resp, dict) or resp.get("status") != "ok":
            raise RuntimeError(f"unhealthy response: {resp!r}")

    return probe


class HealthPeerWatcher:
    """Discover the probe mesh from kvstore advertisements: every node
    publishing under ``cilium/health/peers/`` becomes a probed peer
    (except ourselves), and departures — clean or lease-expired —
    remove the peer. This is how each agent ends up probing every
    other node, the reference's full-mesh discipline."""

    def __init__(self, store, checker: HealthChecker):
        self.store = store
        self.checker = checker
        self._watch = None

    def start(self) -> "HealthPeerWatcher":
        from cilium_tpu_torch.kvstore import EVENT_DELETE

        def on_event(ev) -> None:
            name = ev.key[len(PEERS_PREFIX):]
            if name == self.checker.node_name:
                return  # don't probe ourselves
            if ev.typ == EVENT_DELETE:
                self.checker.remove_node(name)
                return
            try:
                sock = json.loads(ev.value)["socket"]
            except (ValueError, KeyError, TypeError):
                return
            self.checker.add_node(name, socket_probe(sock))

        self._watch = self.store.watch_prefix(PEERS_PREFIX, on_event)
        return self

    def stop(self) -> None:
        if self._watch is not None:
            self._watch.stop()
            self._watch = None
