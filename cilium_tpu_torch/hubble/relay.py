"""Hubble Relay: cluster-wide flow queries.

Reference: ``pkg/hubble/relay`` (SURVEY.md §2.5) — Relay keeps a peer
list (one Hubble observer per node, discovered via the Peer service),
scatter-gathers ``GetFlows`` across all peers, and merge-sorts the
per-node streams by timestamp into one cluster-wide stream. Ours
relays over in-process Observer instances (the node boundary is a
constructor argument, not a gRPC dial — the scatter/gather and
merge-sort semantics are the part that carries).
"""

from __future__ import annotations

import heapq
import threading
from typing import Dict, List, Optional, Tuple

from cilium_tpu_torch.core.flow import Flow
from cilium_tpu_torch.runtime import simclock
from cilium_tpu_torch.hubble.observer import FlowFilter, Observer


class Peer:
    """One node's observer endpoint (reference: peer service entry)."""

    def __init__(self, name: str, observer: Observer) -> None:
        self.name = name
        self.observer = observer
        self.available = True


class Relay:
    """Scatter-gather over per-node observers (``hubble-relay``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._peers: Dict[str, Peer] = {}

    # -- peer management (reference: peer change notifications) ---------
    def add_peer(self, name: str, observer: Observer) -> Peer:
        p = Peer(name, observer)
        with self._lock:
            self._peers[name] = p
        return p

    def remove_peer(self, name: str) -> None:
        with self._lock:
            self._peers.pop(name, None)

    def peers(self) -> List[str]:
        with self._lock:
            return sorted(self._peers)

    # -- queries ---------------------------------------------------------
    def get_flows(self, flt: Optional[FlowFilter] = None,
                  limit: Optional[int] = None) -> List[Tuple[str, Flow]]:
        """Gather matching flows from every available peer, merge-sorted
        by flow time (the relay contract: one globally time-ordered
        stream). Returns ``(peer_name, flow)`` pairs; an unreachable
        peer is skipped and marked unavailable, not fatal (reference
        degrades the same way)."""
        with self._lock:
            peers = list(self._peers.values())
        streams: List[List[Tuple[float, int, str, Flow]]] = []
        for idx, p in enumerate(peers):
            try:
                # materialize inside the try — get_flows is a generator,
                # so failures surface during iteration, not at the call
                stream = [(f.time or 0.0, idx, p.name, f)
                          for f in self._peer_stream(p, flt, limit)]
                p.available = True
            except Exception:
                p.available = False
                continue
            streams.append(stream)
        merged = list(heapq.merge(*streams))
        if limit is not None:
            merged = merged[-limit:]
        return [(name, f) for _, _, name, f in merged]

    def add_remote_peer(self, name: str, socket_path: str) -> Peer:
        """Peer on another node, reached over its hubble socket (the
        reference relay's gRPC dial to each node's observer)."""
        if not socket_path:
            raise ValueError(f"peer {name!r}: empty socket path")
        return self.add_peer(name, RemoteObserver(socket_path))

    @staticmethod
    def _peer_stream(p: Peer, flt, limit):
        """Per-peer query with limit push-down. The global newest-N is
        a subset of the union of per-peer newest-N slices, so an
        unfiltered limited query only transfers ≤N flows per peer
        instead of each peer's whole ring. Filtered queries stay
        unbounded (a newest-N cut below a filter would under-deliver)."""
        obs = p.observer
        if limit is None or flt is not None:
            return obs.get_flows(flt)
        if hasattr(obs, "ring"):  # in-process Observer: newest-N slice
            since = max(obs.ring.oldest_seq, obs.ring.next_seq - limit)
            return obs.get_flows(flt, since_seq=since)
        return obs.get_flows(flt, limit=limit)  # RemoteObserver

    def status(self) -> Dict[str, Dict]:
        with self._lock:
            return {
                name: {"available": p.available}
                for name, p in self._peers.items()
            }


class RemoteObserver:
    """Observer-shaped adapter over a node's hubble socket."""

    def __init__(self, socket_path: str):
        self.socket_path = socket_path

    def get_flows(self, flt: Optional[FlowFilter] = None,
                  limit: Optional[int] = None):
        from cilium_tpu_torch.hubble.server import HubbleClient, filter_to_dict
        from cilium_tpu_torch.ingest.hubble import flow_from_dict

        client = HubbleClient(self.socket_path)
        since = None
        if limit is not None and flt is None:
            # newest-N, not first-N: resume from next_seq - N so a
            # limited relay query transfers N flows, not the whole ring
            st = client.server_status()
            since = max(st["oldest_seq"], st["next_seq"] - limit)
        for d in client.get_flows(flt=filter_to_dict(flt),
                                  since_seq=since):
            yield flow_from_dict(d)


class RelayObserver:
    """Adapter presenting a Relay as the Observer a
    :class:`~cilium_tpu_torch.hubble.server.HubbleServer` serves — one relay
    socket, cluster-wide merged ``GetFlows``, same wire protocol (the
    existing CLI works against it unchanged).

    Snapshot queries only: per-request merge seqs are not stable across
    requests, so honoring ``follow``/``since_seq`` would replay the
    whole cluster snapshot as duplicates in a hot loop. Such requests
    are rejected with an error line instead (the CLI surfaces it);
    follow a node's own hubble socket for live streams.
    ``server_status`` on a relay reports the last snapshot's size.
    """

    def __init__(self, relay: Relay):
        self.relay = relay
        self.seen = 0  # size of the last snapshot served
        self.lost_reported = 0

    class _Ring:
        # a relay has no ring; zeros distinguish it from a node status
        capacity = 0
        oldest_seq = 0
        next_seq = 0

    ring = _Ring()

    def get_flows(self, flt=None, since_seq=None, limit=None,
                  follow=False, timeout=None, with_seq=False):
        if follow or since_seq is not None:
            raise ValueError(
                "the relay serves snapshot queries only; follow/resume "
                "against a node's own hubble socket")
        merged = self.relay.get_flows(flt, limit=limit)
        self.seen = len(merged)
        for seq, (peer, flow) in enumerate(merged):
            flow.node_name = flow.node_name or peer
            yield (seq, flow) if with_seq else flow


class FollowingRelay:
    """Live relay: follow every peer's stream into a local ring and
    serve THAT — the reference relay's actual shape (it holds open
    GetFlows(follow) streams to each node and re-serves the merged
    stream), so follow/resume work natively on the relay socket,
    unlike the snapshot-only :class:`RelayObserver`.

    Each peer gets a follower thread running the hubble client's
    resumable follow loop; flows land in ``self.observer`` (a normal
    ring Observer) stamped with the peer's node name. Interleaving
    across peers is arrival-order (the reference relay's follow mode
    is likewise best-effort ordered)."""

    def __init__(self, ring_capacity: int = 8192):
        self.observer = Observer(capacity=ring_capacity)
        self._lock = threading.Lock()
        self._followers: Dict[str, "_PeerFollower"] = {}

    def add_remote_peer(self, name: str, socket_path: str) -> None:
        if not socket_path:
            raise ValueError(f"peer {name!r}: empty socket path")
        with self._lock:
            old = self._followers.get(name)
            # idempotent: a kvstore re-advertisement (lease-lapse
            # republish) for a live follower must NOT replace it — a
            # fresh client restarts at since_seq=None and would replay
            # the peer's whole ring into ours as duplicates
            if (old is not None and old.socket_path == socket_path
                    and old.alive()):
                return
            f = _PeerFollower(name, socket_path, self.observer)
            f.start()  # started before it becomes visible: a racing
            self._followers[name] = f  # remove/stop never joins an
        if old is not None:            # unstarted thread
            old.stop()

    def remove_peer(self, name: str) -> None:
        with self._lock:
            f = self._followers.pop(name, None)
        if f is not None:
            f.stop()

    def peers(self) -> List[str]:
        with self._lock:
            return sorted(self._followers)

    def status(self) -> Dict[str, Dict]:
        with self._lock:
            return {name: {"available": f.connected,
                           "flows": f.delivered}
                    for name, f in self._followers.items()}

    def stop(self) -> None:
        with self._lock:
            followers = list(self._followers.values())
            self._followers.clear()
        for f in followers:
            f.stop()


class _PeerFollower:
    """One peer's follow stream → the relay's local ring."""

    def __init__(self, name: str, socket_path: str, observer: Observer):
        self.name = name
        self.socket_path = socket_path
        self.observer = observer
        self.connected = False
        self.delivered = 0
        self._stop = threading.Event()
        from cilium_tpu_torch.hubble.server import HubbleClient

        self._client = HubbleClient(socket_path)
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"relay-follow-{name}")

    def start(self) -> None:
        self._thread.start()

    def alive(self) -> bool:
        return self._thread.is_alive()

    def stop(self) -> None:
        self._stop.set()
        self._client.close()  # cancel the in-flight follow window
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def _run(self) -> None:
        from cilium_tpu_torch.ingest.hubble import flow_from_dict

        client = self._client
        backoff = 0.1
        instance = None
        while not self._stop.is_set():
            try:
                # Each window opens with a status probe: it flips
                # `connected` as soon as the peer answers (a quiet node
                # is not an unavailable node), and its observer
                # instance token detects restarts — a restarted node's
                # ring seqs start over, so resuming at our stale cursor
                # would silently skip (or wait out) its new flows
                # regardless of how the seq numbers happen to compare.
                st = client.server_status()
                self.connected = True
                if st.get("instance") != instance:
                    if instance is not None:
                        client.last_seq = None  # peer restarted
                    instance = st.get("instance")
                # long window (idle peers don't get redialed twice a
                # second); stop() cancels it via client.close()
                for d in client.get_flows(
                        follow=True, timeout=60.0,
                        since_seq=(client.last_seq + 1
                                   if client.last_seq is not None
                                   else None)):
                    backoff = 0.1
                    flow = flow_from_dict(d)
                    flow.node_name = flow.node_name or self.name
                    self.observer.observe([flow])
                    self.delivered += 1
                    if self._stop.is_set():
                        return
                backoff = 0.1
            except Exception:
                # ANY failure (connect, torn frame, malformed flow
                # dict) must degrade to reconnect-with-backoff — a
                # dead follower that still reports available would be
                # a silent hole in the merged stream
                self.connected = False
                if simclock.wait_on(self._stop, backoff):
                    return
                backoff = min(5.0, backoff * 2)


class PeerDirectory:
    """kvstore-backed peer discovery (the Hubble Peer service analog):
    agents publish ``cilium/hubble/peers/<node> → {"socket": path}``
    under their registration lease; the relay watches the prefix and
    keeps the peer set current as nodes come and go."""

    PREFIX = "cilium/hubble/peers/"

    def __init__(self, store, relay: Relay):
        self.store = store
        self.relay = relay
        self._watch = None

    def start(self) -> "PeerDirectory":
        import json as _json

        from cilium_tpu_torch.kvstore import EVENT_DELETE

        def on_event(ev):
            name = ev.key[len(self.PREFIX):]
            if ev.typ == EVENT_DELETE:
                self.relay.remove_peer(name)
                return
            try:
                sock = _json.loads(ev.value)["socket"]
            except (ValueError, KeyError, TypeError):
                return
            self.relay.add_remote_peer(name, sock)

        self._watch = self.store.watch_prefix(self.PREFIX, on_event)
        return self

    def stop(self) -> None:
        if self._watch is not None:
            self._watch.stop()
            self._watch = None


def main(argv=None) -> int:  # pragma: no cover - thin wrapper
    """``hubble-relay`` entrypoint: discover peers via the kvstore (or
    take static ``--peer name=socket`` pairs) and serve the merged
    stream on ``--socket``."""
    import argparse
    import signal
    import threading

    from cilium_tpu_torch.hubble.server import HubbleServer
    from cilium_tpu_torch.runtime.logging import setup as setup_logging

    ap = argparse.ArgumentParser(prog="cilium-tpu-hubble-relay")
    ap.add_argument("--socket", required=True,
                    help="unix socket to serve the merged stream on")
    ap.add_argument("--kvstore", help="kvstore socket for peer discovery")
    ap.add_argument("--peer", action="append", default=[],
                    metavar="NAME=SOCKET", help="static peer (repeatable)")
    ap.add_argument("--mode", choices=["live", "snapshot"],
                    default="live",
                    help="live (default): follow every peer into a "
                         "local ring — follow/resume work on the relay "
                         "socket; snapshot: scatter-gather per query "
                         "(full peer history, no follow)")
    args = ap.parse_args(argv)

    setup_logging()
    relay = FollowingRelay() if args.mode == "live" else Relay()
    for spec in args.peer:
        name, sep, sock = spec.partition("=")
        if not sep or not name or not sock:
            ap.error(f"--peer {spec!r}: expected NAME=SOCKET")
        relay.add_remote_peer(name, sock)
    directory = None
    kv = None
    if args.kvstore:
        from cilium_tpu_torch.kvstore_service import RemoteKVStore

        kv = RemoteKVStore(args.kvstore)
        directory = PeerDirectory(kv, relay).start()
    observer = (relay.observer if args.mode == "live"
                else RelayObserver(relay))
    server = HubbleServer(observer, args.socket, relay=relay).start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    server.stop()
    if directory is not None:
        directory.stop()
    if args.mode == "live":
        relay.stop()
    if kv is not None:
        kv.close()
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
