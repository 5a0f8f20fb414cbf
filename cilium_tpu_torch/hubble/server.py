"""Hubble observer served over a Unix socket.

Reference: ``pkg/hubble``'s gRPC ``Observer`` service (``GetFlows`` with
filters + follow, ``ServerStatus``) and the Relay that scatter-gathers
it across nodes (SURVEY.md §2.5). We speak newline-delimited JSON on an
``AF_UNIX`` stream socket — same resource shapes, stdlib transport:

  request  : one JSON line
    {"op": "get_flows", "filter": {...}, "since_seq": N,
     "limit": N, "follow": bool, "timeout": seconds}
    {"op": "server_status"}
    {"op": "peers"}                       (when serving a Relay)
  response : for get_flows, a stream of {"flow": {...}, "seq"?: N}
    lines ending with {"end": true, ...}; single JSON line otherwise.

The flow JSON is the exporter's flowpb-shaped ``flow_to_dict`` — the
same schema the replay harness ingests, so `observe | replay`
round-trips.

Where the port differs from the reference: a follow request waits for
new flows in slices of ``_FOLLOW_SLICE`` seconds (the window still ends
after ``timeout`` with no new flow), so ``stop()`` ends every request
thread within a slice; the reference's thread waits out the window
(up to 300 s) after its server stopped.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
import time
from typing import Dict, Iterator, Optional

from cilium_tpu_torch.core.flow import L7Type, Verdict
from cilium_tpu_torch.hubble.observer import FlowFilter, Observer
from cilium_tpu_torch.ingest.hubble import flow_to_dict

_MAX_FOLLOW_TIMEOUT = 300.0
#: a follow request re-checks its server's stop this often
_FOLLOW_SLICE = 0.5


def filter_to_dict(flt: Optional[FlowFilter]) -> Optional[Dict]:
    """Inverse of :func:`filter_from_dict` (for relaying a filter on to
    a peer's hubble socket)."""
    if flt is None:
        return None
    return {
        "verdict": flt.verdict.name if flt.verdict is not None else None,
        "l7_type": flt.l7_type.name if flt.l7_type is not None else None,
        "src_identity": flt.src_identity,
        "dst_identity": flt.dst_identity,
        "dport": flt.dport,
        "protocol": flt.protocol,
        "http_method": flt.http_method,
        "http_path": flt.http_path,
        "dns_query": flt.dns_query,
        "node_name": flt.node_name,
        "source_label": flt.source_label,
        "destination_label": flt.destination_label,
    }


def filter_from_dict(d: Optional[Dict]) -> Optional[FlowFilter]:
    if not d:
        return None
    return FlowFilter(
        verdict=Verdict[d["verdict"]] if d.get("verdict") else None,
        l7_type=L7Type[d["l7_type"]] if d.get("l7_type") else None,
        src_identity=d.get("src_identity"),
        dst_identity=d.get("dst_identity"),
        dport=d.get("dport"),
        protocol=d.get("protocol"),
        http_method=d.get("http_method"),
        http_path=d.get("http_path"),
        dns_query=d.get("dns_query"),
        node_name=d.get("node_name"),
        source_label=d.get("source_label"),
        destination_label=d.get("destination_label"),
    )


class HubbleServer:
    """Serve an Observer (or Relay) on ``socket_path``."""

    def __init__(self, observer: Observer, socket_path: str,
                 relay=None):
        self.observer = observer
        self.relay = relay
        self.socket_path = socket_path
        if os.path.exists(socket_path):
            from cilium_tpu_torch.runtime.unixsock import unlink_if_stale

            unlink_if_stale(socket_path)
        outer = self
        self._active_requests: set = set()
        self._active_lock = threading.Lock()
        self._stopping = threading.Event()

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):  # noqa: A003
                with outer._active_lock:
                    outer._active_requests.add(self.request)
                try:
                    line = self.rfile.readline(1 << 20)
                    if not line:
                        return
                    try:
                        req = json.loads(line)
                    except json.JSONDecodeError:
                        self._send({"error": "bad request json"})
                        return
                    try:
                        outer._dispatch(req, self._send)
                    except BrokenPipeError:
                        pass  # client went away mid-stream
                    except Exception as e:
                        try:
                            self._send(
                                {"error": f"{type(e).__name__}: {e}"})
                        except OSError:
                            pass
                finally:
                    with outer._active_lock:
                        outer._active_requests.discard(self.request)

            def _send(self, obj: Dict) -> None:
                self.wfile.write((json.dumps(obj) + "\n").encode())
                self.wfile.flush()

        class Server(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server(socket_path, Handler)
        self._thread: Optional[threading.Thread] = None

    # -- request dispatch -------------------------------------------------
    def _dispatch(self, req: Dict, send) -> None:
        op = req.get("op")
        if op == "get_flows":
            flt = filter_from_dict(req.get("filter"))
            limit = req.get("limit")
            follow = bool(req.get("follow", False))
            timeout = min(float(req.get("timeout", 1.0)),
                          _MAX_FOLLOW_TIMEOUT)
            n = 0
            if follow and isinstance(self.observer, Observer):
                n = self._follow(send, flt, req.get("since_seq"), limit,
                                 timeout)
            else:
                for seq, flow in self.observer.get_flows(
                        flt=flt, since_seq=req.get("since_seq"),
                        limit=limit, follow=follow, timeout=timeout,
                        with_seq=True):
                    send({"flow": flow_to_dict(flow), "seq": seq})
                    n += 1
            send({"end": True, "count": n,
                  "lost": self.observer.lost_reported})
        elif op == "server_status":
            send({"seen": self.observer.seen,
                  "lost": self.observer.lost_reported,
                  "ring_capacity": self.observer.ring.capacity,
                  "oldest_seq": self.observer.ring.oldest_seq,
                  "next_seq": self.observer.ring.next_seq,
                  "instance": getattr(self.observer, "instance", "")})
        elif op == "peers":
            if self.relay is None:
                send({"error": "not a relay"})
            else:
                send({"peers": self.relay.peers()})
        else:
            send({"error": f"unknown op {op!r}"})

    def _follow(self, send, flt, since_seq, limit, timeout) -> int:
        """A follow request: the ring's flows from ``since_seq`` on, then
        new ones as they land, until ``timeout`` passes with none, the
        limit is reached or the server stops → flows sent."""
        n, pos = 0, since_seq
        idle_until = time.monotonic() + timeout
        while not self._stopping.is_set():
            left = idle_until - time.monotonic()
            if left <= 0:
                break
            moved = False
            for seq, flow in self.observer.get_flows(
                    since_seq=pos, follow=True,
                    timeout=min(_FOLLOW_SLICE, left), with_seq=True):
                pos, moved = seq + 1, True
                if flt is None or flt.matches(flow):
                    send({"flow": flow_to_dict(flow), "seq": seq})
                    n += 1
                    if limit is not None and n >= limit:
                        return n
            if moved:
                idle_until = time.monotonic() + timeout
        return n

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "HubbleServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="hubble-server",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopping.set()
        self._server.shutdown()
        self._server.server_close()
        # terminate in-flight streams too: a long follow window must
        # not outlive the server (clients would block on a dead server
        # for the rest of the window — e.g. a relay follower missing a
        # node restart behind the same socket path)
        with self._active_lock:
            active = list(self._active_requests)
        for sock in active:
            try:
                sock.shutdown(2)
            except OSError:
                pass
        if self._thread:
            self._thread.join(timeout=5)
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)


class HubbleClient:
    """``hubble`` CLI-style consumer of :class:`HubbleServer`."""

    def __init__(self, socket_path: str):
        self.socket_path = socket_path
        self.last_seq: Optional[int] = None
        self._active_sock: Optional[socket.socket] = None
        self._closed = False

    def close(self) -> None:
        """Cancel an in-flight request/stream from another thread AND
        refuse new ones (sticky): without the flag, close() landing
        between two requests cancels nothing and the owner blocks in a
        fresh follow window. shutdown only — the owning thread's
        ``finally`` is the single close, avoiding the cross-thread
        fd-reuse hazard."""
        self._closed = True
        sock = self._active_sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _request(self, req: Dict) -> Iterator[Dict]:
        if self._closed:
            raise ConnectionError("client closed")
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._active_sock = sock
        try:
            sock.connect(self.socket_path)
            sock.sendall((json.dumps(req) + "\n").encode())
            buf = b""
            while True:
                chunk = sock.recv(65536)
                if not chunk:
                    return
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    yield json.loads(line)
        finally:
            self._active_sock = None
            sock.close()

    def get_flows(self, flt: Optional[Dict] = None,
                  limit: Optional[int] = None, follow: bool = False,
                  timeout: float = 1.0,
                  since_seq: Optional[int] = None) -> Iterator[Dict]:
        """Yields flow dicts; raises on server error lines. The last
        delivered ring sequence is kept on ``self.last_seq`` so a
        dropped stream resumes duplicate-free via
        ``since_seq=client.last_seq + 1``."""
        for obj in self._request({"op": "get_flows", "filter": flt,
                                  "limit": limit, "follow": follow,
                                  "timeout": timeout,
                                  "since_seq": since_seq}):
            if "flow" in obj:
                if "seq" in obj:
                    self.last_seq = obj["seq"]
                yield obj["flow"]
            elif "end" in obj:
                return
            elif "error" in obj:
                raise RuntimeError(obj["error"])
        # the stream closed WITHOUT the end marker (server stopped and
        # severed it): a silently truncated list would be
        # indistinguishable from a complete one
        raise ConnectionError("flow stream truncated before end marker")

    def follow(self, flt: Optional[Dict] = None,
               timeout: float = _MAX_FOLLOW_TIMEOUT) -> Iterator[Dict]:
        """Indefinite follow: re-requests with ``since_seq`` resume each
        time the server's inactivity window lapses (the server caps a
        single request at ``_MAX_FOLLOW_TIMEOUT``)."""
        while True:
            yield from self.get_flows(
                flt=flt, follow=True, timeout=timeout,
                since_seq=(self.last_seq + 1
                           if self.last_seq is not None else None))

    def server_status(self) -> Dict:
        return next(iter(self._request({"op": "server_status"})))

    def peers(self) -> Dict:
        return next(iter(self._request({"op": "peers"})))
