"""kvstore over a Unix socket: the etcd-server analog.

Reference: ``pkg/kvstore`` backed by etcd (SURVEY.md §2.4, §2.7) — the
shared store through which agents, the operator, and clustermesh peers
coordinate across processes. v0 used the in-process
:class:`~cilium_tpu_torch.kvstore.KVStore` ("single-process registry…
pluggable later" — §2.7); this module is the "later": a
:class:`KVStoreServer` serving a local store over length-prefixed JSON
frames, and a :class:`RemoteKVStore` client implementing the same
duck-type interface (set/get/delete/list_prefix, replay-then-follow
prefix watches, TTL leases with keepalive), so ``Agent(kvstore=...)``,
``Operator(...)`` and clustermesh take either transparently.

Run standalone: ``python -m cilium_tpu_torch.kvstore_service /run/kv.sock``.

Protocol (one JSON object per frame, request/response except watches):
  {op: set, key, value, lease?}        → {ok}
  {op: get, key}                       → {value|null}
  {op: delete, key}                    → {deleted: bool}
  {op: delete_prefix, prefix}          → {deleted: N}
  {op: list_prefix, prefix}            → {kv: {...}}
  {op: lease, ttl}                     → {lease: id}
  {op: keepalive, lease}               → {ok|error}
  {op: revoke, lease}                  → {ok}
  {op: revision}                       → {revision: N}
  {op: watch, prefix, replay}          → stream of {event:{typ,key,value}}
A watch connection switches to server-push; the client stops it by
closing the socket (mirroring gRPC stream cancellation).
"""

from __future__ import annotations

import json
import os
import queue
import select
import socket
import socketserver
import struct
import threading
from typing import Callable, Dict, Optional

from cilium_tpu_torch.runtime import simclock
from cilium_tpu_torch.kvstore import Event, KVStore, Lease
from cilium_tpu_torch.runtime.logging import get_logger
from cilium_tpu_torch.runtime.service import recv_msg, send_msg
from cilium_tpu_torch.runtime.unixsock import unlink_if_stale

LOG = get_logger("kvstore")

#: Server-side sweep interval: leases must lapse (and watches fire)
#: even when no client is issuing requests.
EXPIRY_SWEEP_S = 1.0


class KVStoreServer:
    """Serve a (usually fresh) KVStore over a Unix socket."""

    def __init__(self, socket_path: str, store: Optional[KVStore] = None):
        self.store = store if store is not None else KVStore()
        self.socket_path = socket_path
        self._leases: Dict[int, Lease] = {}
        self._lease_lock = threading.Lock()
        self._next_lease = 1
        self._server: Optional[socketserver.ThreadingUnixStreamServer] = None
        self._thread: Optional[threading.Thread] = None
        self._sweeper: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- request handling -------------------------------------------------
    def _lease_of(self, req: Dict) -> Optional[Lease]:
        lid = req.get("lease")
        if lid is None:
            return None
        with self._lease_lock:
            lease = self._leases.get(lid)
        if lease is None:
            raise KeyError(f"unknown lease {lid}")
        return lease

    def handle(self, req: Dict, sock: socket.socket) -> Optional[Dict]:
        """Returns a response dict, or None if the connection became a
        watch stream (the handler then parks on it)."""
        op = req.get("op")
        store = self.store
        if op == "set":
            store.set(req["key"], req["value"], lease=self._lease_of(req))
            return {"ok": True}
        if op == "create":
            return {"created": store.create(req["key"], req["value"],
                                            lease=self._lease_of(req))}
        if op == "get":
            return {"value": store.get(req["key"])}
        if op == "delete":
            return {"deleted": store.delete(req["key"])}
        if op == "delete_prefix":
            return {"deleted": store.delete_prefix(req["prefix"])}
        if op == "list_prefix":
            return {"kv": store.list_prefix(req["prefix"])}
        if op == "lease":
            lease = store.lease(float(req["ttl"]))
            with self._lease_lock:
                lid = self._next_lease
                self._next_lease += 1
                self._leases[lid] = lease
            return {"lease": lid}
        if op == "keepalive":
            # etcd semantics: keepalive on an expired/revoked lease is
            # an error (ErrLeaseNotFound), prompting re-registration —
            # never a silent resurrection
            lease = self._lease_of(req)
            if lease is None or lease.expired():
                raise KeyError("lease expired")
            lease.keepalive()
            return {"ok": True}
        if op == "revoke":
            # unknown lease == already revoked (e.g. after a server
            # restart): deregistration paths must still reach their
            # key deletes, so this is not an error
            with self._lease_lock:
                lease = self._leases.pop(req.get("lease"), None)
            if lease is not None:
                store.revoke(lease)
            return {"ok": True}
        if op == "revision":
            return {"revision": store.revision}
        if op == "watch":
            # Events flow through a bounded queue drained by a
            # dedicated sender thread: the store's dispatch lock is
            # NEVER held across a socket write (a slow consumer must
            # not stall every store mutation), frames can't be torn by
            # a timeout mid-send, and a consumer that falls 4096 events
            # behind is evicted (etcd likewise cancels slow watchers —
            # it re-lists on resubscribe, as our client does).
            events: "queue.Queue" = queue.Queue(maxsize=4096)
            done = threading.Event()

            def push(ev: Event) -> None:
                try:
                    events.put_nowait(ev)
                except queue.Full:
                    done.set()

            def sender() -> None:
                while not done.is_set():
                    try:
                        ev = events.get(timeout=0.2)
                    except queue.Empty:
                        continue
                    try:
                        send_msg(sock, {"event": {
                            "typ": ev.typ, "key": ev.key,
                            "value": ev.value}})
                    except OSError:
                        done.set()

            sender_t = threading.Thread(target=sender, daemon=True,
                                        name="kv-watch-sender")
            sender_t.start()
            watch = store.watch_prefix(req["prefix"], push,
                                       replay=bool(req.get("replay", True)))
            try:
                # park until the client closes its end (stream cancel);
                # select keeps the socket blocking for the sender
                while not done.is_set():
                    readable, _, _ = select.select([sock], [], [], 0.5)
                    if not readable:
                        continue
                    try:
                        if sock.recv(1) == b"":
                            break
                    except OSError:
                        break
            finally:
                watch.stop()
                done.set()
                sender_t.join(timeout=5.0)
            return None
        raise ValueError(f"unknown op {op!r}")

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "KVStoreServer":
        server_self = self
        if os.path.exists(self.socket_path):
            unlink_if_stale(self.socket_path)

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):  # noqa: A003
                try:
                    while True:
                        req = recv_msg(self.request)
                        try:
                            resp = server_self.handle(req, self.request)
                        except Exception as e:
                            resp = {"error": f"{type(e).__name__}: {e}"}
                        if resp is None:
                            return  # watch stream finished
                        send_msg(self.request, resp)
                except (ConnectionError, struct.error, OSError,
                        json.JSONDecodeError):
                    pass

        self._server = socketserver.ThreadingUnixStreamServer(
            self.socket_path, Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="kvstore-server")
        self._thread.start()
        self._sweeper = threading.Thread(target=self._sweep, daemon=True,
                                         name="kvstore-lease-sweep")
        self._sweeper.start()
        LOG.info("kvstore serving", extra={"fields": {
            "socket": self.socket_path}})
        return self

    def _sweep(self) -> None:
        while not simclock.wait_on(self._stop, EXPIRY_SWEEP_S):
            self.store.expire_leases()
            # prune the id registry too, or every expiry/re-register
            # cycle leaks one entry for the life of the server
            with self._lease_lock:
                for lid in [lid for lid, lease in self._leases.items()
                            if lease.expired()]:
                    del self._leases[lid]

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)


# ---------------------------------------------------------------------------


class RemoteLease:
    """Client-side lease proxy. The server owns the truth; the local
    deadline is an estimate used by callers that check ``expired()``
    without a round trip (authoritative checks go through key reads)."""

    def __init__(self, store: "RemoteKVStore", lease_id: int, ttl: float):
        self._store = store
        self.id = lease_id
        self.ttl = ttl
        self.deadline = simclock.now() + ttl
        self.revoked = False

    def keepalive(self) -> None:
        self._store._call({"op": "keepalive", "lease": self.id})
        self.deadline = simclock.now() + self.ttl

    def expired(self, now: Optional[float] = None) -> bool:
        return self.revoked or (now or simclock.now()) > self.deadline


class RemoteWatch:
    """Handle for a streaming watch; ``stop()`` closes the socket and
    joins the reader so no callback is in flight afterwards (same
    contract as the in-process ``Watch.stop``)."""

    def __init__(self, sock: socket.socket, thread: threading.Thread,
                 prefix: str):
        self._sock = sock
        self._thread = thread
        self.prefix = prefix
        self.stopped = False

    def stop(self) -> None:
        self.stopped = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=5.0)


class RemoteKVStore:
    """Duck-type of :class:`cilium_tpu_torch.kvstore.KVStore` over the wire."""

    def __init__(self, socket_path: str, timeout: float = 30.0):
        self.socket_path = socket_path
        self.timeout = timeout
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None

    # -- plumbing ---------------------------------------------------------
    def _connect(self) -> socket.socket:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self.socket_path)
        return sock

    #: ops NOT retried once the request may have reached the server:
    #: a replayed "lease" creates (and leaks) a second server-side
    #: lease; a replayed "delete" reports deleted=False for a delete
    #: that happened; a replayed "create" that applied the first time
    #: reports created=False, which callers would misread as a peer
    #: winning the claim (the identity allocator's id-claim key would
    #: leak as an orphan until operator GC). Everything else is
    #: idempotent.
    _NO_RESEND = frozenset({"lease", "delete", "create"})

    def _call(self, req: Dict) -> Dict:
        with self._lock:
            fresh = self._sock is None
            if fresh:
                self._sock = self._connect()
            try:
                send_msg(self._sock, req)
            except (OSError, ConnectionError):
                # send on a reused connection failed — the server
                # restarted since (agents must survive that, §5.3) and
                # nothing was delivered, so resending is always safe
                if fresh:
                    raise
                self._sock.close()
                self._sock = self._connect()
                send_msg(self._sock, req)
            try:
                resp = recv_msg(self._sock)
            except (OSError, ConnectionError):
                # the request MAY have been applied before the
                # connection died: only idempotent ops get one resend
                self._sock.close()
                self._sock = None
                if req.get("op") in self._NO_RESEND:
                    raise
                self._sock = self._connect()
                send_msg(self._sock, req)
                resp = recv_msg(self._sock)
        if "error" in resp:
            raise KeyError(resp["error"])
        return resp

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None

    # -- kv interface -----------------------------------------------------
    def set(self, key: str, value: str,
            lease: Optional[RemoteLease] = None) -> None:
        req = {"op": "set", "key": key, "value": value}
        if lease is not None:
            req["lease"] = lease.id
        self._call(req)

    def create(self, key: str, value: str,
               lease: Optional[RemoteLease] = None) -> bool:
        req = {"op": "create", "key": key, "value": value}
        if lease is not None:
            req["lease"] = lease.id
        return self._call(req)["created"]

    def get(self, key: str) -> Optional[str]:
        return self._call({"op": "get", "key": key})["value"]

    def delete(self, key: str) -> bool:
        return self._call({"op": "delete", "key": key})["deleted"]

    def delete_prefix(self, prefix: str) -> int:
        return self._call({"op": "delete_prefix",
                           "prefix": prefix})["deleted"]

    def list_prefix(self, prefix: str) -> Dict[str, str]:
        return self._call({"op": "list_prefix", "prefix": prefix})["kv"]

    @property
    def revision(self) -> int:
        return self._call({"op": "revision"})["revision"]

    def lease(self, ttl: float) -> RemoteLease:
        lid = self._call({"op": "lease", "ttl": ttl})["lease"]
        return RemoteLease(self, lid, ttl)

    def revoke(self, lease: RemoteLease) -> None:
        lease.revoked = True
        self._call({"op": "revoke", "lease": lease.id})

    def expire_leases(self) -> int:
        # server-side sweeper owns expiry; nothing to do client-side
        return 0

    def watch_prefix(self, prefix: str,
                     callback: Callable[[Event], None],
                     replay: bool = True) -> RemoteWatch:
        sock = self._connect()
        send_msg(sock, {"op": "watch", "prefix": prefix, "replay": replay})
        watch_box = {}

        def reader() -> None:
            nonlocal sock
            backoff = 0.1
            while True:
                try:
                    while True:
                        msg = recv_msg(sock)
                        ev = msg.get("event")
                        if ev is None:
                            continue
                        w = watch_box.get("w")
                        if w is not None and w.stopped:
                            return
                        backoff = 0.1  # healthy stream
                        callback(Event(ev["typ"], ev["key"], ev["value"]))
                except (OSError, ConnectionError, struct.error,
                        json.JSONDecodeError):
                    pass
                # Stream broke. If the caller stopped us, done;
                # otherwise the server restarted (or evicted us as a
                # slow consumer) — resubscribe WITH replay so missed
                # events surface as a fresh CREATE listing (the
                # reference's ListAndWatch resync; consumers are
                # idempotent against duplicate CREATEs). A watch that
                # dies silently here would leave e.g. an agent blind to
                # podCIDR re-carves forever.
                w = watch_box.get("w")
                if w is None or w.stopped:
                    return
                simclock.sleep(backoff)
                backoff = min(5.0, backoff * 2)
                try:
                    newsock = self._connect()
                    send_msg(newsock, {"op": "watch", "prefix": prefix,
                                       "replay": True})
                except (OSError, ConnectionError):
                    continue  # server still down; keep backing off
                sock = newsock
                w._sock = newsock  # stop() must close the live socket
                if w.stopped:  # stop() raced the swap; don't park
                    newsock.close()
                    return

        thread = threading.Thread(target=reader, daemon=True,
                                  name=f"kv-watch-{prefix}")
        watch = RemoteWatch(sock, thread, prefix)
        watch_box["w"] = watch
        thread.start()
        return watch


def main(argv=None) -> int:  # pragma: no cover - thin wrapper
    import argparse
    import signal

    from cilium_tpu_torch.runtime.logging import setup as setup_logging

    ap = argparse.ArgumentParser(
        description="serve a cilium-tpu kvstore (etcd analog)")
    ap.add_argument("socket", help="unix socket path to serve on")
    args = ap.parse_args(argv)
    setup_logging()
    server = KVStoreServer(args.socket).start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    server.stop()
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
