"""Minimal kube-apiserver analog for Cilium CRDs.

Reference: the kube-apiserver surface that ``pkg/k8s/`` (client-go
reflectors + generated cilium.io/v2 clients) is written against
(SURVEY §2.4). What matters for watcher correctness — and what this
module reproduces faithfully — is the *resource semantics*, not HTTP:

* every write bumps a single monotonic ``resourceVersion`` (rv);
* ``list`` returns the items plus the store rv to watch from;
* ``watch`` streams ADDED/MODIFIED/DELETED events strictly after a
  given rv; a watcher asking for history that has been compacted gets
  ``410 Gone`` and must relist (client-go Reflector contract);
* ``update`` with a stale ``metadata.resourceVersion`` fails with a
  conflict (optimistic concurrency);
* ``create`` of an existing object conflicts; ``delete`` returns the
  final state.

Transport is the repo's standard length-prefixed JSON over a Unix
socket (one object per frame; a watch switches the connection to
server-push) — the same substitution PARITY.md records for gRPC.

Run standalone:  ``python -m cilium_tpu_torch.k8s.apiserver /run/k8s.sock``
"""

from __future__ import annotations

import collections
import json
import os
import queue
import select
import socket
import socketserver
import struct
import threading
from typing import Callable, Dict, List, Optional, Tuple

from cilium_tpu_torch.runtime.logging import get_logger
from cilium_tpu_torch.runtime.service import recv_msg, send_msg
from cilium_tpu_torch.runtime.unixsock import unlink_if_stale

LOG = get_logger("k8s-apiserver")

#: plural → (kind, namespaced) for the cilium.io/v2 CRD set
#: (reference: pkg/k8s/apis/cilium.io/v2)
RESOURCES: Dict[str, Tuple[str, bool]] = {
    "ciliumnetworkpolicies": ("CiliumNetworkPolicy", True),
    "ciliumclusterwidenetworkpolicies":
        ("CiliumClusterwideNetworkPolicy", False),
    "ciliumendpoints": ("CiliumEndpoint", True),
    "ciliumidentities": ("CiliumIdentity", False),
    "ciliumnodes": ("CiliumNode", False),
    # v2alpha1 additions (newer reference trees):
    # CiliumCIDRGroup — named CIDR sets policies reference via
    # cidrGroupRef; CiliumEndpointSlice — operator-batched CEPs so
    # watchers scale with slices, not endpoints
    "ciliumcidrgroups": ("CiliumCIDRGroup", False),
    "ciliumendpointslices": ("CiliumEndpointSlice", False),
}

#: watch-history ring size: how many events back a lagging watcher can
#: resume from before being told 410 Gone (etcd compaction analog)
EVENT_RING = 4096


class Conflict(Exception):
    """409: create-exists or stale-resourceVersion update."""


class NotFound(Exception):
    """404: unknown resource or object."""


class WatchGone(Exception):
    """410: requested resourceVersion compacted away — relist."""


def _key(namespace: str, name: str) -> Tuple[str, str]:
    return (namespace or "", name)


class ResourceStore:
    """The typed object store + watch ring behind the server.

    Thread-safe; watch callbacks are delivered under a dispatch lock so
    a replay and the live stream can never interleave out of order
    (same discipline as kvstore.KVStore.watch_prefix).
    """

    def __init__(self):
        import uuid

        #: instance identity (etcd cluster-id analog): a watch resumed
        #: against a DIFFERENT store instance must get 410 Gone, not a
        #: silent no-event resume — a fresh store restarts its rv
        #: counter, so a stale reflector's rv can coincidentally be
        #: "valid" here while meaning a completely different history
        self.instance = uuid.uuid4().hex
        self._lock = threading.Lock()
        self._dispatch = threading.Lock()
        # plural → {(ns, name) → obj}
        self._objs: Dict[str, Dict[Tuple[str, str], Dict]] = {
            p: {} for p in RESOURCES}
        self._rv = 0
        self._uid = 0
        # (rv, type, plural, obj-snapshot); oldest evicted rv for Gone
        self._events: collections.deque = collections.deque(
            maxlen=EVENT_RING)
        self._compacted_rv = 0
        self._watches: List["_Watch"] = []

    # -- object plumbing --------------------------------------------------
    def _check(self, plural: str) -> Tuple[str, bool]:
        try:
            return RESOURCES[plural]
        except KeyError:
            raise NotFound(f"unknown resource {plural!r}") from None

    def _stamp_new(self, plural: str, obj: Dict) -> Dict:
        kind, namespaced = self._check(plural)
        obj = json.loads(json.dumps(obj))  # defensive deep copy
        meta = obj.setdefault("metadata", {})
        if not meta.get("name"):
            raise ValueError("metadata.name required")
        if namespaced:
            meta.setdefault("namespace", "default")
        else:
            meta.pop("namespace", None)
        obj.setdefault("apiVersion", "cilium.io/v2")
        obj.setdefault("kind", kind)
        self._uid += 1
        meta["uid"] = f"uid-{self._uid}"
        meta["generation"] = 1
        return obj

    def _emit_locked(self, typ: str, plural: str, obj: Dict) -> None:
        """Caller holds self._lock; records the event and snapshots the
        watch list. Delivery happens outside self._lock (under the
        dispatch lock) via the returned closure pattern below."""
        self._rv += 1
        obj["metadata"]["resourceVersion"] = str(self._rv)
        snap = json.loads(json.dumps(obj))
        if len(self._events) == self._events.maxlen:
            self._compacted_rv = self._events[0][0]
        self._events.append((self._rv, typ, plural, snap))

    def _deliver_locked(self, typ: str, plural: str, obj: Dict) -> None:
        """Caller holds self._dispatch (NOT self._lock): push to the
        watches registered for `plural`. Emission (rv stamping) and
        delivery happen inside ONE dispatch critical section per write
        — two concurrent writes delivering in separate sections could
        reach watchers out of rv order, making informers cache the
        stale object (its event arrives last) until a relist, and a
        registering watch could see a just-emitted event twice
        (backlog + live)."""
        with self._lock:
            watches = [w for w in self._watches if w.plural == plural]
        ev = {"type": typ, "object": obj}
        for w in watches:
            w.push(ev)

    # -- verbs ------------------------------------------------------------
    def list(self, plural: str, namespace: Optional[str] = None) -> Dict:
        self._check(plural)
        with self._lock:
            items = [json.loads(json.dumps(o))
                     for (ns, _), o in sorted(self._objs[plural].items())
                     if namespace is None or ns == (namespace or "")]
            return {"items": items, "resource_version": str(self._rv),
                    "instance": self.instance}

    def get(self, plural: str, namespace: str, name: str) -> Dict:
        self._check(plural)
        with self._lock:
            obj = self._objs[plural].get(_key(namespace, name))
            if obj is None:
                raise NotFound(f"{plural} {namespace}/{name}")
            return json.loads(json.dumps(obj))

    def create(self, plural: str, obj: Dict) -> Dict:
        obj = self._stamp_new(plural, obj)
        meta = obj["metadata"]
        k = _key(meta.get("namespace", ""), meta["name"])
        with self._dispatch:
            with self._lock:
                if k in self._objs[plural]:
                    raise Conflict(f"{plural} {k[0]}/{k[1]} exists")
                self._emit_locked("ADDED", plural, obj)
                self._objs[plural][k] = obj
                snap = json.loads(json.dumps(obj))
            self._deliver_locked("ADDED", plural, snap)
        return snap

    def update(self, plural: str, obj: Dict) -> Dict:
        kind, namespaced = self._check(plural)
        obj = json.loads(json.dumps(obj))
        meta = obj.setdefault("metadata", {})
        if not meta.get("name"):
            raise ValueError("metadata.name required")
        # same namespace handling as _stamp_new: a namespace-less
        # object of a namespaced kind lives in "default" (so apply =
        # create → update resolves to the SAME key on both verbs), and
        # a cluster-scoped object can never pick up a namespace
        if namespaced:
            meta.setdefault("namespace", "default")
        else:
            meta.pop("namespace", None)
        k = _key(meta["namespace"] if namespaced else "", meta["name"])
        with self._dispatch:
            with self._lock:
                cur = self._objs[plural].get(k)
                if cur is None:
                    raise NotFound(f"{plural} {k[0]}/{k[1]}")
                want_rv = meta.get("resourceVersion")
                if want_rv is not None and \
                        want_rv != cur["metadata"]["resourceVersion"]:
                    raise Conflict(
                        f"{plural} {k[1]}: stale resourceVersion "
                        f"{want_rv} (current "
                        f"{cur['metadata']['resourceVersion']})")
                # carry immutable metadata; bump generation on change
                for field in ("uid", "generation"):
                    meta[field] = cur["metadata"][field]
                obj.setdefault("apiVersion", "cilium.io/v2")
                obj.setdefault("kind", kind)
                if any(obj.get(f) != cur.get(f)
                       for f in ("spec", "specs")):
                    meta["generation"] = \
                        cur["metadata"]["generation"] + 1
                self._emit_locked("MODIFIED", plural, obj)
                self._objs[plural][k] = obj
                snap = json.loads(json.dumps(obj))
            self._deliver_locked("MODIFIED", plural, snap)
        return snap

    def delete(self, plural: str, namespace: str, name: str) -> Dict:
        self._check(plural)
        k = _key(namespace, name)
        with self._dispatch:
            with self._lock:
                obj = self._objs[plural].pop(k, None)
                if obj is None:
                    raise NotFound(f"{plural} {k[0]}/{k[1]}")
                self._emit_locked("DELETED", plural, obj)
                snap = json.loads(json.dumps(obj))
            self._deliver_locked("DELETED", plural, snap)
        return snap

    # -- watch ------------------------------------------------------------
    def watch(self, plural: str, since_rv: str,
              callback: Callable[[Dict], None],
              instance: Optional[str] = None) -> "_Watch":
        """Register a watch delivering every event with rv > since_rv.

        Raises WatchGone when `since_rv` predates the retained history,
        comes from a different store instance, or lies in the future
        (both mean the caller's rv belongs to another history) — the
        410 the Reflector relists on. Replay and registration are
        atomic under the dispatch lock, so no event is missed between
        the history scan and going live."""
        self._check(plural)
        if instance is not None and instance != self.instance:
            raise WatchGone("apiserver instance changed — relist")
        since = int(since_rv)
        with self._lock:
            if since > self._rv:
                raise WatchGone(
                    f"resourceVersion {since} is in the future "
                    f"(current {self._rv}) — relist")
        w = _Watch(self, plural, callback)
        with self._dispatch:
            with self._lock:
                if since < self._compacted_rv:
                    raise WatchGone(
                        f"resourceVersion {since} compacted "
                        f"(oldest retained {self._compacted_rv})")
                backlog = [(t, o) for (rv, t, p, o) in self._events
                           if p == plural and rv > since]
                self._watches.append(w)
            for typ, obj in backlog:
                w.push({"type": typ, "object": obj})
        return w

    def unwatch(self, w: "_Watch") -> None:
        with self._lock:
            if w in self._watches:
                self._watches.remove(w)


class _Watch:
    def __init__(self, store: ResourceStore, plural: str,
                 callback: Callable[[Dict], None]):
        self.store = store
        self.plural = plural
        self.push = callback

    def stop(self) -> None:
        self.store.unwatch(self)


class APIServer:
    """Serve a ResourceStore over a Unix socket."""

    def __init__(self, socket_path: str,
                 store: Optional[ResourceStore] = None):
        self.store = store if store is not None else ResourceStore()
        self.socket_path = socket_path
        self._server: Optional[socketserver.ThreadingUnixStreamServer] \
            = None
        self._thread: Optional[threading.Thread] = None
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    def handle(self, req: Dict, sock: socket.socket) -> Optional[Dict]:
        op = req.get("op")
        store = self.store
        if op == "list":
            return store.list(req["plural"], req.get("namespace"))
        if op == "get":
            return {"object": store.get(req["plural"],
                                        req.get("namespace", ""),
                                        req["name"])}
        if op == "create":
            return {"object": store.create(req["plural"], req["object"])}
        if op == "update":
            return {"object": store.update(req["plural"], req["object"])}
        if op == "delete":
            return {"object": store.delete(req["plural"],
                                           req.get("namespace", ""),
                                           req["name"])}
        if op == "watch":
            # same slow-consumer discipline as kvstore_service: events
            # ride a bounded queue drained by a sender thread; a
            # watcher 4096 events behind is evicted (it relists — the
            # apiserver likewise closes too-slow watches)
            events: "queue.Queue" = queue.Queue(maxsize=EVENT_RING)
            done = threading.Event()

            def push(ev: Dict) -> None:
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
                        send_msg(sock, {"event": ev})
                    except OSError:
                        done.set()

            try:
                watch = store.watch(req["plural"],
                                    str(req.get("resource_version", "0")),
                                    push,
                                    instance=req.get("instance"))
            except WatchGone as e:
                send_msg(sock, {"gone": str(e)})
                return None
            sender_t = threading.Thread(target=sender, daemon=True,
                                        name="k8s-watch-sender")
            sender_t.start()
            try:
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

    def start(self) -> "APIServer":
        server_self = self
        if os.path.exists(self.socket_path):
            unlink_if_stale(self.socket_path)

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):  # noqa: A003
                with server_self._conns_lock:
                    server_self._conns.add(self.request)
                try:
                    while True:
                        req = recv_msg(self.request)
                        try:
                            resp = server_self.handle(req, self.request)
                        except (Conflict, NotFound, ValueError) as e:
                            resp = {"error": f"{type(e).__name__}: {e}",
                                    "reason": type(e).__name__}
                        except Exception as e:  # noqa: BLE001
                            resp = {"error": f"{type(e).__name__}: {e}"}
                        if resp is None:
                            return  # watch stream finished
                        send_msg(self.request, resp)
                except (ConnectionError, struct.error, OSError,
                        json.JSONDecodeError):
                    pass
                finally:
                    with server_self._conns_lock:
                        server_self._conns.discard(self.request)

        self._server = socketserver.ThreadingUnixStreamServer(
            self.socket_path, Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="k8s-apiserver")
        self._thread.start()
        LOG.info("k8s apiserver serving", extra={"fields": {
            "socket": self.socket_path}})
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        # a dead apiserver closes its connections: established watch
        # streams must break so Reflectors notice and relist
        with self._conns_lock:
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass


class K8sClient:
    """Typed client for the apiserver socket (generated-client analog).

    One short-lived connection per request; ``watch`` hands the socket
    to the caller's callback loop (the Informer drives reconnection —
    matching the Reflector/client split in client-go)."""

    def __init__(self, socket_path: str, timeout: float = 30.0):
        self.socket_path = socket_path
        self.timeout = timeout

    def _request(self, req: Dict) -> Dict:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        try:
            sock.connect(self.socket_path)
            send_msg(sock, req)
            resp = recv_msg(sock)
        finally:
            sock.close()
        if "error" in resp:
            reason = resp.get("reason")
            exc = {"Conflict": Conflict, "NotFound": NotFound}.get(
                reason, RuntimeError)
            raise exc(resp["error"])
        return resp

    def list(self, plural: str,
             namespace: Optional[str] = None) -> Dict:
        return self._request({"op": "list", "plural": plural,
                              "namespace": namespace})

    @staticmethod
    def _default_ns(plural: str, namespace: Optional[str]) -> str:
        if namespace is not None:
            return namespace
        _, namespaced = RESOURCES.get(plural, ("", False))
        return "default" if namespaced else ""

    def get(self, plural: str, name: str,
            namespace: Optional[str] = None) -> Dict:
        return self._request({"op": "get", "plural": plural,
                              "namespace": self._default_ns(
                                  plural, namespace),
                              "name": name})["object"]

    def create(self, plural: str, obj: Dict) -> Dict:
        return self._request({"op": "create", "plural": plural,
                              "object": obj})["object"]

    def update(self, plural: str, obj: Dict) -> Dict:
        return self._request({"op": "update", "plural": plural,
                              "object": obj})["object"]

    def apply(self, plural: str, obj: Dict) -> Dict:
        """Create-or-update (kubectl apply): retries the races both
        directions so concurrent appliers converge."""
        try:
            return self.create(plural, obj)
        except Conflict:
            pass
        meta = obj.get("metadata", {})
        try:
            cur = self.get(plural, meta.get("name", ""),
                           meta.get("namespace"))
        except NotFound:
            return self.create(plural, obj)  # deleted in between
        merged = json.loads(json.dumps(obj))
        merged.setdefault("metadata", {})["resourceVersion"] = \
            cur["metadata"]["resourceVersion"]
        return self.update(plural, merged)

    def delete(self, plural: str, name: str,
               namespace: Optional[str] = None) -> Dict:
        return self._request({"op": "delete", "plural": plural,
                              "namespace": self._default_ns(
                                  plural, namespace),
                              "name": name})["object"]

    def watch_socket(self, plural: str, resource_version: str,
                     instance: Optional[str] = None) -> socket.socket:
        """Open a watch stream; caller reads frames with recv_msg and
        closes the socket to cancel. A ``{"gone": ...}`` frame means
        relist (410). Pass the ``instance`` from the list being resumed
        so a restarted (different-history) server is detected instead
        of silently resuming on a coincidentally-valid rv."""
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self.socket_path)
        send_msg(sock, {"op": "watch", "plural": plural,
                        "resource_version": resource_version,
                        "instance": instance})
        return sock


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import signal

    ap = argparse.ArgumentParser(
        description="cilium_tpu fake kube-apiserver (CRD store with "
                    "list/watch semantics)")
    ap.add_argument("socket", help="unix socket path to serve")
    args = ap.parse_args(argv)
    server = APIServer(args.socket).start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
