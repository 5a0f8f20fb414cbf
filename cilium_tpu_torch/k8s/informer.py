"""Reflector/Informer analog (client-go ``cache.NewInformer``).

Reference: ``pkg/k8s`` builds its CNP/CCNP/endpoint watchers on
client-go reflectors — ListAndWatch: list the resource, sync the local
store (emitting deltas), then watch from the list's resourceVersion;
any stream break or 410 Gone restarts the cycle with a fresh list.
Handlers therefore see an eventually-consistent add/update/delete
stream that survives apiserver restarts and watch compaction, and
consumers must be idempotent — exactly the contract the agent's policy
repository upsert path expects (SURVEY §3.2).

Where the port differs from the reference: ``stop()`` shuts its watch
socket down before closing it, which wakes the reader blocked in
``recv``; the reference's bare ``close()`` does not, so its stop waits
out the 5 s join.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Callable, Dict, Optional, Tuple

from cilium_tpu_torch.runtime import simclock
from cilium_tpu_torch.k8s.apiserver import K8sClient
from cilium_tpu_torch.runtime.logging import get_logger
from cilium_tpu_torch.runtime.service import recv_msg

LOG = get_logger("k8s-informer")

Handler = Callable[[Dict], None]
UpdateHandler = Callable[[Dict, Dict], None]


def _key(obj: Dict) -> Tuple[str, str]:
    meta = obj.get("metadata", {})
    return (meta.get("namespace", ""), meta.get("name", ""))


class Informer:
    """List+watch one resource, maintaining a local store and firing
    on_add(obj) / on_update(old, new) / on_delete(obj).

    ``start()`` performs the initial list SYNCHRONOUSLY (the agent
    needs policy fully synced before the first verdict — client-go's
    WaitForCacheSync), then follows asynchronously.
    """

    def __init__(self, client: K8sClient, plural: str,
                 on_add: Optional[Handler] = None,
                 on_update: Optional[UpdateHandler] = None,
                 on_delete: Optional[Handler] = None,
                 sync_timeout: float = 30.0):
        self.client = client
        self.plural = plural
        self.on_add = on_add
        self.on_update = on_update
        self.on_delete = on_delete
        self.sync_timeout = sync_timeout
        self.store: Dict[Tuple[str, str], Dict] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sock: Optional[socket.socket] = None
        #: the store instance the last list came from; sent with every
        #: watch so a restarted server (fresh rv history) yields an
        #: immediate 410 instead of a silent wrong-history resume
        self._instance: Optional[str] = None
        #: bumped on every completed relist; tests use it to await sync
        self.list_count = 0

    # -- delta plumbing ---------------------------------------------------
    def _fire_add(self, obj: Dict) -> None:
        if self.on_add is not None:
            self.on_add(obj)

    def _fire_update(self, old: Dict, new: Dict) -> None:
        if self.on_update is not None:
            self.on_update(old, new)
        elif self.on_add is not None:
            self.on_add(new)  # add-only consumers treat update as add

    def _fire_delete(self, obj: Dict) -> None:
        if self.on_delete is not None:
            self.on_delete(obj)

    def _sync_list(self) -> str:
        """List and reconcile the local store, emitting deltas — a
        relist after a gap must surface as adds/updates/deletes, never
        as a silent store swap (that is where reference watchers get
        their crash-consistency from)."""
        resp = self.client.list(self.plural)
        self._instance = resp.get("instance")
        fresh = {_key(o): o for o in resp["items"]}
        with self._lock:
            known = dict(self.store)
            self.store = fresh
        for k, obj in fresh.items():
            old = known.pop(k, None)
            if old is None:
                self._fire_add(obj)
            elif old["metadata"]["resourceVersion"] != \
                    obj["metadata"]["resourceVersion"]:
                self._fire_update(old, obj)
        for obj in known.values():
            self._fire_delete(obj)
        self.list_count += 1
        return resp["resource_version"]

    def _apply_event(self, ev: Dict) -> None:
        typ, obj = ev["type"], ev["object"]
        k = _key(obj)
        with self._lock:
            old = self.store.get(k)
            if typ == "DELETED":
                self.store.pop(k, None)
            else:
                self.store[k] = obj
        if typ == "DELETED":
            if old is not None:
                self._fire_delete(old)
        elif old is None:
            self._fire_add(obj)
        elif old["metadata"]["resourceVersion"] != \
                obj["metadata"]["resourceVersion"]:
            self._fire_update(old, obj)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "Informer":
        # synchronous first sync, retried with backoff: an agent
        # starting alongside (or slightly before) the apiserver is a
        # normal boot-order race, not a fatal error — the reference
        # blocks in WaitForCacheSync the same way
        deadline = simclock.now() + self.sync_timeout
        backoff = 0.1
        while True:
            try:
                rv = self._sync_list()
                break
            except (OSError, ConnectionError, RuntimeError):
                if simclock.now() >= deadline:
                    raise
                simclock.sleep(backoff)
                backoff = min(2.0, backoff * 2)
        self._thread = threading.Thread(
            target=self._run, args=(rv,), daemon=True,
            name=f"informer-{self.plural}")
        self._thread.start()
        return self

    def _run(self, rv: str) -> None:
        backoff = 0.1
        while not self._stop.is_set():
            try:
                sock = self.client.watch_socket(self.plural, rv,
                                                self._instance)
            except OSError:
                if simclock.wait_on(self._stop, backoff):
                    return
                backoff = min(5.0, backoff * 2)
                continue
            self._sock = sock
            try:
                while not self._stop.is_set():
                    msg = recv_msg(sock)
                    if "gone" in msg:
                        raise _Relist  # compacted: list again
                    ev = msg.get("event")
                    if ev is None:
                        continue
                    backoff = 0.1
                    self._apply_event(ev)
                    rv = ev["object"]["metadata"]["resourceVersion"]
            except _Relist:
                pass
            except (OSError, ConnectionError, struct.error,
                    json.JSONDecodeError):
                pass
            finally:
                self._sock = None
                try:
                    sock.close()
                except OSError:
                    pass
            if simclock.wait_on(self._stop, backoff):
                return
            backoff = min(5.0, backoff * 2)
            # stream broke or history compacted: ListAndWatch again
            while not self._stop.is_set():
                try:
                    rv = self._sync_list()
                    break
                except (OSError, ConnectionError, RuntimeError):
                    if simclock.wait_on(self._stop, backoff):
                        return
                    backoff = min(5.0, backoff * 2)

    def stop(self) -> None:
        self._stop.set()
        sock = self._sock
        if sock is not None:
            try:
                # shutdown, then close: a bare close() does not wake a
                # recv blocked in another thread, which would then
                # hold stop() for the join's full timeout
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()  # unblock recv_msg
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class _Relist(Exception):
    pass
