"""Monitor: datapath event stream with aggregation.

Reference: ``pkg/monitor`` + ``pkg/maps/eventsmap`` (SURVEY.md §2.5) —
the kernel datapath emits ``TraceNotify`` / ``DropNotify`` /
``PolicyVerdictNotify`` / debug events over a perf ring buffer; the
monitor agent decodes them, applies a configurable aggregation level,
and fans them out to listeners (Hubble's parser is the main consumer).

Device mapping: the "perf buffer" is the verdict/match arrays the
engine returns per batch (numpy, one readback a batch, shared with
``hubble.observer.annotate_flows``) — `events_from_outputs` is the
decoder that turns one batch's arrays into typed notification
records. Aggregation levels mirror ``monitorAggregation``: ``none``
emits a TraceNotify per flow, ``medium``/``maximum`` suppress per-flow
traces and keep only verdict/drop events (the reference suppresses to
connection-level trace points).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from cilium_tpu_torch.runtime import simclock
from cilium_tpu_torch.core.flow import Flow, TrafficDirection, Verdict
from cilium_tpu_torch.runtime.metrics import METRICS


class AggregationLevel(enum.IntEnum):
    """``--monitor-aggregation`` levels (reference: none/low/medium/max)."""

    NONE = 0
    LOW = 1
    MEDIUM = 2
    MAXIMUM = 3


class EventType(enum.IntEnum):
    """Perf-event message types (reference: ``monitorAPI.MessageType*``)."""

    DROP = 1
    DEBUG = 2
    CAPTURE = 3
    TRACE = 4
    POLICY_VERDICT = 5


@dataclasses.dataclass(frozen=True)
class MonitorEvent:
    """One decoded notification (union of the reference notify types)."""

    typ: EventType
    ts: float
    src_identity: int
    dst_identity: int
    dport: int
    direction: TrafficDirection
    verdict: Verdict
    #: engine match_spec (which precedence slot matched, -1 = none) —
    #: plays the role of the reference's ``policy_match_type`` +
    #: ``drop_reason`` fields on PolicyVerdictNotify/DropNotify
    match_spec: int = -1
    message: str = ""


def events_from_outputs(flows: Sequence[Flow],
                        outputs: Dict[str, np.ndarray],
                        level: AggregationLevel = AggregationLevel.MEDIUM,
                        ) -> List[MonitorEvent]:
    """Decode one engine batch into monitor events.

    Always emits POLICY_VERDICT per flow (the reference emits
    PolicyVerdictNotify whenever policy evaluation happened) and DROP
    for denied flows; TraceNotify per forwarded flow only below
    MEDIUM aggregation.
    """
    verdicts = np.asarray(outputs["verdict"])
    specs = np.asarray(outputs.get("match_spec",
                                   np.full(len(flows), -1)))
    now = simclock.wall()
    events: List[MonitorEvent] = []
    for i, f in enumerate(flows):
        v = Verdict(int(verdicts[i]))
        spec = int(specs[i]) if i < len(specs) else -1
        events.append(MonitorEvent(
            typ=EventType.POLICY_VERDICT, ts=now,
            src_identity=f.src_identity, dst_identity=f.dst_identity,
            dport=f.dport, direction=f.direction, verdict=v,
            match_spec=spec))
        if v == Verdict.DROPPED:
            events.append(MonitorEvent(
                typ=EventType.DROP, ts=now,
                src_identity=f.src_identity, dst_identity=f.dst_identity,
                dport=f.dport, direction=f.direction, verdict=v,
                match_spec=spec, message="Policy denied"))
        elif level < AggregationLevel.MEDIUM:
            events.append(MonitorEvent(
                typ=EventType.TRACE, ts=now,
                src_identity=f.src_identity, dst_identity=f.dst_identity,
                dport=f.dport, direction=f.direction, verdict=v,
                match_spec=spec))
    return events


class MonitorAgent:
    """Fan-out of monitor events to subscribed listeners.

    Reference: ``pkg/monitor/agent`` — listeners attach in-process
    (Hubble's parser) or over the monitor Unix socket
    (:class:`MonitorServer`, the ``cilium-dbg monitor`` contract).
    Listener callbacks run synchronously in notification order; a
    listener that raises is detached (the reference drops slow/broken
    consumers rather than stalling the pipeline).
    """

    def __init__(self,
                 level: AggregationLevel = AggregationLevel.MEDIUM) -> None:
        self.level = level
        self._lock = threading.Lock()
        self._listeners: List[Callable[[MonitorEvent], None]] = []
        #: raw-batch taps (flows, outputs) — the monitor socket server
        #: attaches here so it can decode at EACH subscriber's
        #: aggregation level instead of the agent's global one
        self._batch_listeners: List[Callable] = []
        self.lost = 0

    def subscribe(self, fn: Callable[[MonitorEvent], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def unsubscribe(self, fn: Callable[[MonitorEvent], None]) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def subscribe_batch(self, fn: Callable) -> None:
        with self._lock:
            self._batch_listeners.append(fn)

    def unsubscribe_batch(self, fn: Callable) -> None:
        with self._lock:
            if fn in self._batch_listeners:
                self._batch_listeners.remove(fn)

    def notify_batch(self, flows: Sequence[Flow],
                     outputs: Dict[str, np.ndarray]) -> List[MonitorEvent]:
        with self._lock:
            batch_listeners = list(self._batch_listeners)
        for fn in batch_listeners:
            try:
                fn(flows, outputs)
            except Exception:
                self.unsubscribe_batch(fn)
                self.lost += 1
        events = events_from_outputs(flows, outputs, self.level)
        with self._lock:
            listeners = list(self._listeners)
        dead = []
        for ev in events:
            METRICS.inc("cilium_tpu_monitor_events_total",
                        labels={"type": ev.typ.name.lower()})
            for fn in listeners:
                if fn in dead:
                    continue
                try:
                    fn(ev)
                except Exception:
                    dead.append(fn)
                    self.lost += 1
        for fn in dead:
            self.unsubscribe(fn)
        return events

    def num_listeners(self) -> int:
        with self._lock:
            return len(self._listeners)


def event_to_dict(ev: MonitorEvent) -> Dict:
    return {
        "type": ev.typ.name,
        "ts": ev.ts,
        "src_identity": ev.src_identity,
        "dst_identity": ev.dst_identity,
        "dport": ev.dport,
        "direction": ev.direction.name,
        "verdict": ev.verdict.name,
        "match_spec": ev.match_spec,
        "message": ev.message,
    }


class MonitorServer:
    """The monitor Unix socket (reference: ``pkg/monitor/agent``'s
    ``monitor.sock`` that ``cilium-dbg monitor`` attaches to).

    Protocol (4-byte big-endian length + JSON frames, the repo's
    shared socket framing): the client sends ONE subscription frame
    ``{"level": "none|low|medium|maximum", "types": ["drop", ...]}``
    (both fields optional; default = the agent's level, all types),
    then receives a stream of event frames (plus an occasional
    ``{"ping": true}`` idle keepalive, which doubles as dead-peer
    detection — consumers skip it). Aggregation is applied
    PER SUBSCRIBER — the server taps raw batches off the MonitorAgent
    and decodes at each client's requested level, so one attached
    debugger can see per-flow traces while the fleet default stays
    MEDIUM. A slow client's queue overflows by DROPPING events with a
    per-client ``lost`` count (the reference's perf-ring overflow
    accounting), never by stalling the verdict pipeline.
    """

    def __init__(self, agent: MonitorAgent, socket_path: str,
                 queue_max: int = 1024):
        import socketserver

        self.agent = agent
        self.socket_path = socket_path
        self.queue_max = queue_max
        self._clients: List["_MonitorClient"] = []
        self._lock = threading.Lock()
        self._server: Optional[
            socketserver.ThreadingUnixStreamServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- batch tap --------------------------------------------------------
    def _on_batch(self, flows, outputs) -> None:
        with self._lock:
            clients = list(self._clients)
        if not clients:
            return
        # decode once per distinct subscribed level (clients at the
        # same level share the event list). NEVER raise: the
        # MonitorAgent detaches a raising batch tap, and this tap is
        # the whole socket feed — one malformed batch must not
        # silently kill monitoring for every subscriber until restart
        by_level: Dict[int, List[MonitorEvent]] = {}
        for c in clients:
            try:
                if c.level not in by_level:
                    by_level[c.level] = events_from_outputs(
                        flows, outputs, AggregationLevel(c.level))
                c.offer(by_level[c.level])
            except Exception:
                c.lost += 1

    def num_clients(self) -> int:
        with self._lock:
            return len(self._clients)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "MonitorServer":
        import os
        import socketserver

        from cilium_tpu_torch.runtime.service import recv_msg, send_msg
        from cilium_tpu_torch.runtime.unixsock import unlink_if_stale

        if os.path.exists(self.socket_path):
            unlink_if_stale(self.socket_path)  # never hijack a live one
        server = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):  # noqa: A003
                try:
                    sub = recv_msg(self.request)
                except Exception:
                    return
                try:
                    # `or`: a JSON null/"" level means "agent default",
                    # not AggregationLevel[str(None)] == NONE
                    level = AggregationLevel[
                        str(sub.get("level")
                            or server.agent.level.name).upper()]
                except KeyError:
                    send_msg(self.request,
                             {"error": f"bad level {sub.get('level')!r}"})
                    return
                types = None
                if sub.get("types"):
                    try:
                        types = {EventType[str(t).upper()]
                                 for t in sub["types"]}
                    except KeyError:
                        send_msg(self.request,
                                 {"error": "bad type in "
                                  f"{sub['types']!r}"})
                        return
                client = _MonitorClient(int(level), types,
                                        server.queue_max)
                send_msg(self.request, {"ok": True,
                                        "level": level.name})
                with server._lock:
                    server._clients.append(client)
                import queue as _queue

                try:
                    while True:
                        try:
                            ev = client.queue.get(timeout=15.0)
                        except _queue.Empty:
                            # idle keepalive: a peer that vanished
                            # between batches is detected HERE (the
                            # send raises) instead of leaking a blocked
                            # handler + queue until the next event
                            send_msg(self.request, {"ping": True})
                            continue
                        if ev is None:
                            return  # server shutting down
                        send_msg(self.request, event_to_dict(ev))
                except OSError:
                    pass  # client went away
                finally:
                    with server._lock:
                        if client in server._clients:
                            server._clients.remove(client)

        self._server = socketserver.ThreadingUnixStreamServer(
            self.socket_path, Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="monitor-server")
        self._thread.start()
        self.agent.subscribe_batch(self._on_batch)
        return self

    def stop(self) -> None:
        import os

        self.agent.unsubscribe_batch(self._on_batch)
        with self._lock:
            clients, self._clients = self._clients, []
        for c in clients:
            c.close()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)


class _MonitorClient:
    """One attached monitor consumer: bounded queue + filters."""

    def __init__(self, level: int, types, queue_max: int):
        import queue

        self.level = level
        self.types = types  # None = all
        self.queue: "queue.Queue" = queue.Queue(maxsize=queue_max)
        self.lost = 0

    def offer(self, events: Sequence[MonitorEvent]) -> None:
        import queue

        for ev in events:
            if self.types is not None and ev.typ not in self.types:
                continue
            try:
                self.queue.put_nowait(ev)
            except queue.Full:
                self.lost += 1

    def close(self) -> None:
        import queue

        # the shutdown sentinel MUST land even on a full queue, or the
        # handler thread blocks in get() forever — drop an event to
        # make room (the client is going away anyway)
        while True:
            try:
                self.queue.put_nowait(None)
                return
            except queue.Full:
                try:
                    self.queue.get_nowait()
                except queue.Empty:
                    pass


class _MonitorStream:
    """Iterator over a subscribed monitor connection. A plain object
    (not a generator) so ``close()`` releases the socket — and the
    server-side subscriber — even if the stream is never iterated."""

    def __init__(self, sock):
        self._sock = sock

    def __iter__(self):
        return self

    def __next__(self) -> Dict:
        from cilium_tpu_torch.runtime.service import recv_msg

        while True:
            try:
                ev = recv_msg(self._sock)
            except Exception:
                self.close()
                raise
            if not ev.get("ping"):  # skip idle keepalive frames
                return ev

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def monitor_follow(socket_path: str,
                   level: Optional[str] = None,
                   types: Optional[Sequence[str]] = None
                   ) -> _MonitorStream:
    """Attach to a monitor socket; returns an iterator of event dicts
    (what ``cilium-tpu monitor`` prints). Subscribes EAGERLY so
    subscription errors surface here and no events are missed before
    the first ``next()``."""
    import socket as _socket

    from cilium_tpu_torch.runtime.service import recv_msg, send_msg

    sock = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
    sock.connect(socket_path)
    sub: Dict = {}
    if level:
        sub["level"] = level
    if types:
        sub["types"] = list(types)
    send_msg(sock, sub)
    ack = recv_msg(sock)
    if "error" in ack:
        sock.close()
        raise ValueError(ack["error"])
    return _MonitorStream(sock)
