"""Request-scoped tracing: the sampled flight recorder (the part of the
reference's ``runtime/tracing.py`` the serving path, the verdict
service, the stream and the REST API's ``/v1/trace`` use).

Every ingress may draw a trace id; the context rides a contextvar
through the layers, and each layer records **phase-attributed spans**
into a bounded ring buffer. The serve loop's pack thread holds no
contextvar for the streams it serves, so it appends the chunk's span BY
trace id (:meth:`Tracer.record_remote`, :meth:`Tracer.event_remote`).

Disarmed cost: ``TRACER.span(...)`` with no active context returns a
shared no-op context manager.
"""

from __future__ import annotations

import contextvars
import threading
import uuid
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from cilium_tpu_torch.runtime import simclock
from cilium_tpu_torch.runtime.metrics import METRICS, TRACE_SPANS

#: canonical phase names
PHASE_QUEUE = "queue-wait"
PHASE_HOST = "host-prep"
PHASE_DEVICE = "device-dispatch"
PHASE_FALLBACK = "oracle-fallback"
#: the request never reached the engine (shed or reaped)
PHASE_SHED = "shed"
PHASES = (PHASE_QUEUE, PHASE_HOST, PHASE_DEVICE, PHASE_FALLBACK,
          PHASE_SHED)

#: trace ids on the wire are exactly this many ascii hex chars
TRACE_ID_CHARS = 16

_CURRENT: "contextvars.ContextVar[Optional[TraceContext]]" = \
    contextvars.ContextVar("cilium_tpu_torch_trace", default=None)


def new_trace_id() -> str:
    return uuid.uuid4().hex[:TRACE_ID_CHARS]


class TraceContext:
    """One sampled request's identity: the trace id plus a span-id
    counter; ``epoch`` orders a trace's spans across hosts."""

    __slots__ = ("trace_id", "name", "t0", "attrs", "_next_span",
                 "epoch")

    def __init__(self, trace_id: str, name: str,
                 attrs: Optional[Dict] = None, epoch: int = 0):
        self.trace_id = trace_id
        self.name = name
        self.t0 = simclock.wall()
        self.attrs = attrs or {}
        self.epoch = int(epoch)
        self._next_span = [0]

    def next_span_id(self) -> int:
        sid = self._next_span[0]
        self._next_span[0] = sid + 1
        return sid

    def members(self) -> Tuple["TraceContext", ...]:
        return (self,)


class GroupContext:
    """A batch's worth of contexts: one measured span fans out to
    every member (a MicroBatcher flush serves many requests; each
    request's trace must still show the batch's device phase)."""

    __slots__ = ("_members",)

    def __init__(self, members: Sequence[TraceContext]):
        self._members = tuple(members)

    @property
    def trace_id(self) -> str:
        # a group is not ONE trace: the first member keeps log lines
        # joinable
        return self._members[0].trace_id if self._members else ""

    def members(self) -> Tuple[TraceContext, ...]:
        return self._members


class _NoopSpan:
    """Shared do-nothing context manager (disarmed path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _SpanCM:
    __slots__ = ("tracer", "ctx", "name", "phase", "attrs", "t0")

    def __init__(self, tracer, ctx, name, phase, attrs):
        self.tracer = tracer
        self.ctx = ctx
        self.name = name
        self.phase = phase
        self.attrs = attrs

    def __enter__(self):
        self.t0 = simclock.wall()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = simclock.wall() - self.t0
        if exc is not None:
            self.attrs = dict(self.attrs,
                              error=f"{exc_type.__name__}: {exc}")
        self.tracer._record(self.ctx, self.name, self.phase,
                            self.t0, dur, self.attrs)
        return False


class Tracer:
    """The flight recorder. One process-global instance
    (:data:`TRACER`); tests build their own."""

    def __init__(self, capacity: int = 4096, sample_rate: float = 1.0,
                 enabled: bool = True):
        self.enabled = bool(enabled)
        self.sample_rate = float(sample_rate)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        #: monotone sampling counter: rate r admits every
        #: round(1/r)-th ingress (deterministic)
        self._ingress = 0
        self.dropped = 0  # records evicted by the ring bound
        #: span ids for by-id (contextvar-less) remote records
        self._remote_span = 1 << 20

    def configure(self, enabled: Optional[bool] = None,
                  sample_rate: Optional[float] = None,
                  capacity: Optional[int] = None) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if sample_rate is not None:
                self.sample_rate = min(1.0, max(0.0, float(sample_rate)))
            if capacity is not None and \
                    int(capacity) != self._ring.maxlen:
                self._ring = deque(self._ring,
                                   maxlen=max(1, int(capacity)))

    # -- trace lifecycle --------------------------------------------------
    def start(self, name: str, trace_id: Optional[str] = None,
              **attrs) -> Optional[TraceContext]:
        """Sampling decision + context creation; ``trace_id`` adopts a
        propagated id. None when not sampled."""
        if not self.enabled:
            return None
        if trace_id is None:
            rate = self.sample_rate
            if rate <= 0.0:
                return None
            if rate < 1.0:
                with self._lock:
                    n = self._ingress
                    self._ingress = n + 1
                if (n % max(1, round(1.0 / rate))) != 0:
                    return None
            trace_id = new_trace_id()
        return TraceContext(trace_id, name, attrs or None)

    def activate(self, ctx) -> "_Activation":
        """``with TRACER.activate(ctx): ...`` — contextvar scope (no-op
        for None, so callers never branch)."""
        return _Activation(ctx)

    def group(self, ctxs: Sequence[Optional[TraceContext]]):
        """Collapse a batch's member contexts: None when none are
        sampled, the single member, or a :class:`GroupContext`."""
        live = [c for c in ctxs if c is not None]
        if not live:
            return None
        if len(live) == 1:
            return live[0]
        return GroupContext(live)

    def trace(self, name: str, trace_id: Optional[str] = None,
              **attrs) -> "_RootTrace":
        """start + activate + a root span recorded on exit:
        ``with TRACER.trace("serve.stream") as ctx``."""
        return _RootTrace(self, name, trace_id, attrs)

    def finish(self, ctx) -> None:
        """Record the root (end-to-end) span for a started context."""
        if ctx is None:
            return
        for m in ctx.members():
            self._record(m, m.name, "", m.t0, simclock.wall() - m.t0,
                         dict(m.attrs, root=True))

    @staticmethod
    def current() -> Optional[TraceContext]:
        return _CURRENT.get()

    @staticmethod
    def current_trace_id() -> str:
        ctx = _CURRENT.get()
        return ctx.trace_id if ctx is not None else ""

    # -- recording --------------------------------------------------------
    def span(self, name: str, phase: str = "", ctx=None, **attrs):
        """Measured span context manager; no-op when no trace is
        active."""
        ctx = ctx if ctx is not None else _CURRENT.get()
        if ctx is None or not self.enabled:
            return _NOOP
        return _SpanCM(self, ctx, name, phase, attrs)

    def add_span(self, ctx, name: str, phase: str,
                 t0: float, dur: float, **attrs) -> None:
        """Record a span with explicit timing — for durations measured
        elsewhere (queue-wait from enqueue stamps)."""
        if ctx is None or not self.enabled:
            return
        self._record(ctx, name, phase, t0, dur, attrs)

    def event(self, name: str, ctx=None, **attrs) -> None:
        """Point-in-time annotation attached to the active trace."""
        ctx = ctx if ctx is not None else _CURRENT.get()
        if ctx is None or not self.enabled:
            return
        now = simclock.wall()
        recs = [{"trace_id": m.trace_id, "span_id": m.next_span_id(),
                 "name": name, "event": True, "ts": round(now, 6),
                 "attrs": attrs} for m in ctx.members()]
        with self._lock:
            self._note_evictions(len(recs))
            self._ring.extend(recs)

    def _record(self, ctx, name, phase, t0, dur, attrs) -> None:
        recs = [{"trace_id": m.trace_id, "span_id": m.next_span_id(),
                 "name": name, "phase": phase, "ts": round(t0, 6),
                 "dur": round(max(0.0, dur), 9),
                 **({"epoch": m.epoch}
                    if getattr(m, "epoch", 0) else {}),
                 **({"attrs": attrs} if attrs else {})}
                for m in ctx.members()]
        with self._lock:
            self._note_evictions(len(recs))
            self._ring.extend(recs)
        METRICS.inc(TRACE_SPANS, len(recs),
                    labels={"phase": phase or "root"})

    def _append_remote(self, rec: Dict, phase: str) -> None:
        with self._lock:
            rec["span_id"] = self._remote_span
            self._remote_span += 1
            self._note_evictions(1)
            self._ring.append(rec)
        METRICS.inc(TRACE_SPANS, labels={"phase": phase or "root"})

    def record_remote(self, trace_id: str, name: str, phase: str = "",
                      t0: Optional[float] = None, dur: float = 0.0,
                      host: str = "", epoch: int = 0,
                      parent: Optional[int] = None, **attrs) -> None:
        """Append a span to a trace BY ID — for code that holds no
        contextvar for the trace (the pack thread resolving another
        stream's ticket). ``host``/``epoch``/``parent`` land as record
        keys only when set."""
        if not self.enabled or not trace_id:
            return
        ts = simclock.wall() if t0 is None else t0
        rec: Dict = {"trace_id": trace_id, "name": name,
                     "phase": phase, "ts": round(ts, 6),
                     "dur": round(max(0.0, dur), 9)}
        if host:
            rec["host"] = host
        if epoch:
            rec["epoch"] = int(epoch)
        if parent is not None:
            rec["parent"] = int(parent)
        if attrs:
            rec["attrs"] = attrs
        self._append_remote(rec, phase)

    def event_remote(self, trace_id: str, name: str, host: str = "",
                     epoch: int = 0, **attrs) -> None:
        """Point-in-time annotation appended BY trace id."""
        if not self.enabled or not trace_id:
            return
        rec: Dict = {"trace_id": trace_id, "name": name,
                     "event": True, "ts": round(simclock.wall(), 6)}
        if host:
            rec["host"] = host
        if epoch:
            rec["epoch"] = int(epoch)
        if attrs:
            rec["attrs"] = attrs
        self._append_remote(rec, "")

    def stitch(self, trace_id: str) -> Dict:
        """One stream's causally-ordered cross-host timeline: every
        record for the trace, ordered by (causal epoch, timestamp) —
        NOT timestamp alone, because a survivor's span can carry an
        earlier wall reading than the dead host's last span — plus
        the distinct hosts that contributed and whether the timeline
        actually crossed a handoff (``stitched``)."""
        recs = self.dump(trace_id=trace_id)
        recs.sort(key=lambda r: (r.get("epoch", 0), r["ts"]))
        hosts: List[str] = []
        for r in recs:
            h = r.get("host") or (r.get("attrs") or {}).get("host")
            if h and h not in hosts:
                hosts.append(h)
        epochs = sorted({int(r.get("epoch", 0)) for r in recs})
        handoff = any(r.get("event") and r["name"] == "fleet.handoff"
                      for r in recs)
        return {
            "trace_id": trace_id,
            "records": recs,
            "hosts": hosts,
            "epochs": epochs,
            "stitched": bool(handoff or len(hosts) > 1
                             or any(epochs[1:])
                             or (epochs and epochs[0] > 0)),
        }

    def _note_evictions(self, incoming: int) -> None:
        room = self._ring.maxlen - len(self._ring)
        if incoming > room:
            self.dropped += incoming - room

    # -- export -----------------------------------------------------------
    def dump(self, trace_id: Optional[str] = None,
             limit: Optional[int] = None) -> List[Dict]:
        """Recorded spans/events (oldest first), optionally one trace's
        and/or the newest ``limit``."""
        with self._lock:
            recs = list(self._ring)
        if trace_id is not None:
            recs = [r for r in recs if r["trace_id"] == trace_id]
        if limit is not None and limit > 0:
            recs = recs[-limit:]
        return recs

    def trace_ids(self) -> List[str]:
        """Distinct trace ids currently in the ring, oldest first."""
        seen: Dict[str, None] = {}
        for r in self.dump():
            seen.setdefault(r["trace_id"], None)
        return list(seen)

    def chrome_trace(self, trace_id: Optional[str] = None) -> Dict:
        """Chrome trace-event JSON (``chrome://tracing`` / Perfetto).
        Each trace renders as its own thread track; phase spans are
        complete ('X') events, trace events are instants ('i')."""
        events = []
        tids: Dict[str, int] = {}
        for r in self.dump(trace_id=trace_id):
            tid = tids.setdefault(r["trace_id"], len(tids) + 1)
            base = {
                "pid": 1,
                "tid": tid,
                "ts": round(r["ts"] * 1e6, 3),
                "name": r["name"],
                "args": dict(r.get("attrs") or {},
                             trace_id=r["trace_id"]),
            }
            if r.get("event"):
                events.append(dict(base, ph="i", s="t"))
            else:
                events.append(dict(base, ph="X",
                                   cat=r.get("phase") or "span",
                                   dur=round(r["dur"] * 1e6, 3)))
        meta = [{"ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
                 "args": {"name": f"trace {tr}"}}
                for tr, tid in tids.items()]
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms"}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0
            self._ingress = 0


class _Activation:
    __slots__ = ("ctx", "_token")

    def __init__(self, ctx):
        self.ctx = ctx

    def __enter__(self):
        self._token = (_CURRENT.set(self.ctx)
                       if self.ctx is not None else None)
        return self.ctx

    def __exit__(self, *exc):
        if self._token is not None:
            _CURRENT.reset(self._token)
        return False


class _RootTrace:
    __slots__ = ("tracer", "name", "trace_id", "attrs", "ctx", "_token")

    def __init__(self, tracer, name, trace_id, attrs):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.attrs = attrs

    def __enter__(self) -> Optional[TraceContext]:
        self.ctx = self.tracer.start(self.name, trace_id=self.trace_id,
                                     **self.attrs)
        self._token = (_CURRENT.set(self.ctx)
                       if self.ctx is not None else None)
        return self.ctx

    def __exit__(self, exc_type, exc, tb):
        if self._token is not None:
            _CURRENT.reset(self._token)
        if self.ctx is not None:
            if exc is not None:
                self.ctx.attrs = dict(self.ctx.attrs,
                                      error=f"{exc_type.__name__}: {exc}")
            self.tracer.finish(self.ctx)
        return False


#: process-global flight recorder (like the metrics registry)
TRACER = Tracer()
