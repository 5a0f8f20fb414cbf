"""Request-scoped tracing: the sampled flight recorder (the part of the
reference's ``runtime/tracing.py`` the serving path uses).

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
from typing import Dict, List, Optional, Tuple

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

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0
            self._ingress = 0


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
