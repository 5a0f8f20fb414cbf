"""Verdict service: Unix-socket server + micro-batcher + policy bridge
(the reference's ``runtime/service.py``), serving the port's ``Loader``.

The proxy side reaches the verdict engine over one Unix socket speaking
4-byte-length-prefixed JSON: the C++ shim (``shim/``), the proxylib
parsers and the chunked binary stream (``runtime/stream.py``) are its
clients.

Protocol (request → response):
  {"op": "ping"}                       → {"ok": true, "revision": N}
  {"op": "verdict", "flows": [flowpb-ish dicts]}
                                       → {"verdicts": [1|2|5, ...]}
  {"op": "check", "flow": {...}}       → {"verdict": 1|2|5}   (batched)
  {"op": "on_new_connection", "proto": "kafka", "conn": 7,
   "ingress": true, "src": 1001, "dst": 1002, "dport": 9092}
                                       → {"ok": true}
  {"op": "on_data", "conn": 7, "reply": false, "end": false,
   "data_b64": "..."}                  → {"ops": [[op, n], ...]}
  {"op": "stream_start", ...}          → the connection becomes a stream

Micro-batching: single-record policy checks are queued and flushed to
the engine either when ``batch_max`` records are pending or after
``deadline_ms`` — p99 latency traded for fuller device batches.

Where the port differs from the reference:

* "is this a device engine?" is ``isinstance(engine,
  TorchVerdictEngine)`` (the reference tests for a JAX-only attribute):
  the breaker, the serve loop and the stream's session route all key on
  it;
* two kinds of error pass the breaker (:func:`passes_breaker`): a
  ``NotImplementedError`` — what the port does not serve yet, such as
  the ``autotune`` scan-arm pick (queue 1's Q6) — and a kernel failure (a
  hand-written kernel that did not build, load or launch, or a fault
  CUDA reported). Each is an error response (a ``check``'s included),
  never a trip or an oracle verdict: the CPU does not answer for a
  kernel that failed on the card;
* the socket's listen backlog is ``SOMAXCONN``, not socketserver's 5:
  16 clients connecting at once saw ``EAGAIN`` on the H100's host;
* no agent is attached (queue 1's Q13): ``policy_get`` and ``bugtool``
  answer ``"no agent attached"``, and ``profile`` (which needs
  ``runtime/profiling.py``) answers an error naming its queue item.
"""

from __future__ import annotations

import base64
import inspect
import json
import os
import socket
import socketserver
import struct
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from cilium_tpu_torch.core.flow import (
    DNSInfo,
    Flow,
    GenericL7Info,
    HTTPInfo,
    KafkaInfo,
    L7Type,
    Protocol,
    TrafficDirection,
    Verdict,
)
from cilium_tpu_torch.engine import _build
from cilium_tpu_torch.engine.verdict import TorchVerdictEngine
from cilium_tpu_torch.ingest.hubble import flow_from_dict
from cilium_tpu_torch.proxylib.parser import Connection, create_parser
from cilium_tpu_torch.runtime import admission, faults, simclock
from cilium_tpu_torch.runtime.logging import get_logger
from cilium_tpu_torch.runtime.metrics import (
    ADMISSION_REAPED,
    BREAKER_FALLBACK_VERDICTS,
    BREAKER_RECOVERIES,
    BREAKER_STATE,
    BREAKER_TRIPS,
    DRAINS,
    METRICS,
    MICROBATCH_SECONDS,
    MICROBATCH_SIZE,
    NPDS_PULLS,
    POLICY_L7,
    SERVICE_VERDICTS,
)
from cilium_tpu_torch.runtime.tracing import (
    PHASE_FALLBACK,
    PHASE_QUEUE,
    PHASE_SHED,
    TRACER,
)

LOG = get_logger("service")

#: fires between stop-admitting and the pending flush in
#: VerdictService.drain — a crash mid-drain leaves the gate draining
#: (not half-open); the operator retries the drain
DRAIN_POINT = faults.register_point(
    "service.drain", "drain sequence in VerdictService.drain")

#: the answer of the ``profile`` op until ``runtime/profiling.py`` is
#: ported
_PROFILE_UNPORTED = ("profile: runtime/profiling.py is not ported yet; "
                     "it arrives with the tooling and agent slices "
                     "(queue 1, Q12/Q13)")


def verdict_flows_padded(engine, flows: Sequence[Flow],
                         authed_pairs=None) -> List[int]:
    """``engine.verdict_flows`` with the batch padded to the next
    power of two: service traffic produces arbitrary batch sizes, and
    pow2 bucketing bounds the shapes the engine sees to ~log2(batch_max)
    sizes. Pad flows are identity-0 tuples; their verdicts are sliced
    off. Only the verdict lane is read back."""
    return [int(v) for v in
            verdict_outputs_padded(engine, flows,
                                   authed_pairs=authed_pairs,
                                   outputs=("verdict",))["verdict"]]


def verdict_outputs_padded(engine, flows: Sequence[Flow],
                           authed_pairs=None, outputs=None):
    """Full output lanes under the same pow2 padding (every lane sliced
    back to the real batch). ``outputs`` limits which lanes are read
    back."""
    n = len(flows)
    target = 1 << max(0, n - 1).bit_length()
    if target > n:
        flows = list(flows) + [Flow()] * (target - n)
    # the blob transport (one H2D per batch instead of seven) exists on
    # the device engine only; the oracle has no transfers to save
    fn = getattr(engine, "verdict_flows_blob", engine.verdict_flows)
    out = fn(flows, authed_pairs=authed_pairs, outputs=outputs)
    return {k: np.asarray(v)[:n] for k, v in out.items()}


def passes_breaker(exc: BaseException) -> bool:
    """Is ``exc`` an error that the breaker lets through rather than
    count as a device failure? An input the port does not serve yet
    (``NotImplementedError``), or a kernel failure
    (:func:`_build.is_kernel_failure`). What the breaker absorbs is the
    rest: the ``engine.dispatch`` fault, and other dispatch failures
    such as running out of device memory."""
    return isinstance(exc, NotImplementedError) or \
        _build.is_kernel_failure(exc)


class CircuitBreaker:
    """Device-lane circuit breaker: CLOSED routes verdicts to the
    device engine; ``failure_threshold`` CONSECUTIVE dispatch failures
    trip it OPEN (every verdict then rides the CPU oracle — correct but
    slower); after ``probe_interval`` seconds one request is let
    through HALF_OPEN as a probe — success recovers to CLOSED, failure
    re-opens and re-arms the probe timer.

    Thread-safe; the MicroBatcher drain workers, the bulk "verdict" op
    and the stream sessions all share one instance. ``clock`` is
    injectable; the default follows the process clock
    (``runtime/simclock.py``)."""

    CLOSED, OPEN, HALF_OPEN = 0, 1, 2
    _NAMES = {0: "closed", 1: "open", 2: "half-open"}

    def __init__(self, failure_threshold: int = 3,
                 probe_interval: float = 5.0, clock=None):
        self.failure_threshold = max(1, int(failure_threshold))
        self.probe_interval = float(probe_interval)
        self.clock = clock if clock is not None else simclock.now
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        #: (event, state-name) transition log
        self.events: List = []
        METRICS.set_gauge(BREAKER_STATE, float(self.CLOSED))

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def _transition(self, state: int, event: str) -> None:
        self._state = state
        self.events.append((event, self._NAMES[state]))
        METRICS.set_gauge(BREAKER_STATE, float(state))

    def allow_primary(self) -> bool:
        """May this request try the device lane? OPEN returns False
        until the probe timer expires, then exactly one caller gets
        True as the HALF_OPEN probe."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN and \
                    self.clock() - self._opened_at >= self.probe_interval:
                self._transition(self.HALF_OPEN, "probe")
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._transition(self.CLOSED, "recover")
                METRICS.inc(BREAKER_RECOVERIES)
            self._consecutive_failures = 0

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if self._state == self.HALF_OPEN:
                # failed probe: back to OPEN, re-arm the timer
                self._opened_at = self.clock()
                self._transition(self.OPEN, "probe-failed")
            elif (self._state == self.CLOSED
                  and self._consecutive_failures
                  >= self.failure_threshold):
                self._opened_at = self.clock()
                self._transition(self.OPEN, "trip")
                METRICS.inc(BREAKER_TRIPS)

    def release_probe(self) -> None:
        """The probe's request ended in an error the breaker lets
        through (:func:`passes_breaker`): neither success nor failure.
        Back to OPEN with the timer still expired, so the next request
        probes."""
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._transition(self.OPEN, "probe-released")


class ResilientVerdictor:
    """The degraded-mode verdict pipeline: device engine behind a
    :class:`CircuitBreaker`, CPU oracle (``Loader.fallback_engine``) as
    the always-correct fallback. Every verdict path of the service
    (MicroBatcher, the bulk "verdict" op, stream sessions) routes
    through one instance.

    When the active engine already is the oracle (gate off) the breaker
    never engages — there is no faster lane to trip from."""

    def __init__(self, loader, breaker: Optional[CircuitBreaker] = None,
                 authed_pairs_fn=None):
        self.loader = loader
        cfg = getattr(loader.config, "breaker", None)
        if breaker is None:
            breaker = CircuitBreaker(
                failure_threshold=getattr(cfg, "failure_threshold", 3),
                probe_interval=getattr(cfg, "probe_interval", 5.0))
        self.breaker = breaker
        self.enabled = getattr(cfg, "enabled", True)
        self.authed_pairs_fn = authed_pairs_fn

    @staticmethod
    def _device_backed(engine) -> bool:
        return isinstance(engine, TorchVerdictEngine)

    def _pairs(self, authed_pairs):
        if authed_pairs is not None:
            return authed_pairs
        return (self.authed_pairs_fn()
                if self.authed_pairs_fn is not None else None)

    # -- breaker bookkeeping shared with StreamSession ------------------
    def allow_device(self, engine) -> bool:
        if not self.enabled or not self._device_backed(engine):
            return True
        return self.breaker.allow_primary()

    def on_device_success(self) -> None:
        if self.enabled:
            self.breaker.record_success()

    def on_passed(self) -> None:
        """The request raised an error the breaker lets through
        (:func:`passes_breaker`): not counted as a device failure; a
        probe it held is released."""
        if self.enabled:
            self.breaker.release_probe()

    def on_device_failure(self, exc: BaseException) -> None:
        if self.enabled:
            self.breaker.record_failure()
        TRACER.event("device.failure",
                     error=f"{type(exc).__name__}: {exc}")
        LOG.warning("device verdict lane failed; serving via oracle",
                    extra={"fields": {
                        "error": f"{type(exc).__name__}: {exc}"}})

    def fallback_outputs(self, flows: Sequence[Flow], authed_pairs=None,
                         outputs=None):
        """Oracle lane, with the fallback counter."""
        METRICS.inc(BREAKER_FALLBACK_VERDICTS, len(flows))
        with TRACER.span("oracle.verdict", phase=PHASE_FALLBACK,
                         records=len(flows)):
            return verdict_outputs_padded(
                self.loader.fallback_engine, flows,
                authed_pairs=self._pairs(authed_pairs), outputs=outputs)

    # -- the verdict entry points ---------------------------------------
    def outputs(self, flows: Sequence[Flow], authed_pairs=None,
                outputs=None, deadline: Optional[float] = None):
        """Full output lanes under pow2 padding, surviving device
        failure: device lane when the breaker allows, oracle otherwise
        or on dispatch failure. ``deadline`` (absolute monotonic) is
        recorded on the dispatch trace."""
        if deadline is not None:
            TRACER.event("dispatch.deadline",
                         remaining_ms=round(
                             (deadline - simclock.now()) * 1e3, 3))
        engine = self.loader.engine
        if engine is None:
            raise RuntimeError("no policy loaded")
        pairs = self._pairs(authed_pairs)
        if not self._device_backed(engine):
            # the active engine IS the oracle (gate off): the whole
            # evaluation is the fallback phase
            with TRACER.span("oracle.verdict", phase=PHASE_FALLBACK,
                             records=len(flows)):
                return verdict_outputs_padded(engine, flows,
                                              authed_pairs=pairs,
                                              outputs=outputs)
        if not self.enabled:
            return verdict_outputs_padded(engine, flows,
                                          authed_pairs=pairs,
                                          outputs=outputs)
        if self.breaker.allow_primary():
            try:
                out = verdict_outputs_padded(engine, flows,
                                             authed_pairs=pairs,
                                             outputs=outputs)
            except Exception as e:  # noqa: BLE001 — degrade, don't die
                if passes_breaker(e):
                    self.on_passed()
                    raise
                self.on_device_failure(e)
            else:
                self.breaker.record_success()
                return out
        else:
            TRACER.event("breaker.rerouted", state=self.breaker.state)
        return self.fallback_outputs(flows, authed_pairs=pairs,
                                     outputs=outputs)

    def verdicts(self, flows: Sequence[Flow], authed_pairs=None,
                 deadline: Optional[float] = None) -> List[int]:
        return [int(v) for v in
                self.outputs(flows, authed_pairs=authed_pairs,
                             outputs=("verdict",),
                             deadline=deadline)["verdict"]]


class _Pending:
    """One queued check: the flow plus its rendezvous and deadline
    bookkeeping. ``abandoned`` flips when the caller gives up waiting —
    the drain worker reaps the entry before dispatch."""

    __slots__ = ("flow", "ev", "box", "t_enq", "ctx", "deadline",
                 "abandoned")

    def __init__(self, flow: Flow, deadline: Optional[float], ctx):
        self.flow = flow
        # clock-integrated event: a VirtualClock wakes the waiting
        # caller promptly when the drain worker answers in virtual time
        self.ev = simclock.event()
        #: the verdict, or an error the breaker let through
        self.box: List = []
        self.t_enq = simclock.now()
        self.ctx = ctx
        self.deadline = deadline
        self.abandoned = False


class MicroBatcher:
    """Collects single flows; flushes as one engine batch on size or
    deadline.

    ``drain_workers`` long-lived drain workers run engine batches
    (default 1 = strictly serial: while a batch executes, new requests
    keep enqueuing and form the next batch). With 2+ workers, batch k+1
    can accumulate AND dispatch while batch k is in flight. Each
    request gets exactly one verdict (ERROR when its batch failed), or
    the error of its batch where the breaker let that through;
    ordering across batches is not part of the contract.

    Overload discipline (``runtime/admission.py``): ``max_pending`` is
    the HARD queue bound, enforced under the lock — enqueues past it
    shed explicitly; per-entry deadlines are carried to dispatch, and
    entries whose caller abandoned them or whose deadline lapsed in the
    queue are reaped before featurize."""

    def __init__(self, verdict_fn: Callable[[Sequence[Flow]], Sequence[int]],
                 batch_max: int = 256, deadline_ms: float = 2.0,
                 drain_workers: int = 1, max_pending: int = 0,
                 gate=None):
        self.verdict_fn = verdict_fn
        self.batch_max = batch_max
        self.deadline_s = deadline_ms / 1e3
        self.drain_workers = max(1, int(drain_workers))
        #: hard occupancy bound (0 = unbounded, standalone/test use;
        #: the service always passes its configured bound)
        self.max_pending = max(0, int(max_pending))
        #: optional AdmissionGate: fed the per-batch service rate for
        #: its deadline-feasibility estimate
        self.gate = gate
        try:
            self._fn_takes_deadline = "deadline" in \
                inspect.signature(verdict_fn).parameters
        except (TypeError, ValueError):
            self._fn_takes_deadline = False
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: List[_Pending] = []
        self._inflight = 0               # entries popped, batch running
        self.peak_pending = 0            # high-water mark
        self._workers: List[threading.Thread] = []
        self._closed = False
        self._draining = False

    # -- enqueue ----------------------------------------------------------
    def check(self, flow: Flow, timeout: float = 5.0,
              deadline: Optional[float] = None) -> int:
        return self.check_ex(flow, timeout=timeout, deadline=deadline)[0]

    def check_ex(self, flow: Flow, timeout: float = 5.0,
                 deadline: Optional[float] = None):
        """(verdict, status): status is "ok", "shed" (queue at bound),
        "closed" (drained/stopped), or "timeout" (caller gave up; the
        entry is marked abandoned and reaped before dispatch). Raises
        the error of a batch that failed with one the breaker lets
        through (:func:`passes_breaker`).
        ``deadline`` is absolute monotonic seconds; None derives one
        from ``timeout`` so every entry is reapable."""
        if deadline is None:
            deadline = simclock.now() + timeout
        # the caller's trace context crosses the thread handoff WITH
        # the entry
        entry = _Pending(flow, deadline, TRACER.current())
        shed = False
        with self._cond:
            if self._closed or self._draining:
                return int(Verdict.ERROR), "closed"
            if self.max_pending and \
                    len(self._pending) >= self.max_pending:
                shed = True
            else:
                self._pending.append(entry)
                if len(self._pending) > self.peak_pending:
                    self.peak_pending = len(self._pending)
                if not self._workers:
                    self._workers = [
                        threading.Thread(target=self._drain, daemon=True)
                        for _ in range(self.drain_workers)]
                    for w in self._workers:
                        w.start()
                self._cond.notify()
        if shed:
            admission.count_shed("batcher", admission.CLASS_DATA,
                                 admission.SHED_QUEUE_FULL)
            if entry.ctx is not None:
                TRACER.add_span(entry.ctx, "admission.shed",
                                PHASE_SHED, simclock.wall(), 0.0,
                                reason=admission.SHED_QUEUE_FULL)
            return int(Verdict.ERROR), "shed"
        wait = min(timeout, max(0.0, deadline - simclock.now()))
        if not simclock.wait_on(entry.ev, wait):
            # caller is leaving: the drain worker drops the entry
            # before featurize/dispatch
            entry.abandoned = True
            return int(Verdict.ERROR), "timeout"
        if isinstance(entry.box[0], BaseException):
            raise entry.box[0]
        return entry.box[0], "ok"

    # -- lifecycle --------------------------------------------------------
    def close(self, abort: bool = True) -> None:
        """``abort=True`` (default): stop now, pending entries get
        ERROR verdicts. ``abort=False`` delegates to :meth:`drain`."""
        if not abort:
            self.drain()
            return
        with self._cond:
            self._closed = True
            pending, self._pending = self._pending, []
            self._cond.notify_all()
        for entry in pending:
            entry.box.append(int(Verdict.ERROR))
            entry.ev.set()

    def drain(self, timeout: float = 30.0) -> int:
        """Flush pending entries THROUGH the engine, then stop. Entries
        still unflushed when ``timeout`` lapses resolve as ERROR.
        Returns the number of entries flushed with real verdicts.
        Idempotent."""
        t_deadline = simclock.now() + max(0.0, timeout)
        with self._cond:
            if self._closed:
                return 0
            self._draining = True
            backlog = len(self._pending) + self._inflight
            self._cond.notify_all()
            while self._pending or self._inflight:
                left = t_deadline - simclock.now()
                if left <= 0:
                    break
                simclock.wait_cond(self._cond, min(left, 0.05))
            self._closed = True
            leftovers, self._pending = self._pending, []
            # joining happens OUTSIDE the lock (workers need it to
            # observe _closed and exit)
            workers = list(self._workers)
            self._cond.notify_all()
        for entry in leftovers:
            entry.box.append(int(Verdict.ERROR))
            entry.ev.set()
        for w in workers:
            w.join(timeout=1.0)
        return max(0, backlog - len(leftovers))

    # -- drain workers ----------------------------------------------------
    def _drain(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if self._closed:
                    return
                # wait for a full batch or the oldest entry's deadline;
                # non-emptiness re-checked after EVERY wake (a sibling
                # worker may have drained the queue). Drain mode
                # flushes immediately.
                while (self._pending
                       and len(self._pending) < self.batch_max
                       and not self._closed and not self._draining):
                    oldest = self._pending[0].t_enq
                    left = oldest + self.deadline_s - simclock.now()
                    if left <= 0 or not simclock.wait_cond(self._cond,
                                                           left):
                        break
                if self._closed:
                    return
                if not self._pending:
                    continue  # sibling took everything; wait again
                # cap at batch_max: the padding buckets assume bounded
                # batches
                pending = self._pending[:self.batch_max]
                del self._pending[:self.batch_max]
                self._inflight += len(pending)
                if self._pending:
                    self._cond.notify()
            try:
                self._run_batch(pending)
            finally:
                with self._cond:
                    self._inflight -= len(pending)
                    self._cond.notify_all()

    def _reap(self, pending: List[_Pending]) -> List[_Pending]:
        """Drop abandoned/expired entries before dispatch; they resolve
        ERROR and are counted."""
        now = simclock.now()
        live: List[_Pending] = []
        reaped: List[_Pending] = []
        for entry in pending:
            if entry.abandoned or (entry.deadline is not None
                                   and entry.deadline <= now):
                reaped.append(entry)
            else:
                live.append(entry)
        if reaped:
            if self.gate is not None:
                self.gate.reap(len(reaped))
            else:
                METRICS.inc(ADMISSION_REAPED, len(reaped))
            wall = simclock.wall()
            for entry in reaped:
                if entry.ctx is not None:
                    waited = now - entry.t_enq
                    TRACER.add_span(entry.ctx, "admission.reap",
                                    PHASE_SHED, wall - waited, waited)
                entry.box.append(int(Verdict.ERROR))
                entry.ev.set()
        return live

    def _run_batch(self, pending: List[_Pending]) -> None:
        pending = self._reap(pending)
        if not pending:
            return
        flows = [p.flow for p in pending]
        t_drain = simclock.now()
        wall = simclock.wall()
        for entry in pending:
            if entry.ctx is not None:
                waited = t_drain - entry.t_enq
                TRACER.add_span(entry.ctx, "batch.queue", PHASE_QUEUE,
                                wall - waited, waited)
        # the batch dispatch runs under the GROUP of sampled member
        # contexts: each request's trace shows the batch's spans
        group = TRACER.group([p.ctx for p in pending])
        deadlines = [p.deadline for p in pending
                     if p.deadline is not None]
        batch_deadline = min(deadlines) if deadlines else None
        t0 = simclock.perf()
        try:
            with TRACER.activate(group):
                if self._fn_takes_deadline:
                    verdicts = self.verdict_fn(flows,
                                               deadline=batch_deadline)
                else:
                    verdicts = self.verdict_fn(flows)
        except Exception as e:  # noqa: BLE001 — every entry gets an answer
            # an error the breaker let through is each caller's to see
            # (an error response); any other is an ERROR verdict
            verdicts = ([e] if passes_breaker(e) else
                        [int(Verdict.ERROR)]) * len(flows)
        seconds = simclock.perf() - t0
        METRICS.observe(MICROBATCH_SECONDS, seconds)
        METRICS.observe(MICROBATCH_SIZE, len(flows))
        if self.gate is not None:
            self.gate.note_batch(len(flows), seconds)
        for entry, v in zip(pending, verdicts):
            entry.box.append(v if isinstance(v, BaseException) else int(v))
            entry.ev.set()


class PolicyBridge:
    """Adapts parsed L7 records (from proxylib parsers) to engine
    verdicts — the role of proxylib's ``policymap.go``."""

    def __init__(self, loader, batch_max: int = 256,
                 deadline_ms: float = 2.0, authed_pairs_fn=None,
                 accesslog_fn=None, drain_workers: int = 1,
                 verdictor: Optional[ResilientVerdictor] = None,
                 gate=None):
        self.loader = loader
        #: supplies the authenticated (src, dst) pairs: the L7 proxy
        #: path enforces drop-until-authed like every other path
        self.authed_pairs_fn = authed_pairs_fn
        #: shared degraded-mode pipeline (standalone bridges build
        #: their own so the breaker protects them too)
        self.verdictor = verdictor or ResilientVerdictor(
            loader, authed_pairs_fn=authed_pairs_fn)
        #: ``accesslog_fn(flow)``: sink for LOG-action access-log
        #: records (the annotated L7 flow)
        self.accesslog_fn = accesslog_fn
        adm = getattr(loader.config, "admission", None)
        self.batcher = MicroBatcher(
            self._verdicts, batch_max=batch_max,
            deadline_ms=deadline_ms, drain_workers=drain_workers,
            max_pending=getattr(adm, "max_pending", 0), gate=gate)
        # has_proxy_actions memo, valid for ONE policy revision
        self._pa_cache: Dict = {}
        self._pa_revision = -1

    def _verdicts(self, flows: Sequence[Flow],
                  deadline: Optional[float] = None) -> Sequence[int]:
        if self.loader.engine is None:
            return [int(Verdict.DROPPED)] * len(flows)
        return self.verdictor.verdicts(flows, deadline=deadline)

    def record_to_flow(self, conn: Connection, record) -> Flow:
        f = Flow(
            src_identity=conn.src_identity,
            dst_identity=conn.dst_identity,
            dport=conn.dport,
            protocol=Protocol.TCP,
            direction=(TrafficDirection.INGRESS if conn.ingress
                       else TrafficDirection.EGRESS),
        )
        if isinstance(record, HTTPInfo):
            f.l7, f.http = L7Type.HTTP, record
        elif isinstance(record, KafkaInfo):
            f.l7, f.kafka = L7Type.KAFKA, record
        elif isinstance(record, DNSInfo):
            f.l7, f.dns = L7Type.DNS, record
        elif isinstance(record, GenericL7Info):
            f.l7, f.generic = L7Type.GENERIC, record
        return f

    def http_proxy_actions(self, flow: Flow):
        """(rewrites, log) for an ALLOWED HTTP flow: the firing
        ADD/DELETE/REPLACE header-rewrite ops plus whether a LOG-action
        mismatch should annotate the access log (a host-side walk of
        the rule objects, gated on ``has_proxy_actions``)."""
        from cilium_tpu_torch.policy.oracle import (
            has_proxy_actions,
            http_proxy_actions,
            lookup_entry,
        )

        allowed, entry = lookup_entry(self.loader.per_identity, flow)
        if not allowed or entry is None or not entry.is_redirect:
            return [], False
        if self._pa_revision != self.loader.revision:
            self._pa_cache = {}
            self._pa_revision = self.loader.revision
        gate = self._pa_cache.get(entry.l7_rules)
        if gate is None:
            gate = self._pa_cache[entry.l7_rules] = \
                has_proxy_actions(entry.l7_rules)
        if not gate:
            return [], False
        secret_lookup = (self.loader.secrets.lookup
                         if self.loader.secrets is not None else None)
        return http_proxy_actions(entry.l7_rules, flow, secret_lookup)

    def policy_check(self, conn: Connection) -> Callable[[object], bool]:
        def check(record) -> bool:
            flow = self.record_to_flow(conn, record)
            v = self.batcher.check(flow)
            # AUDIT forwards: audit mode reports the would-be denial
            # but does not enforce it
            allowed = v in (int(Verdict.FORWARDED),
                            int(Verdict.REDIRECTED), int(Verdict.AUDIT))
            conn.pending_rewrites = []
            if allowed and flow.http is not None:
                rewrites, log = self.http_proxy_actions(flow)
                conn.pending_rewrites = rewrites
                if log and self.accesslog_fn is not None:
                    flow.verdict = Verdict(v)
                    self.accesslog_fn(flow)
            METRICS.inc(POLICY_L7,
                        labels={"proto": conn.proto,
                                "verdict": "allow" if allowed else "deny"})
            return allowed

        return check


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def send_msg(sock: socket.socket, obj: Dict) -> None:
    payload = json.dumps(obj).encode()
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def recv_msg(sock: socket.socket) -> Dict:
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    return json.loads(_recv_exact(sock, n))


class VerdictService:
    """The server. One instance wraps a port ``Loader`` (a
    ``TorchVerdictEngine`` on the loader's device, or the CPU oracle
    with the gate off) and serves parsers, shims and streams."""

    def __init__(self, loader, socket_path: str, batch_max: int = 256,
                 deadline_ms: float = 2.0, drain_workers: int = 1):
        self.loader = loader
        self.socket_path = socket_path
        self.admission_config = getattr(loader.config, "admission",
                                        None)
        #: ONE breaker-guarded pipeline for every verdict path this
        #: service serves (batcher, bulk op, streams)
        self.verdictor = ResilientVerdictor(loader)
        #: bounded admission in front of every verdict ingress; its
        #: depth_fn reads the real batcher backlog
        self.gate = admission.AdmissionGate.from_config(
            self.admission_config,
            depth_fn=lambda: len(self.bridge.batcher._pending))
        self.bridge = PolicyBridge(
            loader, batch_max=batch_max, deadline_ms=deadline_ms,
            drain_workers=drain_workers, verdictor=self.verdictor,
            gate=self.gate)
        self._connections: Dict[int, Connection] = {}
        self._conn_lock = threading.Lock()
        self._server: Optional[socketserver.ThreadingUnixStreamServer] = None
        self._thread: Optional[threading.Thread] = None
        #: continuously-batched serving loop (``runtime/serveloop.py``),
        #: built on the first stream once a device engine serves —
        #: gated by ``Config.serve.enabled``; stream sessions then
        #: dispatch through ring slot leases instead of private
        #: per-session state (verdict-bit-equal either way)
        self.serveloop = None
        self._serve_config = getattr(loader.config, "serve", None)

    def _ensure_serveloop(self):
        """The serve loop, when enabled and a device engine serves
        (None otherwise — sessions use their private dispatch)."""
        if not getattr(self._serve_config, "enabled", False):
            return None
        with self._conn_lock:
            if self.serveloop is None and isinstance(
                    self.loader.engine, TorchVerdictEngine):
                from cilium_tpu_torch.runtime.serveloop import ServeLoop

                self.serveloop = ServeLoop.from_config(
                    self.loader, self._serve_config,
                    authed_pairs_fn=self.bridge.authed_pairs_fn,
                ).start()
            return self.serveloop

    # -- stream mode ------------------------------------------------------
    def handle_stream(self, sock: socket.socket, req: Dict) -> None:
        """``stream_start``: ack, then hand the connection to a
        :class:`~cilium_tpu_torch.runtime.stream.StreamSession` until
        end-of-stream."""
        from cilium_tpu_torch.runtime.stream import StreamSession

        if self.loader.engine is None:
            send_msg(sock, {"error": "no policy loaded"})
            return
        ok, reason = self.gate.admit(admission.CLASS_DATA)
        if not ok:
            # a draining/overloaded service refuses NEW streams at the
            # handshake — existing sessions run to end-of-stream
            send_msg(sock, {"error": f"shed: {reason}", "shed": True,
                            "reason": reason})
            return
        # credit flow control: clients that opt in (``"credit": true``)
        # get a server-advertised chunk window
        credit_window = 0
        if req.get("credit"):
            credit_window = int(getattr(
                self.admission_config, "stream_credit_window", 32))
        # "trace": this server accepts KIND_CHUNK_TRACED frames
        ack = {"ok": True, "revision": self.loader.revision,
               "trace": True}
        if credit_window > 0:
            ack["credit"] = credit_window
        send_msg(sock, ack)
        StreamSession(
            self.loader, sock,
            widths=req.get("widths") or None,
            authed_pairs_fn=self.bridge.authed_pairs_fn,
            pipeline_depth=int(req.get("pipeline_depth") or 8),
            verdictor=self.verdictor,
            credit_window=credit_window,
            serveloop=self._ensure_serveloop(),
        ).run()

    # -- request handling -------------------------------------------------
    def handle(self, req: Dict) -> Dict:
        op = req.get("op")
        try:
            if op in ("check", "verdict"):
                # verdict-path ingress: one trace per request, id
                # returned to the caller
                with TRACER.trace(f"service.{op}") as ctx:
                    resp = self._handle(req)
                    if ctx is not None and "error" not in resp:
                        resp.setdefault("trace_id", ctx.trace_id)
                    return resp
            return self._handle(req)
        except Exception as e:  # malformed fields must not kill the conn
            return {"error": f"{type(e).__name__}: {e}"}

    def _handle(self, req: Dict) -> Dict:
        op = req.get("op")
        deadline = None
        if op in ("check", "verdict", "on_new_connection"):
            # data-path ingress: bounded admission + deadline
            # feasibility BEFORE any work; control ops never queue
            # behind verdicts
            if op != "on_new_connection":
                deadline = admission.deadline_from_ms(
                    req.get("deadline_ms"),
                    getattr(self.admission_config,
                            "default_deadline_ms", 5000.0))
            ok, reason = self.gate.admit(admission.CLASS_DATA,
                                         deadline=deadline)
            if not ok:
                TRACER.add_span(TRACER.current(), "admission.shed",
                                PHASE_SHED, simclock.wall(), 0.0,
                                reason=reason)
                resp = {"shed": True, "reason": reason}
                if op == "check":
                    # explicit shed verdict: fail-closed, told apart
                    # from a policy DROP by the shed flag
                    resp["verdict"] = int(Verdict.ERROR)
                else:
                    resp["error"] = f"shed: {reason}"
                return resp
        if op == "ping":
            return {"ok": True, "revision": self.loader.revision}
        if op == "drain":
            return self.drain()
        if op == "status":
            out = {"engine_revision": self.loader.revision,
                   "banks": self.loader.bank_status()}
            if self.serveloop is not None:
                out["serve"] = self.serveloop.status()
            return out
        if op == "explain":
            # recorded provenance for one trace id, re-resolved through
            # the CPU oracle at the current revision
            from cilium_tpu_torch.runtime.explain import resolve_explain

            tid = str(req.get("trace_id", "") or "")
            if not tid:
                return {"error": "explain needs trace_id"}
            return resolve_explain(self.loader, tid)
        if op == "metrics":
            return {"text": METRICS.expose()}
        if op == "mapstate_pull":
            # NPDS role: the compiled L3/L4 MapState serialized for the
            # shim's local fast path (runtime/npds.py)
            from cilium_tpu_torch.runtime.npds import serialize_mapstates

            blob = serialize_mapstates(
                self.loader.per_identity, self.loader.revision,
                audit_global=self.loader.config.policy_audit_mode)
            METRICS.inc(NPDS_PULLS)
            return {"revision": self.loader.revision,
                    "npds_b64": base64.b64encode(blob).decode()}
        if op in ("policy_get", "bugtool"):
            return {"error": "no agent attached"}
        if op == "check":
            # single-record policy check through the MicroBatcher
            # (requests coalesce across connections into one batch);
            # the wire deadline rides the queue entry
            flow = flow_from_dict(req.get("flow", {}))
            v, status = self.bridge.batcher.check_ex(
                flow, deadline=deadline)
            resp = {"verdict": v}
            if status in ("shed", "closed"):
                resp["shed"] = True
                resp["reason"] = (admission.SHED_QUEUE_FULL
                                  if status == "shed"
                                  else admission.SHED_DRAINING)
            return resp
        if op == "verdict":
            flows = [flow_from_dict(d) for d in req.get("flows", ())]
            if self.loader.engine is None:
                return {"error": "no policy loaded"}
            # breaker-guarded: a device dispatch failure degrades this
            # request to the oracle lane instead of an error response
            out = self.verdictor.outputs(flows, deadline=deadline)
            verdicts = [int(v) for v in out["verdict"]]
            METRICS.inc(SERVICE_VERDICTS, len(flows))
            return {"verdicts": verdicts}
        if op == "on_new_connection":
            conn = Connection(
                proto=req["proto"],
                connection_id=int(req["conn"]),
                ingress=bool(req.get("ingress", True)),
                src_identity=int(req.get("src", 0)),
                dst_identity=int(req.get("dst", 0)),
                dport=int(req.get("dport", 0)),
                policy_name=req.get("policy_name", ""),
            )
            try:
                create_parser(req["proto"], conn,
                              self.bridge.policy_check(conn))
            except KeyError as e:
                return {"error": str(e)}
            with self._conn_lock:
                self._connections[conn.connection_id] = conn
            # the revision stamp is the shim's NPDS invalidation signal
            return {"ok": True, "revision": self.loader.revision}
        if op == "on_data":
            with self._conn_lock:
                conn = self._connections.get(int(req["conn"]))
            if conn is None:
                return {"error": f"unknown connection {req.get('conn')}"}
            data = base64.b64decode(req.get("data_b64", ""))
            ops = conn.on_data(bool(req.get("reply", False)),
                               bool(req.get("end", False)), data)
            resp = {"ops": [[int(o), int(n)] for o, n in ops]}
            inj = conn.take_inject(reply=True)
            if inj:
                resp["inject_b64"] = base64.b64encode(inj).decode()
            inj_req = conn.take_inject(reply=False)
            if inj_req:
                # upstream-bound bytes (rewritten request frames) ride
                # their own field
                resp["inject_req_b64"] = \
                    base64.b64encode(inj_req).decode()
            return resp
        if op == "profile":
            return {"error": _PROFILE_UNPORTED}
        if op == "close_connection":
            with self._conn_lock:
                self._connections.pop(int(req.get("conn", -1)), None)
            return {"ok": True}
        return {"error": f"unknown op {op!r}"}

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        service = self
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):  # noqa: A003
                try:
                    while True:
                        try:
                            req = recv_msg(self.request)
                        except json.JSONDecodeError:
                            # malformed frame: answer and drop the
                            # connection (framing is now unreliable)
                            send_msg(self.request,
                                     {"error": "malformed request"})
                            return
                        if req.get("op") == "stream_start":
                            # the connection becomes a chunked binary
                            # verdict stream until end-of-stream
                            service.handle_stream(self.request, req)
                            return
                        send_msg(self.request, service.handle(req))
                except (ConnectionError, struct.error, OSError):
                    pass

        class Server(socketserver.ThreadingUnixStreamServer):
            # many proxies connect at once: past socketserver's default
            # backlog of 5, a Unix-socket connect can fail with EAGAIN
            request_queue_size = socket.SOMAXCONN
            daemon_threads = True

        self._server = Server(self.socket_path, Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def drain(self) -> Dict:
        """Graceful drain: stop admitting data-path work, flush — not
        error — pending batches through the engine, then snapshot the
        loader's warm state. Idempotent; control ops keep answering. A
        fault injected at ``service.drain`` aborts between
        stop-admitting and the flush."""
        self.gate.begin_drain()
        faults.maybe_fail(DRAIN_POINT)
        timeout = getattr(self.admission_config, "drain_timeout_s",
                          30.0)
        flushed = self.bridge.batcher.drain(timeout=timeout)
        if self.serveloop is not None:
            flushed += self.serveloop.drain()
        warm = False
        if self.loader.revision > 0:
            warm = self.loader.snapshot_warm()
        METRICS.inc(DRAINS)
        TRACER.event("service.drained", flushed=flushed,
                     warm_snapshot=warm)
        LOG.info("service drained", extra={"fields": {
            "flushed": flushed, "warm_snapshot": warm,
            "revision": self.loader.revision}})
        return {"ok": True, "flushed": flushed,
                "warm_snapshot": warm,
                "revision": self.loader.revision}

    def stop(self, drain: bool = True) -> None:
        """Shutdown. ``drain=True`` flushes pending verdicts through the
        engine before stopping (without latching the gate into drain
        mode); ``drain=False`` is the crash-stop path."""
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if drain:
            self.bridge.batcher.drain(timeout=getattr(
                self.admission_config, "drain_timeout_s", 30.0))
        self.bridge.batcher.close()
        if self.serveloop is not None:
            self.serveloop.stop()
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)


class VerdictClient:
    """Python client for the service (what the C++ shim does in C)."""

    def __init__(self, socket_path: str):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(socket_path)
        self._lock = threading.Lock()

    def call(self, req: Dict) -> Dict:
        with self._lock:
            send_msg(self.sock, req)
            return recv_msg(self.sock)

    def close(self) -> None:
        self.sock.close()
