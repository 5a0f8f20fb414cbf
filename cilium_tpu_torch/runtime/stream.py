"""Streaming binary verdict transport (the reference's
``runtime/stream.py``): the serving-path counterpart of the offline
capture replay, on the port's engine.

A CHUNKED BINARY STREAM on the verdict service's Unix socket:

* the client sends length-prefixed frames whose payload is a
  self-contained v2/v3 capture image (``ingest.binary
  .sections_to_bytes``) — no JSON, no base64, no per-record parsing;
* the server runs a three-stage pipeline: a reader thread (socket →
  frame queue), a worker thread (parse → featurize → dispatch) and a
  writer thread (readback → verdict frame). Dispatch is asynchronous,
  so while chunk k's readback is in flight, chunks k+1..k+D are already
  staged or executing on the device;
* verdicts return as raw u8 arrays keyed by the client's sequence
  number, on the same socket, decoupled from sends.

Protocol (after a ``{"op": "stream_start", ...}`` JSON handshake on the
verdict socket; see ``VerdictService``):

  frame   := <u32 payload_len> <u32 seq> <u8 kind> payload
  c→s     := kind 0: capture image | kind 1: end-of-stream (empty)
           | kind 3: capture image prefixed by a 16-hex trace id
             (only to servers that advertised ``"trace": true``)
  s→c     := kind 0: u8 verdict array (one byte per record, in the
             chunk's record order)
           | kind 1: end-ack (all pending verdicts flushed)
           | kind 2: per-chunk error (utf-8 message; stream continues)
           | kind 4: credit grant (u32 additional chunk credits; only
             to clients that sent ``"credit": true`` in the hello)

Credit flow control: clients that opt in receive a window in the
stream_start ack (``"credit": N`` — ``Config.admission
.stream_credit_window``); each chunk send consumes a credit, each
answered chunk grants one back, and the client HALTS sends at zero.
Credits survive reconnect-with-resume (fresh window minus the re-sent
unacked chunks).

A poisoned frame (bad magic, truncated image) fails ONLY its sequence
number, and so does a chunk that meets what the port does not serve yet
(``NotImplementedError``) or one whose kernel failed on the card:
errors the breaker lets through (``service.passes_breaker``), never a
trip or an oracle verdict. A v3 image's GENERIC section (frontend and
proxy-only ``l7proto`` records) is served like any other chunk.

Where the port differs from the reference: the session route is taken
for a ``TorchVerdictEngine`` (``isinstance``, where the reference tests
a JAX-only attribute), and the readback: right after a chunk's dispatch
on the card the worker issues a non-blocking copy of its verdict lane
into pinned host memory and records a CUDA event; the writer waits on
that chunk's event alone — a blocking copy would wait for every chunk
the worker enqueued since.
"""

from __future__ import annotations

import queue
import random
import socket
import struct
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cilium_tpu_torch.engine.verdict import TorchVerdictEngine
from cilium_tpu_torch.ingest.binary import (
    CaptureError,
    capture_from_bytes,
    capture_to_bytes,
    records_to_flows_l7,
)
from cilium_tpu_torch.runtime import faults, simclock
from cilium_tpu_torch.runtime.metrics import (
    METRICS,
    STREAM_CHUNKS,
    STREAM_CREDIT_WAITS,
    STREAM_CREDITS_GRANTED,
    STREAM_RECONNECTS,
    STREAM_UNKNOWN_FRAMES,
    STREAM_VERDICTS,
)
from cilium_tpu_torch.runtime.service import passes_breaker
from cilium_tpu_torch.runtime.tracing import (
    PHASE_DEVICE,
    PHASE_FALLBACK,
    PHASE_HOST,
    PHASE_QUEUE,
    TRACE_ID_CHARS,
    TRACER,
)

#: fires at the server's per-chunk dispatch (a fault fails ONE seq)
FRAME_SERVER_POINT = faults.register_point(
    "stream.frame.server", "per-chunk dispatch in StreamSession")
#: fires at the client's per-frame receive; plans typically raise
#: ConnectionError here to exercise reconnect-with-resume
FRAME_CLIENT_POINT = faults.register_point(
    "stream.frame.client", "per-frame receive in StreamClient")
#: fires at the server's credit-grant send: an injected fault LOSES the
#: grant (the client's window shrinks by one)
CREDIT_POINT = faults.register_point(
    "stream.credit", "credit grant send in StreamSession")

FRAME_HEADER = struct.Struct("<IIB")

KIND_CHUNK = 0
KIND_END = 1
KIND_ERROR = 2
#: client-to-server only: a capture chunk whose payload is prefixed by
#: a 16-hex-char trace id; the server adopts the id and replies with
#: plain KIND_CHUNK frames
# ctlint: disable=frame-kind  # one-directional kind, see above
KIND_CHUNK_TRACED = 3
#: server-to-client only: credit grant, a little-endian u32 of
#: additional chunk credits
# ctlint: disable=frame-kind  # server-to-client only, see above
KIND_CREDIT = 4

#: hard cap on one frame's payload — a corrupt length prefix must not
#: make the server try to buffer gigabytes
MAX_FRAME = 256 << 20

#: default bound on dispatched-but-unread chunks
PIPELINE_DEPTH = 16

#: the largest record count one chunk may carry
CHUNK_MAX = 1 << 17

#: the route label of ``cilium_tpu_stream_chunks_total``: the session's
#: incremental dispatch, the serve loop's ring, the oracle when it is
#: the active engine (gate off), and the breaker's oracle fallback
ROUTE_SESSION, ROUTE_RING = "session", "ring"
ROUTE_ORACLE, ROUTE_FALLBACK = "oracle", "fallback"


def send_frame(sock: socket.socket, seq: int, kind: int,
               payload: bytes = b"") -> None:
    sock.sendall(FRAME_HEADER.pack(len(payload), seq, kind) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    parts: List[bytes] = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


def recv_frame(sock: socket.socket) -> Tuple[int, int, bytes]:
    n, seq, kind = FRAME_HEADER.unpack(
        _recv_exact(sock, FRAME_HEADER.size))
    if n > MAX_FRAME:
        raise ConnectionError(f"frame too large ({n} bytes)")
    return seq, kind, _recv_exact(sock, n) if n else b""


class Readback:
    """One chunk's verdicts on their way to the host: a non-blocking
    copy of the first ``n`` entries of a CUDA verdict lane into pinned
    memory, issued on the current stream when built, and the event
    recorded after it. :meth:`wait` blocks on that event alone."""

    __slots__ = ("host", "done")

    def __init__(self, dev: torch.Tensor, n: int):
        self.host = torch.empty(n, dtype=dev.dtype, pin_memory=True)
        self.host.copy_(dev[:n], non_blocking=True)
        self.done = torch.cuda.Event()
        self.done.record()

    def wait(self) -> np.ndarray:
        self.done.synchronize()
        return self.host.numpy()


def _host_verdicts(dev, n: int) -> np.ndarray:
    """A chunk's verdicts as u8 on the host, from whatever its route
    produced: a :class:`Readback`, a CPU tensor or a host array."""
    if isinstance(dev, Readback):
        arr = dev.wait()
    elif isinstance(dev, torch.Tensor):
        arr = dev[:n].cpu().numpy()
    else:
        arr = np.asarray(dev)
    return arr[:n].astype(np.uint8)


class StreamSession:
    """Server side of one stream connection (runs on the service's
    handler thread until end-of-stream or disconnect)."""

    def __init__(self, loader, sock: socket.socket,
                 widths: Optional[Dict[str, int]] = None,
                 authed_pairs_fn=None,
                 pipeline_depth: int = PIPELINE_DEPTH,
                 verdictor=None, credit_window: int = 0,
                 serveloop=None):
        from cilium_tpu_torch.core.config import EngineConfig

        self.loader = loader
        self.sock = sock
        self.authed_pairs_fn = authed_pairs_fn
        #: optional serving loop (``runtime/serveloop.py``): device
        #: chunks dispatch through a ring slot lease — cross-stream
        #: dedup/memo, one fused launch per pack cycle — instead of this
        #: session's private IncrementalSession. A ring-full shed at
        #: lease time falls back to the private path for this session.
        self.serveloop = serveloop
        self._lease = None
        self._stream_id = f"stream-{id(self):x}"
        #: chunk credits advertised to this session's client; 0 = the
        #: client didn't opt in, grant nothing
        self.credit_window = max(0, int(credit_window))
        #: optional ResilientVerdictor (runtime/service.py): shares the
        #: service-wide circuit breaker
        self.verdictor = verdictor
        cfg = EngineConfig()
        # session-fixed string widths: the client promises its strings
        # fit (longer ones clip like the engine's config caps)
        caps = {"path": max(cfg.http_path_buckets),
                "method": cfg.http_method_len,
                "host": cfg.http_host_len,
                "headers": 1024, "qname": cfg.dns_name_len}
        self.widths = dict(caps)
        for k, v in (widths or {}).items():
            if k in caps:
                self.widths[k] = max(1, min(int(v), caps[k]))
        self._in: "queue.Queue" = queue.Queue(maxsize=32)
        self._out: "queue.Queue" = queue.Queue(
            maxsize=max(1, int(pipeline_depth)))
        self._send_lock = threading.Lock()
        #: incremental dedup session; a committed revision is consumed
        #: through the loader's PolicyDeltas (engine/session.py)
        self._inc = None

    # -- pipeline stages ---------------------------------------------------
    def run(self) -> None:
        worker = threading.Thread(target=self._work, daemon=True,
                                  name="stream-worker")
        writer = threading.Thread(target=self._write, daemon=True,
                                  name="stream-writer")
        worker.start()
        writer.start()
        try:
            while True:
                try:
                    seq, kind, payload = recv_frame(self.sock)
                except (ConnectionError, OSError):
                    break
                # receive stamp: the worker attributes reader-queue
                # dwell as the chunk's queue-wait phase
                self._in.put((seq, kind, payload, simclock.now()))
                if kind == KIND_END:
                    break
        finally:
            self._in.put(None)
            worker.join()
            writer.join()
            if self._lease is not None and self.serveloop is not None:
                self.serveloop.disconnect(self._lease)
                self._lease = None

    def _dispatch_chunk(self, payload: bytes):
        """Parse + incremental-dedup featurize + asynchronous dispatch.
        Returns (n_records, verdicts): a :class:`Readback` on the card,
        a tensor or an array otherwise — the writer reads them back."""
        faults.maybe_fail(FRAME_SERVER_POINT)
        with TRACER.span("stream.parse", phase=PHASE_HOST,
                         bytes=len(payload)):
            rec, l7, offsets, blob, gen = capture_from_bytes(payload)
        n = len(rec)
        if n == 0:
            return 0, None
        if n > CHUNK_MAX:
            raise CaptureError(
                f"chunk of {n} records exceeds max {CHUNK_MAX}")
        engine = self.loader.engine
        if engine is None:
            raise RuntimeError("no policy loaded")
        pairs = (self.authed_pairs_fn()
                 if self.authed_pairs_fn is not None else None)
        if not isinstance(engine, TorchVerdictEngine):
            # oracle backend (gate off): reconstruct and verdict
            # host-side so stream clients work identically either way
            METRICS.inc(STREAM_CHUNKS, labels={"route": ROUTE_ORACLE})
            with TRACER.span("oracle.verdict", phase=PHASE_FALLBACK,
                             records=n):
                flows = records_to_flows_l7(rec, l7, offsets, blob,
                                            gen=gen)
                out = engine.verdict_flows(flows, authed_pairs=pairs)
                return n, np.asarray(out["verdict"])
        vd = self.verdictor
        if vd is not None and not vd.allow_device(engine):
            # breaker open: this chunk rides the oracle like every
            # other path
            return n, self._oracle_chunk(rec, l7, offsets, blob, gen,
                                         pairs)
        if self.serveloop is not None:
            try:
                out = self._ring_chunk(rec, l7, offsets, blob, gen)
            except Exception as e:  # noqa: BLE001 — fails its seq
                if vd is not None and passes_breaker(e):
                    vd.on_passed()
                raise
            if out is not None:
                if vd is not None:
                    vd.on_device_success()
                METRICS.inc(STREAM_CHUNKS, labels={"route": ROUTE_RING})
                return n, out
            # ring-full at lease time: this session fell back to its
            # private dispatch path (serveloop cleared)
        try:
            if self._inc is None:
                # loader-wired: a policy committed mid-stream is
                # consumed as a bank-scoped delta — the session rescans
                # only what changed and keeps its rows and memo
                from cilium_tpu_torch.engine.session import (
                    IncrementalSession,
                )

                self._inc = IncrementalSession(engine,
                                               widths=self.widths,
                                               loader=self.loader)
            n, verdict = self._inc.verdict_chunk(
                rec, l7, offsets, blob, gen=gen, authed_pairs=pairs)
            if verdict.device.type == "cuda":
                # issue the copy NOW: readbacks overlap only if issued
                # while earlier ones are in flight
                verdict = Readback(verdict, n)
        except Exception as e:  # noqa: BLE001 — degrade, don't error
            if vd is None:
                raise
            if passes_breaker(e):
                # an input the port does not serve yet, or a kernel
                # that failed: the seq fails, the oracle answers nothing
                vd.on_passed()
                raise
            vd.on_device_failure(e)
            # the session may hold state staged against the failed
            # dispatch — rebuild it on the next device chunk
            self._inc = None
            return n, self._oracle_chunk(rec, l7, offsets, blob, gen,
                                         pairs)
        if vd is not None:
            vd.on_device_success()
        METRICS.inc(STREAM_CHUNKS, labels={"route": ROUTE_SESSION})
        return n, verdict

    def _ring_chunk(self, rec, l7, offsets, blob, gen):
        """One chunk through the verdict ring: lease on first use
        (reconnect-with-resume on expiry), submit, wait for the pack
        cycle. Returns host verdicts, or None when the ring shed the
        LEASE — the session then falls back to its private dispatch for
        good. Chunk-level sheds raise and fail only their seq."""
        from cilium_tpu_torch.runtime.serveloop import (
            LeaseExpired,
            ShedError,
        )

        loop = self.serveloop
        try:
            if self._lease is None:
                self._lease = loop.connect(self._stream_id)
        except ShedError:
            self.serveloop = None
            return None
        with TRACER.span("stream.ring", phase=PHASE_DEVICE,
                         records=len(rec)):
            try:
                ticket = loop.submit(self._lease, rec, l7, offsets,
                                     blob, gen=gen)
            except LeaseExpired:
                self._lease = loop.connect(self._stream_id,
                                           resume=True)
                ticket = loop.submit(self._lease, rec, l7, offsets,
                                     blob, gen=gen)
            return ticket.wait(timeout=30.0)

    def _oracle_chunk(self, rec, l7, offsets, blob, gen, pairs):
        """One chunk through the CPU oracle (the breaker's degraded
        lane) — correct verdicts, no device involved."""
        METRICS.inc(STREAM_CHUNKS, labels={"route": ROUTE_FALLBACK})
        flows = records_to_flows_l7(rec, l7, offsets, blob, gen=gen)
        out = self.verdictor.fallback_outputs(flows, authed_pairs=pairs,
                                              outputs=("verdict",))
        return np.asarray(out["verdict"])

    def _work(self) -> None:
        while True:
            item = self._in.get()
            if item is None:
                self._out.put(None)
                return
            seq, kind, payload, t_recv = item
            if kind == KIND_END:
                if self._lease is not None and self.serveloop is not None:
                    # release BEFORE queueing the END ack: a client
                    # whose finish() saw the ack must observe the slot
                    # returned
                    self.serveloop.disconnect(self._lease)
                    self._lease = None
                self._out.put((seq, KIND_END, 0, None, None))
                self._out.put(None)
                return
            ctx = None
            if kind == KIND_CHUNK_TRACED:
                # adopt the client's trace id and split the id prefix
                # off the capture image
                tid = payload[:TRACE_ID_CHARS].decode("ascii", "replace")
                payload = payload[TRACE_ID_CHARS:]
                ctx = TRACER.start("stream.chunk", trace_id=tid,
                                   seq=seq)
                kind = KIND_CHUNK
            if kind != KIND_CHUNK:
                self._out.put((seq, KIND_ERROR, 0,
                               f"unknown frame kind {kind}", None))
                continue
            if ctx is not None:
                waited = simclock.now() - t_recv
                TRACER.add_span(ctx, "stream.queue", PHASE_QUEUE,
                                simclock.wall() - waited, waited)
            try:
                with TRACER.activate(ctx):
                    n, dev = self._dispatch_chunk(payload)
            except Exception as e:  # noqa: BLE001 — fail the SEQ only
                TRACER.event("stream.chunk_error", ctx=ctx,
                             error=f"{type(e).__name__}: {e}")
                TRACER.finish(ctx)
                self._out.put((seq, KIND_ERROR, 0,
                               f"{type(e).__name__}: {e}", None))
                continue
            self._out.put((seq, KIND_CHUNK, n, dev, ctx))

    def _grant_credit(self, seq: int) -> None:
        """One credit back to the producer for one answered chunk. An
        injected ``stream.credit`` fault LOSES the grant."""
        if not self.credit_window:
            return
        try:
            faults.maybe_fail(CREDIT_POINT)
        except Exception:  # noqa: BLE001 — plan-chosen exception
            return  # the grant is lost; FAULTS_INJECTED counted it
        with self._send_lock:
            send_frame(self.sock, seq, KIND_CREDIT,
                       struct.pack("<I", 1))
        METRICS.inc(STREAM_CREDITS_GRANTED)

    def _write(self) -> None:
        while True:
            item = self._out.get()
            if item is None:
                return
            seq, kind, n, dev, ctx = item
            try:
                if kind == KIND_END:
                    with self._send_lock:
                        send_frame(self.sock, seq, KIND_END)
                    continue
                if kind == KIND_ERROR:
                    with self._send_lock:
                        send_frame(self.sock, seq, KIND_ERROR,
                                   str(dev).encode())
                    self._grant_credit(seq)
                    continue
                if n == 0:
                    with self._send_lock:
                        send_frame(self.sock, seq, KIND_CHUNK)
                    self._grant_credit(seq)
                    continue
                # the wait for an asynchronous dispatch is device time,
                # attributed where it is paid
                with TRACER.span("stream.readback", phase=PHASE_DEVICE,
                                 ctx=ctx, records=n):
                    verdicts = _host_verdicts(dev, n)
                METRICS.inc(STREAM_VERDICTS, n)
                with self._send_lock:
                    send_frame(self.sock, seq, KIND_CHUNK,
                               verdicts.tobytes())
                # grant AFTER the verdict frame: the window counts
                # unanswered chunks
                self._grant_credit(seq)
            except OSError:
                # client went away: drain silently so the worker can
                # finish and the session unwinds
                continue
            finally:
                TRACER.finish(ctx)


class StreamClient:
    """Client for the stream protocol (what a proxy data plane would
    speak in C; Python here for tests and the chip smoke).

    ``send_flows``/``send_image`` are non-blocking up to the socket
    buffer and the credit window; verdicts arrive on a background
    thread and are retrieved with ``result(seq)`` (blocking) or
    ``results()`` (drain in completion order). ``finish()`` sends
    end-of-stream and blocks for the end-ack.

    ``reconnect=True`` adds RECONNECT-WITH-RESUME: every sent chunk is
    retained until its verdict (or per-chunk error) lands; on a
    connection drop the client re-dials with exponential backoff +
    seeded jitter, re-handshakes and re-sends every unacked chunk in
    sequence order. Server verdicts are deterministic, so the
    at-least-once replay of an in-flight chunk is idempotent."""

    def __init__(self, socket_path: str, widths: Optional[Dict] = None,
                 timeout: float = 120.0,
                 pipeline_depth: Optional[int] = None,
                 reconnect: bool = False, max_reconnects: int = 5,
                 backoff_base: float = 0.05, backoff_max: float = 2.0,
                 reconnect_seed: int = 0):
        self.socket_path = socket_path
        self.timeout = timeout
        self._widths = widths or {}
        self._pipeline_depth = pipeline_depth
        self.reconnect = reconnect
        self.max_reconnects = max_reconnects
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self._jitter = random.Random(reconnect_seed)
        self._seq = 0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._send_lock = threading.Lock()
        self._results: Dict[int, object] = {}
        #: seq → (trace_id, chunk image), retained until acked
        #: (reconnect mode)
        self._unacked: Dict[int, Tuple[str, bytes]] = {}
        #: did the server's stream_start ack advertise trace support?
        self._trace_peer = False
        #: credit flow control: None = the peer advertised no window →
        #: unenforced; else the remaining chunk credits
        self._credits: Optional[int] = None
        self._credit_window = 0
        self._finish_seq: Optional[int] = None
        self._done = False
        self._connect()
        self._recv_thread = threading.Thread(target=self._recv_loop,
                                             daemon=True)
        self._recv_thread.start()

    def _connect(self) -> None:
        from cilium_tpu_torch.runtime.service import recv_msg, send_msg

        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.connect(self.socket_path)
        hello = {"op": "stream_start", "widths": self._widths,
                 "credit": True}
        if self._pipeline_depth:
            hello["pipeline_depth"] = int(self._pipeline_depth)
        send_msg(sock, hello)
        ack = recv_msg(sock)
        if not ack.get("ok"):
            sock.close()
            raise RuntimeError(f"stream_start refused: {ack}")
        self.revision = ack.get("revision")
        self._trace_peer = bool(ack.get("trace"))
        window = int(ack.get("credit") or 0)
        with self._cond:
            self._credit_window = window
            self._credits = window if window > 0 else None
            self._cond.notify_all()
        self.sock = sock

    def _try_reconnect(self) -> bool:
        """Re-dial + re-handshake + re-send unacked chunks, with
        exponential backoff plus seeded jitter."""
        try:
            self.sock.close()
        except OSError:
            pass
        for attempt in range(self.max_reconnects):
            delay = min(self.backoff_base * (2 ** attempt),
                        self.backoff_max)
            simclock.sleep(delay * (1.0 + 0.25 * self._jitter.random()))
            try:
                self._connect()
            except (OSError, RuntimeError):
                continue
            with self._lock:
                pending = sorted(self._unacked.items())
                finish_seq = self._finish_seq
            try:
                with self._send_lock:
                    for seq, (tid, image) in pending:
                        send_frame(self.sock, seq, *self._chunk_frame(
                            tid, image))
                    if finish_seq is not None:
                        # finish() already ran: re-send end-of-stream
                        send_frame(self.sock, finish_seq, KIND_END)
            except (OSError, ConnectionError):
                continue
            with self._cond:
                # the fresh window, minus the unacked chunks re-sent
                if self._credits is not None:
                    self._credits = max(
                        0, self._credit_window - len(pending))
                self._cond.notify_all()
            METRICS.inc(STREAM_RECONNECTS)
            return True
        return False

    def _recv_loop(self) -> None:
        while True:
            try:
                seq, kind, payload = recv_frame(self.sock)
                # injected drops model the connection dying mid-frame:
                # the received frame is DISCARDED (its seq stays
                # unacked and is re-sent after resume)
                faults.maybe_fail(FRAME_CLIENT_POINT)
            except (ConnectionError, OSError):
                if self.reconnect and not self._done \
                        and self._try_reconnect():
                    continue
                with self._cond:
                    self._done = True
                    self._cond.notify_all()
                return
            with self._cond:
                if kind == KIND_CREDIT:
                    # MUST precede the resume-dedup branch: a grant's
                    # seq echoes an already-acked chunk
                    grant = (struct.unpack("<I", payload[:4])[0]
                             if len(payload) >= 4 else 1)
                    if self._credits is not None:
                        self._credits += grant
                    self._cond.notify_all()
                    continue
                if kind == KIND_END:
                    self._done = True
                elif (self.reconnect and seq not in self._unacked
                      and seq not in self._results):
                    # at-least-once resume: the second delivery of an
                    # already-consumed seq is dropped
                    pass
                elif kind == KIND_ERROR:
                    self._unacked.pop(seq, None)
                    self._results[seq] = RuntimeError(
                        payload.decode("utf-8", "replace"))
                elif kind == KIND_CHUNK:
                    self._unacked.pop(seq, None)
                    self._results[seq] = np.frombuffer(
                        payload, dtype=np.uint8)
                else:
                    # a kind this client does not speak: dropped and
                    # counted, never misparsed as verdicts
                    METRICS.inc(STREAM_UNKNOWN_FRAMES)
                self._cond.notify_all()
                if kind == KIND_END:
                    return

    def _chunk_frame(self, trace_id: str,
                     image: bytes) -> Tuple[int, bytes]:
        """(kind, payload) for one chunk: traced when the peer
        advertised support and a well-formed id is present."""
        if self._trace_peer and trace_id \
                and len(trace_id) == TRACE_ID_CHARS:
            return KIND_CHUNK_TRACED, trace_id.encode("ascii") + image
        return KIND_CHUNK, image

    def _acquire_credit(self) -> None:
        """Halt at zero credit until the server grants. No-op when the
        peer advertised no window. Raises TimeoutError if no grant
        lands within ``timeout``."""
        with self._cond:
            if self._credits is None:
                return
            if self._credits <= 0:
                METRICS.inc(STREAM_CREDIT_WAITS)
                ok = simclock.wait_for(
                    self._cond,
                    lambda: (self._credits is None
                             or self._credits > 0 or self._done),
                    timeout=self.timeout)
                if self._credits is None or self._done:
                    return  # window gone / stream over: let send fail
                if not ok:
                    raise TimeoutError(
                        "no stream credit: server window exhausted "
                        "and no grant arrived")
            self._credits -= 1

    def send_image(self, image: bytes,
                   trace_id: Optional[str] = None) -> int:
        """``trace_id=None`` picks up the ambient flight-recorder
        context (if any); pass ``""`` to force an untraced frame."""
        if trace_id is None:
            trace_id = TRACER.current_trace_id()
        self._acquire_credit()
        with self._lock:
            seq = self._seq
            self._seq += 1
            if self.reconnect:
                self._unacked[seq] = (trace_id, image)
        try:
            kind, payload = self._chunk_frame(trace_id, image)
            with self._send_lock:
                send_frame(self.sock, seq, kind, payload)
        except (OSError, ConnectionError):
            if not self.reconnect:
                raise
            # the chunk stays in _unacked; the recv thread's reconnect
            # re-sends it once the session is back
        return seq

    def send_flows(self, flows: Sequence,
                   trace_id: Optional[str] = None) -> int:
        return self.send_image(capture_to_bytes(flows),
                               trace_id=trace_id)

    def result(self, seq: int) -> np.ndarray:
        """Block for one chunk's verdicts (raises if the server failed
        that chunk)."""
        with self._cond:
            simclock.wait_for(
                self._cond,
                lambda: seq in self._results or self._done,
                timeout=self.timeout)
            if seq not in self._results:
                raise TimeoutError(
                    f"no verdict for seq {seq}"
                    + (" (stream closed)" if self._done else ""))
            r = self._results.pop(seq)
        if isinstance(r, Exception):
            raise r
        return r

    def results(self) -> Iterator[Tuple[int, object]]:
        """Drain results as they land, until the stream ends and all
        are consumed. Yields ``(seq, ndarray)`` for verdicts and
        ``(seq, Exception)`` for per-chunk failures."""
        while True:
            with self._cond:
                simclock.wait_for(
                    self._cond,
                    lambda: self._results or self._done,
                    timeout=self.timeout)
                if not self._results:
                    if self._done:
                        return
                    raise TimeoutError("stream stalled")
                seq = next(iter(self._results))
                r = self._results.pop(seq)
            yield seq, r

    def finish(self) -> None:
        with self._lock:
            seq = self._seq
            self._seq += 1
            if self.reconnect:
                self._finish_seq = seq
        try:
            with self._send_lock:
                send_frame(self.sock, seq, KIND_END)
        except (OSError, ConnectionError):
            if not self.reconnect:
                raise  # the recv thread's resume re-sends END
        with self._cond:
            if not simclock.wait_for(self._cond, lambda: self._done,
                                     timeout=self.timeout):
                raise TimeoutError("no end-ack")

    def close(self) -> None:
        with self._cond:
            self._done = True  # no reconnect once closed
        try:
            # shutdown wakes the receive thread's blocked recv
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
        self._recv_thread.join(timeout=5.0)
