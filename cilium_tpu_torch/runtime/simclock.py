"""Injectable time: the clock seam under the serving loop (a copy of
the reference's ``runtime/simclock.py``).

* **Behavioral time** (``now``/``wall``/``sleep`` and the timed waits)
  is virtualizable: ``now()`` is monotonic seconds (deadlines, TTLs),
  ``wall()`` epoch seconds (stamps on traces and explain entries).
* **Measurement time** (``perf()``) is real under :class:`RealClock`
  and virtual under :class:`VirtualClock`, so simulated work is
  measured in the currency it was spent in.
* The module-level functions read the installed clock at CALL time,
  so objects built before a test installs a :class:`VirtualClock`
  still follow it.

Tests install a ``VirtualClock`` with :func:`use` and drive it with
``advance``; ``ServeLoop.start()`` paces its pack thread with
:func:`sleep`, so the same loop runs on either clock.
"""

from __future__ import annotations

import contextlib
import heapq
import threading
import time
from typing import Callable, List, Optional

__all__ = [
    "Clock", "RealClock", "VirtualClock", "ClockEvent",
    "get", "install", "reset", "use",
    "now", "wall", "perf", "sleep", "event", "hold",
    "wait_on", "wait_for", "wait_cond",
]

#: fixed virtual epoch (2020-09-13T12:26:40Z): wall stamps under a
#: VirtualClock are a pure function of virtual time, never of the
#: host's clock
VIRTUAL_EPOCH = 1_600_000_000.0


class Clock:
    """The protocol. ``RealClock`` is the production implementation;
    ``VirtualClock`` the simulation one. Methods mirror the stdlib
    call sites they replace so the refactor stays mechanical."""

    def now(self) -> float:            # pragma: no cover - interface
        raise NotImplementedError

    def wall(self) -> float:           # pragma: no cover - interface
        raise NotImplementedError

    def perf(self) -> float:           # pragma: no cover - interface
        raise NotImplementedError

    def sleep(self, seconds: float) -> float:  # pragma: no cover
        """Block for ``seconds`` on this clock; returns the wake
        instant in this clock's ``now()`` timeline."""
        raise NotImplementedError

    def event(self) -> threading.Event:
        """An Event whose timed wait integrates with this clock (pair
        with :meth:`wait_on`)."""
        return threading.Event()

    def wait_on(self, ev, timeout: Optional[float] = None) -> bool:
        """``ev.wait(timeout)`` with the timeout measured on THIS
        clock. Returns True when the event fired."""
        raise NotImplementedError      # pragma: no cover - interface

    def wait_for(self, cond: threading.Condition,
                 predicate: Callable[[], bool],
                 timeout: Optional[float] = None) -> bool:
        """``cond.wait_for(predicate, timeout)`` with the timeout on
        THIS clock. Caller holds ``cond``."""
        raise NotImplementedError      # pragma: no cover - interface

    def wait_cond(self, cond: threading.Condition,
                  timeout: Optional[float] = None) -> bool:
        """``cond.wait(timeout)`` with the timeout on THIS clock.
        Returns False once the (virtual) deadline has passed; True on
        any earlier wake-up. Like the stdlib primitive it may wake
        spuriously — call sites re-check their predicate in a loop."""
        raise NotImplementedError      # pragma: no cover - interface


class RealClock(Clock):
    """Production time: thin delegation to the stdlib."""

    def now(self) -> float:
        return time.monotonic()

    def wall(self) -> float:
        return time.time()

    def perf(self) -> float:
        return time.perf_counter()

    def sleep(self, seconds: float) -> float:
        time.sleep(seconds)
        return self.now()

    def wait_on(self, ev, timeout: Optional[float] = None) -> bool:
        return ev.wait(timeout)

    def wait_for(self, cond, predicate, timeout=None) -> bool:
        return cond.wait_for(predicate, timeout)

    def wait_cond(self, cond, timeout=None) -> bool:
        woke = cond.wait(timeout)
        return True if timeout is None else woke


class ClockEvent:
    """A ``threading.Event`` that notifies its VirtualClock on
    ``set()``, so a virtual ``wait_on`` wakes promptly instead of on
    its safety poll. Transparent on the real clock (never built)."""

    __slots__ = ("_ev", "_clock")

    def __init__(self, clock: "VirtualClock"):
        self._ev = threading.Event()
        self._clock = clock

    def set(self) -> None:
        self._ev.set()
        self._clock.kick()

    def clear(self) -> None:
        self._ev.clear()

    def is_set(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        # a bare .wait on a ClockEvent measures on the virtual clock
        # too — callers that hold one got it from VirtualClock.event()
        return self._clock.wait_on(self, timeout)


class _Waiter:
    """One parked virtual wait: its deadline, the condition to notify
    at expiry (None = parked on the clock's own condvar), and the
    fired flag advance() flips."""

    __slots__ = ("deadline", "seq", "cond", "fired")

    def __init__(self, deadline: float, seq: int,
                 cond: Optional[threading.Condition]):
        self.deadline = deadline
        self.seq = seq
        self.cond = cond
        self.fired = False


class VirtualClock(Clock):
    """Deterministic simulated time.

    Two driving modes:

    * **Driven** (default): time moves only when the test calls
      :meth:`advance` / :meth:`advance_to` — sleepers park on an event
      heap and wake exactly at their deadline, so the whole event
      sequence is a pure function of the calls that advance it.
    * **Autojump** (``autojump=seconds``): when the clock has parked
      waiters and sees no clock activity for that many REAL seconds
      (every thread that participates in time is blocked), it jumps to
      the earliest deadline — trio's MockClock discipline adapted to
      OS threads.

    ``perf()`` is virtual here: simulated work (a virtual sleep inside
    a synthetic engine) must be measured in the currency it was spent
    in, or EWMA service-rate estimates would divide real microseconds
    into virtual records.
    """

    def __init__(self, start: float = 0.0, wall0: float = VIRTUAL_EPOCH,
                 autojump: Optional[float] = None, poll: float = 0.002,
                 max_real_block: float = 120.0):
        self._cv = threading.Condition()
        self._now = float(start)
        self._wall0 = float(wall0)
        self._heap: List[tuple] = []   # (deadline, seq) → waiter
        self._by_seq = {}
        self._seq = 0
        self._activity = 0
        self._busy = 0
        self._poll = float(poll)
        self._autojump = autojump
        self._max_real_block = float(max_real_block)
        self._jumper: Optional[threading.Thread] = None
        self._closed = False
        #: total virtual seconds advanced
        self.simulated = 0.0

    # -- reads ------------------------------------------------------------
    def now(self) -> float:
        return self._now          # float read is atomic under the GIL

    def wall(self) -> float:
        return self._wall0 + self._now

    def perf(self) -> float:
        return self._now

    # -- waiter bookkeeping ----------------------------------------------
    def _register(self, deadline: float,
                  cond: Optional[threading.Condition]) -> _Waiter:
        # registering (= a thread going to sleep) is deliberately NOT
        # activity: a waiter re-arming a short poll must not hold the
        # autojump off forever. Activity is the real wake signals —
        # events firing, kicks, advances.
        with self._cv:
            self._seq += 1
            w = _Waiter(deadline, self._seq, cond)
            heapq.heappush(self._heap, (deadline, w.seq))
            self._by_seq[w.seq] = w
            self._ensure_jumper()
            return w

    def _unregister(self, w: _Waiter) -> None:
        with self._cv:
            self._by_seq.pop(w.seq, None)   # heap entry lazily dropped
            self._cv.notify_all()

    def kick(self) -> None:
        """External wake signal (a ClockEvent fired, work arrived):
        bump activity so autojump holds off, and wake parked
        waiters so they re-check their events."""
        with self._cv:
            self._activity += 1
            self._cv.notify_all()

    @contextlib.contextmanager
    def hold(self):
        """Mark the calling thread BUSY for the block: autojump will
        not advance virtual time while any thread holds. An unparked
        thread doing real compute (an engine dispatch, a compile) is
        invisible to the parked-waiter heuristic — without a hold the
        jumper reads its silence as quiet and races virtual time past
        work that is still happening, which inflates every simulated
        latency by REAL compute time. Driven mode and RealClock are
        unaffected (the jumper is the only reader)."""
        with self._cv:
            self._busy += 1
            self._activity += 1
        try:
            yield
        finally:
            with self._cv:
                self._busy -= 1
                self._activity += 1
                self._cv.notify_all()

    # -- advancing --------------------------------------------------------
    def advance(self, dt: float) -> float:
        """Move virtual time forward by ``dt``; fires every waiter
        whose deadline falls inside, in deadline order, waking each at
        exactly its own instant. Returns the new now()."""
        return self.advance_to(self._now + max(0.0, float(dt)))

    def advance_to(self, target: float) -> float:
        while True:
            notify_conds = []
            with self._cv:
                target = max(target, self._now)
                due = None
                while self._heap:
                    deadline, seq = self._heap[0]
                    w = self._by_seq.get(seq)
                    if w is None:            # stale heap entry
                        heapq.heappop(self._heap)
                        continue
                    if deadline > target:
                        break
                    heapq.heappop(self._heap)
                    due = w
                    break
                if due is None:
                    self.simulated += target - self._now
                    self._now = target
                    self._activity += 1
                    self._cv.notify_all()
                    return self._now
                # step to THIS deadline only: a woken sleeper may
                # register new, earlier work before later waiters fire
                self.simulated += max(0.0, due.deadline - self._now)
                self._now = max(self._now, due.deadline)
                due.fired = True
                self._by_seq.pop(due.seq, None)
                self._activity += 1
                self._cv.notify_all()
                if due.cond is not None:
                    notify_conds.append(due.cond)
            # notify foreign condvars OUTSIDE self._cv: a waiter holds
            # its cond then takes _cv to register — acquiring in the
            # opposite order here would deadlock the pair
            for cond in notify_conds:
                with cond:
                    cond.notify_all()

    def advance_to_next(self) -> Optional[float]:
        """Jump to the earliest parked deadline (None when idle)."""
        with self._cv:
            while self._heap and self._heap[0][1] not in self._by_seq:
                heapq.heappop(self._heap)
            if not self._heap:
                return None
            target = self._heap[0][0]
        return self.advance_to(target)

    # -- autojump ---------------------------------------------------------
    def _ensure_jumper(self) -> None:
        # caller holds _cv
        if self._autojump is None or self._jumper is not None:
            return
        t = threading.Thread(target=self._jump_loop, daemon=True,
                             name="simclock-autojump")
        self._jumper = t
        t.start()

    def _jump_loop(self) -> None:
        last = -1
        while not self._closed:
            time.sleep(self._autojump)
            with self._cv:
                if self._closed:
                    return
                live = [s for _, s in self._heap if s in self._by_seq]
                if not live or self._busy > 0 \
                        or self._activity != last:
                    last = self._activity
                    continue
                target = min(self._by_seq[s].deadline for s in live)
                if target <= self._now:
                    continue
            self.advance_to(target)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    # -- waits ------------------------------------------------------------
    def sleep(self, seconds: float) -> float:
        """Park until virtual time reaches now+seconds. Returns the
        virtual WAKE instant (the waiter's own deadline) — the only
        race-free way for a woken thread to know when it ran: by the
        time it reads ``now()`` another thread may have advanced it."""
        w = self._register(self._now + max(0.0, float(seconds)), None)
        deadline_real = time.monotonic() + self._max_real_block
        try:
            with self._cv:
                while not w.fired:
                    if time.monotonic() >= deadline_real:
                        raise RuntimeError(
                            "virtual sleep blocked for "
                            f"{self._max_real_block}s real time — "
                            "nothing is advancing the VirtualClock")
                    self._cv.wait(self._poll if self._autojump is None
                                  else 1.0)
            return w.deadline
        finally:
            self._unregister(w)

    def event(self):
        return ClockEvent(self)

    def wait_on(self, ev, timeout: Optional[float] = None) -> bool:
        real = getattr(ev, "_ev", ev)   # unwrap ClockEvent
        if timeout is None:
            return real.wait()
        # ClockEvent.set() kicks our condvar, so the poll slice is a
        # safety net only; a plain threading.Event set by a thread
        # that doesn't know the clock is caught by the poll
        slice_s = 0.25 if isinstance(ev, ClockEvent) else self._poll
        w = self._register(self._now + max(0.0, float(timeout)), None)
        deadline_real = time.monotonic() + self._max_real_block
        try:
            with self._cv:
                while True:
                    if real.is_set():
                        return True
                    if w.fired or self._now >= w.deadline:
                        return real.is_set()
                    if time.monotonic() >= deadline_real:
                        raise RuntimeError(
                            "virtual wait_on blocked for "
                            f"{self._max_real_block}s real time — "
                            "nothing is advancing the VirtualClock")
                    self._cv.wait(slice_s)
        finally:
            self._unregister(w)

    def wait_for(self, cond, predicate, timeout=None) -> bool:
        if timeout is None:
            # timeless wait: plain condition semantics, no heap entry
            while not predicate():
                cond.wait(self._poll)
            return True
        w = self._register(self._now + max(0.0, float(timeout)), cond)
        deadline_real = time.monotonic() + self._max_real_block
        try:
            while True:
                if predicate():
                    return True
                if w.fired or self._now >= w.deadline:
                    return predicate()
                if time.monotonic() >= deadline_real:
                    raise RuntimeError(
                        "virtual wait_for blocked for "
                        f"{self._max_real_block}s real time — "
                        "nothing is advancing the VirtualClock")
                cond.wait(self._poll)
        finally:
            self._unregister(w)

    def wait_cond(self, cond, timeout=None) -> bool:
        if timeout is None:
            cond.wait()
            return True
        w = self._register(self._now + max(0.0, float(timeout)), cond)
        try:
            cond.wait(self._poll)
            return not (w.fired or self._now >= w.deadline)
        finally:
            self._unregister(w)


# -- the installed clock ----------------------------------------------------

_REAL = RealClock()
_CLOCK: Clock = _REAL
_INSTALL_LOCK = threading.Lock()


def get() -> Clock:
    return _CLOCK


def install(clock: Clock) -> None:
    """Install ``clock`` process-wide. Tests prefer :func:`use`."""
    global _CLOCK
    with _INSTALL_LOCK:
        _CLOCK = clock


def reset() -> None:
    global _CLOCK
    with _INSTALL_LOCK:
        _CLOCK = _REAL


@contextlib.contextmanager
def use(clock: Clock):
    """``with use(VirtualClock()) as clk: ...`` — install for the
    block, always restored (a leaked virtual clock would wedge every
    later test's timeouts)."""
    prev = _CLOCK
    install(clock)
    try:
        yield clock
    finally:
        install(prev)
        if isinstance(clock, VirtualClock):
            clock.close()


# -- call-time delegation: late-bound so objects built before a test
#    installs its clock still follow it ------------------------------------

def now() -> float:
    return _CLOCK.now()


def wall() -> float:
    return _CLOCK.wall()


def perf() -> float:
    return _CLOCK.perf()


def sleep(seconds: float) -> float:
    return _CLOCK.sleep(seconds)


def event() -> threading.Event:
    return _CLOCK.event()


def hold():
    """``with simclock.hold(): <real compute>`` — marks the calling
    thread busy so an autojumping VirtualClock will not advance
    virtual time past work that is still physically happening. A
    no-op context under RealClock (and harmless under driven virtual
    clocks — only the autojump loop reads the flag)."""
    clock = _CLOCK
    if isinstance(clock, VirtualClock):
        return clock.hold()
    return contextlib.nullcontext()


def wait_on(ev, timeout: Optional[float] = None) -> bool:
    return _CLOCK.wait_on(ev, timeout)


def wait_for(cond: threading.Condition, predicate,
             timeout: Optional[float] = None) -> bool:
    return _CLOCK.wait_for(cond, predicate, timeout)


def wait_cond(cond: threading.Condition,
              timeout: Optional[float] = None) -> bool:
    return _CLOCK.wait_cond(cond, timeout)
