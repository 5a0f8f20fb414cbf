"""Deterministic, seeded fault injection (a copy of the reference's
``runtime/faults.py``).

Named **injection points** sit at the seams where failures happen, and
a :class:`FaultPlan` decides, deterministically, which hits of which
point raise what:

* **Zero cost when idle.** ``maybe_fail`` is a module-global ``None``
  check when no plan is installed.
* **Replayable.** Every decision is drawn from a per-point RNG seeded
  by ``(plan seed, point name)`` and consumed in per-point hit order.
* **Plans choose the exception** (:class:`FaultInjected` by default).

Points the port registers: ``engine.dispatch`` (device dispatch,
``engine/verdict.py``; the session's ``serve_ids`` fires it),
``service.admit`` (``runtime/admission.py``), ``serve.lease`` and
``serve.ring_slot`` (``runtime/serveloop.py``).

Usage::

    with inject(FaultPlan([FaultRule("engine.dispatch", times=1)])):
        ...
"""

from __future__ import annotations

import contextlib
import random
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from cilium_tpu_torch.runtime.metrics import FAULTS_INJECTED, METRICS


class FaultInjected(Exception):
    """Default exception raised at an armed injection point."""


class FaultRule:
    """One point's failure policy.

    ``prob``  — per-hit fire probability (1.0 = every eligible hit).
    ``times`` — max fires (None = unbounded); after that the point is
                permanently healthy, which is how chaos tests model
                "the outage ends".
    ``after`` — skip the first N hits (fault appears mid-run).
    ``exc``   — exception *class* to raise (``FaultInjected`` default);
                instantiated with ``message`` per fire so tracebacks
                carry the point name.
    """

    def __init__(self, point: str, prob: float = 1.0,
                 times: Optional[int] = None, after: int = 0,
                 exc: type = FaultInjected,
                 message: Optional[str] = None):
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {prob}")
        self.point = point
        self.prob = prob
        self.times = times
        self.after = after
        self.exc = exc
        self.message = message or f"injected fault at {point}"


class _PointState:
    """Per-point mutable state: its own RNG, counters, and trace."""

    __slots__ = ("rule", "rng", "hits", "fires", "trace", "lock")

    def __init__(self, rule: FaultRule, seed: int):
        self.rule = rule
        # crc32 folds the point name into the seed so two points under
        # one plan draw independent, order-free decision streams
        self.rng = random.Random(
            (seed << 32) ^ zlib.crc32(rule.point.encode()))
        self.hits = 0
        self.fires = 0
        self.trace: List[Tuple[int, bool]] = []
        self.lock = threading.Lock()

    def decide(self) -> Optional[Exception]:
        with self.lock:
            idx = self.hits
            self.hits += 1
            # the RNG is consumed on EVERY hit (fired or not) so the
            # decision at hit k never depends on times/after gating
            draw = self.rng.random()
            fire = (idx >= self.rule.after
                    and (self.rule.times is None
                         or self.fires < self.rule.times)
                    and draw < self.rule.prob)
            if fire:
                self.fires += 1
            self.trace.append((idx, fire))
        if not fire:
            return None
        return self.rule.exc(f"{self.rule.message} (hit {idx})")


class FaultPlan:
    """A seeded set of :class:`FaultRule`\\ s plus the recorded trace."""

    def __init__(self, rules: Sequence[FaultRule] = (), seed: int = 0):
        self.seed = seed
        self._points: Dict[str, _PointState] = {}
        for r in rules:
            if r.point in self._points:
                raise ValueError(f"duplicate rule for point {r.point!r}")
            self._points[r.point] = _PointState(r, seed)

    def check(self, point: str) -> Optional[Exception]:
        st = self._points.get(point)
        return st.decide() if st is not None else None

    def trace(self) -> Dict[str, List[Tuple[int, bool]]]:
        """point → [(hit index, fired)] — the replayable event trace."""
        return {p: list(st.trace) for p, st in self._points.items()}

    def counts(self, point: str) -> Tuple[int, int]:
        """(hits, fires) for one point (0, 0 if never hit/ruled)."""
        st = self._points.get(point)
        return (st.hits, st.fires) if st is not None else (0, 0)


#: the armed plan; ``None`` (the default, and the production state)
#: makes every ``maybe_fail`` a single global read
_PLAN: Optional[FaultPlan] = None
_PLAN_LOCK = threading.Lock()

#: advisory registry of seams that call ``maybe_fail`` (introspection /
#: docs; unknown points still work — the registry is not a gate)
_POINTS: Dict[str, str] = {}


def register_point(name: str, doc: str = "") -> str:
    """Declare an injection point (module import time). Returns the
    name so seams can do ``POINT = register_point(...)``."""
    _POINTS.setdefault(name, doc)
    return name


def registered_points() -> Dict[str, str]:
    return dict(_POINTS)


def install(plan: FaultPlan) -> None:
    global _PLAN
    with _PLAN_LOCK:
        if _PLAN is not None:
            raise RuntimeError("a FaultPlan is already installed")
        _PLAN = plan


def clear() -> None:
    global _PLAN
    with _PLAN_LOCK:
        _PLAN = None


def active() -> Optional[FaultPlan]:
    return _PLAN


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """``with inject(plan): ...`` — install for the block, always
    cleared on exit (a leaked plan would fail unrelated tests)."""
    install(plan)
    try:
        yield plan
    finally:
        clear()


def maybe_fail(point: str) -> None:
    """The seam probe. Raises the plan's exception when the armed plan
    says this hit of ``point`` fails; otherwise (or with no plan) does
    nothing. Seams call this unconditionally — disarmed cost is one
    global read."""
    plan = _PLAN
    if plan is None:
        return
    exc = plan.check(point)
    if exc is not None:
        METRICS.inc(FAULTS_INJECTED, labels={"point": point})
        # a fired fault under an active flight-recorder trace becomes
        # a span event — the trace shows WHICH request the fault hit
        # (import here: the disarmed path must stay one global read)
        from cilium_tpu_torch.runtime.tracing import TRACER

        TRACER.event("fault.injected", point=point,
                     exc=type(exc).__name__)
        raise exc
