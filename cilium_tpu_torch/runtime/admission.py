"""Bounded admission control for the serving path (the part of the
reference's ``runtime/admission.py``: the classes, the shed reasons,
:func:`count_shed`, :class:`AdmissionGate` for the serving path and
:class:`RequestSlots` for the REST API).

* **Bounded queue occupancy**: ``AdmissionGate.admit`` sheds when the
  queue is at its bound — an explicit, counted shed beats an unbounded
  queue and a timeout.
* **Two priority classes**: ``CLASS_CONTROL`` gets ``control_reserve``
  headroom above the data-path bound.
* **Deadline feasibility**: a request whose deadline cannot be met
  given the queue depth and the recent service rate sheds at
  admission.
* **Drain mode**: ``begin_drain`` stops admitting data-path work.

Sheds are counted on ``cilium_tpu_admission_shed_total{surface,class,
reason}``.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Tuple

from cilium_tpu_torch.runtime import faults, simclock
from cilium_tpu_torch.runtime.metrics import (
    ADMISSION_ADMITTED,
    ADMISSION_QUEUE_DEPTH,
    ADMISSION_REAPED,
    ADMISSION_SHED,
    METRICS,
)

#: priority classes: data-path verdict traffic sheds first; control
#: traffic (policy/config/drain/health) gets reserved headroom
CLASS_DATA = "data"
CLASS_CONTROL = "control"

#: shed reasons (the ``reason`` label on the shed counter)
SHED_QUEUE_FULL = "queue-full"
SHED_DEADLINE = "deadline"
SHED_DRAINING = "draining"
SHED_FAULT = "fault"
#: the verdict ring has no free slot for a new stream lease
#: (runtime/serveloop.py) — explicit, counted, retryable
SHED_RING_FULL = "ring-full"
#: fleet serving: every live host is past its spill headroom
SHED_HOST_OVERLOADED = "host-overloaded"
#: the placed host is draining toward a restart/rejoin
SHED_HOST_DRAINING = "host-draining"
#: the host suspects a partition and fails closed
SHED_PARTITIONED = "partitioned"
#: the requesting tenant is past its weighted fair share of the
#: admission window while the gate is congested: THAT tenant sheds
SHED_TENANT_QUOTA = "tenant-quota"

#: fires at every admission decision; an injected fault forces a shed
#: (reason "fault") — the chaos suite's handle on the gate
ADMIT_POINT = faults.register_point(
    "service.admit", "admission decision in AdmissionGate.admit")


def deadline_from_ms(deadline_ms, default_ms: float,
                     clock=None) -> float:
    """Absolute monotonic deadline from a wire-carried ``deadline_ms``.
    None/0/unparsable → the configured default; NEGATIVE passes
    through as already-expired (the caller declared it gave up — the
    gate sheds it with reason "deadline")."""
    try:
        ms = float(deadline_ms) if deadline_ms is not None else 0.0
    except (TypeError, ValueError):
        ms = 0.0
    if ms == 0.0:
        ms = float(default_ms)
    now = clock() if clock is not None else simclock.now()
    return now + ms / 1e3


def count_shed(surface: str, klass: str, reason: str,
               tenant: str = "") -> None:
    """One shed, on the shared counter — callers that shed outside the
    gate stay on the same series. A
    non-empty ``tenant`` rides as an extra label (tenant-less callers
    keep the exact pre-tenant series)."""
    labels = {"surface": surface, "class": klass, "reason": reason}
    if tenant:
        labels["tenant"] = tenant
    METRICS.inc(ADMISSION_SHED, labels=labels)


class AdmissionGate:
    """The admission decision. ``depth_fn`` reads the guarded queue's
    occupancy so the bound tracks the real backlog."""

    def __init__(self, max_pending: int = 1024,
                 control_reserve: int = 64, enabled: bool = True,
                 depth_fn: Optional[Callable[[], int]] = None,
                 clock=None, surface: str = "service",
                 fairness=None, quotas=None):
        self.max_pending = max(1, int(max_pending))
        self.control_reserve = max(0, int(control_reserve))
        self.enabled = bool(enabled)
        self.depth_fn = depth_fn
        self.clock = clock if clock is not None else simclock.now
        self.surface = surface
        #: per-tenant weighted-fairness window (``over_share`` /
        #: ``note``); None = tenant-blind
        self.fairness = fairness
        #: per-tenant share store (``share_of``) feeding the fairness
        #: ceiling; None = the window's static share
        self.quotas = quotas
        self._lock = threading.Lock()
        self._draining = False
        #: EWMA of the batcher's service rate (records/second) — the
        #: denominator of the deadline-feasibility estimate
        self._rate = 0.0

    @classmethod
    def from_config(cls, cfg, depth_fn=None,
                    surface: str = "service") -> "AdmissionGate":
        """Build from ``Config.admission`` (tolerates absence so
        standalone loaders/old configs keep working)."""
        return cls(
            max_pending=getattr(cfg, "max_pending", 1024),
            control_reserve=getattr(cfg, "control_reserve", 64),
            enabled=getattr(cfg, "enabled", True),
            depth_fn=depth_fn, surface=surface)

    # -- drain ------------------------------------------------------------
    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def begin_drain(self) -> None:
        """Stop admitting data-path work (idempotent). Control traffic
        stays admitted — a draining service must still answer status,
        metrics, and the drain op itself."""
        with self._lock:
            self._draining = True

    # -- feasibility estimate ---------------------------------------------
    def note_batch(self, records: int, seconds: float) -> None:
        """Fold one completed batch into the service-rate EWMA (the
        queue calls this per flush)."""
        if records <= 0 or seconds <= 0.0:
            return
        rate = records / seconds
        with self._lock:
            self._rate = rate if self._rate <= 0.0 \
                else 0.8 * self._rate + 0.2 * rate

    def estimated_wait(self, depth: int) -> float:
        """Seconds a request arriving now waits behind ``depth``
        queued records (0 until a rate estimate exists)."""
        with self._lock:
            rate = self._rate
        return depth / rate if rate > 0.0 else 0.0

    # -- the decision -----------------------------------------------------
    def admit(self, klass: str = CLASS_DATA,
              deadline: Optional[float] = None,
              tenant: str = "") -> Tuple[bool, str]:
        """(admitted, shed_reason). Sheds are counted; admitted
        requests are counted per class. Disabled gates only enforce
        drain mode — drain correctness trumps the knob. A non-empty
        ``tenant`` rides every shed's label and, when a fairness
        window is wired, subjects the request to the weighted-fair
        share check while the gate is congested (past half the
        data-path bound — a lone tenant bursting into idle capacity
        is never penalized)."""
        try:
            faults.maybe_fail(ADMIT_POINT)
        except Exception:  # noqa: BLE001 — plan-chosen exception
            # an injected admission fault IS a shed: the request is
            # refused explicitly, never half-admitted
            count_shed(self.surface, klass, SHED_FAULT, tenant)
            return False, SHED_FAULT
        with self._lock:
            draining = self._draining
        if draining and klass != CLASS_CONTROL:
            count_shed(self.surface, klass, SHED_DRAINING, tenant)
            return False, SHED_DRAINING
        if not self.enabled:
            return True, ""
        depth = self.depth_fn() if self.depth_fn is not None else 0
        METRICS.set_gauge(ADMISSION_QUEUE_DEPTH, float(depth),
                          labels={"surface": self.surface})
        bound = self.max_pending + (self.control_reserve
                                    if klass == CLASS_CONTROL else 0)
        if depth >= bound:
            count_shed(self.surface, klass, SHED_QUEUE_FULL, tenant)
            return False, SHED_QUEUE_FULL
        if (tenant and self.fairness is not None
                and klass != CLASS_CONTROL
                and depth > self.max_pending // 2):
            cap = (self.quotas.share_of(tenant)
                   if self.quotas is not None else None)
            if self.fairness.over_share(tenant, share_cap=cap):
                # the storming tenant sheds; every other tenant's
                # window share is untouched by this decision
                count_shed(self.surface, klass, SHED_TENANT_QUOTA,
                           tenant)
                return False, SHED_TENANT_QUOTA
        if deadline is not None:
            remaining = deadline - self.clock()
            if remaining <= 0.0 or remaining < self.estimated_wait(depth):
                # infeasible: the caller will have given up before we
                # could answer — admitting it only wastes a batch slot
                count_shed(self.surface, klass, SHED_DEADLINE, tenant)
                return False, SHED_DEADLINE
        if tenant and self.fairness is not None:
            self.fairness.note(tenant)
        METRICS.inc(ADMISSION_ADMITTED,
                    labels={"surface": self.surface, "class": klass})
        return True, ""

    def reap(self, count: int = 1) -> None:
        """Count entries dropped before dispatch (abandoned callers /
        expired deadlines)."""
        if count > 0:
            METRICS.inc(ADMISSION_REAPED, count)


class RequestSlots:
    """Bounded in-flight admission for the REST API: each request
    holds a slot for its handler's duration; data-class requests shed
    at ``max_inflight``, control-class requests get ``control_reserve``
    headroom so policy/config/drain ops land during overload."""

    def __init__(self, max_inflight: int = 64,
                 control_reserve: int = 8, enabled: bool = True):
        self.max_inflight = max(0, int(max_inflight))
        self.control_reserve = max(0, int(control_reserve))
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._inflight = 0

    @classmethod
    def from_config(cls, cfg) -> "RequestSlots":
        return cls(max_inflight=getattr(cfg, "api_max_inflight", 64),
                   control_reserve=getattr(cfg, "control_reserve", 64),
                   enabled=getattr(cfg, "enabled", True))

    def acquire(self, klass: str = CLASS_DATA) -> Tuple[bool, str]:
        if not self.enabled:
            with self._lock:
                self._inflight += 1
            return True, ""
        bound = self.max_inflight + (self.control_reserve
                                     if klass == CLASS_CONTROL else 0)
        with self._lock:
            if self._inflight >= bound:
                shed = True
            else:
                shed = False
                self._inflight += 1
        if shed:
            count_shed("api", klass, SHED_QUEUE_FULL)
            return False, SHED_QUEUE_FULL
        METRICS.inc(ADMISSION_ADMITTED,
                    labels={"surface": "api", "class": klass})
        return True, ""

    def release(self) -> None:
        with self._lock:
            if self._inflight > 0:
                self._inflight -= 1

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight
