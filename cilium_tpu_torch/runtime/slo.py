"""Live SLO telemetry: multi-window burn-rate gauges over declared
targets (a copy of the reference's ``runtime/slo.py``).

* ``serve-p99`` — "99% of served chunks complete under
  ``serve_p99_ms``"; burn rate = observed bad fraction / 0.01.
* ``serve-shed`` — "the shed rate stays under ``shed_rate``"; burn
  rate = observed shed fraction / the declared rate.

Each SLO is tracked over every window in ``windows_s`` with bounded
bucketed counters on the installed simclock; observations carrying a
tenant also land in that tenant's own windows. Published as
``cilium_tpu_slo_burn_rate{slo,window[,tenant][,host]}``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional, Tuple

from cilium_tpu_torch.runtime import simclock
from cilium_tpu_torch.runtime.metrics import METRICS, SLO_BURN_RATE

#: buckets per window: granularity of expiry, not of the rate itself
_BUCKETS = 30


class _Window:
    """Bounded bucketed (bad, total) counters over one trailing
    window."""

    __slots__ = ("window_s", "bucket_s", "buckets")

    def __init__(self, window_s: float):
        self.window_s = float(window_s)
        self.bucket_s = self.window_s / _BUCKETS
        #: deque of [bucket_start, bad, total]
        self.buckets: deque = deque(maxlen=_BUCKETS + 1)

    def observe(self, now: float, bad: bool) -> None:
        start = now - (now % self.bucket_s)
        if not self.buckets or self.buckets[-1][0] != start:
            self.buckets.append([start, 0, 0])
        b = self.buckets[-1]
        b[1] += 1 if bad else 0
        b[2] += 1

    def fraction(self, now: float) -> Tuple[int, int]:
        cutoff = now - self.window_s
        bad = total = 0
        for start, b, t in self.buckets:
            if start + self.bucket_s <= cutoff:
                continue
            bad += b
            total += t
        return bad, total


class SLOTracker:
    """Burn-rate tracking for the serve loop's two declared SLOs.
    Thread-safe; observation is O(windows)."""

    def __init__(self, serve_p99_ms: float = 50.0,
                 shed_rate: float = 1e-3,
                 windows_s: Tuple[float, ...] = (300.0, 3600.0),
                 host: str = ""):
        #: which host this tracker burns FOR: a fleet replica sets it so
        #: its gauges stay distinct series; a standalone tracker
        #: publishes unlabeled series
        self.host = str(host)
        self.serve_p99_s = float(serve_p99_ms) / 1e3
        #: the latency SLO's error budget: p99 ⇒ 1% may exceed
        self.latency_budget = 0.01
        self.shed_budget = max(float(shed_rate), 1e-9)
        self.windows_s = tuple(float(w) for w in windows_s) or (300.0,)
        self._lock = threading.Lock()
        self._lat = {w: _Window(w) for w in self.windows_s}
        self._shed = {w: _Window(w) for w in self.windows_s}
        #: per-tenant window sets, created on first observation —
        #: keyed by the CONFIGURED tenant set (plus "default"), so
        #: cardinality is operator-bounded, never flow-driven
        self._tenant_lat: Dict[str, Dict[float, _Window]] = {}
        self._tenant_shed: Dict[str, Dict[float, _Window]] = {}

    @classmethod
    def from_config(cls, cfg) -> Optional["SLOTracker"]:
        """Build from ``Config.slo``; None when disabled or absent
        (embedders with older configs keep working)."""
        if cfg is None or not getattr(cfg, "enabled", False):
            return None
        return cls(serve_p99_ms=getattr(cfg, "serve_p99_ms", 50.0),
                   shed_rate=getattr(cfg, "shed_rate", 1e-3),
                   windows_s=tuple(getattr(cfg, "windows_s",
                                           (300.0, 3600.0))))

    # -- observation ------------------------------------------------------
    def _tenant_windows_locked(self, registry, tenant: str):
        wins = registry.get(tenant)
        if wins is None:
            wins = {w: _Window(w) for w in self.windows_s}
            registry[tenant] = wins
        return wins

    def observe_latency(self, latency_s: float,
                        tenant: str = "") -> None:
        now = simclock.now()
        bad = latency_s > self.serve_p99_s
        with self._lock:
            for w in self._lat.values():
                w.observe(now, bad)
            if tenant:
                for w in self._tenant_windows_locked(
                        self._tenant_lat, tenant).values():
                    w.observe(now, bad)

    def observe_request(self, shed: bool, tenant: str = "") -> None:
        """One admission outcome (served or shed) for the
        availability SLO, attributed to ``tenant`` when given."""
        now = simclock.now()
        with self._lock:
            for w in self._shed.values():
                w.observe(now, shed)
            if tenant:
                for w in self._tenant_windows_locked(
                        self._tenant_shed, tenant).values():
                    w.observe(now, shed)

    # -- read-out ---------------------------------------------------------
    @staticmethod
    def _label(window_s: float) -> str:
        return f"{int(window_s)}s"

    def burn_rates(self) -> Dict[str, Dict[str, float]]:
        """{slo: {window label: burn rate}} over the trailing
        windows. Windows with no observations burn 0.0."""
        now = simclock.now()
        out: Dict[str, Dict[str, float]] = {"serve-p99": {},
                                            "serve-shed": {}}
        with self._lock:
            for ws, w in self._lat.items():
                bad, total = w.fraction(now)
                frac = bad / total if total else 0.0
                out["serve-p99"][self._label(ws)] = round(
                    frac / self.latency_budget, 4)
            for ws, w in self._shed.items():
                bad, total = w.fraction(now)
                frac = bad / total if total else 0.0
                out["serve-shed"][self._label(ws)] = round(
                    frac / self.shed_budget, 4)
        return out

    def tenant_burn_rates(self) -> Dict[str, Dict[str, Dict[str,
                                                            float]]]:
        """{tenant: {slo: {window label: burn rate}}} over every
        tenant that has observed — the isolation invariant's per-
        tenant SLO face."""
        now = simclock.now()
        out: Dict[str, Dict[str, Dict[str, float]]] = {}
        with self._lock:
            tenants = set(self._tenant_lat) | set(self._tenant_shed)
            for tenant in sorted(tenants):
                rates: Dict[str, Dict[str, float]] = {
                    "serve-p99": {}, "serve-shed": {}}
                for ws, w in self._tenant_lat.get(tenant,
                                                  {}).items():
                    bad, total = w.fraction(now)
                    frac = bad / total if total else 0.0
                    rates["serve-p99"][self._label(ws)] = round(
                        frac / self.latency_budget, 4)
                for ws, w in self._tenant_shed.get(tenant,
                                                   {}).items():
                    bad, total = w.fraction(now)
                    frac = bad / total if total else 0.0
                    rates["serve-shed"][self._label(ws)] = round(
                        frac / self.shed_budget, 4)
                out[tenant] = rates
        return out

    def publish(self) -> Dict[str, Dict[str, float]]:
        """Refresh the burn-rate gauges (called once per pack cycle —
        cheap, bounded by slos × windows × configured tenants) and
        return the aggregate rates."""
        rates = self.burn_rates()
        for slo, per_window in rates.items():
            for window, rate in per_window.items():
                labels = {"slo": slo, "window": window}
                if self.host:
                    labels["host"] = self.host
                METRICS.set_gauge(SLO_BURN_RATE, rate, labels=labels)
        for tenant, per_slo in self.tenant_burn_rates().items():
            for slo, per_window in per_slo.items():
                for window, rate in per_window.items():
                    labels = {"slo": slo, "window": window,
                              "tenant": tenant}
                    if self.host:
                        labels["host"] = self.host
                    METRICS.set_gauge(SLO_BURN_RATE, rate,
                                      labels=labels)
        return rates

    def window_totals(self) -> Dict[str, int]:
        """Requests observed per trailing window — the weights the
        fleet-weighted burn-rate roll-up multiplies each host's rate
        by (a quiet host must not dilute a burning one equally)."""
        now = simclock.now()
        out: Dict[str, int] = {}
        with self._lock:
            for ws, w in self._shed.items():
                _bad, total = w.fraction(now)
                out[self._label(ws)] = total
        return out

    def status(self) -> Dict[str, object]:
        out = {
            "targets": {"serve_p99_ms": self.serve_p99_s * 1e3,
                        "shed_rate": self.shed_budget},
            "windows_s": list(self.windows_s),
            "burn_rates": self.burn_rates(),
        }
        tenants = self.tenant_burn_rates()
        if tenants:
            out["tenants"] = tenants
        return out
