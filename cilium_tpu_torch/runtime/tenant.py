"""Tenant namespaces for the control plane (counterpart of the
reference's ``runtime/tenant.py``).

- :data:`SHARED_NAMESPACE` — where patterns claimed by several tenants
  (or by none) land;
- :func:`parse_ranges`, :func:`parse_weights` and :class:`TenantMap` —
  the declared identity-range → tenant mapping (``[tenant].ranges``)
  plus per-tenant fair-queueing weights. Pure and deterministic.
- :class:`TenantQuotas` — the per-tenant share store with TTL'd
  entries. A share not refreshed within its TTL lapses to the
  conservative default, and a LOST read (the ``tenant.quota`` fault
  point) fails to the same conservative default — a tenant whose
  quota record vanished is bounded, never unbounded.
- :class:`FairShareWindow` — the weighted-fair admission window on
  the installed clock: per-tenant admitted counts over a rotating
  quantum. Rotation happens at EXACTLY ``window_start + quantum_s``
  (closed boundary), so the fairness decision is an exact virtual
  tick, never sleep-shaped.

The namespace partition of the bank plane is built by the loader from
this map — see ``Loader._tenant_namer`` and ``policy/compiler/bankplan``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

from cilium_tpu_torch.runtime import faults, simclock
from cilium_tpu_torch.runtime.metrics import METRICS, TENANT_QUOTA_READS

#: the namespace of identities matching no declared range, and of
#: requests that declare no tenant
DEFAULT_TENANT = "default"

#: patterns claimed by two or more tenants (or by none) land in the
#: shared namespace: their banks are common infrastructure, and a
#: shared bank recompile is attributable to every claimant
SHARED_NAMESPACE = "shared"

#: fires on every per-tenant quota-store read: a fired fault models
#: the quota record being lost/unreadable and MUST fail to the
#: conservative default share — bounded, never unbounded
TENANT_QUOTA_POINT = faults.register_point(
    "tenant.quota", "per-tenant quota-store read in TenantQuotas")


def parse_ranges(specs: Sequence[str]
                 ) -> Tuple[Tuple[str, int, int], ...]:
    """``"name:lo-hi"`` declarations → ((name, lo, hi), ...) with
    inclusive bounds; malformed entries raise at config time, not at
    admission time."""
    out = []
    for spec in specs:
        name, _, span = spec.partition(":")
        lo, _, hi = span.partition("-")
        if not (name and lo and hi):
            raise ValueError(f"bad tenant range {spec!r} "
                             f"(want 'name:lo-hi')")
        out.append((name, int(lo), int(hi)))
    return tuple(out)


def parse_weights(specs: Sequence[str]) -> Dict[str, float]:
    """``"name:weight"`` declarations → {name: weight}; weights must
    be positive (a zero-weight tenant could never drain its queue)."""
    out: Dict[str, float] = {}
    for spec in specs:
        name, _, w = spec.partition(":")
        if not (name and w):
            raise ValueError(f"bad tenant weight {spec!r} "
                             f"(want 'name:weight')")
        weight = float(w)
        if weight <= 0.0:
            raise ValueError(f"tenant weight must be > 0: {spec!r}")
        out[name] = weight
    return out


class TenantMap:
    """The declared tenant partition: identity ranges + weights.

    Immutable after construction and safe to share across threads —
    every lookup is a pure read."""

    def __init__(self, ranges: Sequence[str] = (),
                 weights: Sequence[str] = (),
                 default_tenant: str = DEFAULT_TENANT):
        self.ranges = parse_ranges(ranges)
        self.weights = parse_weights(weights)
        self.default_tenant = default_tenant or DEFAULT_TENANT

    @classmethod
    def from_config(cls, cfg) -> "TenantMap":
        return cls(ranges=cfg.tenant.ranges,
                   weights=cfg.tenant.weights,
                   default_tenant=cfg.tenant.default_tenant)

    def tenant_of(self, identity: int) -> str:
        """First declared range containing ``identity`` wins; no
        match → the default tenant."""
        nid = int(identity)
        for name, lo, hi in self.ranges:
            if lo <= nid <= hi:
                return name
        return self.default_tenant

    def weight_of(self, tenant: str) -> float:
        return self.weights.get(tenant, 1.0)

    def tenants(self) -> Tuple[str, ...]:
        """Every declared tenant name, deterministic order."""
        seen = []
        for name, _, _ in self.ranges:
            if name not in seen:
                seen.append(name)
        return tuple(seen)


class _QuotaEntry:
    __slots__ = ("share", "expires_at")

    def __init__(self, share: float, expires_at: float):
        self.share = share
        self.expires_at = expires_at


class TenantQuotas:
    """TTL'd per-tenant share store with a conservative default.

    ``share_of`` is the ONE read path, and it is where the
    ``tenant.quota`` fault point fires: a lost read returns the
    conservative default share (bounded), counted ``fault-default``.
    An entry whose TTL lapsed — ``expires_at <= now``, the closed
    boundary the DST boundary suite pins — reads as the default too,
    counted ``lapsed``; a live entry counts ``live``."""

    def __init__(self, default_share: float = 0.5,
                 ttl_s: float = 60.0, clock=None):
        self.default_share = float(default_share)
        self.ttl_s = float(ttl_s)
        self.clock = clock if clock is not None else simclock.now
        self._lock = threading.Lock()
        self._entries: Dict[str, _QuotaEntry] = {}

    @classmethod
    def from_config(cls, cfg, clock=None) -> "TenantQuotas":
        return cls(default_share=cfg.tenant.max_share,
                   ttl_s=cfg.tenant.quota_ttl_s, clock=clock)

    def set_share(self, tenant: str, share: float,
                  ttl_s: Optional[float] = None) -> None:
        ttl = self.ttl_s if ttl_s is None else float(ttl_s)
        entry = _QuotaEntry(float(share), self.clock() + ttl)
        with self._lock:
            self._entries[tenant] = entry

    def share_of(self, tenant: str) -> float:
        try:
            faults.maybe_fail(TENANT_QUOTA_POINT)
        except faults.FaultInjected:
            # the quota record is unreadable: the tenant is bounded
            # by the conservative default, never unbounded
            METRICS.inc(TENANT_QUOTA_READS,
                        labels={"result": "fault-default"})
            return self.default_share
        now = self.clock()
        with self._lock:
            entry = self._entries.get(tenant)
            if entry is not None and entry.expires_at <= now:
                # lapsed AT the tick (closed boundary): drop it so a
                # later refresh starts a fresh TTL
                del self._entries[tenant]
                entry = None
        if entry is None:
            METRICS.inc(TENANT_QUOTA_READS,
                        labels={"result": "lapsed"})
            return self.default_share
        METRICS.inc(TENANT_QUOTA_READS, labels={"result": "live"})
        return entry.share

    def status(self) -> Dict:
        now = self.clock()
        with self._lock:
            return {
                "tenants": sorted(self._entries),
                "live": sum(1 for e in self._entries.values()
                            if e.expires_at > now),
                "default_share": self.default_share,
            }


class FairShareWindow:
    """Per-tenant admitted counts over a rotating virtual-time
    quantum — the AdmissionGate's weighted-fairness memory.

    The window rotates at EXACTLY ``window_start + quantum_s`` (``now
    >= start + quantum``, closed boundary): the counts reset and the
    storming tenant gets a fresh fair chance every quantum. A tenant
    is over-share only when BOTH hold — its CURRENT share of the
    window is past the hard ``max_share`` ceiling AND past its
    weighted fair share among the tenants seen this window. Judging
    the current share (never the would-be-next fraction) means a
    tenant sitting exactly AT its fair share still admits — two equal
    tenants alternate instead of mutually shedding at equilibrium —
    and a lone tenant (fair share 1.0) is never penalized."""

    def __init__(self, quantum_s: float = 1.0, max_share: float = 0.5,
                 weight_of=None, clock=None):
        self.quantum_s = float(quantum_s)
        self.max_share = float(max_share)
        self.weight_of = weight_of or (lambda tenant: 1.0)
        self.clock = clock if clock is not None else simclock.now
        self._lock = threading.Lock()
        self._start = self.clock()
        self._counts: Dict[str, int] = {}
        self._total = 0

    def _rotate_locked(self, now: float) -> None:
        if now >= self._start + self.quantum_s:
            # land the new window's start ON the quantum grid so a
            # long idle gap doesn't skew the next rotation tick
            lapsed = int((now - self._start) // self.quantum_s)
            self._start += lapsed * self.quantum_s
            self._counts.clear()
            self._total = 0

    def note(self, tenant: str) -> None:
        """Record one admission for ``tenant`` in the current window."""
        now = self.clock()
        with self._lock:
            self._rotate_locked(now)
            self._counts[tenant] = self._counts.get(tenant, 0) + 1
            self._total += 1

    def over_share(self, tenant: str,
                   share_cap: Optional[float] = None) -> bool:
        """Is ``tenant`` past its fair share of the current window?

        ``share_cap`` overrides the window's ``max_share`` ceiling
        (the per-tenant quota read feeds it)."""
        cap = self.max_share if share_cap is None else float(share_cap)
        now = self.clock()
        with self._lock:
            self._rotate_locked(now)
            total = self._total
            if total <= 0:
                return False
            frac = self._counts.get(tenant, 0) / total
            if frac <= cap:
                return False
            weights = {t: self.weight_of(t) for t in self._counts}
            weights.setdefault(tenant, self.weight_of(tenant))
            wsum = sum(weights.values())
            fair = weights[tenant] / wsum if wsum > 0 else 1.0
            return frac > fair

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def window_start(self) -> float:
        with self._lock:
            return self._start
