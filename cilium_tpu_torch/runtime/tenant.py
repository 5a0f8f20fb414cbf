"""Tenant namespaces for the control plane: the part of the
reference's ``runtime/tenant.py`` the loader and the compile queue
read.

- :data:`SHARED_NAMESPACE` — where patterns claimed by several tenants
  (or by none) land;
- :func:`parse_ranges`, :func:`parse_weights` and :class:`TenantMap` —
  the declared identity-range → tenant mapping (``[tenant].ranges``)
  plus per-tenant fair-queueing weights. Pure and deterministic.

The admission plane's ``TenantQuotas`` and ``FairShareWindow`` arrive
with their only reader, the DST slice (queue 1, Q11). The namespace
partition of the bank plane is built by the loader from this map — see
``Loader._tenant_namer`` and ``policy/compiler/bankplan``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

#: the namespace of identities matching no declared range, and of
#: requests that declare no tenant
DEFAULT_TENANT = "default"

#: patterns claimed by two or more tenants (or by none) land in the
#: shared namespace: their banks are common infrastructure, and a
#: shared bank recompile is attributable to every claimant
SHARED_NAMESPACE = "shared"

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
