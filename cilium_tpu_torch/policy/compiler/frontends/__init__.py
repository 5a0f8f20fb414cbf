"""Protocol-frontend compiler plane: ``l7proto`` rule specs as
banked-automaton compiler frontends (a copy of the reference's
``policy/compiler/frontends``).

A frontend owns three things:

* **identity** — the ``l7proto`` name it claims and the engine family
  lane it verdicts on (an ``L7Type`` value > GENERIC, ≤ 7: the family
  rides the memo row mirror ``(ep, l7type, dport)``, the loader's
  per-family fingerprint split and the 3-bit family field of the
  provenance word);
* **predicate extraction** — validating a rule's field keys and values
  at compile time (unknown keys fail loudly) and lowering each rule
  (:meth:`ProtocolFrontend.lower_rule`) into one full-match pattern
  over the protocol's ONE high-cardinality **scan field** (cassandra's
  query table, memcached's key, r2d2's file) for the ``l7g`` banked
  automaton, plus interned ``(proto, key, value)`` pair requirements
  for every small-cardinality enum field, matched by the generic
  path's pair-subset check;
* nothing else — framing stays in the proxylib parser.

The module is also the ONE registry of the ``l7proto`` universe:
``proxylib.parser.register_parser`` feeds :func:`register_proxy_parser`,
and a policy naming an ``l7proto`` that is neither an engine frontend
nor a registered proxy parser raises :class:`UnknownL7ProtoError` at
compile time.

The loader keys its per-identity family fingerprints by the family
names (``runtime/loader._identity_family_tuples``), so the port's
``PolicyDelta`` equals the reference's only while the name sets are
equal: :data:`PROTOS` and :data:`MAX_FAMILY` keep the reference's
values.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from cilium_tpu_torch.policy.api.l7 import SanitizeError


class UnknownL7ProtoError(SanitizeError):
    """A policy names an ``l7proto`` with neither an engine frontend
    nor a registered proxy parser."""


@dataclasses.dataclass(frozen=True)
class FrontendSpec:
    """What a protocol frontend declares about itself."""

    #: the ``l7proto`` / ``register_parser`` name (one registry)
    name: str
    #: engine family lane (an L7Type value > GENERIC, ≤ MAX_FAMILY)
    family: int
    #: family name in the memo/delta enums
    family_name: str
    #: legal rule field keys — anything else fails loudly at compile
    fields: Tuple[str, ...] = ()
    #: the ONE high-cardinality field whose value scans through the
    #: ``l7g`` banked automaton; "" = no scan field (all-enum protocol)
    scan_field: str = ""
    doc: str = ""


# -- the lowering ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LoweredRule:
    """One frontend rule, lowered for the engine:

    * ``pattern`` — full-match regex over the record's scan-field value
      (None = the rule leaves the scan field unconstrained);
    * ``pairs`` — required interned-predicate triples ``(proto, key,
      value)``; value ``""`` is a presence requirement;
    * ``dead`` — the rule is unsatisfiable (two distinct exact values
      for the scan field)."""

    pattern: Optional[str]
    pairs: Tuple[Tuple[str, str, str], ...]
    dead: bool = False


def scan_value(proto: str, fields: Dict[str, str]) -> bytes:
    """The bytes the ``l7g`` automaton scans for one record: the
    frontend's scan field's value (empty when absent — absence vs
    present-but-empty is carried by the presence pair id, never by the
    scan)."""
    fe = _FRONTENDS.get(proto)
    if fe is None or not fe.spec.scan_field:
        return b""
    return str(fields.get(fe.spec.scan_field, "")).encode("utf-8")


# -- the frontend contract ---------------------------------------------------


class ProtocolFrontend:
    """Base frontend: subclass, set :attr:`spec`, optionally override
    :meth:`validate_rule` or :meth:`value_pattern`, and
    :func:`register_frontend` the instance at import time. The default
    lowering is the oracle's exact-match semantics."""

    spec: FrontendSpec

    def validate_rule(self, pairs: Sequence[Tuple[str, str]]) -> None:
        """Raise :class:`SanitizeError` on a rule no record of this
        protocol could ever produce. The base check is the field-key
        universe."""
        legal = set(self.spec.fields)
        for k, _v in pairs:
            if k not in legal:
                raise SanitizeError(
                    f"l7proto {self.spec.name!r}: unknown rule field "
                    f"{k!r} (known: {sorted(legal)})")

    def value_pattern(self, value: str) -> str:
        """Scan-field value constraint → full-match regex over the scan
        bytes (exact: plain literals keep a bank's subset construction
        trie-shaped)."""
        return re.escape(value)

    def lower_rule(self, pairs: Sequence[Tuple[str, str]]
                   ) -> LoweredRule:
        """Split one rule's pairs into the scan-field pattern and the
        interned enum/presence predicates (the oracle's exact-match
        semantics)."""
        proto = self.spec.name
        scan_key = self.spec.scan_field
        scan_vals: Set[str] = set()
        scan_presence = False
        enum: List[Tuple[str, str, str]] = []
        seen: Set[Tuple[str, str, str]] = set()
        for k, v in pairs:
            k, v = str(k), str(v)
            if k == scan_key:
                if v:
                    scan_vals.add(v)
                else:
                    scan_presence = True
                continue
            t = (proto, k, v)
            if t not in seen:
                seen.add(t)
                enum.append(t)
        if len(scan_vals) > 1:
            return LoweredRule(None, (), dead=True)
        pattern = (self.value_pattern(next(iter(scan_vals)))
                   if scan_vals else None)
        if scan_presence and not scan_vals:
            # presence-only scan-field constraint: the presence pair id
            # carries it (the scan cannot see absent-vs-empty)
            enum.append((proto, scan_key, ""))
        return LoweredRule(pattern, tuple(enum))


# -- registry ----------------------------------------------------------------

#: name → engine frontend (import-time registrations)
_FRONTENDS: Dict[str, ProtocolFrontend] = {}
#: family id → name (uniqueness check)
_FAMILY_NAMES: Dict[int, str] = {}
#: parser names registered with proxylib (``register_parser``)
_PROXY_PARSERS: Set[str] = set()

#: family ids the 3-bit provenance-word field can carry
MAX_FAMILY = 7


def register_frontend(fe: ProtocolFrontend) -> ProtocolFrontend:
    from cilium_tpu_torch.core.flow import L7Type

    spec = fe.spec
    if not (int(L7Type.GENERIC) < spec.family <= MAX_FAMILY):
        raise ValueError(
            f"frontend {spec.name!r}: family {spec.family} outside "
            f"({int(L7Type.GENERIC)}, {MAX_FAMILY}] — base families "
            f"are reserved and the provenance word carries 3 bits")
    prev = _FAMILY_NAMES.get(spec.family)
    if prev is not None and prev != spec.name:
        raise ValueError(
            f"frontend {spec.name!r}: family {spec.family} already "
            f"claimed by {prev!r}")
    # ctlint: disable=unbounded-registry  # import-time frontend registrations (one per frontend module)
    _FRONTENDS[spec.name] = fe
    # ctlint: disable=unbounded-registry  # bounded by MAX_FAMILY (3-bit provenance family field)
    _FAMILY_NAMES[spec.family] = spec.name
    return fe


def register_proxy_parser(name: str) -> None:
    """Record a proxylib parser name in the unified registry (called by
    ``proxylib.parser.register_parser``)."""
    # ctlint: disable=unbounded-registry  # import-time parser registrations (one per proxylib module)
    _PROXY_PARSERS.add(name)


def get(name: str) -> Optional[ProtocolFrontend]:
    return _FRONTENDS.get(name)


def frontends() -> Dict[str, ProtocolFrontend]:
    return dict(_FRONTENDS)


def family_of(proto: str) -> int:
    """Engine family id of a frontend ``l7proto`` (0 = not a
    frontend — the record stays on the generic pair path)."""
    fe = _FRONTENDS.get(proto)
    return fe.spec.family if fe is not None else 0


def family_name_of(proto: str) -> Optional[str]:
    fe = _FRONTENDS.get(proto)
    return fe.spec.family_name if fe is not None else None


def family_names() -> Dict[int, str]:
    """family id → memo/delta family name, every registered
    frontend."""
    return {fe.spec.family: fe.spec.family_name
            for fe in _FRONTENDS.values()}


def _ensure_parsers_loaded() -> None:
    """The proxy half of the registry fills when the port's proxylib
    imports; validation must not depend on who imported what first."""
    import cilium_tpu_torch.proxylib  # noqa: F401  (registers parsers)


def known_l7protos() -> Set[str]:
    _ensure_parsers_loaded()
    return set(_FRONTENDS) | set(_PROXY_PARSERS)


def validate_l7proto(proto: str) -> None:
    """Raise :class:`UnknownL7ProtoError` unless ``proto`` is an engine
    frontend or a registered proxy parser."""
    _ensure_parsers_loaded()
    if proto in _FRONTENDS or proto in _PROXY_PARSERS:
        return
    raise UnknownL7ProtoError(
        f"unknown l7proto {proto!r}: not an engine frontend and no "
        f"proxylib parser is registered under that name (known: "
        f"{sorted(set(_FRONTENDS) | set(_PROXY_PARSERS))})")


# the shipped frontends register on package import
from cilium_tpu_torch.policy.compiler.frontends import (  # noqa: E402,F401
    cassandra,
    memcached,
    r2d2,
)

#: the registered frontend protos (the reference's three)
PROTOS: Tuple[str, ...] = tuple(_FRONTENDS)
