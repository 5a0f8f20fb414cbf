"""Endpoint and FQDN selectors.

Reference: ``pkg/policy/api/selector.go`` (``EndpointSelector`` wraps a
k8s ``LabelSelector``: matchLabels + matchExpressions) and
``pkg/policy/api/fqdn.go`` (``FQDNSelector{MatchName, MatchPattern}``).
Unverified paths — SURVEY.md provenance note.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from cilium_tpu_torch.core.labels import Label, LabelSet, ParseLabel


@dataclasses.dataclass(frozen=True)
class MatchExpression:
    """k8s LabelSelectorRequirement: key op [values]."""

    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist
    values: Tuple[str, ...] = ()

    def matches(self, labels: LabelSet) -> bool:
        sel = ParseLabel(self.key)
        present = labels.has(Label(key=sel.key, value="", source=sel.source))
        if self.operator == "Exists":
            return present
        if self.operator == "DoesNotExist":
            return not present
        if self.operator == "In":
            return any(
                labels.has(Label(key=sel.key, value=v, source=sel.source))
                for v in self.values
            )
        if self.operator == "NotIn":
            return not any(
                labels.has(Label(key=sel.key, value=v, source=sel.source))
                for v in self.values
            )
        raise ValueError(f"unknown matchExpressions operator {self.operator!r}")


@dataclasses.dataclass(frozen=True)
class EndpointSelector:
    """Selects endpoints by labels.

    ``match_labels`` keys may carry a source prefix (``k8s:app`` /
    ``any:app`` / ``reserved:host``); bare keys default to ``any:``
    (reference behavior for selectors).  The empty selector selects *all*
    endpoints (wildcard); ``None`` in rule fields means "no constraint
    from this field".
    """

    match_labels: Tuple[Tuple[str, str], ...] = ()
    match_expressions: Tuple[MatchExpression, ...] = ()

    @classmethod
    def from_dict(cls, d: Optional[Dict]) -> "EndpointSelector":
        d = d or {}
        ml = tuple(sorted((d.get("matchLabels") or {}).items()))
        me = tuple(
            MatchExpression(
                key=e["key"],
                operator=e["operator"],
                values=tuple(e.get("values") or ()),
            )
            for e in (d.get("matchExpressions") or ())
        )
        return cls(match_labels=ml, match_expressions=me)

    @classmethod
    def from_labels(cls, **kv: str) -> "EndpointSelector":
        return cls(match_labels=tuple(sorted(kv.items())))

    def is_wildcard(self) -> bool:
        return not self.match_labels and not self.match_expressions

    def matches(self, labels: LabelSet) -> bool:
        for k, v in self.match_labels:
            sel = ParseLabel(k if v == "" else f"{k}={v}")
            if not labels.has(Label(key=sel.key, value=v, source=sel.source)):
                return False
        for expr in self.match_expressions:
            if not expr.matches(labels):
                return False
        return True

    def cache_key(self) -> str:
        parts = [f"{k}={v}" for k, v in self.match_labels]
        parts += [
            f"{e.key} {e.operator} {','.join(e.values)}"
            for e in self.match_expressions
        ]
        return "&".join(parts) if parts else "<all>"


#: Wildcard selector singleton.
WildcardEndpointSelector = EndpointSelector()

#: Selector matching the reserved world entity.
ReservedWorldSelector = EndpointSelector(
    match_labels=(("reserved:world", ""),)
)


@dataclasses.dataclass(frozen=True)
class FQDNSelector:
    """toFQDNs selector: exact name or glob pattern.

    Reference semantics (``pkg/policy/api/fqdn.go``): ``matchName`` is an
    exact, case-insensitive DNS name; ``matchPattern`` allows ``*`` as
    "zero or more DNS-valid characters within a label" (no dot crossing).
    """

    match_name: str = ""
    match_pattern: str = ""

    def cache_key(self) -> str:
        return f"name={self.match_name}&pattern={self.match_pattern}"
