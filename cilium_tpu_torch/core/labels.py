"""Labels and label sets.

Models the reference's ``pkg/labels`` (``Label{Key, Value, Source}``,
``Labels`` map) at the level needed for policy selector matching.  A label
has a *source* prefix — ``k8s:``, ``reserved:``, ``cidr:``, ``any:`` —
where ``any:`` in a *selector* matches a label with the same key/value from
any source (reference: ``pkg/labels/labels.go``, unverified paths per
SURVEY.md provenance note).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional, Tuple

SOURCE_ANY = "any"
SOURCE_K8S = "k8s"
SOURCE_RESERVED = "reserved"
SOURCE_CIDR = "cidr"
SOURCE_UNSPEC = "unspec"


@dataclasses.dataclass(frozen=True, order=True)
class Label:
    """A single ``source:key=value`` label."""

    key: str
    value: str = ""
    source: str = SOURCE_ANY

    def format(self) -> str:
        if self.value:
            return f"{self.source}:{self.key}={self.value}"
        return f"{self.source}:{self.key}"

    def matches(self, other: "Label") -> bool:
        """Selector-style match: ``self`` (from a selector) vs ``other``
        (on an endpoint). ``any:`` source on the selector side matches any
        source on the endpoint side."""
        if self.key != other.key or self.value != other.value:
            return False
        return self.source == SOURCE_ANY or self.source == other.source

    def __str__(self) -> str:  # pragma: no cover - debug convenience
        return self.format()


#: Label key tagging which cluster an identity came from (reference:
#: ``io.cilium.k8s.policy.cluster``). Canonical home here so both the
#: policy layer and the identity allocator read one definition without
#: an import cycle; ``policy.api.rule`` re-exports it.
CLUSTER_LABEL_KEY = "io.cilium.k8s.policy.cluster"


def ParseLabel(s: str) -> Label:
    """Parse ``[source:]key[=value]`` into a Label.

    Mirrors the reference's ``labels.ParseLabel``: a missing source defaults
    to ``any`` (selector context) — callers storing endpoint labels should
    pass explicit sources.
    """
    source = SOURCE_ANY
    rest = s
    if ":" in rest:
        maybe_src, after = rest.split(":", 1)
        # a '=' before ':' means the ':' was inside the value, not a source
        if "=" not in maybe_src:
            source, rest = maybe_src, after
    if "=" in rest:
        key, value = rest.split("=", 1)
    else:
        key, value = rest, ""
    return Label(key=key, value=value, source=source or SOURCE_ANY)


class LabelSet:
    """An immutable set of labels keyed by ``source:key``.

    Hashable and order-independent so it can key identity allocation
    (reference: ``labels.Labels`` + ``LabelArray`` sorted form).
    """

    __slots__ = ("_labels", "_sorted", "_hash")

    def __init__(self, labels: Iterable[Label] = ()):  # noqa: D401
        d: Dict[Tuple[str, str], Label] = {}
        for lbl in labels:
            d[(lbl.source, lbl.key)] = lbl
        self._labels: Tuple[Label, ...] = tuple(sorted(d.values()))
        self._sorted = self._labels
        self._hash = hash(self._labels)

    @classmethod
    def from_dict(cls, d: Mapping[str, str], source: str = SOURCE_K8S) -> "LabelSet":
        return cls(Label(key=k, value=v, source=source) for k, v in d.items())

    @classmethod
    def parse(cls, items: Iterable[str]) -> "LabelSet":
        return cls(ParseLabel(s) for s in items)

    def __iter__(self):
        return iter(self._sorted)

    def __len__(self) -> int:
        return len(self._sorted)

    def __eq__(self, other) -> bool:
        return isinstance(other, LabelSet) and self._sorted == other._sorted

    def __hash__(self) -> int:
        return self._hash

    def get(self, key: str, source: Optional[str] = None) -> Optional[Label]:
        for lbl in self._sorted:
            if lbl.key == key and (source is None or lbl.source == source):
                return lbl
        return None

    def has(self, sel_label: Label) -> bool:
        """True if some label in the set matches the selector label
        (key equality; value equality unless selector value empty —
        empty-value selector labels are key-presence matches)."""
        for lbl in self._sorted:
            if lbl.key != sel_label.key:
                continue
            if sel_label.source not in (SOURCE_ANY, lbl.source):
                continue
            if sel_label.value == "" or sel_label.value == lbl.value:
                return True
        return False

    def format(self) -> Tuple[str, ...]:
        return tuple(l.format() for l in self._sorted)

    def __repr__(self) -> str:  # pragma: no cover - debug convenience
        return f"LabelSet({list(self.format())})"
