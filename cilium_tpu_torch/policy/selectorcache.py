"""SelectorCache: selectors → live numeric-identity sets.

Reference: ``pkg/policy/selectorcache.go`` (SURVEY.md §2.1) — maps each
``EndpointSelector``/``FQDNSelector`` to the current set of numeric
identities, with incremental add/del notification to subscribers so
policy stays O(Δ) under identity churn rather than re-resolving the
world.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, FrozenSet, Iterable, Optional, Set, Union

from cilium_tpu_torch.core.identity import IdentityAllocator, NumericIdentity
from cilium_tpu_torch.core.labels import LabelSet
from cilium_tpu_torch.policy.api.selector import EndpointSelector, FQDNSelector

Selector = Union[EndpointSelector, FQDNSelector]
#: callback(selector, added_ids, deleted_ids)
SelectionListener = Callable[[Selector, FrozenSet[int], FrozenSet[int]], None]


class SelectorCache:
    def __init__(self, allocator: Optional[IdentityAllocator] = None):
        self._lock = threading.Lock()
        self._identities: Dict[NumericIdentity, LabelSet] = {}
        self._selections: Dict[Selector, Set[int]] = {}
        self._listeners: list[SelectionListener] = []
        if allocator is not None:
            for nid in allocator.identities():
                lbls = allocator.lookup(nid)
                if lbls is not None:
                    self._identities[nid] = lbls

    # -- identity churn ---------------------------------------------------
    def add_identity(self, nid: NumericIdentity, labels: LabelSet) -> None:
        with self._lock:
            self._identities[nid] = labels
            for sel, current in self._selections.items():
                if isinstance(sel, EndpointSelector) and sel.matches(labels):
                    if nid not in current:
                        current.add(nid)
                        self._notify(sel, frozenset([nid]), frozenset())

    def remove_identity(self, nid: NumericIdentity) -> None:
        with self._lock:
            self._identities.pop(nid, None)
            for sel, current in self._selections.items():
                if nid in current:
                    current.discard(nid)
                    self._notify(sel, frozenset(), frozenset([nid]))

    def sync_identities(
        self, identities: Dict[NumericIdentity, LabelSet]
    ) -> None:
        """Bulk replace (initial sync / clustermesh merge)."""
        for nid, lbls in identities.items():
            self.add_identity(nid, lbls)
        for nid in list(self._identities):
            if nid not in identities:
                self.remove_identity(nid)

    # -- selector registration -------------------------------------------
    def add_selector(self, sel: Selector) -> FrozenSet[int]:
        with self._lock:
            if sel not in self._selections:
                if isinstance(sel, EndpointSelector):
                    self._selections[sel] = {
                        nid
                        for nid, lbls in self._identities.items()
                        if sel.matches(lbls)
                    }
                else:
                    self._selections[sel] = set()  # FQDN: fed by NameManager
            return frozenset(self._selections[sel])

    def remove_selector(self, sel: Selector) -> None:
        """Drop a selector no user references anymore (cilium's
        RemoveSelector): its selections stop receiving churn updates."""
        with self._lock:
            self._selections.pop(sel, None)

    def dump(self):
        """Registered selectors → selected identities (the
        ``cilium-dbg policy selectors`` surface)."""
        with self._lock:
            return [
                {"selector": sel.cache_key(),
                 "kind": type(sel).__name__,
                 "identities": sorted(int(i) for i in ids)}
                for sel, ids in sorted(
                    self._selections.items(),
                    key=lambda kv: kv[0].cache_key())
            ]

    def get_selections(self, sel: Selector) -> FrozenSet[int]:
        with self._lock:
            got = self._selections.get(sel)
            if got is not None:
                return frozenset(got)
        return self.add_selector(sel)

    def update_fqdn_selections(
        self, sel: FQDNSelector, identities: Iterable[int]
    ) -> bool:
        """NameManager feeds CIDR identities of resolved IPs here
        (SURVEY.md §3.5 tail). Returns True when the selection changed.

        Deliberately does NOT create the selector: only selectors still
        registered (added via :meth:`add_selector`, not yet removed) are
        updated, so a concurrent ``remove_selector`` can never be
        resurrected by an in-flight NameManager resync."""
        new = set(identities)
        with self._lock:
            cur = self._selections.get(sel)
            if cur is None:
                return False
            added = frozenset(new - cur)
            deleted = frozenset(cur - new)
            if added or deleted:
                self._selections[sel] = new
                self._notify(sel, added, deleted)
                return True
        return False

    # -- notifications ----------------------------------------------------
    def subscribe(self, listener: SelectionListener) -> None:
        self._listeners.append(listener)

    def _notify(self, sel, added, deleted) -> None:
        for fn in self._listeners:
            fn(sel, added, deleted)

    def identities(self) -> Dict[NumericIdentity, LabelSet]:
        with self._lock:
            return dict(self._identities)
