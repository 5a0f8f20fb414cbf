"""Policy repository.

Reference: ``pkg/policy/repository.go`` (SURVEY.md §2.1): holds all rules
under a lock with a monotonically increasing **revision**; rules are
added/deleted by provenance labels; per-identity resolution walks rules
whose ``endpointSelector`` matches the identity's labels.

Where the port differs from the reference: ``matching_rules`` tests only
the rules an identity's labels can select, found through an index of
each rule's first ``matchLabels`` entry (rebuilt when the revision
moves), in the rules' own order, so it returns what the reference's
scan over every rule returns. At BASELINE configs[4] (10000 identities
x 5000 CNPs) the scan made the resolve quadratic.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from cilium_tpu_torch.core.labels import LabelSet, ParseLabel
from cilium_tpu_torch.policy.api.rule import Rule


class Repository:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._rules: List[Rule] = []
        self._revision = 0
        #: (revision, label → rule positions, unindexed positions)
        self._index: Optional[Tuple[int, Dict, List[int]]] = None

    @property
    def revision(self) -> int:
        with self._lock:
            return self._revision

    def add(self, rules: Iterable[Rule], sanitize: bool = True) -> int:
        """Add rules; returns the new revision."""
        rules = list(rules)
        if sanitize:
            for r in rules:
                r.sanitize()
        with self._lock:
            self._rules.extend(rules)
            self._revision += 1
            return self._revision

    def delete_by_labels(self, labels: Sequence[str]) -> Tuple[int, int]:
        """Delete rules carrying all of ``labels``; returns
        (n_deleted, new_revision)."""
        want = set(labels)
        with self._lock:
            keep = [r for r in self._rules if not want.issubset(set(r.labels))]
            n = len(self._rules) - len(keep)
            if n:
                self._rules = keep
                self._revision += 1
            return n, self._revision

    def replace_all(self, rules: Iterable[Rule], sanitize: bool = True) -> int:
        rules = list(rules)
        if sanitize:
            for r in rules:
                r.sanitize()
        with self._lock:
            self._rules = rules
            self._revision += 1
            return self._revision

    def rules(self) -> Tuple[Rule, ...]:
        with self._lock:
            return tuple(self._rules)

    def matching_rules(self, endpoint_labels: LabelSet) -> Tuple[Rule, ...]:
        """Rules whose endpointSelector matches (resolvePolicyLocked's
        outer loop)."""
        with self._lock:
            # Rule.selects applies the pod/node scope split: CCNP
            # nodeSelector rules only select host endpoints and pod
            # rules never do (reference: host-firewall policies are
            # sourced exclusively from nodeSelector CCNPs)
            _, by_label, rest = self._selector_index()
            hits = set(rest)
            for lbl in endpoint_labels:
                hits.update(by_label.get((lbl.key, None), ()))
                hits.update(by_label.get((lbl.key, lbl.value), ()))
            return tuple(
                self._rules[i] for i in sorted(hits)
                if self._rules[i].selects(endpoint_labels)
            )

    def _selector_index(self):
        """The index ``matching_rules`` reads, for this revision: a rule
        whose endpointSelector's first ``matchLabels`` entry is ``k: v``
        can only select label sets holding a label of key ``k`` (and
        value ``v`` unless ``v`` is empty: a presence match), as
        ``EndpointSelector.matches`` tests it; rules with no
        ``matchLabels`` are always tested. Called under the lock."""
        if self._index is not None and self._index[0] == self._revision:
            return self._index
        by_label: Dict[Tuple[str, Optional[str]], List[int]] = {}
        rest: List[int] = []
        for i, r in enumerate(self._rules):
            ml = r.endpoint_selector.match_labels
            if not ml:
                rest.append(i)
                continue
            k, v = ml[0]
            sel = ParseLabel(k if v == "" else f"{k}={v}")
            by_label.setdefault((sel.key, v or None), []).append(i)
        self._index = (self._revision, by_label, rest)
        return self._index

    def __len__(self) -> int:
        with self._lock:
            return len(self._rules)
