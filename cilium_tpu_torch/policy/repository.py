"""Policy repository.

Reference: ``pkg/policy/repository.go`` (SURVEY.md §2.1): holds all rules
under a lock with a monotonically increasing **revision**; rules are
added/deleted by provenance labels; per-identity resolution walks rules
whose ``endpointSelector`` matches the identity's labels.
"""

from __future__ import annotations

import threading
from typing import Iterable, List, Sequence, Tuple

from cilium_tpu_torch.core.labels import LabelSet
from cilium_tpu_torch.policy.api.rule import Rule


class Repository:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._rules: List[Rule] = []
        self._revision = 0

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
            return tuple(
                r for r in self._rules if r.selects(endpoint_labels)
            )

    def __len__(self) -> int:
        with self._lock:
            return len(self._rules)
