"""Policy directory watcher — the k8s CNP watcher analog.

Reference: ``pkg/k8s`` resource watchers feed CNP add/update/delete
events into the policy repository (SURVEY.md §3.2); the k8s apiserver
is the source of truth and the agent reconciles. Here the source of
truth is a directory of CNP YAML files (one or more CNPs per file):

* new file / changed mtime → parse; **upsert** each CNP (delete rules
  carrying the CNP's provenance labels, then add — the same
  replace-on-update the reference performs);
* removed file → delete the rules of every CNP it last contained;
* parse errors leave the previously-applied state intact (a bad CNP
  must not wipe enforcement) and are surfaced via metrics.

Runs as a named controller (runtime/controller.py retry loop), matching
how watchers live inside the reference agent.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Tuple

from cilium_tpu_torch.policy.api.cnp import load_cnp_yaml
from cilium_tpu_torch.runtime.metrics import METRICS


class PolicyDirWatcher:
    """Reconcile ``*.yaml`` under ``directory`` into the agent's repo."""

    def __init__(self, agent, directory: str):
        self.agent = agent
        self.directory = directory
        # path → (mtime, [cnp labels tuples])
        self._seen: Dict[str, Tuple[float, List[Tuple[str, ...]]]] = {}

    def scan_once(self) -> int:
        """One reconcile pass; returns the number of apply/delete ops."""
        with self.agent.write_lock:
            return self._scan_locked()

    def _scan_locked(self) -> int:
        ops = 0
        present = {}
        for path in sorted(glob.glob(
                os.path.join(self.directory, "**", "*.yaml"),
                recursive=True)):
            try:
                present[path] = os.stat(path).st_mtime
            except OSError:
                continue  # raced with deletion

        # deletions first: a rename (delete+create) must not end with
        # the old provenance labels still installed
        for path in list(self._seen):
            if path not in present:
                _, label_sets = self._seen.pop(path)
                for labels in label_sets:
                    self.agent.policy_delete(list(labels), wait=False)
                    ops += 1

        for path, mtime in present.items():
            old = self._seen.get(path)
            if old is not None and old[0] == mtime:
                continue
            try:
                cnps = load_cnp_yaml(path)
            except Exception:
                METRICS.inc("cilium_tpu_policy_watch_parse_errors_total", 1)
                # keep previously-applied rules, but record the mtime so
                # the bad file is not re-parsed until it changes again
                self._seen[path] = (mtime, old[1] if old else [])
                continue
            new_label_sets = [tuple(c.labels) for c in cnps]
            if old is not None:  # update: drop CNPs no longer in the file
                for labels in old[1]:
                    if labels not in new_label_sets:
                        self.agent.policy_delete(list(labels), wait=False)
                        ops += 1
            for cnp in cnps:
                self.agent.policy_delete(list(cnp.labels), wait=False)
                self.agent.policy_add(cnp, wait=False)
                ops += 1
            self._seen[path] = (mtime, new_label_sets)

        if ops:
            self.agent.endpoint_manager.regenerate_all(wait=False)
            METRICS.inc("cilium_tpu_policy_watch_ops_total", ops)
        return ops

    def register(self, controllers, interval: float = 2.0) -> None:
        """Install as a named retry-loop controller."""
        controllers.update("policy-dir-watcher", self.scan_once,
                           interval=interval)
