"""Secret store: the k8s-Secret source for secret-backed policy values
(a copy of the reference's ``secrets.py``).

Reference: header-match values may come from k8s Secrets
(``pkg/policy/api/http.go ·HeaderMatch.Secret`` + the agent's secret
sync). Here a thread-safe in-process table keyed by (namespace, name);
the agent owns one and threads a ``lookup`` into the loader so both
engines resolve the same snapshot at compile time.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple


class SecretStore:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, str], str] = {}

    def set(self, namespace: str, name: str, value: str) -> None:
        with self._lock:
            self._values[(namespace, name)] = value

    def delete(self, namespace: str, name: str) -> None:
        with self._lock:
            self._values.pop((namespace, name), None)

    def lookup(self, namespace: str, name: str) -> Optional[str]:
        with self._lock:
            return self._values.get((namespace, name))

    def __len__(self) -> int:
        with self._lock:
            return len(self._values)


def resolve_header_value(hm, secret_lookup) -> Optional[str]:
    """Effective expected value of a HeaderMatch: the secret's value
    when a secret ref is set (None if unresolvable — FAIL matches must
    then fail closed), else the inline value."""
    if hm.secret is not None:
        if secret_lookup is None:
            return None
        return secret_lookup(*hm.secret)
    return hm.value
