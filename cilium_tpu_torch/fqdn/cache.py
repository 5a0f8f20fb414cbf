"""DNS TTL cache (counterpart of the reference's ``fqdn/cache.py``,
copied): per-name IP sets with TTL expiry, min-TTL clamping and JSON
persist/restore, on the port's ``simclock``.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, Iterable, List, Optional, Set

from cilium_tpu_torch.runtime import simclock
from cilium_tpu_torch.policy.compiler import matchpattern


class DNSCache:
    def __init__(self, min_ttl: int = 60) -> None:
        self._lock = threading.Lock()
        self.min_ttl = min_ttl
        # name → ip → expiry time
        self._names: Dict[str, Dict[str, float]] = {}

    def update(self, lookup_time: float, name: str, ips: Iterable[str],
               ttl: int) -> bool:
        """Record a DNS answer. Returns True if new IPs appeared."""
        name = matchpattern.sanitize_name(name)
        ttl = max(ttl, self.min_ttl)
        expiry = lookup_time + ttl
        changed = False
        with self._lock:
            entry = self._names.setdefault(name, {})
            for ip in ips:
                if ip not in entry:
                    changed = True
                old = entry.get(ip, 0.0)
                entry[ip] = max(old, expiry)
        return changed

    def lookup(self, name: str, now: Optional[float] = None) -> List[str]:
        name = matchpattern.sanitize_name(name)
        now = simclock.wall() if now is None else now
        with self._lock:
            entry = self._names.get(name, {})
            return sorted(ip for ip, exp in entry.items() if exp > now)

    def lookup_by_regex(self, regex, now: Optional[float] = None
                        ) -> Dict[str, List[str]]:
        now = simclock.wall() if now is None else now
        out: Dict[str, List[str]] = {}
        with self._lock:
            for name, entry in self._names.items():
                if regex.match(name):
                    live = sorted(ip for ip, exp in entry.items() if exp > now)
                    if live:
                        out[name] = live
        return out

    def expire(self, now: Optional[float] = None) -> Set[str]:
        """Drop expired IPs; returns names that lost IPs (the reference's
        GC feeds these into policy updates)."""
        now = simclock.wall() if now is None else now
        affected: Set[str] = set()
        with self._lock:
            for name, entry in list(self._names.items()):
                dead = [ip for ip, exp in entry.items() if exp <= now]
                for ip in dead:
                    del entry[ip]
                    affected.add(name)
                if not entry:
                    del self._names[name]
        return affected

    # -- persist/restore (checkpoint/resume, SURVEY.md §5.4) -------------
    def to_json(self) -> str:
        with self._lock:
            return json.dumps(self._names)

    @classmethod
    def from_json(cls, data: str, min_ttl: int = 60) -> "DNSCache":
        c = cls(min_ttl=min_ttl)
        c._names = {n: dict(v) for n, v in json.loads(data).items()}
        return c

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._names)
