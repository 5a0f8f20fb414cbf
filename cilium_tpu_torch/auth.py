"""Mutual-auth state: which identity pairs have completed a handshake.

Reference: the auth map + ``pkg/auth`` (SURVEY §2.1's AuthType slot is
the demand side; this is the supply side) — traffic whose winning
policy entry demands authentication DROPS until the pair
(src identity, dst identity) appears here, with expiration like the
datapath's auth map entries. The agent stages the pair set as a sorted
table next to the policy (same discipline as rule tensors: host
mutates, device consumes a snapshot; the engine's ``_stage_auth``
copies it to the card).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np

# ctlint: disable=unused-import  # re-export: the reference defines AUTH_UNENFORCED in auth.py, and the port's callers (cli.py) import the engine's own object from here
from cilium_tpu_torch.engine.verdict import AUTH_UNENFORCED  # noqa: F401
from cilium_tpu_torch.runtime import simclock
from cilium_tpu_torch.runtime.metrics import METRICS

#: padding sentinel GREATER than any real identity (identities are
#: non-negative int32): sentinel rows at the tail keep the padded
#: table lexicographically sorted. Two int32 words, as the reference
#: stages them.
PAIR_SENTINEL = np.iinfo(np.int32).max

#: ``AUTH_UNENFORCED`` (imported above) is the engine's own object:
#: the explicit opt-out for ``authed_pairs`` on the verdict calls
#: (auth demand surfaces as an output lane only and auth-requiring
#: traffic still forwards). The engine and the oracle test it with
#: ``is``, so there is exactly one. Passing ``None`` instead is
#: fail-closed — auth-demanding flows drop until a pairs table is
#: supplied.


class AuthManager:
    """Authed (src, dst) identity pairs with expiry."""

    def __init__(self, default_ttl: float = 3600.0):
        self.default_ttl = default_ttl
        self._lock = threading.Lock()
        self._pairs: Dict[Tuple[int, int], float] = {}  # pair → expiry
        self._version = 0
        #: (version, earliest_expiry_among_cached, array)
        self._cached: Optional[Tuple[int, float, np.ndarray]] = None

    def authenticate(self, src_identity: int, dst_identity: int,
                     ttl: Optional[float] = None) -> None:
        """Record a completed handshake (the reference's auth map
        upsert after the auth service signs off)."""
        src, dst = int(src_identity), int(dst_identity)
        for nid in (src, dst):
            # one out-of-range pair would make every later
            # pairs_array() build raise (int32 overflow) and poison the
            # whole verdict path; == PAIR_SENTINEL would match padding
            if not (0 <= nid < PAIR_SENTINEL):
                raise ValueError(f"identity {nid} outside int32 range")
        expiry = simclock.wall() + (self.default_ttl if ttl is None else ttl)
        with self._lock:
            self._pairs[(src, dst)] = expiry
            self._version += 1
            METRICS.set_gauge("cilium_tpu_auth_pairs",
                              float(len(self._pairs)))

    def revoke(self, src_identity: int, dst_identity: int) -> bool:
        with self._lock:
            hit = self._pairs.pop((int(src_identity),
                                   int(dst_identity)), None)
            if hit is not None:
                self._version += 1
            METRICS.set_gauge("cilium_tpu_auth_pairs",
                              float(len(self._pairs)))
        return hit is not None

    def expire(self) -> int:
        """GC lapsed entries (controller duty). Returns count removed."""
        now = simclock.wall()
        with self._lock:
            dead = [p for p, exp in self._pairs.items() if exp <= now]
            for p in dead:
                del self._pairs[p]
            if dead:
                self._version += 1
            METRICS.set_gauge("cilium_tpu_auth_pairs",
                              float(len(self._pairs)))
        return len(dead)

    def is_authed(self, src_identity: int, dst_identity: int) -> bool:
        with self._lock:
            exp = self._pairs.get((int(src_identity), int(dst_identity)))
        return exp is not None and exp > simclock.wall()

    def pairs(self) -> Dict[Tuple[int, int], float]:
        with self._lock:
            return dict(self._pairs)

    def pairs_array(self) -> np.ndarray:
        """Live pairs as a lexicographically sorted [P, 2] int32 table
        (src, dst columns), padded to the next power of two with
        sentinel rows so the engine sees few distinct shapes. Cached behind a
        version counter AND the earliest expiry of the cached set: the
        hot path pays a dict lookup when nothing changed, yet a lapsed
        TTL invalidates at the next call — expiry binds at lookup time
        (as the reference datapath checks auth-map expiration inline),
        not at the next GC sweep."""
        now = simclock.wall()
        with self._lock:
            if (self._cached is not None
                    and self._cached[0] == self._version
                    and now < self._cached[1]):
                return self._cached[2]
            live = sorted((s, d) for (s, d), exp in self._pairs.items()
                          if exp > now)
            earliest = min((exp for exp in self._pairs.values()
                            if exp > now), default=float("inf"))
            size = 8
            while size < len(live):
                size *= 2
            out = np.full((size, 2), PAIR_SENTINEL, dtype=np.int32)
            for i, (s, d) in enumerate(live):
                out[i] = (s, d)
            self._cached = (self._version, earliest, out)
            return out
