"""Compiled-artifact cache (a copy of the reference's
``runtime/checkpoint.py``).

Compiled policies are content-addressed by a fingerprint of the rule
set + engine config, so a restarted loader skips automaton compilation.

* The cache is **byte-bounded**: past ``max_bytes`` the least-recently-
  used entries are evicted (counted). The serving policy's artifact and
  the warm-restart snapshot are *protected*.
* :class:`BankArtifactStore` makes compiled bank GROUPS distributable
  artifacts: content-addressed by their bank key, wrapped with a
  sha256 checksum, fetched on registry miss. A corrupt, truncated, or
  lost artifact (the ``artifact.fetch`` injection point) degrades to
  a counted recompile — never a crash, never a silently wrong bank.

:func:`ruleset_fingerprint` hashes the pickle of its parts. Bank keys
(tuples of pattern strings and compile options) are therefore equal to
the reference's. Per-identity fingerprints hash MapState key tuples
that carry the ``TrafficDirection`` enum, which pickle names by its
defining module: the tuples equal the reference's, the digests differ
by that name (and so does the artifact key derived from them). The two
packages keep separate cache directories (``LoaderConfig.cache_dir``),
so neither ever unpickles the other's classes.
"""


from __future__ import annotations

import collections
import hashlib
import os
import pickle
import threading
from typing import Any, Iterable, Optional

from cilium_tpu_torch.runtime import faults
from cilium_tpu_torch.runtime.metrics import (
    ARTIFACT_CACHE_CORRUPT,
    ARTIFACT_CACHE_EVICTIONS,
    BANK_ARTIFACT_FETCHES,
    METRICS,
)

#: everything a poisoned/stale pickle can legitimately raise: I/O
#: failures, truncation, garbage bytes, and artifacts referencing
#: classes that moved or vanished across versions. Deliberately NOT
#: ``Exception`` — a MemoryError or KeyboardInterrupt mid-load must
#: propagate, not silently turn into "cache miss, recompile"
_CORRUPT_ERRORS = (OSError, EOFError, pickle.UnpicklingError,
                   AttributeError, ImportError)

#: fires on every compiled-bank artifact fetch: a fired fault models a
#: lost/corrupt distributed artifact — the fetch degrades to a counted
#: recompile, never a crash or a silently wrong bank
ARTIFACT_FETCH_POINT = faults.register_point(
    "artifact.fetch",
    "compiled-bank artifact fetch in runtime/checkpoint."
    "BankArtifactStore (a fired fault = lost/corrupt artifact; "
    "degrade to recompile, counted)")


def ruleset_fingerprint(*parts: Any) -> str:
    """Stable hash over arbitrary picklable rule-set descriptors."""
    h = hashlib.sha256()
    for p in parts:
        h.update(pickle.dumps(p, protocol=4))
    return h.hexdigest()[:24]


class ArtifactCache:
    """On-disk pickle cache with an in-process byte-bounded LRU.

    ``max_bytes=0`` disables the bound.
    LRU order is tracked in-process (gets/puts move to MRU) and seeded
    from file mtimes on first touch, so a restarted process evicts the
    artifacts the PREVIOUS incarnation used least recently rather than
    arbitrary ones. Keys in the protected set are never evicted."""

    def __init__(self, cache_dir: str, enable: bool = True,
                 max_bytes: int = 0):
        self.cache_dir = cache_dir
        self.enable = enable
        self.max_bytes = max(0, int(max_bytes))
        self.evictions = 0
        self._lock = threading.Lock()
        self._protected: frozenset = frozenset()
        #: key → file size, in LRU order (oldest first); lazily seeded
        self._sizes: "collections.OrderedDict[str, int]" = \
            collections.OrderedDict()
        self._scanned = False
        if enable:
            os.makedirs(cache_dir, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.cache_dir, f"{key}.pkl")

    # -- byte-bound bookkeeping -------------------------------------------
    def _scan_locked(self) -> None:
        """Seed the size/LRU index from the dir (once): mtime order
        approximates the previous incarnation's recency."""
        if self._scanned:
            return
        self._scanned = True
        entries = []
        try:
            names = os.listdir(self.cache_dir)
        except OSError:
            return
        for name in names:
            if not name.endswith(".pkl"):
                continue
            path = os.path.join(self.cache_dir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            entries.append((st.st_mtime, name[:-4], int(st.st_size)))
        for _, key, size in sorted(entries):
            self._sizes[key] = size

    def _touch_locked(self, key: str, size: Optional[int] = None
                      ) -> None:
        self._scan_locked()
        if size is not None:
            self._sizes[key] = size
        if key in self._sizes:
            self._sizes.move_to_end(key)

    def _evict_locked(self) -> None:
        if not self.max_bytes:
            return
        total = sum(self._sizes.values())
        if total <= self.max_bytes:
            return
        for key in list(self._sizes):
            if total <= self.max_bytes:
                break
            if key in self._protected:
                continue
            size = self._sizes.pop(key)
            total -= size
            try:
                os.remove(self._path(key))
            except OSError:
                pass  # already gone — the byte goal is what matters
            self.evictions += 1
            METRICS.inc(ARTIFACT_CACHE_EVICTIONS)

    def set_protected(self, keys: Iterable[str]) -> None:
        """Replace the eviction-exempt key set (the loader keeps the
        serving artifact + warm snapshot here). Never evicting the
        serving key is a correctness property of the warm-restart
        path, not an optimization."""
        with self._lock:
            self._protected = frozenset(k for k in keys if k)

    def total_bytes(self) -> int:
        with self._lock:
            self._scan_locked()
            return sum(self._sizes.values())

    # -- read/write -------------------------------------------------------
    def get(self, key: str) -> Optional[Any]:
        if not self.enable:
            return None
        path = self._path(key)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                value = pickle.load(f)
        except _CORRUPT_ERRORS:
            # corrupt entry → recompile; DELETE it so every later get
            # of this key is a clean miss instead of a re-parse of the
            # same poison, and count it so a recurring corruption
            # (bad disk, version skew) is visible to operators
            METRICS.inc(ARTIFACT_CACHE_CORRUPT)
            try:
                os.remove(path)
            except OSError:
                pass  # already gone, or unremovable — miss either way
            with self._lock:
                self._sizes.pop(key, None)
            return None
        with self._lock:
            self._touch_locked(key)
        return value

    def put(self, key: str, value: Any) -> None:
        if not self.enable:
            return
        # unique tmp per writer: concurrent puts of the same key are
        # benign (content-addressed) but must not race on one tmp file
        tmp = self._path(key) + f".{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(value, f, protocol=4)
        size = os.path.getsize(tmp)
        os.replace(tmp, self._path(key))
        with self._lock:
            self._touch_locked(key, size)
            self._evict_locked()


class BankArtifactStore:
    """Compiled bank groups as distributable, checksummed artifacts.

    Content-addressed bank keys (policy/compiler/bankplan.py) make a
    compiled group location-transparent: any host that compiled it can
    publish it here, any host that needs it can fetch instead of
    compiling. The payload is pickled separately and wrapped with a
    sha256 so a torn write, bit rot, or a wrong-content artifact under
    the right name is DETECTED — the fetch returns None (counted
    ``corrupt``) and the caller recompiles. Fail closed on integrity,
    open on availability."""

    FORMAT = "bank-art-v1"
    _PREFIX = "bankart-"

    def __init__(self, cache: ArtifactCache):
        self.cache = cache

    def put(self, key: str, group: Any) -> None:
        if not self.cache.enable:
            return
        payload = pickle.dumps(group, protocol=4)
        self.cache.put(self._PREFIX + key, {
            "format": self.FORMAT,
            "sha": hashlib.sha256(payload).hexdigest(),
            "payload": payload,
        })

    def fetch(self, key: str) -> Optional[Any]:
        """The distributed-fetch seam. Returns the compiled group, or
        None on miss/corruption/fault — the caller's recompile path is
        the degradation for every failure mode."""
        if not self.cache.enable:
            return None
        try:
            faults.maybe_fail(ARTIFACT_FETCH_POINT)
            entry = self.cache.get(self._PREFIX + key)
        except faults.FaultInjected:
            # a lost artifact (network partition, GC'd blob store):
            # indistinguishable from a miss to the caller
            METRICS.inc(BANK_ARTIFACT_FETCHES,
                        labels={"result": "corrupt"})
            return None
        if entry is None:
            METRICS.inc(BANK_ARTIFACT_FETCHES,
                        labels={"result": "miss"})
            return None
        try:
            if (not isinstance(entry, dict)
                    or entry.get("format") != self.FORMAT):
                raise ValueError("unknown bank-artifact format")
            payload = entry["payload"]
            if hashlib.sha256(payload).hexdigest() != entry["sha"]:
                raise ValueError("bank-artifact checksum mismatch")
            group = pickle.loads(payload)
        except _CORRUPT_ERRORS + (KeyError, TypeError, ValueError):
            # verified-corrupt: delete the poison so later fetches are
            # clean misses, count it, recompile
            METRICS.inc(BANK_ARTIFACT_FETCHES,
                        labels={"result": "corrupt"})
            try:
                os.remove(self.cache._path(self._PREFIX + key))
            except OSError:
                pass
            return None
        METRICS.inc(BANK_ARTIFACT_FETCHES, labels={"result": "hit"})
        return group
