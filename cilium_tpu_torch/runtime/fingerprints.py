"""Sharded, byte-bounded identity-fingerprint store (a copy of the
reference's ``runtime/fingerprints.py``).

The loader derives every commit's artifact key and bank-scoped
invalidation delta from per-identity fingerprints
(``runtime/loader.identity_fingerprints`` /
``identity_family_fingerprints``). This store makes the walk O(Δ):
fingerprints are cached per identity, keyed by the **object identity**
of the resolved MapState. A MapState is immutable once handed to the
loader — every resolver builds fresh objects per resolve — so a caller
that reuses unchanged MapState objects pays only for the identities it
touched. The entry pins a strong reference to the MapState, so its
``id()`` can never be recycled while the entry lives.

Shards are byte-bounded LRUs (``[compile] fp_cache_max_bytes``
total). Eviction is pure cost, never correctness: an evicted bundle
recomputes on next use and fingerprints are pure functions of
content."""


from __future__ import annotations

import collections
import threading
from typing import Callable, Dict

from cilium_tpu_torch.runtime.metrics import (
    FP_CACHE_EVICTIONS,
    METRICS,
)

#: shard count: fixed (identity id mod N) — the store is in-process,
#: so sharding buys lock granularity and eviction isolation, not
#: placement; 8 matches the registry default
N_SHARDS = 8


class _FPShard:
    __slots__ = ("lock", "entries", "bytes")

    def __init__(self):
        self.lock = threading.Lock()
        #: identity → (mapstate ref, fingerprint bundle, nbytes),
        #: LRU order
        self.entries: "collections.OrderedDict[int, Tuple[object, object, int]]" = \
            collections.OrderedDict()
        self.bytes = 0


def _bundle_bytes(bundle) -> int:
    """Rough, stable byte estimate of one (fp, family→port→fp)
    bundle — enough for the LRU bound; exactness buys nothing."""
    fp, fams = bundle
    n = len(fp) + 64
    for fam, ports in fams.items():
        n += len(fam) + 16
        if isinstance(ports, dict):
            for _, pfp in ports.items():
                n += len(pfp) + 24
        else:
            n += len(ports) + 8
    return n


class FingerprintStore:
    """``bundle(per_identity, compute)`` → ``{ep: (fp, family_fps)}``
    with per-object caching. ``compute(ms)`` produces the bundle for
    one MapState; identities sharing one MapState object share one
    computation per call AND one cache entry's content."""

    def __init__(self, max_bytes: int = 64 << 20):
        self.max_bytes = max(0, int(max_bytes))
        self._shards = [_FPShard() for _ in range(N_SHARDS)]
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _shard(self, ep: int) -> _FPShard:
        return self._shards[int(ep) % N_SHARDS]

    def bundle(self, per_identity: Dict[int, object],
               compute: Callable[[object], object]
               ) -> Dict[int, object]:
        out: Dict[int, object] = {}
        #: per-call memo keyed by the MapState object id — identities
        #: sharing one resolved state compute once (safe: the dict
        #: values keep every ms alive for the call's duration)
        by_obj: Dict[int, object] = {}
        for ep, ms in per_identity.items():
            sh = self._shard(ep)
            with sh.lock:
                ent = sh.entries.get(ep)
                if ent is not None and ent[0] is ms:
                    sh.entries.move_to_end(ep)
                    out[ep] = ent[1]
                    self.hits += 1
                    continue
            bundle = by_obj.get(id(ms))
            if bundle is None:
                bundle = compute(ms)
                by_obj[id(ms)] = bundle
            self.misses += 1
            out[ep] = bundle
            nbytes = _bundle_bytes(bundle)
            evicted = 0
            with sh.lock:
                old = sh.entries.pop(ep, None)
                if old is not None:
                    sh.bytes -= old[2]
                sh.entries[ep] = (ms, bundle, nbytes)
                sh.bytes += nbytes
                if self.max_bytes:
                    cap = max(1, self.max_bytes // N_SHARDS)
                    while sh.entries and sh.bytes > cap:
                        _, (_, _, nb) = sh.entries.popitem(last=False)
                        sh.bytes -= nb
                        evicted += 1
            if evicted:
                self.evictions += evicted
                METRICS.inc(FP_CACHE_EVICTIONS, evicted)
        return out

    def status(self) -> Dict[str, int]:
        return {
            "entries": sum(len(s.entries) for s in self._shards),
            "bytes": sum(s.bytes for s in self._shards),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }
