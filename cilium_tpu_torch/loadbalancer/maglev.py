"""Maglev consistent hashing (counterpart of the reference's
``loadbalancer/maglev.py``, host numpy, copied as it is: the tables
must come out identical, since table identity is what bounds
disruption).

Reference: ``pkg/maglev`` (SURVEY.md §2.4) — cilium's kube-proxy
replacement selects backends with Maglev lookup tables ("Maglev: A Fast
and Reliable Software Network Load Balancer", NSDI'16): each backend
gets a pseudo-random permutation of table slots; backends claim slots
round-robin until the table is full. Properties we test for: every slot
populated, near-even shares, and minimal disruption when a backend set
changes (only the removed backend's slots move).

The reference builds one table per service in Go and mirrors it into
the BPF ``lbmap``; ours builds the same table in numpy and the loader
stacks all services' tables into one ``[n_services, M]`` slab the
batched lookup gathers from (``loadbalancer.kernel``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

#: Default table size — prime, cilium's default ``maglev-table-size``.
DEFAULT_TABLE_SIZE = 16381

_FNV_PRIME = np.uint32(0x01000193)
_FNV_BASIS = np.uint32(0x811C9DC5)


def fnv1a(data: bytes, basis: int = 0x811C9DC5) -> int:
    """32-bit FNV-1a. Stable across processes (unlike ``hash()``)."""
    h = basis
    for b in data:
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h


def fnv1a_words(words: np.ndarray, basis: int = 0x811C9DC5) -> np.ndarray:
    """Vectorized FNV-1a over ``[..., K]`` uint32 words (each word is
    one symbol). ``kernel.lb_lookup`` implements the identical recurrence
    on tensors — keep the two in lockstep."""
    h = np.full(words.shape[:-1], basis, dtype=np.uint32)
    with np.errstate(over="ignore"):  # uint32 wraparound is the point
        for k in range(words.shape[-1]):
            h = (h ^ words[..., k]) * _FNV_PRIME
    return h


def maglev_table(
    backend_ids: Sequence[int],
    backend_names: Sequence[str],
    m: int = DEFAULT_TABLE_SIZE,
    weights: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Build a Maglev lookup table: ``[m] int32`` of backend ids.

    ``backend_names`` seed the per-backend permutations (stable across
    table rebuilds — that is what bounds disruption); ``backend_ids``
    are what the table stores. Integer ``weights`` make a backend claim
    proportionally more slots per round.
    """
    if weights is None:
        weights = [1] * len(backend_ids)
    # weight 0 = "registered but receives no traffic" (reference
    # semantics); dropping the backend here also keeps the claim loop
    # from spinning forever when every weight is 0
    keep = [i for i, w in enumerate(weights) if w > 0]
    backend_ids = [backend_ids[i] for i in keep]
    backend_names = [backend_names[i] for i in keep]
    weights = [weights[i] for i in keep]
    n = len(backend_ids)
    if n == 0:
        return np.full(m, -1, dtype=np.int32)
    offsets = np.empty(n, dtype=np.int64)
    skips = np.empty(n, dtype=np.int64)
    for i, name in enumerate(backend_names):
        b = name.encode()
        offsets[i] = fnv1a(b) % m
        skips[i] = fnv1a(b, basis=0x01000193 ^ 0x811C9DC5) % (m - 1) + 1
    table = np.full(m, -1, dtype=np.int32)
    nexts = np.zeros(n, dtype=np.int64)
    filled = 0
    while True:
        for i in range(n):
            for _ in range(int(weights[i])):
                c = (offsets[i] + nexts[i] * skips[i]) % m
                while table[c] >= 0:
                    nexts[i] += 1
                    c = (offsets[i] + nexts[i] * skips[i]) % m
                table[c] = backend_ids[i]
                nexts[i] += 1
                filled += 1
                if filled == m:
                    return table


def disruption(old: np.ndarray, new: np.ndarray) -> float:
    """Fraction of slots whose backend changed between two tables."""
    assert old.shape == new.shape
    return float(np.mean(old != new))
