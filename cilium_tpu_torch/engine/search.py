"""Vectorized lower-bound binary search over multi-word sorted keys
(counterpart of the reference's ``engine/search.py``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def lower_bound(
    keys: Sequence[torch.Tensor],    # each [N], jointly lexsorted
    probes: Sequence[torch.Tensor],  # each [B] (broadcastable shapes)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lexicographic lower bound of each probe tuple in the key table.

    Returns ``(index [B] int64 clipped to [0, N-1], found [B] bool)``
    where ``found`` marks exact matches.
    """
    if len(keys) != len(probes) or not keys:
        raise ValueError("keys and probes must be equal-length, non-empty")
    N = keys[0].shape[0]
    iters = max(1, int(N).bit_length())
    shape = torch.broadcast_shapes(*(p.shape for p in probes))
    dev = keys[0].device
    lo = torch.zeros(shape, dtype=torch.int64, device=dev)
    hi = torch.full(shape, N, dtype=torch.int64, device=dev)
    for _ in range(iters):
        mid = (lo + hi) >> 1
        # once lo == hi == N, mid reaches N: JAX's gather clamps that
        # read to N-1, torch's faults — clamp explicitly (the update
        # below still uses the unclamped mid, as the reference does)
        mc = mid.clamp(max=N - 1)
        ge = keys[-1][mc] >= probes[-1]
        for k, p in zip(reversed(keys[:-1]), reversed(probes[:-1])):
            m = k[mc]
            ge = (m > p) | ((m == p) & ge)
        lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid, hi)
    idx = lo.clamp(0, N - 1)
    found = lo < N
    for k, p in zip(keys, probes):
        found = found & (k[idx] == p)
    return idx, found
