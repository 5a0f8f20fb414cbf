"""Long-payload automaton scanning, sequence parallel (counterpart of the
reference's ``engine/longscan.py``).

A DFA's per-byte step is a function ``f_c: S→S``, and function
composition is associative, so a payload's net effect can be computed
blockwise: split the payload into blocks, compute each block's composed
transition vector ``g[S]`` with a sequential loop inside the block but
vectorized across blocks, then combine the blocks by a log-depth
pairwise reduce. Parallelism L/block × S instead of a length-L chain.
Plain PyTorch on the caller's device (no hand-written kernel); the
sequential scan it is held against is kernel KD (and K2 where S ≤ 128).

Three departures from the reference, each giving the same integers:

* a step gathers ``trans.reshape(-1)[g * K + c]`` ([..., S]) where the
  reference builds ``trans[g]`` ([..., S, K]), which XLA fuses away and
  torch would materialise (~21 GB a step at S = 1024, K = 32, 16
  blocks, B = 10000);
* ``lax.associative_scan`` becomes a pairwise reduce over the block
  axis padded to a power of two with the identity ``arange(S)``: only
  the last prefix (the whole payload) is read;
* ``torch.gather`` does not broadcast as ``take_along_axis`` does, so
  :func:`_compose` expands its operands first.

The context-parallel scan (``_cp_step``, ``payload_scan_cp``: the
payload sharded over devices, the carry passed around a ring) waits for
the port's multi-device slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _compose(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(f ∘ g)[s] = f[g[s]] — apply g first, then f.

    Leading batch dims broadcast: f, g: [..., S] int32."""
    lead = torch.broadcast_shapes(f.shape[:-1], g.shape[:-1])
    return torch.gather(f.expand(*lead, f.shape[-1]), -1,
                        g.expand(*lead, g.shape[-1]).long())


def block_transitions(
    trans: torch.Tensor,       # [S, K] int32
    byteclass: torch.Tensor,   # [256] int32
    data: torch.Tensor,        # [..., L] uint8 — L is the block length
    valid: Optional[torch.Tensor] = None,  # [..., L] bool, False = skip
) -> torch.Tensor:
    """Composed transition vector for each block: out[..., S] with
    out[..., s] = state reached from s after consuming the block."""
    S, K = trans.shape
    flat = trans.reshape(-1)
    cls = byteclass[data.long()]                         # [..., L]
    g = torch.arange(S, dtype=trans.dtype, device=trans.device) \
        .expand(*data.shape[:-1], S)
    for t in range(data.shape[-1]):
        # next g[s] = T[g[s], c_t]  (apply byte t after the prefix)
        rows = flat[g * K + cls[..., t, None]]           # [..., S]
        if valid is not None:
            rows = torch.where(valid[..., t, None], rows, g)
        g = rows
    return g


def _compose_blocks(g: torch.Tensor) -> torch.Tensor:
    """[B, nb, S] block functions → [B, S], their composition in block
    order (block 0 applied first): pairs (a, b) of adjacent blocks
    combine to ``b ∘ a`` until one is left, the block axis padded to a
    power of two with the identity."""
    B, nb, S = g.shape
    pad = (1 << max(nb - 1, 0).bit_length()) - nb
    if pad:
        ident = torch.arange(S, dtype=g.dtype, device=g.device)
        g = torch.cat([g, ident.expand(B, pad, S)], dim=1)
    while g.shape[1] > 1:
        g = _compose(g[:, 1::2], g[:, 0::2])
    return g[:, 0]


def payload_scan_sp(
    trans: torch.Tensor,       # [S, K]
    byteclass: torch.Tensor,   # [256]
    start,                     # scalar (or [B]) int
    data: torch.Tensor,        # [B, L] uint8
    lengths: torch.Tensor,     # [B] int
    block: int = 256,
) -> torch.Tensor:
    """Final DFA states [B] for long payloads, blockwise-parallel. A row
    consumes its first ``lengths`` bytes: none when the length is zero
    or negative, all L when it is past L."""
    B, L = data.shape
    pad = (-L) % block
    if pad:
        data = F.pad(data, (0, pad))
    nblocks = data.shape[1] // block
    blocks = data.reshape(B, nblocks, block)
    pos = torch.arange(nblocks * block, device=data.device) \
        .reshape(nblocks, block)                         # [nb, block]
    valid = pos[None, :, :] < lengths.reshape(B, 1, 1)   # [B, nb, block]

    g = block_transitions(trans, byteclass, blocks, valid)   # [B, nb, S]
    final_fn = _compose_blocks(g)                            # [B, S]
    st = torch.as_tensor(start, device=data.device).long().reshape(-1)
    return torch.gather(final_fn, 1, st.expand(B)[:, None])[:, 0]
