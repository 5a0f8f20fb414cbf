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

The context-parallel scan (:func:`payload_scan_cp`; the reference's
``_cp_step`` is its body): the payload's byte columns sharded over the
ranks of a mesh axis, each rank composing its shard's function with
the same blockwise SP, then a ring ``ppermute`` pass circulating each
rank's ``[B, S]`` function one hop a step, so every rank composes what
lies to its left; the last rank alone has the whole payload, and a
final all-gather hands its states to every rank. Both collectives go
through ``parallel/collectives.py``'s ledger.
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


def shard_function(trans, byteclass, data_shard, lengths, idx: int,
                   block: int) -> torch.Tensor:
    """Blockwise SP inside one rank's payload shard: the composed
    transition function [B, S] of the ``idx``-th column block
    ``data_shard`` [B, L/n] (bytes at or past a row's length are
    skipped). The shard is padded up to a multiple of ``block`` (a
    shard shorter than ``block`` is one block of its own length), and
    the padding is skipped in every row.

    The reference marks a padded byte valid by its position alone
    (``offset + column < length``), and the positions of a shard's
    padding are the next shard's first columns: where ``block`` does
    not divide the shard, a row longer than the shard's end consumes
    the zero padding as bytes, and its states differ from the
    sequential scan's (``tests/test_torch_parallel_strategies.py``
    shows it). The port skips the padding, so its states are the
    sequential scan's."""
    B, shard_len = data_shard.shape
    block = max(1, min(block, shard_len))
    pad = (-shard_len) % block
    d = F.pad(data_shard, (0, pad)) if pad else data_shard
    nb = d.shape[1] // block
    col = torch.arange(nb * block, device=d.device).reshape(nb, block)
    valid = ((idx * shard_len + col)[None, :, :] < lengths.reshape(B, 1, 1)) \
        & (col < shard_len)[None, :, :]
    return _compose_blocks(block_transitions(
        trans, byteclass, d.reshape(B, nb, block), valid))


def payload_scan_cp(
    mesh,
    trans: torch.Tensor,       # [S, K]
    byteclass: torch.Tensor,   # [256]
    start,                     # scalar int
    data: torch.Tensor,        # [B, L/n] — this rank's column block
    lengths: torch.Tensor,     # [B] int
    seq_axis: str = "seq",
    block: int = 256,
) -> torch.Tensor:
    """Context-parallel payload scan: the payload's length sharded over
    ``seq_axis`` (``data`` is this rank's contiguous block of
    ``L / n`` columns; ``parallel.cp.shard_columns`` cuts it); final
    states [B], the same on every rank. Blockwise composition inside
    the shard, a ring ppermute of the carry (n - 1 calls), one gather."""
    from cilium_tpu_torch.parallel import collectives

    n_dev = mesh.shape[seq_axis]
    idx = mesh.axis_index(seq_axis)
    B = data.shape[0]
    mine = shard_function(trans, byteclass, data, lengths, idx,
                          block)                               # [B, S]

    # ring exclusive-prefix composition: step i delivers the function of
    # the shard i + 1 hops to my left, composed in while it still lies
    # left of me; after n - 1 steps ``carry`` covers shards [0, idx)
    S = trans.shape[0]
    carry = torch.arange(S, dtype=mine.dtype, device=mine.device) \
        .expand(B, S)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    send = mine
    for i in range(n_dev - 1):
        recv = collectives.ppermute(send, mesh, seq_axis, perm,
                                    site="cp.ring_carry")
        if idx - 1 - i >= 0:
            carry = _compose(carry, recv)
        send = recv
    final_fn = _compose(mine, carry)                           # [B, S]
    st = torch.as_tensor(start, device=mine.device).long().reshape(-1)
    states = torch.gather(final_fn, 1, st.expand(B)[:, None])[:, 0]
    # rank idx holds the composition of shards [0..idx]; only the last
    # has the whole payload — gather and keep its answer
    all_states = collectives.all_gather(states, mesh, seq_axis,
                                        site="cp.final_gather")  # [n, B]
    return all_states[n_dev - 1]
