"""TP (tensor parallel): shard the automaton **state axis** across
ranks (the reference's ``parallel/tp.py``).

The step uses the one-hot matmul form of the DFA transition: with the
current state one-hot ``oh[B, S]`` and transition table ``T[S, K]``,
the next-state row is ``oh @ T``. Sharding ``S`` gives each rank a
slice ``T[S/n, K]`` and the *partial* one-hot for its state range
(all-zero rows when the current state lives on another rank); the local
product is a partial ``[B, K]`` contribution and a ``psum`` restores
the exact row (each one-hot row has exactly one nonzero). State ids
ride through float32, exact only below 2^24 — a hard check
(``MAX_TP_STATES``) — and only when the product is computed in full
float32: a TF32 product keeps 10 mantissa bits and would be wrong past
2^11 states, so the lane raises unless
``torch.get_float32_matmul_precision()`` is ``"highest"`` and
``torch.backends.cuda.matmul.allow_tf32`` is off (it sets neither).
Accept words come back the same way, byte plane by byte plane.

The one-hot product is a plain matrix product, as in the reference
(outside any Pallas kernel): ``torch.bmm``. This is the fallback lane:
one ``psum`` per scanned byte (L a call on the ledger). The throughput
lane for scan sharding is the payload-sharded CP scan (``cp.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cilium_tpu_torch.parallel import collectives
from cilium_tpu_torch.parallel.mesh import Mesh

#: one-hot matmul carries state ids in f32 — exact only below 2^24
MAX_TP_STATES = 1 << 24


def _check_state_count(S: int) -> None:
    if S >= MAX_TP_STATES:
        raise ValueError(
            f"TP one-hot matmul step is exact only for state ids < "
            f"2^24; got {S} states. Split the bank (smaller bank_size / "
            f"max_dfa_states) before sharding.")


def _check_exact_matmul() -> None:
    """The products must run in full float32 (see the module doc)."""
    prec = torch.get_float32_matmul_precision()
    if prec != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"TP needs full-float32 matrix products: float32 matmul "
            f"precision is {prec!r} and allow_tf32 is "
            f"{torch.backends.cuda.matmul.allow_tf32}; state ids past "
            f"2^11 would round")


def pad_states(trans: np.ndarray, accept: np.ndarray,
               n_shards: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the state axis to a multiple of ``n_shards``.

    Padded states self-loop into the dead state (0) and accept nothing;
    reachable dynamics never enter them. Accepts single-bank
    ``trans [S, K] / accept [S, W]`` or banked ``[NB, S, K] / [NB, S, W]``.
    """
    s_axis = trans.ndim - 2
    S = trans.shape[s_axis]
    pad = (-S) % n_shards
    if pad == 0:
        return trans, accept
    widths_t = [(0, 0)] * trans.ndim
    widths_t[s_axis] = (0, pad)
    widths_a = [(0, 0)] * accept.ndim
    widths_a[s_axis] = (0, pad)
    return (np.pad(trans, widths_t), np.pad(accept, widths_a))


def _local_scan(trans_l, byteclass, start, accept_l, data, lengths,
                mesh: Mesh, state_axis: str, mapped: int):
    """The TP body on this rank over stacked banks: ``trans_l [NB,
    S/n, K]`` / ``accept_l [NB, S/n, W]`` hold its state slice,
    ``byteclass [NB, 256]`` / ``start [NB]`` whole → (finals [NB, B],
    words [NB, B, W]). One psum of ``[NB, B, K]`` a byte and one of
    ``[NB, B, W]`` an accept plane; ``mapped`` = 1 when the banks stand
    for the reference's vmapped axis (the ledger then counts one
    bank's bytes, as the reference's does)."""
    _check_exact_matmul()
    NB, S_loc, K = trans_l.shape
    offset = mesh.axis_index(state_axis) * S_loc
    B, L = data.shape
    dev = data.device
    cls = byteclass.long()[:, data.long()]                  # [NB, B, L]
    trans_f = trans_l.to(torch.float32)
    local = torch.arange(S_loc, device=dev)

    def one_hot(states):
        # partial one-hot: rows are zero when the state is off-shard
        return ((states - offset)[..., None] == local).to(torch.float32)

    states = start.long()[:, None].expand(NB, B).contiguous()
    lens = lengths.long()
    for t in range(L):
        part = torch.bmm(one_hot(states), trans_f)          # [NB, B, K]
        # exact: one nonzero term. The collective-per-scanned-byte that
        # makes TP a fallback lane, on the ledger
        rows = collectives.psum(part, mesh, state_axis, site="tp.scan_step",
                                mapped=mapped)
        nxt = torch.gather(rows, 2, cls[:, :, t, None])[..., 0].long()
        states = torch.where(t < lens, nxt, states)

    # accept words, state-sharded: psum of byte-plane products
    oh_f = one_hot(states)
    W = accept_l.shape[2]
    out = torch.zeros((NB, B, W), dtype=torch.int32, device=dev)
    for shift in (0, 8, 16, 24):
        # int32 bit patterns: the arithmetic shift's sign bits are
        # masked off, and 255 << 24 wraps to the word's bit pattern
        plane = ((accept_l >> shift) & 0xFF).to(torch.float32)
        part = torch.bmm(oh_f, plane)
        vals = collectives.psum(part, mesh, state_axis,
                                site="tp.accept_plane", mapped=mapped)
        out = out | (vals.to(torch.int32) << shift)
    return states.to(torch.int32), out


def dfa_scan_tp(
    mesh: Mesh,
    trans: torch.Tensor,       # [S/n, K] int32 — this rank's states
    byteclass: torch.Tensor,   # [256] int32
    start,                     # scalar int
    accept: torch.Tensor,      # [S/n, W] int32 bit patterns
    data: torch.Tensor,        # [B, L] uint8
    lengths: torch.Tensor,     # [B] int32
    state_axis: str = "state",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """State-axis-sharded DFA scan → (finals [B], accept words [B, W]),
    the same on every rank. ``trans``/``accept`` are this rank's block
    of :func:`pad_states`' tables."""
    _check_state_count(trans.shape[0] * mesh.shape[state_axis])
    st = torch.as_tensor(start, device=data.device).reshape(1)
    finals, words = _local_scan(trans[None], byteclass[None], st,
                                accept[None], data, lengths, mesh,
                                state_axis, mapped=1)
    return finals[0], words[0]


def dfa_scan_banked_tp(
    mesh: Mesh,
    trans: torch.Tensor,       # [NB, S/n, K] int32
    byteclass: torch.Tensor,   # [NB, 256] int32
    start: torch.Tensor,       # [NB] int32
    accept: torch.Tensor,      # [NB, S/n, W] int32 bit patterns
    data: torch.Tensor,        # [B, L]
    lengths: torch.Tensor,     # [B]
    state_axis: str = "state",
) -> torch.Tensor:
    """All banks, state-axis TP → accept words ``[B, NB, W]`` (same
    contract as ``dfa_kernel.dfa_scan_banked``), the same on every
    rank. The banks stack in one product and one psum a byte, where
    the reference vmaps them: the ledger's rows are the reference's."""
    _check_state_count(trans.shape[1] * mesh.shape[state_axis])
    _, words = _local_scan(trans, byteclass, start, accept, data, lengths,
                           mesh, state_axis, mapped=1)
    return words.permute(1, 0, 2).contiguous()              # [B, NB, W]
