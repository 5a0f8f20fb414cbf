"""CP (context parallel): shard the **payload byte columns**, not the
automaton state (the reference's ``parallel/cp.py``).

A DFA byte step is a function ``f_c: S→S`` and composition is
associative, so a payload's net effect factors into per-block composed
transition vectors that combine with ONE small exchange — not a
collective per byte, as the state-sharded TP lane (``tp.py``) pays.

* the full (small) transition table is resident on every rank;
* the payload byte columns are sharded over the ``seq`` axis: each rank
  scans its contiguous block with ``engine.longscan``'s blockwise SP
  and composes a block function ``[B, S]`` per bank;
* ONE carry-exchange collective per sharded field: the all-gather of
  the ``[NB, B, S]`` functions, after which every rank applies the n
  functions in order and reads the final states. The ledger records
  one collective per sharded field where TP records L.

The verdict-step face (:func:`make_cp_verdict_step`) reads the
megakernel's group-accept planes (``rp_path_gaccept``) off the same
final states, so the factored resolve runs as in the fused step; fields
too narrow to shard scan whole on kernel KD. Two departures from the
reference, each giving the same integers: a shard shorter than the
inner block is one block of its own length (``longscan.
shard_function``), and the n gathered functions are applied to each
bank's start state in order (n gathers of ``[B]``) instead of composed
into one ``[NB, B, S]`` function first.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cilium_tpu_torch.engine.dfa_dense_cuda import accept_words
from cilium_tpu_torch.engine.longscan import shard_function
from cilium_tpu_torch.engine.megakernel import (
    SCAN_FIELDS,
    field_words,
    fused_scan_field,
    policy_lookup,
    resolve_words,
    scan_fields,
)
from cilium_tpu_torch.engine.verdict import batch_field, unpack_batch
from cilium_tpu_torch.parallel import collectives
from cilium_tpu_torch.parallel.mesh import Mesh, local_slice
from cilium_tpu_torch.weights import stage_array

#: a field only CP-shards when each rank gets at least this many byte
#: columns — below it the exchange would outweigh the scan and the
#: field scans replicated (zero collectives) instead
MIN_SHARD_COLS = 8


def _compose_finals(trans, byteclass, start, data_shard, lengths,
                    mesh: Mesh, seq_axis: str, block: int,
                    site: str) -> torch.Tensor:
    """This rank's byte-column block → final DFA states ``[NB, B]`` for
    every bank, via blockwise composition and ONE carry-exchange
    collective. ``trans [NB, S, K]`` / ``byteclass [NB, 256]`` /
    ``start [NB]`` are whole on every rank; ``data_shard [B, Lg/n]`` is
    this rank's contiguous column block of the global ``[B, Lg]``
    payload."""
    idx = mesh.axis_index(seq_axis)
    mine = torch.stack([
        shard_function(trans[nb], byteclass[nb], data_shard, lengths, idx,
                       block)
        for nb in range(trans.shape[0])])                  # [NB, B, S]
    # THE carry exchange — the lane's ONLY collective for this field
    allg = collectives.all_gather(mine, mesh, seq_axis, site=site)
    B = data_shard.shape[0]
    states = start.long()[:, None].expand(-1, B)           # [NB, B]
    for j in range(allg.shape[0]):
        states = torch.gather(allg[j], 2, states[:, :, None])[..., 0].long()
    return states.to(torch.int32)


def shard_columns(data, mesh: Mesh, seq_axis: str = "seq"):
    """This rank's contiguous column block of a global ``[B, L]``
    payload, ``L`` padded with zero bytes up to a multiple of the axis
    size first (padded bytes sit past every length and compose to the
    identity)."""
    n = mesh.shape[seq_axis]
    pad = (-data.shape[1]) % n
    if pad:
        data = (np.pad(data, ((0, 0), (0, pad))) if isinstance(data, np.ndarray)
                else F.pad(data, (0, pad)))
    return local_slice(data, mesh, seq_axis, dim=1)


def dfa_scan_banked_cp(
    mesh: Mesh,
    trans: torch.Tensor,       # [NB, S, K] int32 — whole on every rank
    byteclass: torch.Tensor,   # [NB, 256] int32
    start: torch.Tensor,       # [NB] int32
    accept: torch.Tensor,      # [NB, S, W] int32 bit patterns
    data: torch.Tensor,        # [B, L/n] uint8 — this rank's columns
    lengths: torch.Tensor,     # [B] int32
    seq_axis: str = "seq",
    block: int = 256,
    extra_accept: Optional[torch.Tensor] = None,
):
    """Payload-sharded banked scan → accept words ``[B, NB, W]``, the
    same on every rank and bit-identical to ``dfa_scan_banked`` over
    the global payload (same contract incl. the ``extra_accept`` →
    ``(words, extra_words)`` tuple the megakernel's group planes use).
    ``data`` is :func:`shard_columns`' block."""
    finals = _compose_finals(trans, byteclass, start, data, lengths, mesh,
                             seq_axis, int(block), "cp.carry_exchange")
    return accept_words(finals, accept, extra_accept)


# ----------------------------------------------------- verdict-step face --

def cp_sharded_keys(batch: Dict, mesh: Mesh,
                    seq_axis: str = "seq") -> Tuple[str, ...]:
    """Which ``*_data`` byte buckets of the GLOBAL batch CP-shard on this
    mesh: the column count must divide the axis and leave ≥
    :data:`MIN_SHARD_COLS` per rank."""
    n = mesh.shape[seq_axis]
    out = []
    for _prefix, field in SCAN_FIELDS:
        key = f"{field}_data"
        if key not in batch:
            continue
        L = batch[key].shape[1]
        if L % n == 0 and L // n >= MIN_SHARD_COLS:
            out.append(key)
    return tuple(sorted(out))


def cp_shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh,
                   seq_axis: str = "seq") -> Dict[str, torch.Tensor]:
    """Stage a flat/packed host batch for the CP step ONCE: sharded byte
    buckets as this rank's column block, everything else whole."""
    sharded = set(cp_sharded_keys(batch, mesh, seq_axis))
    return {k: stage_array(local_slice(v, mesh, seq_axis, dim=1)
                           if k in sharded else v, mesh.device)
            for k, v in batch.items()}


def make_cp_verdict_step(mesh: Mesh, batch: Dict, seq_axis: str = "seq",
                         block: int = 256):
    """The CP-sharded verdict step for ``batch``'s layout (the GLOBAL
    host batch): the full ten-lane output on every rank, bit-equal to
    the single-device fused step. Stage inputs with
    :func:`cp_shard_batch` (batch) and whole policy arrays."""
    sharded = frozenset(cp_sharded_keys(batch, mesh, seq_axis))

    def step(arrays, sbatch):
        return _cp_body(mesh, seq_axis, int(block), sharded, arrays, sbatch)

    step.mesh, step.out_axis = mesh, None
    return step


def _cp_body(mesh: Mesh, seq_axis: str, block: int, sharded, arrays,
             batch):
    """The fused step with the CP-sharded fields scanned by
    :func:`_compose_finals` (this rank's column block, one carry
    exchange a field); every other field scans whole on KD, as in
    ``megakernel.fused_verdict_step``."""
    b = unpack_batch(batch) if "scalars" in batch else dict(batch)
    ms, auth_src_dst = policy_lookup(
        arrays, b["ep_ids"], b["peer_ids"], b["dports"], b["protos"],
        b["directions"])
    plan_on = "rp_g_method" in arrays
    words, gwords = [], None
    for prefix, field in scan_fields(arrays):
        data, lengths, valid = batch_field(b, field)
        want_groups = plan_on and prefix == "path"
        if f"{field}_data" in sharded:
            finals = _compose_finals(
                arrays[f"{prefix}_trans"], arrays[f"{prefix}_byteclass"],
                arrays[f"{prefix}_start"], data, lengths, mesh, seq_axis,
                block, f"cp.carry.{prefix}")
            w, gw = field_words(
                accept_words(finals, arrays[f"{prefix}_accept"],
                             arrays["rp_path_gaccept"] if want_groups
                             else None),
                valid, want_groups)
        else:
            w, gw = fused_scan_field(arrays, prefix, data, lengths, valid,
                                     want_groups=want_groups)
        words.append(w)
        if gw is not None:
            gwords = gw
    return resolve_words(arrays, b, ms, auth_src_dst, words, gwords)
