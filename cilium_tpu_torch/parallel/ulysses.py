"""Ulysses-style EP: rule banks sharded, ONE all-to-all re-shard
between parse and match (the reference's ``parallel/ulysses.py``).

The DFA banks are bank-sharded over the mesh axis, so every rank scans
the batch against ITS banks (kernel KD on the card), but the per-rule
conjunction needs all banks of each flow — a re-shard between the scan
("parse") and the resolve ("match"):

* **The verdict-step face** (:func:`make_ep_verdict_step`): bank
  tensors staged as this rank's block of banks once
  (:func:`stage_ep_arrays`), the encoded batch staged whole once
  (:func:`stage_replicated`); the step issues exactly one collective,
  the all-to-all that splits the batch axis and concatenates the bank
  axis (every family's accept words plus the megakernel's group planes
  ride ONE packed int32 payload), then the mapstate lookup and the
  resolve run on this rank's rows.
* **The raw scan** (:func:`ulysses_scan_banked`, batch-sharded inputs)
  packs payload bytes and lengths into ONE gathered buffer — one
  all-gather and one all-to-all a call.

The reference's ``lru_cache``d factories become plain functions: torch
has no jit cache to protect.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cilium_tpu_torch.engine.dfa_kernel import dfa_scan_banked
from cilium_tpu_torch.engine.megakernel import (
    L7G_FIELD,
    SCAN_FIELDS,
    fused_scan_field,
    policy_lookup,
    resolve_words,
)
from cilium_tpu_torch.engine.nfa_kernel import _or_reduce
from cilium_tpu_torch.engine.verdict import batch_field, unpack_batch
from cilium_tpu_torch.parallel import collectives
from cilium_tpu_torch.parallel.mesh import Mesh
from cilium_tpu_torch.parallel.sharding import stage_sharded
from cilium_tpu_torch.weights import stage_array

#: the batch columns the resolve reads, besides the scanned fields
_RESOLVE_COLUMNS = ("l7_types", "kafka_api_key", "kafka_api_version",
                    "kafka_client", "kafka_topic", "gen_proto", "gen_pairs")


def ulysses_scan_banked(
    mesh: Mesh,
    trans: torch.Tensor,       # [NB/n, S, K] int32 — this rank's banks
    byteclass: torch.Tensor,   # [NB/n, 256] int32
    start: torch.Tensor,       # [NB/n] int32
    accept: torch.Tensor,      # [NB/n, S, W] int32 bit patterns
    data: torch.Tensor,        # [B/n, L] — this rank's rows
    lengths: torch.Tensor,     # [B/n]
    axis: str = "data",
) -> torch.Tensor:
    """Bank-sharded scan of batch-sharded inputs → this rank's rows of
    the words ``[B/n, NB, W]`` (bit-identical to ``dfa_scan_banked``
    over the global arrays). ONE packed all-gather (the byte-compressed
    payloads and their lengths; transition tables never move) and ONE
    batch↔bank switch."""
    Bl = data.shape[0]
    # the lengths ride as the little-endian bytes of their int32
    lb = lengths.to(torch.int32).contiguous().reshape(Bl, 1) \
        .view(torch.uint8)
    packed = torch.cat([data.to(torch.uint8), lb], dim=1)     # [Bl, L+4]
    allp = collectives.all_gather(packed, mesh, axis, tiled=True,
                                  site="ulysses.gather")      # [B, L+4]
    all_data = allp[:, :-4]
    all_len = allp[:, -4:].contiguous().view(torch.int32)[:, 0]
    words = dfa_scan_banked(trans, byteclass, start, accept, all_data,
                            all_len)                          # [B, NB/n, W]
    # Ulysses switch: split batch, concat banks → [B/n, NB, W]
    return collectives.all_to_all(words, mesh, axis, split_axis=0,
                                  concat_axis=1, site="ulysses.switch")


# ----------------------------------------------------- verdict-step face --

def stage_ep_arrays(arrays: Dict[str, np.ndarray], mesh: Mesh,
                    axis: str = "expert") -> Dict[str, torch.Tensor]:
    """Stage policy tensors for the one-shot EP step ONCE: every DFA
    family's bank tensors (and the path group-accept plane) as this
    rank's block of banks, everything else whole. Bank counts pad up to
    the axis size (``sharding.pad_banks_for_ep`` — padded banks are
    inert)."""
    return stage_sharded(arrays, mesh, axis)


def stage_replicated(batch: Dict[str, np.ndarray], mesh: Mesh
                     ) -> Dict[str, torch.Tensor]:
    """Stage a host batch whole on this rank ONCE — the EP step's inputs
    enter replicated so it needs no input gather."""
    return {k: stage_array(v, mesh.device) for k, v in batch.items()}


def make_ep_verdict_step(mesh: Mesh, arrays: Dict, batch: Dict,
                         axis: str = "expert"):
    """The one-shot EP verdict step for these layouts: the ten-lane
    output for this rank's rows (``sharding.read_global`` gathers them),
    bit-equal to the single-device fused step. ``arrays`` from
    :func:`stage_ep_arrays`, ``batch`` from :func:`stage_replicated`;
    the batch size must divide the axis (checked loudly — a silent
    floor-divide would truncate verdicts)."""
    n = mesh.shape[axis]
    B = (batch["scalars"].shape[0] if "scalars" in batch
         else batch["ep_ids"].shape[0])
    if B % n:
        raise ValueError(
            f"EP one-shot step needs the batch ({B}) divisible by "
            f"the {axis!r} axis ({n}); pad the batch first")

    def step(arrays, batch):
        return _ep_body(mesh, axis, arrays, batch)

    step.mesh, step.out_axis = mesh, axis
    return step


def _ep_body(mesh: Mesh, axis: str, arrays, batch):
    """Local-bank scans over the full batch → ONE packed all-to-all
    (batch-axis split → bank-axis gather) → this rank's rows' resolve."""
    n = mesh.shape[axis]
    b = unpack_batch(batch) if "scalars" in batch else dict(batch)
    B = b["ep_ids"].shape[0]
    Bl = B // n
    r0 = mesh.axis_index(axis) * Bl
    plan_on = "rp_g_method" in arrays

    def loc(v):
        return v[r0:r0 + Bl]

    # scan: full batch × LOCAL banks, every family (KD on the card)
    segs = []            # (prefix, field, NBl, W, Gw) for reassembly
    parts = []
    for prefix, field in SCAN_FIELDS:
        want_groups = plan_on and prefix == "path"
        out = dfa_scan_banked(
            arrays[f"{prefix}_trans"], arrays[f"{prefix}_byteclass"],
            arrays[f"{prefix}_start"], arrays[f"{prefix}_accept"],
            b[f"{field}_data"], b[f"{field}_len"],
            extra_accept=(arrays["rp_path_gaccept"] if want_groups
                          else None))
        w3, g3 = out if want_groups else (out, None)
        NBl, W = w3.shape[1], w3.shape[2]
        Gw = g3.shape[2] if g3 is not None else 0
        segs.append((prefix, field, NBl, W, Gw))
        parts.append(w3.reshape(B, NBl * W))
        if g3 is not None:
            parts.append(g3.reshape(B, NBl * Gw))

    # THE re-shard: one all-to-all carries every family's words (and the
    # group planes) — batch split, banks gathered
    payload = torch.cat(parts, dim=1)                        # [B, C]
    C = payload.shape[1]
    switched = collectives.all_to_all(payload, mesh, axis, split_axis=0,
                                      concat_axis=1,
                                      site="ulysses.switch")  # [Bl, n*C]
    blocks = switched.reshape(Bl, n, C)

    # reassemble full-bank words per family (the bank blocks are
    # contiguous, so concatenating over source ranks restores global
    # bank order), masked by the LOCAL valid column
    zero = torch.zeros((), dtype=torch.int32, device=payload.device)
    words = []
    gwords = None
    off = 0
    for prefix, field, NBl, W, Gw in segs:
        valid_l = loc(b[f"{field}_valid"])
        flat = blocks[:, :, off:off + NBl * W].reshape(Bl, n * NBl * W)
        off += NBl * W
        if prefix == "dns" and plan_on:
            # padded dns banks append zero lanes past the rs-mask's
            # width — trim to the plan's lane space
            flat = flat[:, :arrays["rp_dns_rsmask"].shape[1]]
        words.append(torch.where(valid_l[:, None], flat, zero))
        if Gw:
            g = blocks[:, :, off:off + NBl * Gw].reshape(Bl, n * NBl, Gw)
            off += NBl * Gw
            gwords = torch.where(valid_l[:, None], _or_reduce(g, 1), zero)
    # this rank's rows of everything the resolve reads
    bl = {k: loc(b[k]) for k in _RESOLVE_COLUMNS}
    if "auth_pairs" in b:
        bl["auth_pairs"] = b["auth_pairs"]
    if "l7g_trans" in arrays:
        # protocol-frontend scan: the l7g bank stack is small and
        # REPLICATED (not EP-sharded), so each rank scans only its
        # rows after the switch — no extra payload in the all-to-all
        prefix, field = L7G_FIELD
        w, _ = fused_scan_field(arrays, prefix, *(
            loc(v) for v in batch_field(b, field)))
        words.append(w)

    # match: this rank's rows only — mapstate + resolve shard over the
    # batch like DP, scan work sharded over banks
    ms, auth_src_dst = policy_lookup(
        arrays, loc(b["ep_ids"]), loc(b["peer_ids"]), loc(b["dports"]),
        loc(b["protos"]), loc(b["directions"]))
    return resolve_words(arrays, bl, ms, auth_src_dst, words, gwords)
