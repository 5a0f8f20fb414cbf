"""Sharding layouts for the verdict pipeline (the reference's
``parallel/sharding.py``).

DP: every per-flow tensor is sharded on its leading (batch) axis over
the ``data`` mesh axis — each rank holds its contiguous rows — and
policy tensors are replicated; each rank runs the legacy
:func:`~cilium_tpu_torch.engine.verdict.verdict_step` on its rows, with
no collective. EP (optional): DFA bank tensors are sharded on their
leading (bank) axis over the ``expert`` axis.

The helpers take the GLOBAL host arrays (numpy, as
``CompiledPolicy.arrays`` and ``flowbatch_to_host_dict`` give them) and
return this rank's tensors on the mesh's device: the counterpart of
``device_put`` with a ``NamedSharding``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from cilium_tpu_torch.engine.verdict import verdict_step
from cilium_tpu_torch.parallel import collectives
from cilium_tpu_torch.parallel.mesh import Mesh, local_slice, make_mesh
from cilium_tpu_torch.weights import stage_array

#: ALL five DFA matcher families shard their bank tensors under EP
EP_BANKED_FAMILIES = ("path", "method", "host", "hdr", "dns")
_EP_BANKED_SUFFIXES = ("trans", "byteclass", "accept", "start")
_EP_BANKED_KEYS = tuple(f"{fam}_{suf}" for fam in EP_BANKED_FAMILIES
                        for suf in _EP_BANKED_SUFFIXES)


def is_banked_key(k: str) -> bool:
    """Does the array shard on the bank axis under EP? Every family's
    bank tensors, and the megakernel's path group-accept plane, which
    shares the path bank axis."""
    return k in _EP_BANKED_KEYS or k == "rp_path_gaccept"


def pad_banks_for_ep(arrays: Dict[str, np.ndarray],
                     ep_size: int) -> Dict[str, np.ndarray]:
    """Pad every family's bank count up to a multiple of the expert
    axis so the bank axis shards evenly. Padded banks are all-zero:
    transition table pins the dead state, accept words are empty —
    scanning one yields nothing, and lane indices (bank*(32*W)+lane)
    only ever point at real banks. ``rp_path_gaccept`` shares the path
    family's bank axis and pads identically (zero group bits are
    inert)."""
    out = dict(arrays)
    for fam in EP_BANKED_FAMILIES:
        key = f"{fam}_trans"
        if key not in out:
            continue
        n_banks = out[key].shape[0]
        pad = (-n_banks) % ep_size
        if pad == 0:
            continue
        keys = [f"{fam}_{suf}" for suf in _EP_BANKED_SUFFIXES]
        if fam == "path" and "rp_path_gaccept" in out:
            keys.append("rp_path_gaccept")
        for k in keys:
            v = out[k]
            out[k] = np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], dtype=v.dtype)])
    return out


def stage_sharded(arrays: Dict[str, np.ndarray], mesh: Mesh,
                  axis: str) -> Dict[str, torch.Tensor]:
    """Banked tensors (:func:`is_banked_key`) as this rank's block of
    banks on ``axis``, every other tensor whole (padded to the axis
    first)."""
    arrays = pad_banks_for_ep(arrays, mesh.shape[axis])
    return {k: stage_array(local_slice(v, mesh, axis) if is_banked_key(k)
                           else v, mesh.device)
            for k, v in arrays.items()}


def shard_policy_arrays(arrays: Dict[str, np.ndarray], mesh: Mesh,
                        expert_axis: Optional[str] = None
                        ) -> Dict[str, torch.Tensor]:
    """Stage policy tensors: replicated, except (under EP) every DFA
    family's bank tensors, which shard on the leading (bank) axis."""
    if expert_axis is not None:
        return stage_sharded(arrays, mesh, expert_axis)
    return {k: stage_array(v, mesh.device) for k, v in arrays.items()}


def shard_flow_batch(batch: Dict[str, np.ndarray], mesh: Mesh,
                     data_axis: str = "data") -> Dict[str, torch.Tensor]:
    """DP: every per-flow tensor's contiguous block of rows on
    ``data_axis`` (the batch must divide the axis)."""
    return {k: stage_array(local_slice(v, mesh, data_axis), mesh.device)
            for k, v in batch.items()}


def make_sharded_step(mesh: Mesh, data_axis: str = "data",
                      expert_axis: Optional[str] = None):
    """The DP step: ``verdict_step`` on this rank's rows; the outputs
    are this rank's rows (``collectives.gather_global`` reads the
    global ones). With arrays staged by :func:`shard_policy_arrays`
    under ``expert_axis``, the step first all-gathers the bank tensors
    along that axis (the collectives the reference's partitioner
    inserts into the jitted step); without, it issues none."""

    def step(arrays: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]):
        if expert_axis is not None:
            arrays = {k: (collectives.all_gather(v, mesh, expert_axis,
                                                 site="dp.bank_gather",
                                                 tiled=True)
                          if is_banked_key(k) else v)
                      for k, v in arrays.items()}
        return verdict_step(arrays, batch)

    step.mesh, step.out_axis = mesh, data_axis
    return step


def read_global(step, out: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """A lane step's outputs as the global result on every rank: the
    batch-sharded ones (``step.out_axis``: DP, EP) all-gathered along
    their axis, the replicated ones (CP) as they are."""
    if step.out_axis is None:
        return out
    return collectives.gather_global_dict(out, step.mesh, step.out_axis)


#: values of ``[parallel] lane``: which sharded verdict lane
#: :func:`stage_for_lane` builds
LANES = ("auto", "dp", "ep", "cp")


def stage_for_lane(cfg, policy_arrays: Dict[str, np.ndarray],
                   batch: Dict[str, np.ndarray],
                   ranks=None, device=None):
    """The config-driven face of lane selection: stage ``(step, arrays,
    batch)`` for the ``[parallel] lane`` the root ``Config`` names, on a
    single-axis mesh over ``ranks`` (default: the world), on ``device``
    (default ``cuda``). Every rank calls it with the same host arrays.

    * ``dp`` (and ``auto``): batch-sharded verdict step — zero
      collectives; the outputs are this rank's rows;
    * ``ep``: bank-sharded one-shot re-shard (:mod:`.ulysses`) — when
      the bank set outgrows one card's memory; this rank's rows;
    * ``cp``: payload-sharded blockwise scan (:mod:`.cp`, ``cp_block``
      sets the inner composition block) — long payloads, small
      per-bank automata; every rank holds the whole output.

    Every lane is verdict-bit-equal; the knob only moves time and
    memory."""
    pcfg = cfg.parallel
    lane = pcfg.lane
    if lane not in LANES:
        raise ValueError(f"[parallel] lane must be one of {LANES}, "
                         f"got {lane!r}")
    if lane == "auto":
        # DP wins at verdict batch shapes: flows >> banks >> payload
        # length, and DP is the only lane with zero collectives
        lane = "dp"
    if lane == "dp":
        mesh = make_mesh(None, (pcfg.data_axis,), ranks, device)
        arrays = shard_policy_arrays(policy_arrays, mesh)
        sbatch = shard_flow_batch(batch, mesh, pcfg.data_axis)
        return make_sharded_step(mesh, pcfg.data_axis), arrays, sbatch
    if lane == "ep":
        from cilium_tpu_torch.parallel.ulysses import (
            make_ep_verdict_step,
            stage_ep_arrays,
            stage_replicated,
        )

        mesh = make_mesh(None, (pcfg.expert_axis,), ranks, device)
        arrays = stage_ep_arrays(policy_arrays, mesh, pcfg.expert_axis)
        sbatch = stage_replicated(batch, mesh)
        return (make_ep_verdict_step(mesh, arrays, sbatch,
                                     pcfg.expert_axis),
                arrays, sbatch)
    # cp: payload byte columns sharded over the "seq" axis
    from cilium_tpu_torch.parallel.cp import (
        cp_shard_batch,
        make_cp_verdict_step,
    )

    mesh = make_mesh(None, ("seq",), ranks, device)
    arrays = shard_policy_arrays(policy_arrays, mesh)
    sbatch = cp_shard_batch(batch, mesh, "seq")
    return (make_cp_verdict_step(mesh, batch, "seq", block=pcfg.cp_block),
            arrays, sbatch)
