"""Drive one parallel lane on every rank of a world, from GLOBAL host
inputs (numpy): build the lane's mesh over the world, stage this
rank's share, run the lane, read the global result back and report the
collective ledger of one call.

:func:`run_lane` is the rank body that ``chip_smoke.py``'s phase 14 and
the CPU tests (``tests/test_torch_parallel*.py``) send to every rank of
a :class:`~cilium_tpu_torch.parallel.mesh.LocalWorld` (or call in a
one-rank world of their own process). Lanes:

* ``auto`` / ``dp`` / ``ep`` / ``cp`` — ``stage_for_lane`` and its
  verdict step; inputs ``arrays`` (the policy's) and ``batch`` (the
  packed batch); ``dp_ep`` — the DP step over a ``(data, expert)``
  mesh of two expert ranks a row, banks expert-sharded;
* ``ulysses`` — ``ulysses_scan_banked`` (banks and rows sharded);
* ``tp`` / ``tp_banked`` — ``dfa_scan_tp`` / ``dfa_scan_banked_tp``
  (states sharded after ``pad_states``);
* ``cp_scan`` — ``dfa_scan_banked_cp`` (payload columns sharded);
* ``payload_cp`` — ``engine.longscan.payload_scan_cp`` (one bank).

The scan lanes take ``trans``, ``byteclass``, ``start``, ``accept``
(not ``payload_cp``), ``data`` and ``lengths``, the banked lanes' with
a leading bank axis.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict

import torch

from cilium_tpu_torch.core.device import DeviceLike, resolve_device
from cilium_tpu_torch.engine import _build
from cilium_tpu_torch.parallel import collectives
from cilium_tpu_torch.parallel.collectives import LEDGER
from cilium_tpu_torch.parallel.mesh import local_slice, make_mesh
from cilium_tpu_torch.weights import stage_array

VERDICT_LANES = ("auto", "dp", "ep", "cp", "dp_ep")
SCAN_LANES = ("ulysses", "tp", "tp_banked", "cp_scan", "payload_cp")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _verdict_lane(lane: str, inputs: Dict, device, cp_block: int):
    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.parallel.sharding import read_global, stage_for_lane

    if lane == "dp_ep":
        # DP over a (data, expert) mesh with the banks expert-sharded
        from cilium_tpu_torch.parallel.sharding import (
            make_sharded_step,
            shard_flow_batch,
            shard_policy_arrays,
        )

        mesh = make_mesh((torch.distributed.get_world_size() // 2, 2),
                         ("data", "expert"), device=device)
        step = make_sharded_step(mesh, "data", expert_axis="expert")
        arrays = shard_policy_arrays(inputs["arrays"], mesh, "expert")
        sbatch = shard_flow_batch(inputs["batch"], mesh, "data")
    else:
        cfg = Config()
        cfg.parallel.lane = lane
        cfg.parallel.cp_block = cp_block
        step, arrays, sbatch = stage_for_lane(cfg, inputs["arrays"],
                                              inputs["batch"], device=device)
    return (lambda: step(arrays, sbatch)), (lambda out: read_global(step, out))


def _scan_lane(lane: str, inputs: Dict, device, cp_block: int):
    from cilium_tpu_torch.engine.longscan import payload_scan_cp
    from cilium_tpu_torch.parallel.cp import dfa_scan_banked_cp, shard_columns
    from cilium_tpu_torch.parallel.tp import (
        dfa_scan_banked_tp,
        dfa_scan_tp,
        pad_states,
    )
    from cilium_tpu_torch.parallel.ulysses import ulysses_scan_banked

    axis = {"ulysses": "data", "tp": "state", "tp_banked": "state",
            "cp_scan": "seq", "payload_cp": "seq"}[lane]
    mesh = make_mesh(None, (axis,), device=device)
    n = mesh.shape[axis]
    g = dict(inputs)

    def t(a):
        return stage_array(a, mesh.device)

    if lane == "ulysses":
        args = [t(local_slice(g[k], mesh, axis)) for k in
                ("trans", "byteclass", "start", "accept", "data", "lengths")]
        return ((lambda: ulysses_scan_banked(mesh, *args, axis=axis)),
                (lambda out: collectives.gather_global(out, mesh, axis)))
    if lane in ("tp", "tp_banked"):
        trans, accept = pad_states(g["trans"], g["accept"], n)
        s_dim = trans.ndim - 2
        tl = t(local_slice(trans, mesh, axis, dim=s_dim))
        al = t(local_slice(accept, mesh, axis, dim=s_dim))
        bc, data, lens = t(g["byteclass"]), t(g["data"]), t(g["lengths"])
        if lane == "tp":
            start = int(g["start"])
            return ((lambda: dfa_scan_tp(mesh, tl, bc, start, al, data, lens,
                                         state_axis=axis)), None)
        st = t(g["start"])
        return ((lambda: dfa_scan_banked_tp(mesh, tl, bc, st, al, data, lens,
                                            state_axis=axis)), None)
    data = t(shard_columns(g["data"], mesh, axis))
    lens = t(g["lengths"])
    tr, bc = t(g["trans"]), t(g["byteclass"])
    if lane == "cp_scan":
        st, acc = t(g["start"]), t(g["accept"])
        return ((lambda: dfa_scan_banked_cp(mesh, tr, bc, st, acc, data, lens,
                                            seq_axis=axis, block=cp_block)),
                None)
    start = int(g["start"])
    return ((lambda: payload_scan_cp(mesh, tr, bc, start, data, lens,
                                     seq_axis=axis, block=cp_block)), None)


def _numpy(out):
    if isinstance(out, dict):
        return {k: v.cpu().numpy() for k, v in out.items()}
    if isinstance(out, tuple):
        return tuple(v.cpu().numpy() for v in out)
    return out.cpu().numpy()


def run_lane(lane: str, inputs: Dict, device: DeviceLike = None,
             reps: int = 1, cp_block: int = 256) -> Dict:
    """On one rank: stage ``inputs`` for ``lane`` on ``device`` (default
    ``cuda``; raises without it), call it ``reps`` times (each
    completed before the next), and return the global result (numpy,
    on rank 0; None elsewhere), the ledger's rows and host staging of
    the FIRST call, KD's launches in it and in all the calls (each the
    difference of KD's count across the calls: the count is not set to
    0), and every call's wall ms. Every rank of the world must call it
    alike."""
    dev = resolve_device(device)
    if lane in VERDICT_LANES:
        call, read = _verdict_lane(lane, inputs, dev, cp_block)
    elif lane in SCAN_LANES:
        call, read = _scan_lane(lane, inputs, dev, cp_block)
    else:
        raise ValueError(f"unknown lane {lane!r}")
    kd = _build.KERNELS["KD"]
    walls, rows, staging, kd_launches, out = [], None, None, None, None
    kd_start = kd.launches
    for i in range(reps):
        _sync(dev)
        LEDGER.reset()
        k0 = kd.launches
        t0 = time.perf_counter()
        out = call()
        _sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            rows, staging = LEDGER.snapshot(), LEDGER.staging()
            kd_launches = kd.launches - k0
    kd_total = kd.launches - kd_start
    result = read(out) if read is not None else out
    rank = torch.distributed.get_rank()
    return {"out": _numpy(result) if rank == 0 else None, "ledger": rows,
            "staging": staging, "kd_launches": kd_launches,
            "kd_launches_total": kd_total, "wall_ms": walls,
            "median_ms": statistics.median(walls)}


def mesh_probe(shape, axis_names, device: DeviceLike = None) -> Dict:
    """A mesh's view from this rank: its coordinates, each axis's
    ranks, and the sum of the global ranks over each axis's subgroup
    (a ``psum`` on it, so a wrong subgroup shows)."""
    mesh = make_mesh(shape, axis_names, device=device)
    me = torch.tensor([float(mesh.rank)], device=mesh.device)
    return {"rank": mesh.rank, "shape": dict(mesh.shape),
            "coords": {a: mesh.axis_index(a) for a in mesh.axis_names},
            "axis_ranks": {a: mesh.axis_ranks(a) for a in mesh.axis_names},
            "psum": {a: float(collectives.psum(me, mesh, a,
                                               site="probe")[0])
                     for a in mesh.axis_names}}
