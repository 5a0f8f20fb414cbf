"""Rank meshes (the reference's ``parallel/mesh.py``).

In the reference, one process drives a ``jax.sharding.Mesh`` of
devices through ``shard_map``. Here each rank of a
``torch.distributed`` world is a process that runs the ``shard_map``
body on its own shard, and a :class:`Mesh` is a grid of ranks with
named axes: a named axis is a ``torch.distributed`` subgroup (one per
slice of the grid along it), ``lax.axis_index(axis)`` is the rank's
coordinate on it (:meth:`Mesh.axis_index`), a ``P(axis)`` input is the
rank's contiguous slice (:func:`local_slice`) and a ``P()`` input or
output is held whole by every rank.

:class:`LocalWorld` is the counterpart of the reference's
``force_cpu_host_devices`` (8 virtual CPU devices for the tests): ``n``
spawned ``gloo`` ranks that run the functions they are sent, with a
time limit on every call and on the join.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import shutil
import tempfile
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cilium_tpu_torch.core.device import DeviceLike, resolve_device


class Mesh:
    """A grid of global ranks with named axes, seen from one rank:
    :attr:`devices` is the rank grid (the reference's device grid),
    :attr:`shape` maps each axis to its size, and :meth:`group` is this
    rank's subgroup along an axis. :attr:`device` is where this rank
    computes; :attr:`backend` the subgroups' backend."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 groups: Dict[str, object], rank: int, backend: str,
                 device: torch.device):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.rank = rank
        self.backend = backend
        self.device = device
        self._groups = groups
        where = np.argwhere(devices == rank)
        self._coords = ({a: int(c) for a, c in zip(self.axis_names, where[0])}
                        if len(where) else None)

    def _coord(self, axis: str) -> int:
        if self._coords is None:
            raise ValueError(f"rank {self.rank} is not on this mesh")
        return self._coords[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
        return self._coord(axis)

    def axis_ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's slice along ``axis``, in
        axis order."""
        self._coord(axis)
        idx = [self._coords[a] if a != axis else slice(None)
               for a in self.axis_names]
        return [int(r) for r in self.devices[tuple(idx)]]

    def group(self, axis: str):
        """This rank's subgroup along ``axis``."""
        self._coord(axis)
        return self._groups[axis]


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",),
              ranks: Optional[Sequence[int]] = None,
              device: DeviceLike = None,
              backend: Optional[str] = None) -> Mesh:
    """Build a mesh over ``ranks`` (default: the whole world).

    ``shape=None`` puts every rank on the first axis; for a 2-axis
    layout (DP × EP) pass e.g. ``shape=(2, 2), axis_names=("data",
    "expert")``. Every rank of the world must call it with the same
    arguments: it creates one subgroup per slice of every axis, in the
    same order on every rank (``dist.new_group`` is collective over the
    world). ``backend`` defaults to the world's; ``device`` to
    ``cuda`` (raises without it)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "world (init_multihost, or LocalWorld's ranks)")
    world = list(ranks if ranks is not None
                 else range(dist.get_world_size()))
    if shape is None:
        shape = (len(world),) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} has {len(shape)} axes but "
                         f"{len(axis_names)} names {tuple(axis_names)}")
    n = int(np.prod(shape))
    if n > len(world):
        raise ValueError(f"mesh shape {shape} needs {n} ranks, "
                         f"have {len(world)}")
    grid = np.array(world[:n], dtype=np.int64).reshape(shape)
    backend = backend or dist.get_backend()
    me = dist.get_rank()
    groups = {}
    for i, axis in enumerate(axis_names):
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
        for line in lines:
            members = [int(r) for r in line]
            g = dist.new_group(ranks=members, backend=backend)
            if me in members:
                groups[axis] = g
    return Mesh(grid, axis_names, groups, me, backend,
                resolve_device(device))


def mesh_from_config(pcfg, ranks: Optional[Sequence[int]] = None,
                     device: DeviceLike = None) -> Mesh:
    """The mesh a :class:`~cilium_tpu_torch.core.config.ParallelConfig`
    describes: ``data_axis`` (DP over the flow batch), plus
    ``expert_axis`` (EP over DFA banks) when ``use_expert_axis`` is set;
    ``mesh_shape`` pins the layout (None → every rank on the data
    axis)."""
    axes = ((pcfg.data_axis, pcfg.expert_axis)
            if pcfg.use_expert_axis else (pcfg.data_axis,))
    shape = pcfg.mesh_shape
    if shape is not None:
        shape = tuple(shape)
        if len(shape) != len(axes):
            raise ValueError(
                f"mesh_shape {shape} has {len(shape)} axes but the "
                f"config names {len(axes)} ({axes})")
    return make_mesh(shape, axes, ranks, device)


def mesh_from_root_config(cfg, ranks: Optional[Sequence[int]] = None,
                          device: DeviceLike = None) -> Mesh:
    """:func:`mesh_from_config` off a root ``Config`` (its ``parallel``
    section)."""
    return mesh_from_config(cfg.parallel, ranks, device)


def data_parallel_mesh(n: Optional[int] = None,
                       device: DeviceLike = None) -> Mesh:
    ranks = list(range(dist.get_world_size()))
    if n is not None:
        ranks = ranks[:n]
    return make_mesh((len(ranks),), ("data",), ranks, device)


def local_slice(x, mesh: Mesh, axis: str, dim: int = 0):
    """This rank's contiguous block of ``x`` along ``dim`` (a ``P(axis)``
    placement of a global array): the size along ``dim`` must divide
    the axis."""
    n = mesh.shape[axis]
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of size {size} does not shard "
                         f"evenly over the {axis!r} axis ({n})")
    k = size // n
    i = mesh.axis_index(axis)
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(i * k, (i + 1) * k)
    return x[tuple(idx)]


# -- a local world of spawned ranks ------------------------------------------

def _rank_main(rank: int, n: int, store_path: str, conn, backend: str,
               timeout_s: float) -> None:
    """A spawned rank: join the world, then run what the parent sends
    until it sends ``None``."""
    torch.set_num_threads(1)
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, n), rank=rank,
        world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            fn, args, kwargs = msg
            try:
                conn.send(("ok", fn(*args, **kwargs)))
            except Exception:  # reported to the parent, which raises
                conn.send(("err", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class WorldError(RuntimeError):
    """A rank of a :class:`LocalWorld` failed, died or timed out; the
    world is torn down."""


class LocalWorld:
    """``n`` spawned ranks of one ``torch.distributed`` world on this
    host — the tests' counterpart of the reference's virtual CPU
    devices, and ``chip_smoke.py``'s ranks sharing one card.

    * the ranks rendezvous on a ``FileStore`` in a temporary directory
      (no port to race for between concurrent test workers);
    * ``init_process_group`` gets ``timeout_s``, so a collective whose
      peers are gone fails instead of waiting forever;
    * every :meth:`run` has its own time limit: a rank that does not
      answer in time, dies or raises tears the world down and
      :class:`WorldError` names it;
    * each rank calls ``torch.set_num_threads(1)``.

    ``fn`` must be picklable by import path (a module-level function)."""

    def __init__(self, n: int, backend: str = "gloo",
                 timeout_s: float = 120.0):
        self.n = n
        self._dir = tempfile.mkdtemp(prefix="ct-world-")
        ctx = multiprocessing.get_context("spawn")
        self._conns = []
        self._procs = []
        for r in range(n):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                r, n, os.path.join(self._dir, "store"), child, backend,
                timeout_s))
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)
        self._alive = True

    def run(self, fn, *args, timeout_s: float = 120.0, **kwargs) -> list:
        """Run ``fn(*args, **kwargs)`` on every rank; the ranks'
        results in rank order."""
        if not self._alive:
            raise WorldError("the world was torn down by an earlier failure")
        for c in self._conns:
            c.send((fn, args, kwargs))
        deadline = time.monotonic() + timeout_s
        out = []
        for r, c in enumerate(self._conns):
            try:
                ready = c.poll(max(0.0, deadline - time.monotonic()))
                msg = c.recv() if ready else None
            except (EOFError, OSError):
                msg = ("err", f"rank {r} died (exit code "
                              f"{self._procs[r].exitcode})")
            if msg is None:
                msg = ("err", f"rank {r} did not answer in {timeout_s} s")
            if msg[0] != "ok":
                self.close(kill=True)
                raise WorldError(f"{getattr(fn, '__name__', fn)} on rank "
                                 f"{r}: {msg[1]}")
            out.append(msg[1])
        return out

    def close(self, kill: bool = False, timeout_s: float = 30.0) -> None:
        """Stop the ranks (at once with ``kill``), join each with a
        time limit, kill any still alive, and remove the store."""
        if self._alive and not kill:
            for c in self._conns:
                try:
                    c.send(None)
                except (BrokenPipeError, OSError):
                    pass
        self._alive = False
        for p in self._procs:
            if kill:
                p.kill()
            p.join(timeout_s)
            if p.is_alive():
                p.kill()
                p.join(timeout_s)
        for c in self._conns:
            c.close()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "LocalWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close(kill=exc[0] is not None)
