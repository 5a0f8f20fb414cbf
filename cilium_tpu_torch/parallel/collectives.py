"""Collective accounting — the multichip half of the perf ledger (the
reference's ``parallel/collectives.py``).

Every collective in ``parallel/`` and ``engine/longscan.py`` goes
through one of the four wrappers below, which records ``(site, op
kind, axis, payload bytes)`` and then issues the ``torch.distributed``
call on the mesh axis's subgroup:

* :func:`psum` — ``dist.all_reduce`` (sum);
* :func:`all_gather` — ``all_gather_into_tensor``: concatenated on the
  leading axis when ``tiled``, stacked on a new one when not;
* :func:`all_to_all` — ``all_to_all_single`` with the split and the
  concatenated axis moved to the front and back (it splits and
  concatenates dim 0 only);
* :func:`ppermute` — ``batch_isend_irecv`` over the ``(src, dst)``
  pairs of the axis; a rank that is no pair's destination gets zeros.

Semantics of the ledger, against the reference's:

* the reference records while jax traces a block and scales a loop's
  records by its trip count (``scaled``); eager torch issues every
  collective it executes, so here a count is the number of calls since
  :meth:`CollectiveLedger.reset` — per lane call when a caller resets
  before one call and snapshots after it, as the reference's benches
  and tests do. No caller needs ``scaled``, so it is not ported;
* bytes are the payload's own shape. A reference collective under
  ``vmap`` records once with the bytes of one mapped lane; the port's
  callers that stack what the reference vmaps (TP's banks) pass
  ``mapped=1`` and the ledger counts the bytes of one lane the same
  way, so the rows equal the reference's.

The backend is the caller's choice, made once per mesh
(``parallel/mesh.py``). When a ``gloo`` group carries CUDA tensors (ranks
that share one card), the wrapper copies the payload into pinned host
memory, runs the collective there and copies the result back, and the
ledger counts those staged bytes and seconds apart
(:meth:`CollectiveLedger.staging`). It never switches backend and never
catches a failed collective. bool payloads travel as uint8; words are
already int32 bit patterns (neither gloo nor NCCL takes uint32).
:meth:`CollectiveLedger.publish_metrics` copies the counts into the
Prometheus families ``cilium_tpu_collective_ops_total`` /
``cilium_tpu_collective_bytes_total``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from cilium_tpu_torch.runtime.metrics import (
    COLLECTIVE_BYTES,
    COLLECTIVE_OPS,
    METRICS,
)

class CollectiveLedger:
    """Per-process collective account book (one instance:
    :data:`LEDGER`, mirroring the METRICS registry discipline)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: (site, op, axis) → [count, bytes, bytes_per_call]
        self._ops: Dict[tuple, List[int]] = {}
        #: what publish_metrics already pushed, per key
        self._published: Dict[tuple, List[int]] = {}
        self._staged = [0, 0.0]      # bytes, seconds

    def record(self, site: str, op: str, axis: str, shape,
               dtype: torch.dtype, mapped: int = 0) -> None:
        per_lane = tuple(shape)[mapped:]
        n = 1
        for d in per_lane:
            n *= int(d)
        nbytes = n * torch.empty((), dtype=dtype).element_size()
        key = (site, op, str(axis))
        with self._lock:
            cur = self._ops.get(key)
            if cur is None:
                self._ops[key] = [1, nbytes, nbytes]
            else:
                cur[0] += 1
                cur[1] += nbytes
                cur[2] = nbytes

    def record_staging(self, nbytes: int, seconds: float) -> None:
        with self._lock:
            self._staged[0] += int(nbytes)
            self._staged[1] += float(seconds)

    def snapshot(self) -> List[Dict]:
        """Sorted per-site rows, the reference's keys: op kind, count
        per block, bytes per block, bytes per single op."""
        with self._lock:
            items = sorted(self._ops.items())
        return [{"site": site, "op": op, "axis": axis,
                 "count_per_block": int(c),
                 "bytes_per_block": int(b),
                 "bytes_per_call": int(per)}
                for (site, op, axis), (c, b, per) in items]

    def staging(self) -> Dict[str, float]:
        """Host staging since the last reset: bytes copied between the
        card and pinned host memory (both ways) and their seconds."""
        with self._lock:
            return {"bytes": int(self._staged[0]),
                    "seconds": float(self._staged[1])}

    def reset(self) -> None:
        with self._lock:
            self._ops = {}
            self._published = {}
            self._staged = [0, 0.0]

    def publish_metrics(self) -> None:
        """Push accumulated counts into the Prometheus families.
        Idempotent across calls: only deltas since the last publish
        are added."""
        with self._lock:
            items = [(k, list(v)) for k, v in self._ops.items()]
        for key, (c, b, _per) in items:
            pub = self._published.setdefault(key, [0, 0])
            dc, db = c - pub[0], b - pub[1]
            if dc <= 0 and db <= 0:
                continue
            site, op, axis = key
            labels = {"site": site, "op": op, "axis": axis}
            if dc > 0:
                METRICS.inc(COLLECTIVE_OPS, dc, labels=labels)
            if db > 0:
                METRICS.inc(COLLECTIVE_BYTES, db, labels=labels)
            pub[0], pub[1] = c, b


#: process-global ledger (like METRICS)
LEDGER = CollectiveLedger()


# -- payload staging ---------------------------------------------------------

def _staged(mesh) -> bool:
    return mesh.backend == "gloo" and mesh.device.type == "cuda"


def _to_wire(x: torch.Tensor, mesh) -> torch.Tensor:
    """The payload as the backend takes it: bool as uint8, contiguous;
    on a gloo mesh of CUDA ranks, a copy in pinned host memory."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    x = x.contiguous()
    if not _staged(mesh):
        return x
    torch.cuda.current_stream(x.device).synchronize()
    t0 = time.perf_counter()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    LEDGER.record_staging(x.numel() * x.element_size(),
                          time.perf_counter() - t0)
    return host


def _empty_wire(shape, dtype: torch.dtype, mesh) -> torch.Tensor:
    if dtype == torch.bool:
        dtype = torch.uint8
    if _staged(mesh):
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    return torch.empty(shape, dtype=dtype, device=mesh.device)


def _from_wire(y: torch.Tensor, dtype: torch.dtype, mesh) -> torch.Tensor:
    if _staged(mesh):
        t0 = time.perf_counter()
        y = y.to(mesh.device, non_blocking=True)
        torch.cuda.current_stream(mesh.device).synchronize()
        LEDGER.record_staging(y.numel() * y.element_size(),
                              time.perf_counter() - t0)
    return y.to(torch.bool) if dtype == torch.bool else y


# -- the wrappers: record, then issue the collective --------------------------

def psum(x: torch.Tensor, mesh, axis: str, *, site: str,
         mapped: int = 0) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (``lax.psum``)."""
    LEDGER.record(site, "psum", axis, x.shape, x.dtype, mapped)
    buf = _to_wire(x, mesh)
    if buf is x:
        buf = x.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return _from_wire(buf, x.dtype, mesh)


def _gather_raw(x: torch.Tensor, mesh, axis: str,
                tiled: bool) -> torch.Tensor:
    if not x.ndim:
        raise ValueError("all_gather: a scalar has no leading axis")
    n = mesh.shape[axis]
    buf = _to_wire(x, mesh)
    out = _empty_wire((n * x.shape[0],) + tuple(x.shape[1:]), x.dtype, mesh)
    dist.all_gather_into_tensor(out, buf, group=mesh.group(axis))
    out = _from_wire(out, x.dtype, mesh)
    return out if tiled else out.reshape((n,) + tuple(x.shape))


def all_gather(x: torch.Tensor, mesh, axis: str, *, site: str,
               tiled: bool = False) -> torch.Tensor:
    """``lax.all_gather``: every rank's ``x`` in axis order, stacked on
    a new leading axis (``[n, *x.shape]``), or concatenated on the
    leading axis when ``tiled``."""
    LEDGER.record(site, "all_gather", axis, x.shape, x.dtype)
    return _gather_raw(x, mesh, axis, tiled)


def all_to_all(x: torch.Tensor, mesh, axis: str, split_axis: int,
               concat_axis: int, *, site: str) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)`` (the only form the parallel
    layer uses): ``x`` split in n blocks on ``split_axis``; block j goes
    to rank j of ``axis``; the blocks a rank receives are concatenated
    on ``concat_axis`` in source order. ``all_to_all_single`` splits and
    concatenates dim 0 only, so the split axis moves to the front before
    it and the received blocks move next to the concatenated axis after
    it."""
    LEDGER.record(site, "all_to_all", axis, x.shape, x.dtype)
    n = mesh.shape[axis]
    nd = x.ndim
    split_axis %= nd
    concat_axis %= nd
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)}"
                         f" does not split in {n}")
    moved = x.movedim(split_axis, 0)
    lead = moved.shape[0] // n
    send = _to_wire(moved.reshape((n, lead) + tuple(moved.shape[1:])), mesh)
    recv = _empty_wire(send.shape, x.dtype, mesh)
    dist.all_to_all_single(recv, send, group=mesh.group(axis))
    recv = _from_wire(recv, x.dtype, mesh)        # [n(source), lead, ...]
    # the concatenated axis in ``moved``'s order (dims before the split
    # axis shifted one right by the move); the source axis goes in front
    # of it and the two merge, source-major
    c = concat_axis + 1 if concat_axis < split_axis else concat_axis
    merged = recv.movedim(0, c)
    shape = list(merged.shape)
    shape[c:c + 2] = [shape[c] * shape[c + 1]]
    return merged.reshape(shape).movedim(0, split_axis)


def ppermute(x: torch.Tensor, mesh, axis: str,
             perm: Sequence[Tuple[int, int]], *, site: str) -> torch.Tensor:
    """``lax.ppermute``: for each ``(src, dst)`` pair of axis indices,
    ``src`` sends ``x`` to ``dst``; a rank no pair sends to gets zeros."""
    LEDGER.record(site, "ppermute", axis, x.shape, x.dtype)
    me = mesh.axis_index(axis)
    ranks = mesh.axis_ranks(axis)
    group = mesh.group(axis)
    buf = _to_wire(x, mesh)
    recv = _empty_wire(x.shape, x.dtype, mesh)
    ops = []
    got = False
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, buf, ranks[dst], group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, recv, ranks[src], group))
            got = True
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    if not got:
        recv.zero_()
    return _from_wire(recv, x.dtype, mesh)


def gather_global(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """A batch-sharded result (``P(axis)``: DP, EP, Ulysses) → the
    global one, every rank's rows in axis order on every rank: the
    counterpart of reading a global ``jax.Array`` back. Not a lane's
    collective, so the ledger does not record it (staged bytes are
    counted all the same)."""
    return _gather_raw(x, mesh, axis, tiled=True)


def gather_global_dict(out: Dict[str, torch.Tensor], mesh,
                       axis: str) -> Dict[str, torch.Tensor]:
    """:func:`gather_global` over every lane of a verdict output."""
    return {k: gather_global(v, mesh, axis) for k, v in out.items()}
