"""PP (pipeline parallel): the host→device boundary double-buffered
across batches (the reference's ``parallel/pipeline.py``).

The per-batch stage chain (mapstate lookup → field scans → resolve →
verdict) stays one step on purpose; what needs pipelining is the copy
of each batch onto the card. :func:`run_pipelined` issues the copy of
batch *i + depth* on a side stream while batch *i* computes on the
current one: an event recorded after each copy orders it before that
batch's step, and nothing is read back inside the loop.

The step is host-bound (its launches cost more host time than its
kernels take on the card), so the loop's own host work adds to the
wall one for one. A batch therefore travels as ONE flat byte buffer:
its columns are packed into a slot of a ring of ``depth`` pinned
buffers (allocated once a call, each reused once the copy out of it
has finished), copied in one ``copy_`` into one device buffer, and
handed to the step as views of it. The device buffer is allocated on
the compute stream and the side stream waits for the compute stream
before it writes, so the allocator can hand the block back to the
compute stream without ``record_stream``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from cilium_tpu_torch.core.device import DeviceLike, resolve_device

#: each column starts on this byte boundary of the flat buffer (the
#: caching allocator's own alignment, so a view is aligned as a tensor
#: of its own would be)
_ALIGN = 256

#: (name, host array, torch dtype, byte offset) of each column
Layout = List[Tuple[str, np.ndarray, torch.dtype, int]]


def _layout(batch: Dict[str, np.ndarray]) -> Tuple[Layout, int]:
    cols, off = [], 0
    for name, v in batch.items():
        a = np.ascontiguousarray(v)
        cols.append((name, a, torch.from_numpy(a).dtype, off))
        off += -(-a.nbytes // _ALIGN) * _ALIGN
    return cols, off


def _views(flat: torch.Tensor, cols: Layout) -> Dict[str, torch.Tensor]:
    return {name: flat[off:off + a.nbytes].view(dtype).view(a.shape)
            for name, a, dtype, off in cols}


class _PinnedRing:
    """``depth`` pinned byte buffers, each reused once the copy out of
    it has finished."""

    def __init__(self, depth: int):
        self.slots: List = [None] * depth
        self.done: List = [None] * depth

    def fill(self, i: int, batch: Dict[str, np.ndarray]):
        """Batch ``i``'s columns packed into its slot → (the slot's
        bytes, the layout)."""
        k = i % len(self.slots)
        if self.done[k] is not None:
            self.done[k].synchronize()   # the copy of batch i - depth
        cols, total = _layout(batch)
        if self.slots[k] is None or self.slots[k].numel() < total:
            self.slots[k] = torch.empty(total, dtype=torch.uint8,
                                        pin_memory=True)
        host = self.slots[k].numpy()
        for _, a, _, off in cols:
            host[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        return self.slots[k][:total], cols

    def copied(self, i: int, event) -> None:
        self.done[i % len(self.slots)] = event


def run_pipelined(
    step: Callable[[Dict, Dict], Dict],
    arrays: Dict[str, torch.Tensor],
    host_batches: Sequence[Dict[str, np.ndarray]],
    device: DeviceLike = None,
    depth: int = 2,
) -> List[Dict[str, torch.Tensor]]:
    """Run ``step(arrays, batch)`` over ``host_batches`` with the copies
    ``depth`` batches ahead of compute.

    Returns per-batch output dicts of (unread) device tensors; read
    them (:func:`collect`) only after the loop. ``device`` defaults to
    ``cuda``; on the CPU there is no copy to overlap and the batches are
    taken as they are."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    dev = resolve_device(device)
    batches = list(host_batches)
    if dev.type != "cuda":
        return [step(arrays, {k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in b.items()}) for b in batches]
    compute = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    ring = _PinnedRing(depth)
    staged: List = []

    def put(i):
        host, cols = ring.fill(i, batches[i])
        flat = torch.empty(host.shape, dtype=torch.uint8, device=dev)
        # the block may have served the compute stream's earlier work
        side.wait_stream(compute)
        with torch.cuda.stream(side):
            flat.copy_(host, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        ring.copied(i, ready)
        return _views(flat, cols), ready

    for i in range(min(depth, len(batches))):
        staged.append(put(i))
    outputs = []
    for i in range(len(batches)):
        cur, ready = staged[i]
        staged[i] = None   # keep only ~depth batches resident
        compute.wait_event(ready)
        outputs.append(step(arrays, cur))
        if i + depth < len(batches):
            staged.append(put(i + depth))
    return outputs


def collect(outputs: Iterable[Dict[str, torch.Tensor]]
            ) -> List[Dict[str, np.ndarray]]:
    """Read back a pipeline's outputs (one sync point, after all work
    is enqueued)."""
    return [{k: v.cpu().numpy() for k, v in out.items()}
            for out in outputs]
