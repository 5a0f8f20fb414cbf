"""KD: the dense-gather DFA scan as one CUDA launch
(``csrc/dfa_dense.cu``), and its plain PyTorch version.

The reference scans with a ``lax.scan`` of table gathers
(``engine/dfa_kernel.py`` ``dfa_scan_banked``); it has no Pallas
kernel, but a torch loop over L bytes would launch L kernels per field
per batch, so the port gives it a hand-written kernel all the same.

:func:`dense_scan` dispatches on where the tensors lie: CPU tensors go
to :func:`dense_scan_plain`, CUDA tensors to :func:`dense_scan_cuda`,
which launches the kernel or raises.

The kernel has two variants, picked from the shapes alone by
:func:`plan_launch`: ``"smem"`` stages the bank's transition table (and
its accept planes, when they fit) in shared memory with a bulk copy,
``"global"`` reads tables over the shared-memory budget from global
memory. ``KERNEL.launches_by_variant`` counts the launches of each.
A measurement that times the two against each other names one with
the private ``_variant=``; no caller in the port does.
"""

from __future__ import annotations

import array
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from cilium_tpu_torch.engine import _build

KERNEL = _build.KERNELS["KD"]

#: the kernel's CTA: threads, flows per thread, flows per tile
THREADS, CHAINS = 256, 2
FLOWS_PER_CTA = THREADS * CHAINS
#: dynamic shared memory a CTA may use on sm_90
SMEM_MAX = 232448
#: the kernel's shared memory before the staged arrays: the u8 class
#: table and the mbarrier
SMEM_HEADER = 256 + 16
H100_SMS = 132


class LaunchPlan(NamedTuple):
    variant: str                 # "smem" or "global"
    grid: Tuple[int, int]        # (CTAs per bank, NB)
    smem: int                    # dynamic shared memory bytes per CTA
    words_smem: bool             # the accept planes staged beside the table
    vec: int                     # bytes per row load: 16, 4 or 1


def staged_bytes(nbytes: int) -> int:
    """Shared memory the kernel lays out for one staged array: the
    array rounded up to 16 bytes, and 16 more so that it keeps its
    global address mod 16."""
    return -(-nbytes // 16) * 16 + 16


def row_load_width(data_ptr: int, row_stride: int, rows: int, L: int) -> int:
    """The widest load (16, 4 or 1 bytes) that every row start
    ``data_ptr + i * row_stride`` is aligned to and that divides L (a
    load never crosses the row's end)."""
    align = data_ptr | (row_stride if rows > 1 else 0) | L
    for v in (16, 4):
        if align % v == 0:
            return v
    return 1


@functools.lru_cache(maxsize=256)
def plan_launch(NB: int, S: int, K: int, B: int, L: int, W: int = 0,
                Wg: int = 0, data_ptr: int = 0,
                row_stride: Optional[int] = None,
                sms: int = H100_SMS,
                _variant: Optional[str] = None) -> LaunchPlan:
    """The launch of KD for these shapes. The shared-memory variant
    when the bank's transition table fits (``S·K·4`` bytes plus the
    header), with the accept planes (``S·W·4``, ``S·Wg·4``) beside it
    when they fit too; its CTAs per bank fill the SMs once (a CTA loops
    over tiles of ``FLOWS_PER_CTA`` flows, and stages its tables once).
    Else the global variant, one CTA per tile. The row load width
    follows the data's address, row stride and L. For measurement
    only, ``_variant="global"`` takes the global variant whatever the
    table's size; ``_variant="smem"`` raises when the table does not
    fit."""
    if _variant not in (None, "smem", "global"):
        raise ValueError(f"KD has no variant {_variant!r}")
    tiles = -(-B // FLOWS_PER_CTA)
    vec = row_load_width(data_ptr, L if row_stride is None else row_stride,
                         B, L)
    smem = SMEM_HEADER + staged_bytes(S * K * 4)
    if smem > SMEM_MAX and _variant == "smem":
        raise _build.KernelArgumentError(
            f"KD: a {S}x{K} table is over the shared-memory budget")
    if smem > SMEM_MAX or _variant == "global":
        return LaunchPlan("global", (tiles, NB), SMEM_HEADER, False, vec)
    words = sum(staged_bytes(S * w * 4) for w in (W, Wg) if w)
    words_smem = words > 0 and smem + words <= SMEM_MAX
    per_bank = max(1, min(tiles, sms // max(NB, 1)))
    return LaunchPlan("smem", (per_bank, NB),
                      smem + (words if words_smem else 0), words_smem, vec)


@functools.lru_cache(maxsize=8)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def accept_words(finals: torch.Tensor, accept: Optional[torch.Tensor],
                 extra: Optional[torch.Tensor] = None):
    """Final states [NB, B] → accept words [B, NB, W] (+ the extra
    plane's [B, NB, Wg]); the reference's ``_accept_rows`` over all
    banks. With no accept table, the finals themselves."""
    if accept is None:
        return finals

    def rows(acc):
        nb = torch.arange(acc.shape[0], device=acc.device)[:, None]
        return acc[nb, finals.long()].permute(1, 0, 2).contiguous()

    if extra is None:
        return rows(accept)
    return rows(accept), rows(extra)


def dense_finals_plain(trans, byteclass, start, data, lengths):
    """Per-byte loop: final DFA state of every (bank, flow) → [NB, B]
    int32. Bytes at t >= length leave the state unchanged."""
    NB, S, K = trans.shape
    B, L = data.shape
    cls = byteclass.long()[:, data.long()]                # [NB, B, L]
    flat = trans.reshape(-1).long()
    base = (torch.arange(NB, device=trans.device) * (S * K))[:, None]
    states = start.long()[:, None].expand(NB, B)
    lens = lengths.long()[None, :]
    for t in range(L):
        nxt = flat[base + states * K + cls[:, :, t]]
        states = torch.where(t < lens, nxt, states)
    return states.to(torch.int32)


def dense_scan_plain(trans, byteclass, start, data, lengths,
                     accept=None, extra=None):
    """The plain version of KD: finals [NB, B] when ``accept`` is None,
    else accept words [B, NB, W] (and [B, NB, Wg] for ``extra``)."""
    finals = dense_finals_plain(trans, byteclass, start, data, lengths)
    return accept_words(finals, accept, extra)


def _table(t, dtype, what):
    """A table argument: a contiguous CUDA tensor of ``dtype`` (the
    engine stages its tables contiguous; anything else is copied)."""
    _build.cuda_check(t, dtype, what)
    return t if t.is_contiguous() else t.contiguous()


def dense_scan_cuda(trans, byteclass, start, data, lengths,
                    accept=None, extra=None, _variant=None):
    """KD on the card; same contract as :func:`dense_scan_plain`. The
    data is read in place when its bytes are contiguous within a row
    (``stride(1) == 1``), the lengths at any stride. The shapes pick
    the variant (:func:`plan_launch`; ``_variant`` overrides it for
    measurement only)."""
    i32 = torch.int32
    trans = _table(trans, i32, "trans")
    byteclass = _table(byteclass, i32, "byteclass")
    start = _table(start, i32, "start")
    _build.cuda_check(data, torch.uint8, "data")
    _build.cuda_check(lengths, i32, "lengths")
    NB, S, K = trans.shape
    B, L = data.shape
    if byteclass.shape != (NB, 256) or start.shape != (NB,) \
            or lengths.shape != (B,):
        raise _build.KernelArgumentError("dense_scan: inconsistent shapes")
    row_stride, col_stride = data.stride()
    if L > 1 and col_stride != 1:
        data = data.contiguous()
        row_stride = L
    finals = words = xwords = None
    W = Wg = 0
    if accept is None:
        finals = data.new_empty((NB, B), dtype=i32)
    else:
        accept = _table(accept, i32, "accept")
        W = accept.shape[2]
        if accept.shape[:2] != (NB, S):
            raise _build.KernelArgumentError(
                "dense_scan: accept must be [NB, S, W]")
        words = data.new_empty((B, NB, W), dtype=i32)
        if extra is not None:
            extra = _table(extra, i32, "extra")
            Wg = extra.shape[2]
            if extra.shape[:2] != (NB, S):
                raise _build.KernelArgumentError(
                    "dense_scan: extra must be [NB, S, Wg]")
            xwords = data.new_empty((B, NB, Wg), dtype=i32)
    if B and NB:
        dptr = data.data_ptr()
        index = data.get_device()
        plan = plan_launch(NB, S, K, B, L, W, Wg, dptr % 16,
                           row_stride % 16, _sm_count(index), _variant)
        args = array.array("q", (
            trans.data_ptr(), byteclass.data_ptr(), start.data_ptr(),
            0 if accept is None else accept.data_ptr(),
            0 if extra is None else extra.data_ptr(), dptr,
            lengths.data_ptr(), 0 if words is None else words.data_ptr(),
            0 if xwords is None else xwords.data_ptr(),
            0 if finals is None else finals.data_ptr(),
            NB, S, K, W, Wg, B, L, row_stride, lengths.stride()[0],
            plan.variant == "smem", plan.words_smem, plan.grid[0],
            plan.smem, plan.vec, _build.stream_ptr(index)))
        KERNEL.launch(args.buffer_info()[0], variant=plan.variant)
    if accept is None:
        return finals
    return words if extra is None else (words, xwords)


def dense_scan(trans, byteclass, start, data, lengths,
               accept=None, extra=None):
    """Dispatch on the tensors' device: plain on CPU, KD on CUDA."""
    if data.is_cuda:
        return dense_scan_cuda(trans, byteclass, start, data, lengths,
                               accept=accept, extra=extra)
    return dense_scan_plain(trans, byteclass, start, data, lengths,
                            accept=accept, extra=extra)
