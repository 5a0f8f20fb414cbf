"""KD: the dense-gather DFA scan as one CUDA launch
(``csrc/dfa_dense.cu``), and its plain PyTorch version.

The reference scans with a ``lax.scan`` of table gathers
(``engine/dfa_kernel.py`` ``dfa_scan_banked``); it has no Pallas
kernel, but a torch loop over L bytes would launch L kernels per field
per batch, so the port gives it a hand-written kernel all the same.

:func:`dense_scan` dispatches on where the tensors lie: CPU tensors go
to :func:`dense_scan_plain`, CUDA tensors to :func:`dense_scan_cuda`,
which launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from cilium_tpu_torch.engine import _build

KERNEL = _build.KERNELS["KD"]


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


def dense_scan_cuda(trans, byteclass, start, data, lengths,
                    accept=None, extra=None):
    """KD on the card; same contract as :func:`dense_scan_plain`."""
    i32 = torch.int32
    trans = _build.cuda_arg(trans, i32, "trans")
    byteclass = _build.cuda_arg(byteclass, i32, "byteclass")
    start = _build.cuda_arg(start, i32, "start")
    data = _build.cuda_arg(data, torch.uint8, "data")
    lengths = _build.cuda_arg(lengths, i32, "lengths")
    NB, S, K = trans.shape
    B, L = data.shape
    if byteclass.shape != (NB, 256) or start.shape != (NB,) \
            or lengths.shape != (B,):
        raise ValueError("dense_scan: inconsistent shapes")
    dev = trans.device
    finals = words = xwords = None
    W = Wg = 0
    if accept is None:
        finals = torch.empty((NB, B), dtype=i32, device=dev)
    else:
        accept = _build.cuda_arg(accept, i32, "accept")
        W = accept.shape[2]
        if accept.shape[:2] != (NB, S):
            raise ValueError("dense_scan: accept must be [NB, S, W]")
        words = torch.empty((B, NB, W), dtype=i32, device=dev)
        if extra is not None:
            extra = _build.cuda_arg(extra, i32, "extra")
            Wg = extra.shape[2]
            if extra.shape[:2] != (NB, S):
                raise ValueError("dense_scan: extra must be [NB, S, Wg]")
            xwords = torch.empty((B, NB, Wg), dtype=i32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    KERNEL.launch(
        ptr(trans), ptr(byteclass), ptr(start), ptr(accept), ptr(extra),
        ptr(data), ptr(lengths), ptr(words), ptr(xwords), ptr(finals),
        NB, S, K, W, Wg, B, L, _build.stream_ptr())
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
