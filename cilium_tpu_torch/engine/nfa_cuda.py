"""K1: the bitset-NFA byte scan (``csrc/nfa_scan.cu``), the port of the
reference's ``engine/pallas_nfa.py`` ``nfa_finals_pallas``, and its
plain PyTorch version.

Both return the final live-position sets ``[NB, B, P]`` float32 0/1.
One convention differs from the reference's Pallas kernel and is
shared by both versions here: a zero-length flow ends with the empty
set (the reference's XLA ``nfa_finals`` does the same; its Pallas
kernel returns the frozen start set). Callers never see the
difference: ``nfa_kernel._accept_of`` replaces the words of every
zero-length flow with the empty-string accept words.

:func:`nfa_finals_banked` dispatches on where the tensors lie.
"""

from __future__ import annotations

import torch

from cilium_tpu_torch.engine import _build

KERNEL = _build.KERNELS["K1"]

#: position budget per bank (the reference's ``MAX_POSITIONS``): at
#: most 8 k-steps of 16 positions in the kernel's register-held set
MAX_POSITIONS = 128


def nfa_finals_plain(follow, acc_cls, byteclass, start, data, lengths):
    """All banks at once, the reference's arithmetic: byte 0 seeds
    ``start ⊙ acc[c0]``, then per byte ``D' = (D·Follow > 0) ⊙ acc[c]``,
    held where ``t >= length``. Counts stay ≤ 128, exact in float32."""
    NB, P, K = acc_cls.shape
    B, L = data.shape
    dev = follow.device
    if L == 0 or P == 0:
        return torch.zeros((NB, B, P), dtype=torch.float32, device=dev)
    cls = byteclass.long()[:, data.long()]                # [NB, B, L]
    acc_t = acc_cls.float().transpose(1, 2)               # [NB, K, P]
    nb = torch.arange(NB, device=dev)[:, None]
    lens = lengths.long()[None, :, None]
    v = torch.where(lens > 0, start.float()[:, None, :] * acc_t[nb, cls[:, :, 0]],
                    torch.zeros((), device=dev))
    fol = follow.float()
    for t in range(1, L):
        pre = torch.bmm(v, fol)
        nxt = (pre > 0).float() * acc_t[nb, cls[:, :, t]]
        v = torch.where(t < lens, nxt, v)
    return v


def nfa_finals_cuda(follow, acc_cls, byteclass, start, data, lengths):
    """K1 on the card → [NB, B, P] float32 0/1."""
    f32, i32 = torch.float32, torch.int32
    follow = _build.cuda_arg(follow, f32, "follow")
    acc_cls = _build.cuda_arg(acc_cls, f32, "acc_cls")
    byteclass = _build.cuda_arg(byteclass, i32, "byteclass")
    start = _build.cuda_arg(start, f32, "start")
    data = _build.cuda_arg(data, torch.uint8, "data")
    lengths = _build.cuda_arg(lengths, i32, "lengths")
    NB, P, K = acc_cls.shape
    B, L = data.shape
    if P > MAX_POSITIONS:
        raise ValueError(
            f"NFA kernel needs ≤{MAX_POSITIONS} positions/bank, got {P} "
            f"(compile with a smaller bank_size)")
    if follow.shape != (NB, P, P) or start.shape != (NB, P) \
            or byteclass.shape != (NB, 256) or lengths.shape != (B,):
        raise ValueError("nfa_finals: inconsistent shapes")
    finals = torch.empty((NB, B, P), dtype=f32, device=data.device)
    if P == 0:
        return finals            # nothing to scan: no launch
    KERNEL.launch(follow.data_ptr(), acc_cls.data_ptr(),
                  byteclass.data_ptr(), start.data_ptr(), data.data_ptr(),
                  lengths.data_ptr(), finals.data_ptr(),
                  NB, P, K, B, L, _build.stream_ptr())
    return finals


def nfa_finals_banked(follow, acc_cls, byteclass, start, data, lengths):
    """Dispatch on the tensors' device: plain on CPU, K1 on CUDA."""
    if data.is_cuda:
        return nfa_finals_cuda(follow, acc_cls, byteclass, start, data,
                               lengths)
    return nfa_finals_plain(follow, acc_cls, byteclass, start, data,
                            lengths)
