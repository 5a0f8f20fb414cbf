"""K2: the data-oblivious DFA scan (``csrc/dfa_oblivious.cu``), the
port of the reference's ``engine/pallas_dfa.py`` ``dfa_finals_pallas``,
and its plain PyTorch version.

The reference's kernel steps every flow with a one-hot matmul so that
its time never depends on the payload or the rule set. The plain
version below keeps that arithmetic (one-hot state times the table,
then a class column select, exact in float32 since every state id is
below 128); the CUDA kernel computes the same product on the tensor
cores, 16 flows per warp, with the table in fp16 (see the notes in the
source).

:func:`dfa_finals_oblivious` dispatches on where the tensors lie.
"""

from __future__ import annotations

import torch

from cilium_tpu_torch.engine import _build

KERNEL = _build.KERNELS["K2"]

#: state budget per bank (the reference's ``pallas_dfa.MAX_STATES``):
#: at most 8 k-steps of 16 states in the kernel's one-hot operand
MAX_STATES = 128


def pallas_supported(trans_shape) -> bool:
    """True when the banked table fits the kernel's state budget (the
    reference's name, kept so the two packages read alike)."""
    return trans_shape[1] <= MAX_STATES


def _check_states(S: int) -> None:
    if S > MAX_STATES:
        raise ValueError(
            f"oblivious DFA kernel needs ≤{MAX_STATES} states/bank, got "
            f"{S} (compile with a smaller bank_size)")


def dfa_finals_oblivious_plain(trans, byteclass, start, data, lengths):
    """Final DFA states [NB, B] int32 by the reference kernel's
    arithmetic: identity class K on padding bytes, and per byte
    ``rows = onehot(state) · trans``, ``next = Σ_k rows ⊙ onehot(c)``."""
    NB, S, K = trans.shape
    _check_states(S)
    B, L = data.shape
    dev = trans.device
    ident = torch.arange(S, device=dev, dtype=torch.float32)
    tab = torch.cat([trans.float(),
                     ident[None, :, None].expand(NB, S, 1)], dim=2)
    cls = byteclass.long()[:, data.long()]                # [NB, B, L]
    pad = torch.arange(L, device=dev)[None, :] >= lengths.long()[:, None]
    cls = torch.where(pad[None], torch.full_like(cls, K), cls)
    s_oh = torch.nn.functional.one_hot(
        start.long()[:, None].expand(NB, B), S).float()   # [NB, B, S]
    for t in range(L):
        rows = torch.bmm(s_oh, tab)                       # [NB, B, K+1]
        c_oh = torch.nn.functional.one_hot(cls[:, :, t], K + 1).float()
        nxt = (rows * c_oh).sum(dim=2).long()
        s_oh = torch.nn.functional.one_hot(nxt, S).float()
    return s_oh.argmax(dim=2).to(torch.int32)


def dfa_finals_oblivious_cuda(trans, byteclass, start, data, lengths):
    """K2 on the card → [NB, B] int32."""
    i32 = torch.int32
    trans = _build.cuda_arg(trans, i32, "trans")
    byteclass = _build.cuda_arg(byteclass, i32, "byteclass")
    start = _build.cuda_arg(start, i32, "start")
    data = _build.cuda_arg(data, torch.uint8, "data")
    lengths = _build.cuda_arg(lengths, i32, "lengths")
    NB, S, K = trans.shape
    _check_states(S)
    B, L = data.shape
    if byteclass.shape != (NB, 256) or start.shape != (NB,) \
            or lengths.shape != (B,):
        raise ValueError("dfa_finals_oblivious: inconsistent shapes")
    finals = torch.empty((NB, B), dtype=i32, device=trans.device)
    KERNEL.launch(trans.data_ptr(), byteclass.data_ptr(), start.data_ptr(),
                  data.data_ptr(), lengths.data_ptr(), finals.data_ptr(),
                  NB, S, K, B, L, _build.stream_ptr())
    return finals


def dfa_finals_oblivious(trans, byteclass, start, data, lengths):
    """Dispatch on the tensors' device: plain on CPU, K2 on CUDA."""
    if data.is_cuda:
        return dfa_finals_oblivious_cuda(trans, byteclass, start, data,
                                         lengths)
    return dfa_finals_oblivious_plain(trans, byteclass, start, data,
                                      lengths)
