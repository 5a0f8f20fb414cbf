"""Batched DFA byte-scan (counterpart of the reference's
``engine/dfa_kernel.py``).

Two arms, picked once on the host and passed down:

* ``"gather"`` — one transition-table lookup per (bank, flow, byte):
  the reference's default. On CUDA it is kernel KD
  (``engine/dfa_dense_cuda.py``), one launch for the whole scan and the
  accept-word reads; on the CPU its plain per-byte loop.
* ``"oblivious"`` — the reference's ``pallas`` pick
  (``CILIUM_TPU_DFA_IMPL=pallas``): input-independent timing, ≤128
  states per bank. On CUDA it is kernel K2
  (``engine/dfa_oblivious_cuda.py``). A bank over the state budget
  falls back to the gather arm (KD, also a hand-written kernel) with
  the reference's loud ``RuntimeWarning``.

Transition tables are ``[NB, S, K]`` int32; accept words are uint32 in
the reference and travel here as int32 bit patterns.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import torch

from cilium_tpu_torch.engine import dfa_oblivious_cuda
from cilium_tpu_torch.engine.dfa_dense_cuda import (
    accept_words,
    dense_finals_plain,
    dense_scan,
)

IMPL_GATHER = "gather"
IMPL_OBLIVIOUS = "oblivious"


def resolve_impl(env=None) -> str:
    """HOST-side arm resolution from ``CILIUM_TPU_DFA_IMPL`` (the
    reference's variable): ``pallas`` or ``oblivious`` pick the
    oblivious arm, anything else the gather arm (the reference's
    ``onehot`` is bit-equal to gather and is not ported)."""
    env = os.environ if env is None else env
    pick = env.get("CILIUM_TPU_DFA_IMPL", "")
    return IMPL_OBLIVIOUS if pick in ("pallas", IMPL_OBLIVIOUS) \
        else IMPL_GATHER


def _arm_for(impl: Optional[str], trans_shape) -> str:
    impl = impl or IMPL_GATHER
    if impl not in (IMPL_GATHER, IMPL_OBLIVIOUS):
        raise ValueError(f"unknown dfa impl {impl!r}")
    if impl == IMPL_OBLIVIOUS and \
            not dfa_oblivious_cuda.pallas_supported(trans_shape):
        # the oblivious arm is an explicit opt-in for its
        # input-independent timing; degrading must be loud (the
        # reference's warning, word for word)
        warnings.warn(
            f"CILIUM_TPU_DFA_IMPL=pallas requested but a bank has "
            f"{trans_shape[1]} states (limit "
            f"{dfa_oblivious_cuda.MAX_STATES}); falling back to the "
            f"data-dependent 'gather' path — the constant-time "
            f"guarantee does NOT hold. Compile with a smaller "
            f"bank_size to keep it.",
            RuntimeWarning, stacklevel=3)
        impl = IMPL_GATHER
    return impl


def dfa_scan(trans, byteclass, start, data, lengths) -> torch.Tensor:
    """One bank: ``trans [S, K]``, ``byteclass [256]``, scalar
    ``start`` → final states [B] (plain per-byte loop)."""
    return dense_finals_plain(trans[None], byteclass[None],
                              torch.as_tensor(start).reshape(1),
                              data, lengths)[0]


def dfa_finals_banked(trans, byteclass, start, data, lengths,
                      impl: Optional[str] = None) -> torch.Tensor:
    """Final DFA states for every (bank, flow) → [NB, B] int32."""
    if _arm_for(impl, trans.shape) == IMPL_OBLIVIOUS:
        return dfa_oblivious_cuda.dfa_finals_oblivious(
            trans, byteclass, start, data, lengths)
    return dense_scan(trans, byteclass, start, data, lengths)


def dfa_scan_banked(trans, byteclass, start, accept, data, lengths,
                    impl: Optional[str] = None,
                    extra_accept: Optional[torch.Tensor] = None):
    """All banks over one batch → accept words ``[B, NB, W]``;
    ``extra_accept`` ([NB, S, Wg]) reads a second plane off the same
    final states and makes the return a ``(words, extra_words)``
    tuple."""
    if _arm_for(impl, trans.shape) == IMPL_GATHER:
        return dense_scan(trans, byteclass, start, data, lengths,
                          accept=accept, extra=extra_accept)
    finals = dfa_oblivious_cuda.dfa_finals_oblivious(
        trans, byteclass, start, data, lengths)
    return accept_words(finals, accept, extra_accept)
