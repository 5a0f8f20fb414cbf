"""Bitset-NFA byte-scan — the "rules-as-lanes" automaton arm
(counterpart of the reference's ``engine/nfa_kernel.py``).

Instead of gathering one DFA state per byte, the scan carries a bitset
over the bank's NFA positions (byte-consuming Thompson edges) and
advances all of them at once:

    D' = ((D · Follow) > 0) ⊙ ClassAccept[byte]

The host half (``compile_nfa_bank``, ``stack_nfa_banks``,
``banks_from_dfa``) is the reference's code, copied. The scan runs on
kernel K1 (``engine/nfa_cuda.py``) for CUDA tensors and on its plain
version for CPU tensors; the accept-word extraction is plain PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cilium_tpu_torch.policy.compiler import regex_parser as rp
from cilium_tpu_torch.policy.compiler.dfa import _byte_classes
from cilium_tpu_torch.policy.compiler.nfa import build_nfa, eps_closure
# MAX_POSITIONS: the position budget per bank — the reference's Pallas
# cap, and here the four 32-bit words of live set K1 keeps per thread
from cilium_tpu_torch.engine.nfa_cuda import (
    MAX_POSITIONS,
    nfa_finals_banked,
    nfa_finals_plain,
)


@dataclasses.dataclass
class NFABank:
    """One bank's position-automaton tensors (host numpy)."""

    follow: np.ndarray      # [P, P] f32 0/1 ε-closed successor matrix
    acc_cls: np.ndarray     # [P, K] f32 0/1 class acceptance per position
    byteclass: np.ndarray   # [256] int32 byte → class
    start: np.ndarray       # [P] f32 0/1 positions live before byte 0
    accept: np.ndarray      # [P, W] uint32 rule bitmaps per position
    empty: np.ndarray       # [W] uint32 rules matching the empty string
    n_patterns: int

    @property
    def n_positions(self) -> int:
        return self.follow.shape[0]


def compile_nfa_bank(patterns: Sequence[str],
                     max_quantifier: int = 64,
                     case_insensitive: bool = False,
                     lanes: Optional[Sequence[int]] = None) -> NFABank:
    """Compile one bank of patterns into position-automaton tensors.

    ``lanes`` maps pattern i to its accept-bit lane (default i) so a
    registry-assembled bank keeps its served lane layout. An empty
    pattern list yields the 0-position dead bank (matches nothing) —
    the bitset-NFA face of a quarantined fail-closed bank."""
    lanes = list(lanes) if lanes is not None else list(range(len(patterns)))
    n_lanes = (max(lanes) + 1) if lanes else 1
    n_words = max(1, (max(n_lanes, 1) + 31) // 32)
    if not patterns:
        return NFABank(
            follow=np.zeros((0, 0), np.float32),
            acc_cls=np.zeros((0, 1), np.float32),
            byteclass=np.zeros(256, np.int32),
            start=np.zeros((0,), np.float32),
            accept=np.zeros((0, n_words), np.uint32),
            empty=np.zeros((n_words,), np.uint32),
            n_patterns=0)
    asts = [rp.parse(p, max_quantifier=max_quantifier,
                     case_insensitive=case_insensitive)
            for p in patterns]
    nfa = build_nfa(asts)
    byteclass, n_classes = _byte_classes(nfa)
    rep = [0] * n_classes
    for b in range(255, -1, -1):
        rep[int(byteclass[b])] = b
    # positions = byte-consuming edges, in deterministic state order
    edges = [(s, m, t) for s in range(nfa.n_states)
             for (m, t) in nfa.edges[s]]
    P = len(edges)
    acc_cls = np.zeros((P, max(1, n_classes)), np.float32)
    for i, (_, m, _) in enumerate(edges):
        for c in range(n_classes):
            if (m >> rep[c]) & 1:
                acc_cls[i, c] = 1.0
    closures = [eps_closure(nfa, [t]) for (_, _, t) in edges]
    start_cl = eps_closure(nfa, [nfa.start])
    follow = np.zeros((P, P), np.float32)
    for i in range(P):
        cl = closures[i]
        for j, (sj, _, _) in enumerate(edges):
            if sj in cl:
                follow[i, j] = 1.0
    start = np.array([1.0 if e[0] in start_cl else 0.0
                      for e in edges], np.float32)
    accept = np.zeros((P, n_words), np.uint32)
    empty = np.zeros((n_words,), np.uint32)

    def set_bit(words, idx):
        lane = lanes[idx]
        words[lane // 32] |= np.uint32(1 << (lane % 32))

    for i in range(P):
        for s in closures[i]:
            if nfa.accepts[s] >= 0:
                set_bit(accept[i], nfa.accepts[s])
    for s in start_cl:
        if nfa.accepts[s] >= 0:
            set_bit(empty, nfa.accepts[s])
    return NFABank(follow=follow, acc_cls=acc_cls, byteclass=byteclass,
                   start=start, accept=accept, empty=empty,
                   n_patterns=len(patterns))


def nfa_supported(banks: Sequence[NFABank]) -> bool:
    """True when every bank fits the position budget."""
    return all(b.n_positions <= MAX_POSITIONS for b in banks)


def stack_nfa_banks(banks: Sequence[NFABank],
                    extra_accept: Optional[Sequence[np.ndarray]] = None
                    ) -> Dict[str, np.ndarray]:
    """Pad + stack banks for the engine (mirror of
    ``BankedDFA.stacked``). ``extra_accept`` (optional, per bank
    ``[P, Wg]``) rides along as the group-accept plane of the factored
    resolve (``engine/megakernel.py``)."""
    NB = len(banks)
    Pm = max([b.n_positions for b in banks] + [1])
    Km = max([b.acc_cls.shape[1] for b in banks] + [1])
    Wm = max([b.accept.shape[1] for b in banks] + [1])
    out = {
        "nfa_follow": np.zeros((NB, Pm, Pm), np.float32),
        "nfa_acc_cls": np.zeros((NB, Pm, Km), np.float32),
        "nfa_byteclass": np.zeros((NB, 256), np.int32),
        "nfa_start": np.zeros((NB, Pm), np.float32),
        "nfa_accept": np.zeros((NB, Pm, Wm), np.uint32),
        "nfa_empty": np.zeros((NB, Wm), np.uint32),
    }
    for i, b in enumerate(banks):
        P, K, W = b.n_positions, b.acc_cls.shape[1], b.accept.shape[1]
        out["nfa_follow"][i, :P, :P] = b.follow
        out["nfa_acc_cls"][i, :P, :K] = b.acc_cls
        out["nfa_byteclass"][i] = b.byteclass
        out["nfa_start"][i, :P] = b.start
        out["nfa_accept"][i, :P, :W] = b.accept
        out["nfa_empty"][i, :W] = b.empty
    if extra_accept is not None:
        Wg = max([g.shape[1] for g in extra_accept] + [1])
        gacc = np.zeros((NB, Pm, Wg), np.uint32)
        for i, g in enumerate(extra_accept):
            gacc[i, :g.shape[0], :g.shape[1]] = g
        out["nfa_gaccept"] = gacc
    return out


def _or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise-OR reduction of int32 words along ``dim`` (the
    reference's ``lax.reduce(..., bitwise_or)``; torch has no OR
    reduction). Folds halves together: log2(n) elementwise ORs."""
    x = x.movedim(dim, 0)
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    while x.shape[0] > 1:
        n = x.shape[0]
        h = n // 2
        folded = x[:h] | x[h:2 * h]
        x = torch.cat([folded, x[2 * h:]], dim=0) if n % 2 else folded
    return x[0]


def _accept_of(final: torch.Tensor, accept: torch.Tensor,
               empty: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Live-position sets [..., B, P] → accept words [..., B, W]
    (``accept`` [..., P, W] int32 bit patterns, ``empty`` [..., W]).
    Zero-length flows take the empty-string words, whatever the scan
    left in their set."""
    hit = final > 0
    words = _or_reduce(
        torch.where(hit[..., :, :, None], accept[..., None, :, :],
                    torch.zeros((), dtype=accept.dtype,
                                device=accept.device)), -2)
    return torch.where((lengths == 0)[:, None], empty[..., None, :], words)


def nfa_finals(follow, acc_cls, byteclass, start, data, lengths
               ) -> torch.Tensor:
    """One bank's scan → final position bitset [B, P] (f32 0/1); the
    plain version, as the reference's XLA ``nfa_finals``."""
    return nfa_finals_plain(follow[None], acc_cls[None], byteclass[None],
                            start[None], data, lengths)[0]


def nfa_scan_banked(stacked, data, lengths, extra_accept: bool = False):
    """All banks over one batch → accept words ``[B, NB, W]`` (+ group
    words ``[B, NB, Wg]`` when ``extra_accept``; the stack then carries
    ``nfa_gaccept``). Same contract as ``dfa_scan_banked``."""
    finals = nfa_finals_banked(
        stacked["nfa_follow"], stacked["nfa_acc_cls"],
        stacked["nfa_byteclass"], stacked["nfa_start"],
        data, lengths)                                   # [NB, B, P]
    words = _accept_of(finals, stacked["nfa_accept"], stacked["nfa_empty"],
                       lengths).permute(1, 0, 2)
    if not extra_accept:
        return words
    gacc = stacked["nfa_gaccept"]
    gempty = torch.zeros((gacc.shape[0], gacc.shape[2]), dtype=gacc.dtype,
                         device=gacc.device)
    gwords = _accept_of(finals, gacc, gempty, lengths).permute(1, 0, 2)
    return words, gwords


def banks_from_dfa(banked, cfg, case_insensitive: bool = False
                   ) -> Optional[List[NFABank]]:
    """Rebuild each compiled DFA bank's pattern group as an NFA bank,
    preserving lane assignment (``pattern_bank``/``pattern_lane``).
    Returns None when any bank busts the position budget. Banks no
    current pattern references (stale quarantine covers) cannot be
    reconstructed faithfully — callers gate the arm on a
    quarantine-free build (``CompiledPolicy.bank_quarantined``)."""
    per_bank: Dict[int, List[Tuple[int, str]]] = {}
    for i, pat in enumerate(banked.patterns):
        per_bank.setdefault(int(banked.pattern_bank[i]), []).append(
            (int(banked.pattern_lane[i]), pat))
    # cheap pre-flight: positions ≥ literal occurrences, so a bank
    # whose pattern text alone dwarfs the budget can be rejected
    # before paying parse + closure work
    for members in per_bank.values():
        if sum(len(p) for _, p in members) > 16 * MAX_POSITIONS:
            return None
    banks: List[NFABank] = []
    for b in range(banked.n_banks):
        members = sorted(per_bank.get(b, ()))
        bank = compile_nfa_bank(
            [p for _, p in members],
            max_quantifier=cfg.max_quantifier,
            case_insensitive=case_insensitive,
            lanes=[lane for lane, _ in members])
        if bank.n_positions > MAX_POSITIONS:
            return None
        banks.append(bank)
    return banks
