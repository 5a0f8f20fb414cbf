"""Banked multi-pattern DFA compilation + tensor packing.

Subset construction over the union NFA of a *bank* of patterns, with:

* **byte equivalence classes** — bytes indistinguishable to every edge
  mask share a column, compressing the 256-wide alphabet to typically
  10–40 classes (HBM saver; the reference's RE2 does the same trick);
* **accept bitmaps** — each DFA state carries a bank-width bitmap of the
  patterns accepting there, so one scan yields every pattern's verdict
  (the multi-pattern trick from Hyperscan-style engines; cf. the
  SIMD-DFA design in PAPERS.md "Hyperflex");
* a **state cap** with automatic bank splitting — if subset construction
  explodes, the bank is halved and recompiled, so pathological pattern
  combinations degrade to more banks instead of failing.

The packed form is numpy; the engine (``cilium_tpu_torch.engine``) stacks banks
into padded ``[n_banks, S, K]`` device arrays and vmaps the byte-scan
over banks. Patterns keep their global index via ``(bank, lane)`` maps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cilium_tpu_torch.policy.compiler import regex_parser as rp
from cilium_tpu_torch.policy.compiler.nfa import NFA, build_nfa, eps_closure


class BankOverflow(RuntimeError):
    pass


@dataclasses.dataclass
class DFABank:
    """One compiled bank: up to ``bank_size`` patterns, one DFA."""

    trans: np.ndarray       # [n_states, n_classes] int32
    byteclass: np.ndarray   # [256] int32 byte → class
    accept: np.ndarray      # [n_states, n_words] uint32 pattern bitmaps
    start: int
    n_patterns: int

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]

    @property
    def n_classes(self) -> int:
        return self.trans.shape[1]

    @property
    def n_words(self) -> int:
        return self.accept.shape[1]


def _byte_classes(nfa: NFA) -> Tuple[np.ndarray, int]:
    """Partition bytes into equivalence classes w.r.t. all edge masks."""
    masks = set()
    for edges in nfa.edges:
        for m, _ in edges:
            masks.add(m)
    masks.discard(0)
    # signature of byte b = tuple of membership bits across masks
    sig_to_class: Dict[Tuple[bool, ...], int] = {}
    byteclass = np.zeros(256, dtype=np.int32)
    mask_list = list(masks)
    for b in range(256):
        sig = tuple(bool(m >> b & 1) for m in mask_list)
        cls = sig_to_class.setdefault(sig, len(sig_to_class))
        byteclass[b] = cls
    return byteclass, len(sig_to_class)


def compile_bank(asts: Sequence[rp.Node], max_states: int = 8192) -> DFABank:
    """Subset construction for one bank of pattern ASTs."""
    nfa = build_nfa(asts)
    byteclass, n_classes = _byte_classes(nfa)
    # representative byte per class
    rep: List[int] = [0] * n_classes
    for b in range(255, -1, -1):
        rep[int(byteclass[b])] = b

    n_words = (len(asts) + 31) // 32

    start_set = eps_closure(nfa, [nfa.start])
    # DFA state 0 = dead (empty set), state 1 = start
    state_ids: Dict[frozenset, int] = {frozenset(): 0, start_set: 1}
    order: List[frozenset] = [frozenset(), start_set]
    trans_rows: List[List[int]] = [[0] * n_classes]  # dead loops to itself
    accept_rows: List[List[int]] = [[0] * n_words]

    def accept_bitmap(sset: frozenset) -> List[int]:
        words = [0] * n_words
        for s in sset:
            idx = nfa.accepts[s]
            if idx >= 0:
                words[idx // 32] |= 1 << (idx % 32)
        return words

    accept_rows.append(accept_bitmap(start_set))

    i = 1
    while i < len(order):
        sset = order[i]
        row = [0] * n_classes
        for cls in range(n_classes):
            b = rep[cls]
            nxt = set()
            for s in sset:
                for m, t in nfa.edges[s]:
                    if m >> b & 1:
                        nxt.add(t)
            if nxt:
                closure = eps_closure(nfa, list(nxt))
                tid = state_ids.get(closure)
                if tid is None:
                    tid = len(order)
                    if tid > max_states:
                        raise BankOverflow(
                            f"bank exceeded {max_states} DFA states")
                    state_ids[closure] = tid
                    order.append(closure)
                    accept_rows.append(accept_bitmap(closure))
                row[cls] = tid
            else:
                row[cls] = 0  # dead
        trans_rows.append(row)
        i += 1

    return DFABank(
        trans=np.asarray(trans_rows, dtype=np.int32),
        byteclass=byteclass,
        accept=np.asarray(accept_rows, dtype=np.uint32),
        start=1,
        n_patterns=len(asts),
    )


@dataclasses.dataclass
class BankedDFA:
    """A full pattern set compiled into banks + global lane maps."""

    banks: List[DFABank]
    pattern_bank: np.ndarray   # [P] int32: bank index of pattern p
    pattern_lane: np.ndarray   # [P] int32: lane within the bank
    patterns: Tuple[str, ...]  # source patterns (for checkpoint identity)

    @property
    def n_patterns(self) -> int:
        return len(self.pattern_bank)

    @property
    def n_banks(self) -> int:
        return len(self.banks)

    def stacked(self) -> Dict[str, np.ndarray]:
        """Pad + stack banks for the engine.

        Returns arrays:
          trans     [B, S, K] int32 (padded with dead-state self loops)
          byteclass [B, 256]  int32
          accept    [B, S, W] uint32
          start     [B]       int32
          lane_of   [P] int32 global lane = bank * (32*W) + lane  (for
                    building rule bitmaps in engine space)
        """
        B = len(self.banks)
        S = max(b.n_states for b in self.banks)
        K = max(b.n_classes for b in self.banks)
        W = max(b.n_words for b in self.banks)
        # state/class dims BUCKET past their floor (next multiple):
        # one pattern added to the largest bank no longer changes the
        # stacked shape, so incremental fleet updates reuse the jitted
        # step's executable. Padded states self-loop to dead and
        # padded classes are never emitted by byteclass — the same
        # inertness argument as the per-bank padding below. Small
        # policies keep exact shapes.
        if S > 256:
            S = -(-S // 256) * 256
        if K > 64:
            K = -(-K // 16) * 16
        trans = np.zeros((B, S, K), dtype=np.int32)
        byteclass = np.zeros((B, 256), dtype=np.int32)
        accept = np.zeros((B, S, W), dtype=np.uint32)
        start = np.zeros((B,), dtype=np.int32)
        for i, bank in enumerate(self.banks):
            s, k, w = bank.n_states, bank.n_classes, bank.n_words
            trans[i, :s, :k] = bank.trans
            # padded classes behave like class 0 of the dead row: keep 0
            # (dead state), padded states self-loop to dead (0) — safe
            # because byteclass never emits a padded class index.
            byteclass[i] = bank.byteclass
            accept[i, :s, :w] = bank.accept
            start[i] = bank.start
        lane_of = (self.pattern_bank.astype(np.int64) * (32 * W)
                   + self.pattern_lane.astype(np.int64)).astype(np.int32)
        return {
            "trans": trans,
            "byteclass": byteclass,
            "accept": accept,
            "start": start,
            "lane_of": lane_of,
        }


class BankCache:
    """Content-addressed cache of compiled :class:`DFABank` objects —
    the incremental-compile mechanism (SURVEY §7 hard part #4): a rule
    update recompiles only the banks whose pattern membership changed;
    unchanged banks (the common case: patterns append at the end of a
    family's universe) are reused across regenerations. A cached
    ``None`` records "this pattern group overflows the state cap", so
    the split decision is also remembered. Bounded LRU."""

    _MISS = object()

    def __init__(self, max_banks: int = 4096,
                 max_bytes: int = 256 << 20):
        import collections

        self._od = collections.OrderedDict()
        self.max_banks = max_banks
        #: cumulative tensor-byte bound — a bank can be up to ~8MB
        #: (8192 states x 256 classes x int32), so a count bound alone
        #: could retain gigabytes
        self.max_bytes = max_bytes
        self.bytes = 0
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _bank_bytes(bank) -> int:
        if bank is None:
            return 0
        return int(bank.trans.nbytes + bank.accept.nbytes
                   + bank.byteclass.nbytes)

    def get(self, key):
        v = self._od.get(key, self._MISS)
        if v is self._MISS:
            self.misses += 1
            return self._MISS
        self._od.move_to_end(key)
        self.hits += 1
        return v

    def put(self, key, bank) -> None:
        old = self._od.get(key)
        if old is not None:
            self.bytes -= self._bank_bytes(old)
        self._od[key] = bank
        self._od.move_to_end(key)
        self.bytes += self._bank_bytes(bank)
        while self._od and (len(self._od) > self.max_banks
                            or self.bytes > self.max_bytes):
            _, evicted = self._od.popitem(last=False)
            self.bytes -= self._bank_bytes(evicted)


def compile_patterns(
    patterns: Sequence[str],
    bank_size: int = 64,
    max_states: int = 8192,
    max_quantifier: int = 64,
    case_insensitive: bool = False,
    bank_cache: Optional[BankCache] = None,
) -> BankedDFA:
    """Compile ``patterns`` (regex sources) into a :class:`BankedDFA`.

    Patterns are greedily grouped into banks of ``bank_size``; a bank
    whose subset construction exceeds ``max_states`` is split in half
    recursively (single patterns that alone exceed the cap are rejected).
    With a ``bank_cache``, banks whose pattern group compiled before
    are reused (incremental rule updates).
    """
    # ASTs parse LAZILY: a fully-cached rebuild must not pay O(N)
    # regex parsing — the cache key is built from pattern strings alone
    asts: List = [None] * len(patterns)

    def _ast(i: int):
        if asts[i] is None:
            asts[i] = rp.parse(patterns[i],
                               max_quantifier=max_quantifier,
                               case_insensitive=case_insensitive)
        return asts[i]

    banks: List[DFABank] = []
    pattern_bank = np.zeros(len(patterns), dtype=np.int32)
    pattern_lane = np.zeros(len(patterns), dtype=np.int32)

    def compile_range(indices: List[int]) -> None:
        key = (tuple(patterns[i] for i in indices),
               max_states, max_quantifier, case_insensitive)
        bank = (bank_cache.get(key) if bank_cache is not None
                else BankCache._MISS)
        if bank is BankCache._MISS:
            try:
                bank = compile_bank([_ast(i) for i in indices],
                                    max_states=max_states)
            except BankOverflow:
                bank = None
            if bank_cache is not None:
                bank_cache.put(key, bank)
        if bank is None:  # overflows the state cap → split
            if len(indices) == 1:
                raise rp.RegexError(
                    f"pattern too large for state cap: {patterns[indices[0]]!r}")
            mid = len(indices) // 2
            compile_range(indices[:mid])
            compile_range(indices[mid:])
            return
        bid = len(banks)
        banks.append(bank)
        for lane, i in enumerate(indices):
            pattern_bank[i] = bid
            pattern_lane[i] = lane

    for i0 in range(0, len(patterns), bank_size):
        compile_range(list(range(i0, min(i0 + bank_size, len(patterns)))))

    return BankedDFA(
        banks=banks,
        pattern_bank=pattern_bank,
        pattern_lane=pattern_lane,
        patterns=tuple(patterns),
    )


def match_bank_numpy(bank: DFABank, data: np.ndarray,
                     lengths: np.ndarray) -> np.ndarray:
    """CPU reference scan of one bank (golden model for the JAX kernel).

    data: [B, L] uint8 padded byte strings; lengths: [B].
    Returns accept words [B, n_words] uint32 at each string's final state.
    """
    Bsz, L = data.shape
    states = np.full((Bsz,), bank.start, dtype=np.int32)
    cls = bank.byteclass[data]  # [B, L]
    for t in range(L):
        active = t < lengths
        nxt = bank.trans[states, cls[:, t]]
        states = np.where(active, nxt, states)
    return bank.accept[states]
