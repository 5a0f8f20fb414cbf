"""Thompson NFA construction from regex ASTs.

Multi-pattern: a single NFA with a shared start state ε-branching to each
pattern's fragment; accept states are tagged with the pattern index. This
is the union automaton the banked subset construction (dfa.py) consumes —
the TPU replacement for the reference's per-rule RE2 / Go-regex scans
(SURVEY.md §3.4/§3.5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from cilium_tpu_torch.policy.compiler import regex_parser as rp


@dataclasses.dataclass
class NFA:
    """Edges: per-state list of (byte-mask, target). Eps: per-state list
    of targets. ``accepts[s]`` = pattern index accepting at s, or -1."""

    edges: List[List[Tuple[int, int]]]
    eps: List[List[int]]
    accepts: List[int]
    start: int

    @property
    def n_states(self) -> int:
        return len(self.edges)


class _Builder:
    def __init__(self) -> None:
        self.edges: List[List[Tuple[int, int]]] = []
        self.eps: List[List[int]] = []

    def new_state(self) -> int:
        self.edges.append([])
        self.eps.append([])
        return len(self.edges) - 1

    def add_edge(self, s: int, mask: int, t: int) -> None:
        if mask:
            self.edges[s].append((mask, t))

    def add_eps(self, s: int, t: int) -> None:
        self.eps[s].append(t)

    # Each build_* returns (entry, exit) state pair.
    def build(self, node: rp.Node) -> Tuple[int, int]:
        if isinstance(node, rp.Empty):
            s = self.new_state()
            return s, s
        if isinstance(node, rp.Lit):
            s, t = self.new_state(), self.new_state()
            self.add_edge(s, node.mask, t)
            return s, t
        if isinstance(node, rp.Concat):
            entry, cur = None, None
            for part in node.parts:
                e, x = self.build(part)
                if entry is None:
                    entry = e
                else:
                    self.add_eps(cur, e)
                cur = x
            assert entry is not None
            return entry, cur
        if isinstance(node, rp.Alt):
            s, t = self.new_state(), self.new_state()
            for opt in node.options:
                e, x = self.build(opt)
                self.add_eps(s, e)
                self.add_eps(x, t)
            return s, t
        if isinstance(node, rp.Star):
            s, t = self.new_state(), self.new_state()
            e, x = self.build(node.node)
            self.add_eps(s, e)
            self.add_eps(s, t)
            self.add_eps(x, e)
            self.add_eps(x, t)
            return s, t
        if isinstance(node, rp.Plus):
            e, x = self.build(node.node)
            t = self.new_state()
            self.add_eps(x, e)
            self.add_eps(x, t)
            return e, t
        if isinstance(node, rp.Opt):
            s, t = self.new_state(), self.new_state()
            e, x = self.build(node.node)
            self.add_eps(s, e)
            self.add_eps(s, t)
            self.add_eps(x, t)
            return s, t
        if isinstance(node, rp.Repeat):
            # expand {lo,hi}: lo mandatory copies + (hi-lo) optional, or
            # lo copies + Star for unbounded
            entry = self.new_state()
            cur = entry
            for _ in range(node.lo):
                e, x = self.build(node.node)
                self.add_eps(cur, e)
                cur = x
            if node.hi == -1:
                e, x = self.build(rp.Star(node.node))
                self.add_eps(cur, e)
                cur = x
            else:
                # optional tail copies, each skippable to the exit
                exit_ = self.new_state()
                self.add_eps(cur, exit_)
                for _ in range(node.hi - node.lo):
                    e, x = self.build(node.node)
                    self.add_eps(cur, e)
                    self.add_eps(x, exit_)
                    cur = x
                cur = exit_
            return entry, cur
        raise TypeError(f"unknown AST node {node!r}")


def build_nfa(asts: Sequence[rp.Node]) -> NFA:
    """Union NFA over ``asts``; accept tag = index into ``asts``."""
    b = _Builder()
    start = b.new_state()
    accepts: Dict[int, int] = {}
    for idx, ast in enumerate(asts):
        e, x = b.build(ast)
        b.add_eps(start, e)
        final = b.new_state()
        b.add_eps(x, final)
        accepts[final] = idx
    acc = [-1] * len(b.edges)
    for s, idx in accepts.items():
        acc[s] = idx
    return NFA(edges=b.edges, eps=b.eps, accepts=acc, start=start)


def eps_closure(nfa: NFA, states: Sequence[int]) -> frozenset:
    seen = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)
