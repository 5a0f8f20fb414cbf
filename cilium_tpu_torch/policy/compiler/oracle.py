"""CPU oracle matcher (a copy of the reference's
``policy/compiler/oracle.py``).

Mirrors the role of Cilium's CPU matchers (RE2 in Envoy for HTTP,
``pkg/fqdn/re``'s compiled-regex LRU for FQDN): Python ``re`` full
matches, the differential-testing oracle for the compiled automata
(staged verdicts ≡ Python ``re`` verdicts).
"""

from __future__ import annotations

import functools
import re
from typing import Sequence

import numpy as np


@functools.lru_cache(maxsize=4096)
def _compile(pattern: bytes, flags: int) -> "re.Pattern":
    # mirrors pkg/fqdn/re: an LRU cache of compiled regexes
    return re.compile(pattern, flags)


class OracleMatcher:
    """Full-match a batch of strings against a pattern list.

    Matching is at the **UTF-8 byte level** (bytes patterns vs bytes
    inputs) — the same level the compiled DFAs operate at, so '.'
    counts bytes and case folding is ASCII-only on both sides."""

    def __init__(self, patterns: Sequence[str], case_insensitive: bool = False):
        flags = re.IGNORECASE if case_insensitive else 0
        self.patterns = list(patterns)
        self._compiled = [_compile(p.encode("utf-8"), flags)
                          for p in self.patterns]

    @staticmethod
    def _enc(s) -> bytes:
        return s if isinstance(s, bytes) else s.encode("utf-8")

    def match_one(self, s) -> np.ndarray:
        bs = self._enc(s)
        return np.array(
            [bool(c.fullmatch(bs)) for c in self._compiled], dtype=bool
        )

    def match_matrix(self, strings: Sequence) -> np.ndarray:
        """Returns bool [n_strings, n_patterns]."""
        out = np.zeros((len(strings), len(self.patterns)), dtype=bool)
        for i, s in enumerate(strings):
            bs = self._enc(s)
            for j, c in enumerate(self._compiled):
                if c.fullmatch(bs):
                    out[i, j] = True
        return out

    def match_any(self, strings: Sequence) -> np.ndarray:
        return self.match_matrix(strings).any(axis=1)
