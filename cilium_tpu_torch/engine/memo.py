"""Device-resident verdict memo and the policy generation epoch
(counterpart of the reference's ``engine/memo.py``).

Capture replay dedups its featurized rows hard (the http-1000 capture
repeats a few thousand rows over 200k records), so the verdict OUTPUTS
of the unique rows live on the device, keyed by row id, and a replay
chunk is one id copy to the device plus one gather.

Correctness contract: a policy change can never serve a stale verdict.
Every committed revision bumps the process-global
:data:`POLICY_GENERATION`; a memo read first checks its fill-time
generation and auth signature and drops itself on a mismatch, counting
the invalidation. The memo is an accelerator over the shared capture
step (``engine/verdict.verdict_step_capture``), so memoized and
recomputed verdicts are bit-equal by construction.

The host half (``PolicyDelta``, ``hash_rows``, the generation ring) is
the reference's numpy code, copied; the table is a torch tensor.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
from typing import Dict, Optional

import numpy as np
import torch

from cilium_tpu_torch.runtime.metrics import (
    METRICS,
    VERDICT_MEMO_HITS,
    VERDICT_MEMO_INVALIDATIONS,
    VERDICT_MEMO_MISSES,
)

#: L7 family of each l7-type code: which rule family a memoized row's
#: verdict READ ("l4" rows read no L7 bank)
FAMILY_OF_L7TYPE = {0: "l4", 1: "http", 2: "kafka", 3: "dns",
                    4: "generic", 5: "cassandra", 6: "memcache",
                    7: "r2d2"}

#: wildcard family: the identity's structural MapState state changed
FAMILY_ALL = "*"

#: wildcard port: a port-range/wildcard entry of the family changed
PORT_ALL = -1


@dataclasses.dataclass(frozen=True)
class PolicyDelta:
    """What one committed revision changed. ``full=True`` (the
    conservative default) means "assume everything moved"; otherwise
    only rows whose enforcement identity is in ``changed_identities``
    can verdict differently, narrowed by ``changed_identity_families``
    ((identity, family) pairs; family :data:`FAMILY_ALL` marks a
    structural change) and ``changed_identity_family_ports``
    ((identity, family, dport) triples; dport :data:`PORT_ALL` marks a
    range/wildcard entry). An empty narrowing set means "unknown" —
    consumers fall back to the coarser granularity."""

    full: bool = True
    reason: str = "policy-swap"
    changed_identities: frozenset = frozenset()
    changed_banks: frozenset = frozenset()
    changed_identity_families: frozenset = frozenset()
    changed_identity_family_ports: frozenset = frozenset()

    @classmethod
    def none(cls) -> "PolicyDelta":
        """A commit that changed nothing semantic: consumers keep
        memos, buffers, and staged tables."""
        return cls(full=False, reason="no-change")

    @classmethod
    def banks(cls, identities, banks, reason: str = "bank-swap",
              identity_families=(), identity_family_ports=()
              ) -> "PolicyDelta":
        return cls(full=False, reason=reason,
                   changed_identities=frozenset(identities),
                   changed_banks=frozenset(banks),
                   changed_identity_families=frozenset(
                       identity_families),
                   changed_identity_family_ports=frozenset(
                       identity_family_ports))

    @property
    def is_noop(self) -> bool:
        return (not self.full and not self.changed_identities
                and not self.changed_banks)

    def affects(self, identity: int, l7_type: int,
                dport: Optional[int] = None) -> bool:
        """May a memoized row with this (enforcement identity, L7 type,
        destination port) verdict differently under this delta?"""
        if self.full:
            return True
        if identity not in self.changed_identities:
            return False
        fams = self.changed_identity_families
        if not fams:
            return True
        if (identity, FAMILY_ALL) in fams:
            return True
        family = FAMILY_OF_L7TYPE.get(int(l7_type))
        if family is None or (identity, family) not in fams:
            return False
        ports = self.changed_identity_family_ports
        if not ports or dport is None:
            return True
        return ((identity, family, PORT_ALL) in ports
                or (identity, family, int(dport)) in ports)

    def merge(self, other: "PolicyDelta") -> "PolicyDelta":
        if self.full or other.full:
            return PolicyDelta(full=True)
        if other.is_noop:
            return self
        if self.is_noop:
            return other
        # narrowing survives a merge only when BOTH sides carry it
        if (self.changed_identity_families
                and other.changed_identity_families):
            fams = (self.changed_identity_families
                    | other.changed_identity_families)
        else:
            fams = frozenset()
        if fams and self.changed_identity_family_ports \
                and other.changed_identity_family_ports:
            ports = (self.changed_identity_family_ports
                     | other.changed_identity_family_ports)
        else:
            ports = frozenset()
        return PolicyDelta(
            full=False, reason=other.reason,
            changed_identities=(self.changed_identities
                                | other.changed_identities),
            changed_banks=self.changed_banks | other.changed_banks,
            changed_identity_families=fams,
            changed_identity_family_ports=ports)


def affected_row_ids(delta: "PolicyDelta", eps, l7_types,
                     dports=None) -> np.ndarray:
    """Vectorized :meth:`PolicyDelta.affects` over aligned
    ``(enforcement identity, l7 type[, dport])`` columns → the affected
    row ids, int32."""
    eps = np.asarray(eps, dtype=np.int64)
    l7s = np.asarray(l7_types, dtype=np.int64)
    if delta.full:
        return np.arange(len(eps), dtype=np.int32)
    if not delta.changed_identities:
        return np.zeros(0, dtype=np.int32)
    fams = delta.changed_identity_families
    ports = delta.changed_identity_family_ports
    dps = np.asarray(dports, dtype=np.int64) if dports is not None \
        else None
    mask = np.zeros(len(eps), dtype=bool)
    for ep in delta.changed_identities:
        sel = eps == ep
        if not sel.any():
            continue
        if not fams or (ep, FAMILY_ALL) in fams:
            mask |= sel
            continue
        for code, name in FAMILY_OF_L7TYPE.items():
            if (ep, name) not in fams:
                continue
            fam_sel = sel & (l7s == code)
            if not fam_sel.any():
                continue
            if ports and dps is not None \
                    and (ep, name, PORT_ALL) not in ports:
                fam_ports = [p for (e, n, p) in ports
                             if e == ep and n == name]
                fam_sel = fam_sel & np.isin(dps, fam_ports)
            mask |= fam_sel
    return np.nonzero(mask)[0].astype(np.int32)


#: committed-revision deltas retained for lagging consumers; a consumer
#: further behind reads a conservative FULL delta
_DELTA_RING = 64


class _PolicyGeneration:
    """Process-global epoch of committed policy revisions, with a
    bounded ring of the deltas each bump carried and per-bank epochs."""

    __slots__ = ("_lock", "_value", "_ring", "_bank_epochs",
                 "_last_full")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0
        self._ring: collections.deque = collections.deque(
            maxlen=_DELTA_RING)
        self._bank_epochs: Dict[str, int] = {}
        self._last_full = 0

    def bump(self, delta: Optional[PolicyDelta] = None) -> int:
        with self._lock:
            self._value += 1
            d = delta if delta is not None else PolicyDelta(full=True)
            self._ring.append((self._value, d))
            if d.full:
                self._last_full = self._value
            for k in d.changed_banks:
                self._bank_epochs[k] = self._value
            if len(self._bank_epochs) > 65536:
                cut = sorted(self._bank_epochs.values())[
                    len(self._bank_epochs) // 2]
                self._bank_epochs = {
                    k: v for k, v in self._bank_epochs.items()
                    if v >= cut}
            return self._value

    @property
    def value(self) -> int:
        return self._value

    def bank_epoch(self, key: str) -> int:
        """Generation at which bank ``key`` last changed (0 = never);
        a full commit moves every bank's effective epoch."""
        with self._lock:
            return max(self._bank_epochs.get(key, 0), self._last_full)

    def deltas_since(self, gen: int) -> PolicyDelta:
        """Merged delta of every commit after epoch ``gen``: no-op when
        ``gen`` is current, FULL when the ring no longer covers the
        gap."""
        with self._lock:
            if gen >= self._value:
                return PolicyDelta.none()
            if not self._ring or self._ring[0][0] > gen + 1:
                return PolicyDelta(full=True)
            merged = PolicyDelta.none()
            for v, d in self._ring:
                if v > gen:
                    merged = merged.merge(d)
            return merged


POLICY_GENERATION = _PolicyGeneration()


def policy_generation() -> int:
    """The current policy epoch (see :class:`_PolicyGeneration`)."""
    return POLICY_GENERATION.value


def hash_rows(rows: np.ndarray) -> np.ndarray:
    """FNV-1a-style u64 hash per row over the int32 columns, with
    numpy's wrapping uint64 arithmetic — THE row key of the dedup and
    the memo. Collisions are resolved exactly by the callers."""
    rows = np.ascontiguousarray(rows)
    with np.errstate(over="ignore"):
        h = np.full(len(rows), np.uint64(0xCBF29CE484222325))
        prime = np.uint64(0x100000001B3)
        for c in range(rows.shape[1]):
            h = (h ^ rows[:, c].astype(np.uint64)) * prime
    return h


def auth_signature(authed_pairs) -> Optional[str]:
    """Signature of the auth view a verdict depends on: None,
    ``AUTH_UNENFORCED`` and each pairs table are distinct, so a memo
    filled under one view can never serve another."""
    from cilium_tpu_torch.engine.verdict import AUTH_UNENFORCED

    if authed_pairs is AUTH_UNENFORCED:
        return "unenforced"
    if authed_pairs is None:
        return "none"
    a = np.ascontiguousarray(np.asarray(authed_pairs))
    return hashlib.sha1(a.tobytes()).hexdigest()


#: column order of the packed [N, 10] int32 memo table — every output
#: lane of the verdict step (bool lanes stored as 0/1)
MEMO_COLS = ("verdict", "match_spec", "ruleset", "allowed",
             "l3l4_allowed", "redirect", "l7_ok", "l7_log",
             "auth_required", "l7_match")
_MEMO_INT = frozenset(("verdict", "match_spec", "ruleset", "l7_match"))


def memo_pack(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Verdict-step output dict → one [N, 10] int32 block; a producer
    without the ``l7_match`` lane packs -1."""
    cols = []
    for c in MEMO_COLS:
        if c in out:
            cols.append(out[c].to(torch.int32))
        else:
            cols.append(torch.full_like(out["verdict"], -1,
                                        dtype=torch.int32))
    return torch.stack(cols, dim=1)


def as_index(ids: torch.Tensor) -> torch.Tensor:
    """A row-id stream as an int64 index. A ``uint16`` stream crosses to
    the device as its int16 bit pattern (torch indexes with neither),
    and is widened here, on the device."""
    if ids.dtype == torch.int16:
        return ids.to(torch.int64) & 0xFFFF
    return ids.to(torch.int64)


def _pow2(n: int, floor: int = 1) -> int:
    return max(floor, 1 << max(0, max(1, n) - 1).bit_length())


class VerdictMemo:
    """Device-resident verdict memo over one row universe: slot i
    holds the packed outputs of row id i. The owner (``CaptureReplay``)
    assigns ids by row hash; ``fill`` appends, ``gather`` serves a
    chunk with one device gather, ``refill_scatter`` rewrites the rows
    a bank-scoped commit touched, and ``valid_for`` enforces the
    staleness contract (policy generation + auth signature)."""

    def __init__(self, device=None):
        self.device = device
        self._gen = policy_generation()
        self._auth_sig: Optional[str] = None
        self.table: Optional[torch.Tensor] = None   # [cap, 10] int32
        self.capacity = 0
        self.filled = 0            # row ids [0, filled) are memoized
        #: host-side per-slot generation each slot was computed under
        self.gens: Optional[np.ndarray] = None
        #: lifetime counters (mirrors of the METRICS families)
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    # -- validity ---------------------------------------------------------
    def valid_for(self, auth_sig: Optional[str]) -> bool:
        """True when the memo may serve under the current policy
        generation and this auth view; drops (and counts) it otherwise.
        A fresh memo adopts the auth signature on its first fill."""
        if self._gen != policy_generation():
            self.invalidate("policy-swap")
            return False
        if self.filled and auth_sig != self._auth_sig:
            self.invalidate("auth-change")
            return False
        return True

    def invalidate(self, reason: str) -> None:
        """Drop every memoized verdict and re-adopt the generation."""
        self.table = None
        self.capacity = 0
        self.filled = 0
        self.gens = None
        self._auth_sig = None
        self._gen = policy_generation()
        self.invalidations += 1
        METRICS.inc(VERDICT_MEMO_INVALIDATIONS, labels={"reason": reason})

    def adopt(self) -> None:
        """Re-adopt the current generation WITHOUT dropping the table
        — only for an owner that reconciled a bank-scoped delta itself."""
        self._gen = policy_generation()

    def partial_invalidate(self, n_rows: int, reason: str) -> None:
        """Count a bank-scoped partial drop (``n_rows`` slots will be
        rewritten by :meth:`refill_scatter`); the table stays."""
        if n_rows <= 0:
            return
        self.invalidations += 1
        METRICS.inc(VERDICT_MEMO_INVALIDATIONS, labels={"reason": reason})

    def refill_scatter(self, idx: np.ndarray, packed_block: torch.Tensor,
                       n_real: int) -> None:
        """Rewrite the memo rows at ``idx`` with fresh packed outputs.
        ``idx`` may be padded by repeating a real id: ``index_copy_``
        on CUDA writes duplicates in no fixed order, but every
        duplicate carries the same row (the outputs of the same id),
        so the result is exact. Counts ``n_real`` rows as misses."""
        if self.table is None or n_real <= 0:
            return
        ids = torch.from_numpy(np.ascontiguousarray(idx, np.int64))
        self.table.index_copy_(0, ids.to(self.table.device),
                               packed_block.to(torch.int32))
        if self.gens is not None:
            real = np.asarray(idx[:n_real]).astype(np.int64)
            self.gens[real[real < len(self.gens)]] = policy_generation()
        self.misses += n_real
        METRICS.inc(VERDICT_MEMO_MISSES, n_real)

    # -- write ------------------------------------------------------------
    def fill(self, packed_block: torch.Tensor, base: int, n_new: int,
             auth_sig: Optional[str]) -> None:
        """Write packed outputs for row ids ``[base, base + n_new)``
        (``packed_block`` may be padded longer; ids are appended
        densely, in order). Counts the new ids as misses."""
        if n_new <= 0:
            return
        self._auth_sig = auth_sig
        block_rows = int(packed_block.shape[0])
        cap_needed = _pow2(max(base + block_rows, self.filled + n_new))
        if self.table is None or cap_needed > self.capacity:
            grown = torch.zeros((cap_needed, len(MEMO_COLS)),
                                dtype=torch.int32,
                                device=packed_block.device)
            if self.table is not None:
                grown[:self.capacity] = self.table
            self.table, self.capacity = grown, cap_needed
        if self.gens is None or cap_needed > len(self.gens):
            grown_g = np.zeros(cap_needed, dtype=np.int64)
            if self.gens is not None:
                grown_g[:len(self.gens)] = self.gens
            self.gens = grown_g
        # the reference's dynamic_update_slice clamps an overflowing
        # offset; slice assignment here does not, and the capacity
        # arithmetic above keeps every block inside the table
        assert base + block_rows <= self.capacity
        self.table[base:base + block_rows] = packed_block.to(torch.int32)
        self.gens[base:base + n_new] = policy_generation()
        self.filled = max(self.filled, base + n_new)
        self.misses += n_new
        METRICS.inc(VERDICT_MEMO_MISSES, n_new)

    def cited_gens(self, idx) -> np.ndarray:
        """Host-side generation each served row id was computed under
        (-1 for unknown slots)."""
        ids = np.asarray(idx).astype(np.int64)
        out = np.full(len(ids), -1, dtype=np.int64)
        if self.gens is None:
            return out
        ok = (ids >= 0) & (ids < len(self.gens))
        out[ok] = self.gens[ids[ok]]
        return out

    # -- read -------------------------------------------------------------
    def gather(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Serve one chunk of row ids (a device tensor) from the table
        → output dict of device tensors, bool lanes restored. The
        caller guarantees ``valid_for`` ran and every id < ``filled``."""
        cols = self.table.index_select(0, as_index(idx))
        out = {}
        for i, name in enumerate(MEMO_COLS):
            v = cols[:, i]
            out[name] = v if name in _MEMO_INT else (v != 0)
        n = int(idx.shape[0])
        self.hits += n
        METRICS.inc(VERDICT_MEMO_HITS, n)
        return out
