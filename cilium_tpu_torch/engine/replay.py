"""Capture replay with the device verdict memo — the counterpart of the
reference's ``CaptureReplay`` (``engine/verdict.py:2180``) and its
staging-phase timer ``_StagePhase`` (``:1956``).

A session over one v2 or v3 capture: the per-field string tables (and,
for a v3 capture under a policy with frontend rules, the ``l7g`` table
of frontend scan values) are scanned once on the device
(``verdict.stage_capture_tables``), the whole capture is featurized
into one row block (:meth:`stage_rows`; a v3 capture's GENERIC section
rides it as the generic columns), deduped
by row hash into a unique-row table and a per-flow id stream
(:meth:`stage_unique`), every unique row is verdicted once into the
device memo (:meth:`stage_verdict_memo`), and each chunk is then one
id copy to the device and one gather (:meth:`verdict_idx`). Without
the memo the chunk runs the capture step over the gathered rows;
without the dedup it streams row blocks (:meth:`verdict_rows`).

A chunk's layers are flight-recorder spans (``runtime/tracing.py``),
which a collecting ``torch.profiler`` also shows beside the kernels:
``replay.upload`` (the chunk's rows or ids to the device, auth
staging), ``replay.step`` (the host's enqueue of the step, split by
``verdict_step_capture`` into ``step.gather``, ``step.lookup``,
``step.resolve`` and ``step.assemble``) and ``replay.readback``
(``host_lanes``: ``readback.copy``, ``readback.split``). Each blocking
copy counts under ``cilium_tpu_engine_host_syncs_total{site=...}``:
``replay-upload`` for a pageable rows or ids copy, ``host-lanes`` for
the readback.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from cilium_tpu_torch.core.config import EngineConfig
from cilium_tpu_torch.engine import memo as memo_mod
from cilium_tpu_torch.engine.compiled import (
    _ROW_COLS,
    CaptureFeaturizer,
    _pad_rows_pow2,
)
from cilium_tpu_torch.engine.verdict import (
    TorchVerdictEngine,
    host_lanes,
    stage_capture_tables,
    verdict_step_capture,
)
from cilium_tpu_torch.runtime.metrics import (
    CAPTURE_STAGE_SECONDS,
    ENGINE_HOST_SYNCS,
    METRICS,
)
from cilium_tpu_torch.runtime.tracing import PHASE_DEVICE, PHASE_HOST, TRACER


class _StagePhase:
    """Capture-staging phase timer: seconds into
    ``cilium_tpu_capture_stage_seconds{phase=...}``."""

    __slots__ = ("phase", "_t0")

    def __init__(self, phase: str):
        self.phase = phase

    def __enter__(self) -> "_StagePhase":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        METRICS.observe(CAPTURE_STAGE_SECONDS,
                        time.perf_counter() - self._t0,
                        labels={"phase": self.phase})


def _ids_to_device(idx: np.ndarray, device: torch.device,
                   pinned: bool = False) -> torch.Tensor:
    """A chunk's row ids → the device, in their stream width: a uint16
    stream travels as its int16 bit pattern (two bytes a flow) and is
    widened on the device (``memo.as_index``). ``pinned`` stages the
    host side in page-locked memory so the copy is asynchronous."""
    a = np.ascontiguousarray(idx)
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    host = torch.from_numpy(a)
    if device.type != "cuda":
        return host
    if pinned:
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


class CaptureReplay:
    """Replay session over one v2/v3 capture (see the module
    docstring); ``gen`` is a v3 capture's whole GENERIC section.

    ``loader`` (optional; any object with an ``.engine``) makes the
    session swap-safe: every verdict entry point checks the port's
    policy generation, and a committed revision re-stages the session
    against the loader's current engine — a no-change delta keeps
    everything, a bank-scoped one restages the table scan and refills
    only the memo rows it touched, anything else drops the memo and the
    unique-row buffer."""

    def __init__(self, engine: TorchVerdictEngine, l7, offsets, blob,
                 cfg: Optional[EngineConfig] = None, gen=None,
                 loader=None):
        self.engine = engine
        self.loader = loader
        self.cfg = cfg
        self._gen_epoch = memo_mod.policy_generation()
        # raw capture sections, kept so a policy swap can re-stage
        self._sections = (l7, offsets, blob, gen)
        with _StagePhase("tables"):
            self.feat = CaptureFeaturizer(l7, offsets, blob,
                                          engine.policy.kafka_interns,
                                          cfg, gen=gen)
            self.table_words = stage_capture_tables(engine, self.feat)
        self._step = verdict_step_capture
        #: whole-capture row block ([N, 15(+gen)] int32) once staged
        self.rows_all: Optional[np.ndarray] = None
        self._staged_records = None
        #: device unique-row table + per-flow ids (dedup stream)
        self.unique_rows: Optional[torch.Tensor] = None
        self._uniq_host: Optional[np.ndarray] = None
        self.row_idx: Optional[np.ndarray] = None
        self.n_unique: Optional[int] = None
        self._drop_ratio: Optional[float] = None
        #: verdict memo over the unique-row universe (slot == row id)
        self._memo: Optional[memo_mod.VerdictMemo] = None
        self._memo_enabled = (cfg.verdict_memo
                              if cfg is not None else True)
        #: unique-row ids a bank-scoped commit touched, awaiting a
        #: scatter refill at the next memo staging
        self._memo_dirty: Optional[np.ndarray] = None
        #: (start, n) → device ids issued ahead of use
        self._prefetched: Dict[tuple, torch.Tensor] = {}

    # -- swap safety ------------------------------------------------------
    def _ensure_current(self) -> None:
        """Re-validate the session against the policy generation,
        consuming the committed revisions' deltas: no-change → keep
        everything; bank-scoped (interns unchanged) → restage the table
        scan and queue the affected memo rows for a scatter refill;
        otherwise the full re-stage with the memo dropped."""
        gen_now = memo_mod.policy_generation()
        if gen_now == self._gen_epoch:
            return
        delta = memo_mod.POLICY_GENERATION.deltas_since(self._gen_epoch)
        self._gen_epoch = gen_now
        new_engine = self.engine
        if self.loader is not None:
            cand = self.loader.engine
            if isinstance(cand, TorchVerdictEngine):
                new_engine = cand
        if delta.is_noop:
            self.engine = new_engine
            if self._memo is not None:
                self._memo.adopt()
            return
        partial = (not delta.full
                   and new_engine is not self.engine
                   and (new_engine.policy.kafka_interns
                        == self.engine.policy.kafka_interns))
        if partial:
            self.engine = new_engine
            with _StagePhase("tables"):
                self.table_words = stage_capture_tables(new_engine,
                                                        self.feat)
            if self._memo is not None and self._memo.filled:
                affected = self._affected_unique_ids(delta)
                if affected is None:
                    self._memo.invalidate(delta.reason)
                    self._memo_dirty = None
                else:
                    if len(affected):
                        self._memo.partial_invalidate(
                            len(affected), delta.reason)
                        prev = self._memo_dirty
                        self._memo_dirty = (
                            affected if prev is None else
                            np.union1d(prev, affected))
                    self._memo.adopt()
            elif self._memo is not None:
                self._memo.adopt()
            return
        self._prefetched.clear()
        self.unique_rows = None
        self._memo_dirty = None
        if self._memo is not None:
            self._memo.invalidate(delta.reason if delta.full
                                  else "policy-swap")
        if new_engine is not self.engine:
            self.engine = new_engine
            l7, offsets, blob, gen = self._sections
            with _StagePhase("tables"):
                self.feat = CaptureFeaturizer(
                    l7, offsets, blob, new_engine.policy.kafka_interns,
                    self.cfg, gen=gen)
                self.table_words = stage_capture_tables(new_engine,
                                                        self.feat)
            if self._staged_records is not None:
                rec, l7s = self._staged_records
                self.stage_rows(rec, l7s)
                if self._drop_ratio is not None or \
                        self.row_idx is not None:
                    self.stage_unique(self._drop_ratio)

    def _affected_unique_ids(self, delta) -> Optional[np.ndarray]:
        """Unique-row ids whose verdict may have moved under a
        bank-scoped delta; None when no host rows are staged."""
        if self._uniq_host is None or self.rows_all is None:
            return None
        if not delta.changed_identities:
            return np.zeros(0, dtype=np.int32)
        u = self._uniq_host[:self.n_unique]
        return memo_mod.affected_row_ids(
            delta, u[:, _ROW_COLS.index("ep_ids")],
            u[:, _ROW_COLS.index("l7_types")],
            dports=u[:, _ROW_COLS.index("dports")])

    # -- staging ----------------------------------------------------------
    def stage_rows(self, rec, l7) -> np.ndarray:
        """Featurize the WHOLE capture once ([N, 15(+gen)] int32)."""
        self._staged_records = (rec, l7)
        with _StagePhase("featurize"):
            self.rows_all = self.feat.encode_rows(
                np.asarray(rec), l7, gen_rows=self.feat.gen_rows)
        return self.rows_all

    def stage_unique(self, drop_if_ratio_at_least: Optional[float]
                     = None) -> float:
        """Deduplicate the staged row block into a unique-row table and
        per-flow ids (uint16 up to 65536 unique rows, else int32);
        returns the ratio unique/total. Past ``drop_if_ratio_at_least``
        the table and ids are discarded (``row_idx`` stays None) and
        chunks stream rows. Host-side only: :meth:`stage_unique_device`
        pushes the table."""
        assert self.rows_all is not None, "stage_rows first"
        self._drop_ratio = drop_if_ratio_at_least
        with _StagePhase("dedup"):
            return self._stage_unique(drop_if_ratio_at_least)

    def _stage_unique(self, drop_if_ratio_at_least: Optional[float]
                      = None) -> float:
        # dedup by row HASH; exact — every row is checked against its
        # hash representative, and a collision falls back to the row
        # sort. Row ids are therefore hash-assigned: the memo's key.
        h = memo_mod.hash_rows(self.rows_all)
        _, first, inverse = np.unique(h, return_index=True,
                                      return_inverse=True)
        uniq = self.rows_all[first]
        if not np.array_equal(uniq[inverse], self.rows_all):
            uniq, inverse = np.unique(self.rows_all, axis=0,
                                      return_inverse=True)
        n_true = len(uniq)
        ratio = n_true / max(1, len(self.rows_all))
        if drop_if_ratio_at_least is not None \
                and ratio >= drop_if_ratio_at_least:
            self._uniq_host = None
            self.unique_rows = None
            self.row_idx = None
            self.n_unique = n_true
            return ratio
        uniq = _pad_rows_pow2(uniq)
        self._uniq_host = uniq
        self.unique_rows = None
        self.n_unique = n_true
        idx_dtype = np.uint16 if len(uniq) <= (1 << 16) else np.int32
        self.row_idx = inverse.reshape(-1).astype(idx_dtype)
        return ratio

    def stage_unique_device(self) -> torch.Tensor:
        """Push the (padded) unique-row table to the device, once; the
        buffer is dropped only on a policy-generation change."""
        if self.unique_rows is None:
            with _StagePhase("table-h2d"):
                self.unique_rows = torch.from_numpy(
                    self._uniq_host).to(self.engine.device)
                self.unique_rows[:2].cpu()   # completion-forced
        return self.unique_rows

    # -- verdict memo -----------------------------------------------------
    @property
    def memo(self) -> Optional[memo_mod.VerdictMemo]:
        """The session's memo (None until the dedup stream is staged
        and a memo staging ran, or when the memo is disabled)."""
        return self._memo

    def stage_verdict_memo(self, authed_pairs=None):
        """Verdict every unique row ONCE (one capture step over the
        unique table) and keep the packed outputs on the device. No-op
        when the memo is current for this auth view; refills after an
        invalidation, and scatter-refills only the rows a bank-scoped
        commit touched. Returns the memo (None when the dedup was
        dropped or the memo is disabled)."""
        if not self._memo_enabled or self.row_idx is None:
            return None
        sig = memo_mod.auth_signature(authed_pairs)
        if self._memo is None:
            self._memo = memo_mod.VerdictMemo(device=self.engine.device)
        m = self._memo
        if m.valid_for(sig) and m.filled >= self.n_unique:
            dirty = self._memo_dirty
            if dirty is not None and len(dirty) and m.table is not None:
                with _StagePhase("memo-fill"):
                    # padded to a power of two (≥ 32) by repeating the
                    # first dirty id; duplicates write identical rows
                    D = max(32, 1 << (int(len(dirty)) - 1).bit_length())
                    idx = np.concatenate(
                        [dirty, np.full(D - len(dirty), dirty[0],
                                        dtype=dirty.dtype)]) \
                        if D > len(dirty) else dirty
                    batch = {"rows": self.stage_unique_device(),
                             "idx": _ids_to_device(idx,
                                                   self.engine.device)}
                    self.engine._stage_auth(batch, authed_pairs)
                    out = self._step(self.engine._arrays,
                                     self.table_words, batch)
                    m.refill_scatter(idx, memo_mod.memo_pack(out),
                                     len(dirty))
            self._memo_dirty = None
            return m
        with _StagePhase("memo-fill"):
            self._memo_dirty = None  # a full fill supersedes a refill
            batch = {"rows": self.stage_unique_device()}
            self.engine._stage_auth(batch, authed_pairs)
            out = self._step(self.engine._arrays, self.table_words, batch)
            m.fill(memo_mod.memo_pack(out), 0, self.n_unique, sig)
        return m

    def prefetch_idx(self, idx: np.ndarray, start: int) -> None:
        """Issue the copy of a coming chunk's ids ahead of use, from
        page-locked memory so it overlaps the current chunk. The
        caching host allocator keeps the pinned buffer from reuse until
        the copy has run."""
        key = (start, len(idx))
        if key not in self._prefetched:
            if len(self._prefetched) > 2:  # bound the in-flight window
                self._prefetched.clear()
            self._prefetched[key] = _ids_to_device(
                idx, self.engine.device, pinned=True)

    def _idx_device(self, idx: np.ndarray, start: Optional[int]
                    ) -> torch.Tensor:
        if start is not None:
            dev = self._prefetched.pop((start, len(idx)), None)
            if dev is not None:
                return dev
        METRICS.inc(ENGINE_HOST_SYNCS, labels={"site": "replay-upload"})
        return _ids_to_device(idx, self.engine.device)

    # -- replay -----------------------------------------------------------
    def verdict_idx(self, idx: np.ndarray, authed_pairs=None,
                    start: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
        """Verdict a chunk given per-flow unique-row ids: with the memo
        staged and current, one id copy + one gather; otherwise one id
        copy + the capture step. Auth staging as :meth:`verdict_rows`
        (None is fail-closed when the policy demands auth); the memo
        keys on the auth signature."""
        self._ensure_current()
        m = self.stage_verdict_memo(authed_pairs)
        with TRACER.span("replay.upload", PHASE_HOST):
            idx_dev = self._idx_device(idx, start)
            if m is None:
                batch = {"rows": self.stage_unique_device(),
                         "idx": idx_dev}
                self.engine._stage_auth(batch, authed_pairs)
        with TRACER.span("replay.step", PHASE_DEVICE):
            if m is not None:
                return m.gather(idx_dev)
            return self._step(self.engine._arrays, self.table_words,
                              batch)

    def verdict_rows(self, rows: np.ndarray, authed_pairs=None
                     ) -> Dict[str, torch.Tensor]:
        self._ensure_current()
        with TRACER.span("replay.upload", PHASE_HOST):
            METRICS.inc(ENGINE_HOST_SYNCS,
                        labels={"site": "replay-upload"})
            batch = {"rows": torch.from_numpy(
                np.ascontiguousarray(rows)).to(self.engine.device)}
            self.engine._stage_auth(batch, authed_pairs)
        with TRACER.span("replay.step", PHASE_DEVICE):
            return self._step(self.engine._arrays, self.table_words,
                              batch)

    def verdict_chunk(self, rec, l7, authed_pairs=None, start: int = 0
                      ) -> Dict[str, np.ndarray]:
        """``start`` is the chunk's GLOBAL record index (it also picks
        a v3 capture's generic rows). With the dedup
        stream staged the chunk rides :meth:`verdict_idx`, and the NEXT
        chunk's id copy is issued before this one's outputs are read
        back."""
        self._ensure_current()
        n = len(rec)
        if self.row_idx is not None and self.rows_all is not None:
            if start + n > len(self.rows_all):
                raise ValueError(
                    f"chunk [{start}:{start + n}] outside the "
                    f"staged capture ({len(self.rows_all)} rows) — "
                    f"wrong start, or staged from different records")
            idx = self.row_idx[start:start + n]
            out = self.verdict_idx(idx, authed_pairs, start=start)
            nxt = self.row_idx[start + n:start + 2 * n]
            if len(nxt):
                self.prefetch_idx(nxt, start + n)
            with TRACER.span("replay.readback", PHASE_DEVICE):
                return host_lanes(out)
        if self.rows_all is not None:
            rows = self.rows_all[start:start + n]
            if len(rows) != n:
                raise ValueError(
                    f"chunk [{start}:{start + n}] outside the "
                    f"staged capture ({len(self.rows_all)} rows) — "
                    f"wrong start, or staged from different records")
        else:
            gen_rows = (self.feat.gen_rows[start:start + n]
                        if self.feat.gen_rows is not None else None)
            rows = self.feat.encode_rows(rec, l7, gen_rows=gen_rows)
        out = self.verdict_rows(rows, authed_pairs)
        with TRACER.span("replay.readback", PHASE_DEVICE):
            return host_lanes(out)
