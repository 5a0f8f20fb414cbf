"""Incremental verdict session: capture replay's dedup machinery rebuilt
for ONLINE streams (counterpart of the reference's
``engine/session.py``).

An online stream has no whole capture to stage, but live traffic has
the same statistical shape: strings and 15-tuples repeat heavily. The
session makes the dedup incremental:

* per-field session string tables grow as new strings appear; only the
  NEW strings are scanned on the device, one delta per flush through
  the field's banked DFA on the gather arm (kernel KD on the card), the
  match words written in place into the device-resident word table;
* a session unique-row table grows the same way; each chunk ships as
  int32 row ids (4 bytes a flow) plus whatever rows and strings are
  new;
* the device verdict memo (``engine/memo.py``) holds the outputs of
  every session row: a chunk whose rows are all known costs one id
  copy and one gather, and the verdict step runs only for delta rows.

Capacity is bounded: when the row table or a string table reaches its
cap, the session RESETS (drops all tables and re-interns from scratch).

Device tables are written by slice assignment, which faults or
truncates where the reference's ``dynamic_update_slice`` clamps: the
reference's capacity arithmetic (cover ``base + D``, not just ``n``) is
kept and every block is asserted to fit. Match words travel as int32
bit patterns, as everywhere in the port.

Verdicts equal the reference session's and the engine's direct path
(``tests/test_torch_session.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cilium_tpu_torch.core.config import EngineConfig
from cilium_tpu_torch.core.flow import TrafficDirection
from cilium_tpu_torch.engine import memo as memo_mod
from cilium_tpu_torch.engine.compiled import (
    _ROW_COLS,
    _gen_intern_rows,
    _gen_l7g_cols,
)
from cilium_tpu_torch.engine.dfa_kernel import dfa_scan_banked
from cilium_tpu_torch.engine.replay import _ids_to_device
from cilium_tpu_torch.engine.verdict import (
    DISPATCH_POINT,
    TorchVerdictEngine,
    verdict_step_capture,
)
from cilium_tpu_torch.runtime import faults

#: session caps: beyond these the dedup tables stop paying for
#: themselves (high-cardinality traffic) and the session re-interns
MAX_ROWS = 1 << 18
MAX_STRINGS = 1 << 16

_FIELDS = ("path", "method", "host", "headers", "qname")
#: row-column index of the L7 type and the destination port (the keys
#: of the bank-reference invalidation narrowing)
_L7_COL = _ROW_COLS.index("l7_types")
_DPORT_COL = _ROW_COLS.index("dports")
_PREFIX = {"path": "path", "method": "method", "host": "host",
           "headers": "hdr", "qname": "dns", "l7g": "l7g"}


def _pow2(n: int, floor: int = 256) -> int:
    return max(floor, 1 << max(0, n - 1).bit_length())


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class _StringTable:
    """One field's session string table: host dict + device match
    words ([capacity, NB·W] int32), delta-scanned on growth."""

    def __init__(self, engine, field: str, width: int):
        self.engine = engine
        self.field = field
        self.width = width
        self.ids: Dict[bytes, int] = {b"": 0}
        self.n = 1
        self.capacity = 0
        self.words: Optional[torch.Tensor] = None
        self._nw: Optional[int] = None
        #: new (id, bytes) strings awaiting a device delta scan
        self._pending: list = [(0, b"")]

    def intern(self, s: bytes) -> int:
        i = self.ids.get(s)
        if i is None:
            i = self.ids[s] = self.n
            self.n += 1
            self._pending.append((i, s))
        return i

    def flush(self) -> None:
        """Scan the pending strings and write their match words into
        the device table."""
        if not self._pending:
            return
        eng = self.engine
        prefix = _PREFIX[self.field]
        a = eng._arrays
        if f"{prefix}_trans" not in a:
            # no automaton staged for this field (an l7g table under a
            # policy with no frontend rules): interning continues on the
            # host and the pending delta scans when a policy needs it
            return
        if self._nw is None:
            # words per row: every bank's accept words, [NB, S, W] →
            # NB·W int32 lanes
            acc = a[f"{prefix}_accept"]
            self._nw = int(acc.shape[0]) * int(acc.shape[2])
        base = self._pending[0][0]
        D = _pow2(len(self._pending), floor=256)
        # capacity covers base + D, not just n: the delta block is
        # written whole, padding rows included
        cap_needed = _pow2(max(self.n, base + D))
        if cap_needed > self.capacity or self.words is None:
            grown = torch.zeros((cap_needed, self._nw), dtype=torch.int32,
                                device=eng.device)
            if self.words is not None:
                grown[:self.capacity] = self.words
            self.words, self.capacity = grown, cap_needed
        # contiguous ids by construction (appended in intern order)
        data = np.zeros((D, self.width), dtype=np.uint8)
        lens = np.zeros(D, dtype=np.int32)
        valid = np.zeros(D, dtype=bool)
        for j, (_, s) in enumerate(self._pending):
            b = s[:self.width]
            data[j, :len(b)] = np.frombuffer(b, dtype=np.uint8)
            lens[j] = len(b)
            # a string longer than the session width behaves like the
            # raw path's fixed-length clip: invalid → zero words
            valid[j] = len(s) <= self.width
        words = dfa_scan_banked(
            a[f"{prefix}_trans"], a[f"{prefix}_byteclass"],
            a[f"{prefix}_start"], a[f"{prefix}_accept"],
            _to_device(data, eng.device), _to_device(lens, eng.device))
        flat = words.reshape(D, -1)
        flat = torch.where(_to_device(valid, eng.device)[:, None], flat,
                           torch.zeros((), dtype=flat.dtype,
                                       device=flat.device))
        assert base + D <= self.capacity
        self.words[base:base + D] = flat
        self._pending = []


class IncrementalSession:
    """Online counterpart of ``CaptureReplay`` for one
    :class:`TorchVerdictEngine`, on the engine's device.

    ``verdict_chunk(rec, l7, offsets, blob, gen, ...)`` returns
    ``(n, device verdict tensor)`` — dispatch only; the caller reads
    back. ``encode_ids`` (host) and ``serve_ids`` (device) are its two
    halves, which the verdict ring drives for many streams at once."""

    def __init__(self, engine: TorchVerdictEngine,
                 widths: Optional[Dict[str, int]] = None,
                 max_rows: int = MAX_ROWS,
                 max_strings: int = MAX_STRINGS,
                 memo: bool = True, loader=None):
        self.engine = engine
        #: optional loader (anything with an ``.engine``): committed
        #: revisions are consumed as PolicyDeltas, so only rows whose
        #: identity/family/port read a changed bank recompute
        self.loader = loader
        self._gen_epoch = memo_mod.policy_generation()
        #: the device verdict memo over the session row table; disable
        #: to force every chunk through the full step
        self.memo_enabled = memo
        self.memo = (memo_mod.VerdictMemo(device=engine.device)
                     if memo else None)
        cfg = EngineConfig()
        caps = {"path": max(cfg.http_path_buckets),
                "method": cfg.http_method_len,
                "host": cfg.http_host_len,
                "headers": 1024, "qname": cfg.dns_name_len,
                "l7g": cfg.l7g_len}
        self.widths = {f: min(int((widths or {}).get(f, caps[f])),
                              caps[f])
                       for f in _FIELDS + ("l7g",)}
        self.max_rows = max_rows
        self.max_strings = max_strings
        self.fmax = int(engine.policy.kafka_interns.get("gen_fmax", 4))
        # gen block: [proto id, frontend family, l7g string id,
        # pair ids...] — kept in the row so row ids are the reference's
        self.row_width = len(_ROW_COLS) + 3 + self.fmax
        self._step = verdict_step_capture
        self.resets = 0
        self._init_state()

    def _init_state(self) -> None:
        self.tables = {f: _StringTable(self.engine, f, self.widths[f])
                       for f in _FIELDS}
        # the l7g table interns on the host unconditionally (ids are
        # policy-independent) and scans only when the engine stages it
        self.tables["l7g"] = _StringTable(self.engine, "l7g",
                                          self.widths["l7g"])
        self.kafka_memo: Dict[Tuple[str, bytes], int] = {}
        #: row-hash → [(row bytes, id), ...] chains (exact, see _row_idx)
        self.row_ids: Dict[int, list] = {}
        self.n_rows = 0
        self.row_capacity = 0
        self.rows_dev: Optional[torch.Tensor] = None
        self._pending_rows: list = []
        #: host mirror of each session row's (enforcement identity,
        #: l7 type, dport): the bank-reference invalidation mask is
        #: computed from it without a device read back
        self._row_eps: list = []
        #: session row ids a bank-scoped commit touched, awaiting a
        #: scatter refill in _memo_serve
        self._memo_dirty: Optional[np.ndarray] = None

    def reset(self, reason: str = "session-reset") -> None:
        self.resets += 1
        if self.memo is not None:
            # row ids restart from 0: the memo keyed by them goes too
            self.memo.invalidate(reason)
        self._init_state()

    # -- swap safety ------------------------------------------------------
    def _ensure_current(self) -> None:
        """Consume committed revisions' PolicyDeltas: a no-change commit
        keeps every table and the memo; a bank-scoped commit rescans the
        session string tables through the new engine's automata and
        queues only the rows the delta affects for a memo refill;
        anything else resets the session."""
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
            self._rebind(new_engine)
            if self.memo is not None:
                self.memo.adopt()
            return
        partial = (not delta.full
                   and new_engine is not self.engine
                   and (new_engine.policy.kafka_interns
                        == self.engine.policy.kafka_interns))
        if not partial:
            self._rebind(new_engine)
            self.reset(reason="policy-swap")
            return
        self._rebind(new_engine)
        # the match-word tables are policy-scoped even though the
        # strings are not: rescan every session string
        for t in self.tables.values():
            t._pending = sorted(
                ((i, s) for s, i in t.ids.items()), key=lambda p: p[0])
            t.words = None
            t.capacity = 0
            t._nw = None
        if self.memo is not None and self.memo.filled:
            if delta.changed_identities:
                # only rows whose own L7 family AND entry port read a
                # swapped bank refill
                pairs = self._row_eps[:self.memo.filled]
                affected = memo_mod.affected_row_ids(
                    delta,
                    np.fromiter((p[0] for p in pairs),
                                dtype=np.int64, count=len(pairs)),
                    np.fromiter((p[1] for p in pairs),
                                dtype=np.int64, count=len(pairs)),
                    dports=np.fromiter((p[2] for p in pairs),
                                       dtype=np.int64,
                                       count=len(pairs)))
                if len(affected):
                    self.memo.partial_invalidate(len(affected),
                                                 delta.reason)
                    prev = self._memo_dirty
                    self._memo_dirty = (affected if prev is None
                                        else np.union1d(prev, affected))
            self.memo.adopt()
        elif self.memo is not None:
            self.memo.adopt()

    def _rebind(self, engine) -> None:
        if engine is self.engine:
            return
        self.engine = engine
        for t in self.tables.values():
            t.engine = engine

    # -- per-chunk host featurize -----------------------------------------
    def _string_lut(self, field: str, idx: np.ndarray, offsets,
                    blob) -> np.ndarray:
        """Chunk string-table ids → session string ids (session table
        row == match-word row), interning new strings."""
        tbl = self.tables[field]
        uniq = np.unique(idx)
        lut = np.zeros(int(idx.max()) + 1 if len(idx) else 1,
                       dtype=np.int32)
        for u in uniq:
            s = blob[int(offsets[u]):int(offsets[u + 1])].tobytes()
            lut[u] = tbl.intern(s)
        return lut[idx]

    def _kafka_lut(self, key: str, idx: np.ndarray, offsets,
                   blob) -> np.ndarray:
        intern = self.engine.policy.kafka_interns.get(key, {})
        uniq, inv = np.unique(idx, return_inverse=True)
        out = np.empty(len(uniq), dtype=np.int32)
        for j, u in enumerate(uniq):
            s = blob[int(offsets[u]):int(offsets[u + 1])].tobytes()
            memo_key = (key, s)
            v = self.kafka_memo.get(memo_key)
            if v is None:
                v = self.kafka_memo[memo_key] = intern.get(
                    s.decode("utf-8", "replace"), -2)
            out[j] = v
        return out[inv]

    def _encode_rows(self, rec, l7, offsets, blob, gen) -> np.ndarray:
        B = len(rec)
        out = np.full((B, self.row_width), -2, dtype=np.int32)
        col = {c: i for i, c in enumerate(_ROW_COLS)}
        ingress = rec["direction"] == int(TrafficDirection.INGRESS)
        out[:, col["ep_ids"]] = np.where(
            ingress, rec["dst_identity"], rec["src_identity"])
        out[:, col["peer_ids"]] = np.where(
            ingress, rec["src_identity"], rec["dst_identity"])
        out[:, col["dports"]] = rec["dport"]
        out[:, col["protos"]] = rec["proto"]
        out[:, col["directions"]] = rec["direction"]
        out[:, col["l7_types"]] = rec["l7_type"]
        out[:, col["kafka_api_key"]] = l7["kafka_api_key"]
        out[:, col["kafka_api_version"]] = l7["kafka_api_version"]
        out[:, col["kafka_client"]] = self._kafka_lut(
            "client_id", l7["kafka_client"], offsets, blob)
        out[:, col["kafka_topic"]] = self._kafka_lut(
            "topic", l7["kafka_topic"], offsets, blob)
        for f in _FIELDS:
            out[:, col[f"{f}_row"]] = self._string_lut(
                f, l7[f], offsets, blob)
        ncols = len(_ROW_COLS)
        if gen is not None:
            gen_block = _gen_intern_rows(
                gen, offsets, blob, self.engine.policy.kafka_interns)
            fam, uniq_ser, l7g_row = _gen_l7g_cols(gen, offsets, blob)
            # frontend scan values intern into the session's l7g table
            # (delta-scanned like any string); other records keep id 0
            # (the empty string)
            tbl = self.tables["l7g"]
            ser_ids = np.zeros(len(uniq_ser), dtype=np.int32)
            for j, s in enumerate(uniq_ser[1:], start=1):
                ser_ids[j] = tbl.intern(s)
            out[:, ncols] = gen_block[:, 0]
            out[:, ncols + 1] = fam
            out[:, ncols + 2] = ser_ids[l7g_row]
            out[:, ncols + 3:] = gen_block[:, 1:]
            # frontend records normalize the l7-type lane to their
            # family, as encode_flows does: it keys the fe lane on the
            # device and the (ep, l7type, dport) memo mirror
            out[:, col["l7_types"]] = np.where(
                fam > 0, fam, out[:, col["l7_types"]])
        else:
            # no generic section: proto/pair slots stay -2 ("absent"),
            # the family/l7g columns read "no frontend record"
            out[:, ncols + 1] = 0
            out[:, ncols + 2] = 0
        return out

    def _row_idx(self, rows: np.ndarray) -> np.ndarray:
        """Chunk rows → session row ids, interning new unique rows.
        Hashes (``memo.hash_rows``) pick CANDIDATE matches only: every
        row is checked against its hash representative within the
        chunk, and the session's chains compare stored row bytes before
        reuse; an in-chunk collision falls back to the exact row sort."""
        h = memo_mod.hash_rows(rows)
        uh, first, inv = np.unique(h, return_index=True,
                                   return_inverse=True)
        if not np.array_equal(rows, rows[first][inv]):
            return self._row_idx_exact(rows)
        lut = np.empty(len(uh), dtype=np.int32)
        for j in range(len(uh)):
            lut[j] = self._intern_row(rows[first[j]], int(uh[j]))
        return lut[inv].astype(np.int32)

    def _row_idx_exact(self, rows: np.ndarray) -> np.ndarray:
        """Exact fallback for an in-chunk hash collision (row sort)."""
        uniq, inv = np.unique(rows, axis=0, return_inverse=True)
        lut = np.empty(len(uniq), dtype=np.int32)
        for j in range(len(uniq)):
            row = uniq[j]
            lut[j] = self._intern_row(
                row, int(memo_mod.hash_rows(row[None, :])[0]))
        return lut[inv.reshape(-1)].astype(np.int32)

    def _intern_row(self, row: np.ndarray, key: int) -> int:
        chain = self.row_ids.setdefault(key, [])
        raw = row.tobytes()
        for stored_bytes, stored_id in chain:
            if stored_bytes == raw:
                return stored_id
        rid = self.n_rows
        self.n_rows += 1
        self._pending_rows.append(row.copy())
        self._row_eps.append((int(row[0]), int(row[_L7_COL]),
                              int(row[_DPORT_COL])))
        chain.append((raw, rid))
        return rid

    def _flush_rows(self) -> None:
        if not self._pending_rows:
            return
        dev = self.engine.device
        base = self.n_rows - len(self._pending_rows)
        D = _pow2(len(self._pending_rows), floor=256)
        cap_needed = _pow2(max(self.n_rows, base + D))
        if cap_needed > self.row_capacity or self.rows_dev is None:
            grown = torch.zeros((cap_needed, self.row_width),
                                dtype=torch.int32, device=dev)
            if self.rows_dev is not None:
                grown[:self.row_capacity] = self.rows_dev
            self.rows_dev, self.row_capacity = grown, cap_needed
        delta = np.zeros((D, self.row_width), dtype=np.int32)
        delta[:len(self._pending_rows)] = np.stack(self._pending_rows)
        assert base + D <= self.row_capacity
        self.rows_dev[base:base + D] = _to_device(delta, dev)
        self._pending_rows = []

    # -- the chunk entry points -------------------------------------------
    def encode_ids(self, rec, l7, offsets, blob, gen=None):
        """HOST half of a chunk: swap-safety check, capacity guard,
        featurize + intern → ``(idx, novel)``: the chunk's session row
        ids (int32, unpadded) and the number of rows it interned for
        the first time. No device work happens here."""
        n = len(rec)
        if n == 0:
            return np.zeros(0, dtype=np.int32), 0
        self._ensure_current()
        if (self.n_rows >= self.max_rows
                or any(t.n >= self.max_strings
                       for t in self.tables.values())):
            self.reset()
        rows = self._encode_rows(rec, l7, offsets, blob, gen)
        before = self.n_rows
        idx = self._row_idx(rows)
        return idx, self.n_rows - before

    def serve_ids(self, idx: np.ndarray, authed_pairs=None,
                  provenance: bool = False):
        """DEVICE half: flush the pending string and row deltas and
        serve one id vector — the delta rows through the verdict step
        into the memo, then one gather, however many streams' chunks
        were packed into ``idx``. Returns the device verdict tensor
        (padded; the caller slices), or with ``provenance=True`` a
        :class:`~cilium_tpu_torch.engine.attribution.ServedPack`."""
        for t in self.tables.values():
            t.flush()
        self._flush_rows()
        n = len(idx)
        B_pad = _pow2(n, floor=32)
        if B_pad > n:
            # pad ids point at row 0 — a REAL session row, but padded
            # verdicts are sliced off before anything reads them
            idx = np.concatenate(
                [idx, np.zeros(B_pad - n, dtype=np.int32)])
        faults.maybe_fail(DISPATCH_POINT)
        table_words = {f: self.tables[f].words for f in _FIELDS}
        if "l7g_trans" in self.engine._arrays:
            table_words["l7g"] = self.tables["l7g"].words
        # the padded ids cross to the device once, here
        idx_dev = _ids_to_device(idx, self.engine.device)
        if self.memo is not None:
            return self._memo_serve(idx, idx_dev, table_words,
                                    authed_pairs, provenance=provenance)
        batch = {"rows": self.rows_dev, "idx": idx_dev}
        self.engine._stage_auth(batch, authed_pairs)
        out = self._step(self.engine._arrays, table_words, batch)
        if not provenance:
            return out["verdict"]
        return self._pack_provenance(out, idx, memo_hit=None)

    def _pack_provenance(self, out, idx, memo_hit=None):
        """The ServedPack of one served id vector: the step/gather lanes
        plus per-row cited generations and the memo-hit mask (None =
        everything computed this dispatch)."""
        from cilium_tpu_torch.engine.attribution import (
            ServedPack,
            kernel_label,
        )

        gen_now = memo_mod.policy_generation()
        n = len(idx)
        if memo_hit is None:
            memo_hit = np.zeros(n, dtype=bool)
        if self.memo is not None and self.memo.gens is not None:
            gens = self.memo.cited_gens(idx)
        else:
            gens = np.full(n, gen_now, dtype=np.int64)
        return ServedPack(
            verdict=out["verdict"],
            l7_match=out.get("l7_match"),
            match_spec=out["match_spec"],
            gens=gens, memo_hit=memo_hit, generation=gen_now,
            kernel=kernel_label(self.engine))

    def verdict_chunk(self, rec, l7, offsets, blob, gen=None,
                      authed_pairs=None):
        """:meth:`encode_ids` + :meth:`serve_ids` for one stream's
        chunk → ``(n, device verdict tensor)``."""
        from cilium_tpu_torch.runtime.tracing import (
            PHASE_DEVICE,
            PHASE_HOST,
            TRACER,
        )

        n = len(rec)
        if n == 0:
            return 0, None
        with TRACER.span("session.featurize", phase=PHASE_HOST,
                         records=n):
            idx, _ = self.encode_ids(rec, l7, offsets, blob, gen)
        with TRACER.span("session.dispatch", phase=PHASE_DEVICE,
                         records=n):
            return n, self.serve_ids(idx, authed_pairs=authed_pairs)

    def _memo_serve(self, idx: np.ndarray, idx_dev: torch.Tensor,
                    table_words, authed_pairs, provenance: bool = False):
        """Serve one (padded) id chunk from the verdict memo. Outputs
        for DELTA rows — session rows past the memo's fill mark — are
        computed first through the shared capture step and written into
        the memo; the chunk is then one gather. An auth-view change or
        a generation bump drops the memo and the next chunk refills
        from row 0."""
        sig = memo_mod.auth_signature(authed_pairs)
        m = self.memo
        dev = self.engine.device
        m.valid_for(sig)  # drops the memo on generation/auth change
        base0 = m.filled  # rows below this mark are memo HITS
        if m.filled < self.n_rows:
            base = m.filled
            n_new = self.n_rows - base
            D = _pow2(n_new, floor=32)
            # pad ids clamp to real rows; their memo slots sit past the
            # fill mark and are rewritten before any id can reach them
            fill_idx = np.minimum(
                np.arange(base, base + D, dtype=np.int32),
                self.n_rows - 1)
            batch = {"rows": self.rows_dev,
                     "idx": _ids_to_device(fill_idx, dev)}
            self.engine._stage_auth(batch, authed_pairs)
            out = self._step(self.engine._arrays, table_words, batch)
            m.fill(memo_mod.memo_pack(out), base, n_new, sig)
        dirty = self._memo_dirty
        if dirty is not None and len(dirty) and m.table is not None:
            # bank-scoped refill: rewrite ONLY the rows a committed
            # revision touched (padded by repeating the first)
            D = _pow2(len(dirty), floor=32)
            ridx = (np.concatenate(
                [dirty, np.full(D - len(dirty), dirty[0],
                                dtype=dirty.dtype)])
                if D > len(dirty) else dirty)
            batch = {"rows": self.rows_dev,
                     "idx": _ids_to_device(ridx, dev)}
            self.engine._stage_auth(batch, authed_pairs)
            out = self._step(self.engine._arrays, table_words, batch)
            m.refill_scatter(ridx, memo_mod.memo_pack(out), len(dirty))
        refilled = dirty
        self._memo_dirty = None
        gathered = m.gather(idx_dev)
        if not provenance:
            return gathered["verdict"]
        # memo-hit = resident BEFORE this dispatch and not rewritten by
        # the refill above
        hit = idx < base0
        if refilled is not None and len(refilled):
            hit &= ~np.isin(idx, refilled)
        return self._pack_provenance(gathered, idx, memo_hit=hit)
