"""Persistent device-resident verdict ring: the continuous-batching
engine face of the serving loop (counterpart of the reference's
``engine/ring.py``).

* **One row universe for every admitted stream.** The ring owns one
  shared :class:`~cilium_tpu_torch.engine.session.IncrementalSession`:
  string tables, the unique-row table and the device verdict memo are
  ring-resident, not per stream, so cross-stream repeats are memo hits.
* **Continuous batching, one dispatch per pack.** Streams submit
  chunks into their leased slots; the pack cycle drains whatever slots
  have pending work and serves the CONCATENATED id vector through one
  ``serve_ids`` call — the verdict step for the delta rows plus one
  device memo gather for everything known — and reads the pack's lanes
  back to the host once, where they are sliced per chunk.
* **Memo hits never cross the boundary.** ``encode_ids`` interns on the
  host; a row the ring has seen ships a 4-byte id instead of its
  featurized row block, and the saved bytes are counted
  (``cilium_tpu_serve_memo_bypass_bytes_total``, ``bytes_saved``).

Slot-resident state survives policy hot swaps through the shared
session's delta path (``loader=``). Slot lifecycle (grant, TTL, expiry,
admission) lives one layer up in ``runtime/serveloop.py``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from cilium_tpu_torch.engine.attribution import ServedPack
from cilium_tpu_torch.engine.session import IncrementalSession
from cilium_tpu_torch.runtime.metrics import (
    METRICS,
    SERVE_MEMO_BYPASS_BYTES,
    SERVE_PACK_RECORDS,
    SERVE_PACK_STREAMS,
)

#: hard bound on records one pack cycle may carry to the device —
#: chunks past it wait for the next cycle
PACK_MAX = 1 << 17


class RingSlot:
    """One leased stream's ring residency: pending (not yet packed)
    encoded chunks plus lifetime accounting. The slot holds ENCODED
    ids, never raw payloads — encoding happens at submit so the pack
    cycle is a concatenate, not a featurize loop."""

    __slots__ = ("slot_id", "stream_id", "pending", "records_in",
                 "records_out")

    def __init__(self, slot_id: int):
        self.slot_id = slot_id
        self.stream_id: Optional[str] = None
        #: [(idx int32 array, completion token or None, session reset
        #: epoch the ids were encoded under), ...] — bounded by the
        #: serve loop's per-slot pending bound; the ring itself bounds
        #: the PACK, not the slot. The epoch rides EACH chunk: a
        #: session reset orphans the ids encoded before it, and a
        #: later submit into the same slot must not launder the stale
        #: chunk past pack()'s staleness check (see pack)
        self.pending: List[Tuple[np.ndarray, object, int]] = []
        self.records_in = 0
        self.records_out = 0


class RingFull(RuntimeError):
    """No free slot: the caller sheds the stream with an explicit
    reason instead of queueing it invisibly."""


class SlotNotResident(RuntimeError):
    """The slot was released (lease expiry/disconnect) between the
    caller's lease check and the ring operation — the serve loop
    translates this to its lease-lapsed contract."""


class VerdictRing:
    """Fixed-capacity ring of stream slots over one shared
    incremental session. Thread-safe: the serve loop's pack thread
    and the per-connection submit paths interleave under the ring
    lock; the shared session has its OWN lock (``_session_lock``)
    held by both the submit-side encode (which may reset the session
    or consume a policy delta) and the pack-side serve — the dispatch
    runs outside the RING lock so slot/lease operations stay
    responsive, but never concurrently with an encode that could
    mutate the tables it reads. Two packs never run concurrently by
    construction — only the pack loop calls :meth:`pack`."""

    def __init__(self, engine, capacity: int, loader=None,
                 widths: Optional[Dict[str, int]] = None,
                 memo: bool = True, provenance: bool = False,
                 host: str = ""):
        self.capacity = max(1, int(capacity))
        #: a fleet replica passes its identity so the ring's serve-
        #: plane families land as per-host series; a standalone ring
        #: stays unlabeled
        self.host = str(host)
        self._host_labels = {"host": self.host} if self.host else None
        #: serve with the attribution/provenance lanes riding the
        #: dispatch (an engine/attribution.ServedPack per chunk)
        self.provenance = bool(provenance)
        self.session = IncrementalSession(engine, widths=widths,
                                          memo=memo, loader=loader)
        self._lock = threading.Lock()
        #: serializes EVERY session touch: submit-side encode (which
        #: may reset the session or consume a policy delta, mutating
        #: tables/rows_dev/memo) against pack-side serve (which
        #: flushes and reads the same state outside the ring lock).
        #: Ordering: _lock may be held when taking _session_lock,
        #: never the reverse
        self._session_lock = threading.Lock()
        self._slots: Dict[int, RingSlot] = {}
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        #: slot ids with pending work, in submit order (bounded by
        #: capacity: a slot appears at most once)
        self._dirty: List[int] = []
        self._dirty_set: set = set()
        #: lifetime counters (the serve loop's bench/invariant face)
        self.packs = 0
        self.records_packed = 0
        self.bytes_saved = 0
        self.bytes_shipped = 0

    # -- slot lifecycle ---------------------------------------------------
    @property
    def occupancy(self) -> int:
        with self._lock:
            return len(self._slots)

    def acquire(self, stream_id: str) -> RingSlot:
        """Claim a free slot for ``stream_id``; raises
        :class:`RingFull` when the ring is at capacity — the caller
        sheds with reason ``ring-full``, never queues."""
        with self._lock:
            if not self._free:
                raise RingFull(
                    f"ring at capacity ({self.capacity} slots)")
            sid = self._free.pop()
            slot = self._slots.get(sid)
            if slot is None:
                slot = RingSlot(sid)
            slot.stream_id = stream_id
            slot.pending = []
            self._slots[sid] = slot
            return slot

    def release(self, slot: RingSlot
                ) -> List[Tuple[np.ndarray, object, int]]:
        """Return a slot to the free list (lease expiry, stream end,
        drain). Pending unpacked chunks are DROPPED and returned —
        popped under the ring lock, so a chunk is resolved by EITHER
        the pack cycle (verdicts) or the releaser (error), never
        both. Identity-checked: releasing a slot OBJECT whose id was
        already re-acquired by another stream must not evict the new
        resident."""
        with self._lock:
            dropped = slot.pending
            slot.pending = []
            slot.stream_id = None
            if self._slots.get(slot.slot_id) is slot:
                del self._slots[slot.slot_id]
                self._free.append(slot.slot_id)
                if slot.slot_id in self._dirty_set:
                    self._dirty_set.discard(slot.slot_id)
                    self._dirty = [s for s in self._dirty
                                   if s != slot.slot_id]
            return dropped

    # -- submit -----------------------------------------------------------
    def submit(self, slot: RingSlot, rec, l7, offsets, blob, gen=None,
               done=None) -> int:
        """Encode one chunk into the slot's pending queue (host work
        only). ``done`` is a completion token the pack cycle hands
        back with the chunk's verdicts; if non-None it must expose
        ``resolve(verdicts, error=...)`` so the ring can fail it
        directly when its slot vanishes mid-dispatch (see pack's
        failure handler). Returns the chunk's record count. Raises
        :class:`SlotNotResident` if the slot was released."""
        n = len(rec)
        with self._lock:
            if self._slots.get(slot.slot_id) is not slot:
                raise SlotNotResident("slot is not ring-resident")
            # encode under the session lock: encode may reset the
            # session or consume a policy delta, and pack's dispatch
            # reads the same tables outside the ring lock
            with self._session_lock:
                idx, novel = self.session.encode_ids(rec, l7, offsets,
                                                     blob, gen)
                epoch = self.session.resets
            known = n - novel
            row_bytes = self.session.row_width * 4
            # selective-copy accounting: known rows ship a 4-byte id
            # instead of their featurized row block
            self.bytes_saved += known * max(0, row_bytes - 4)
            self.bytes_shipped += novel * row_bytes + n * 4
            if known:
                METRICS.inc(SERVE_MEMO_BYPASS_BYTES,
                            known * max(0, row_bytes - 4),
                            labels=self._host_labels)
            # the epoch rides the chunk, not the slot: a later submit
            # after a reset must not launder THIS chunk's stale ids
            slot.pending.append((idx, done, epoch))
            slot.records_in += n
            if slot.slot_id not in self._dirty_set:
                self._dirty_set.add(slot.slot_id)
                self._dirty.append(slot.slot_id)
        return n

    # -- the pack cycle ---------------------------------------------------
    def pack(self, authed_pairs=None, max_records: int = PACK_MAX
             ) -> List[Tuple[RingSlot, int, object, object]]:
        """Drain pending chunks (submit order, up to ``max_records``)
        into ONE dispatch; returns ``[(slot, n, done, host verdict
        slice or ServedPack slice), ...]`` per packed chunk. Chunks whose ids
        predate a session reset are dropped with ``verdicts=None`` —
        the serve loop resubmits them (their payload is gone; the
        LOAD MODEL treats it as a retryable shed). Empty list when
        nothing was pending."""
        with self._lock:
            batch: List[Tuple[RingSlot, np.ndarray, object, int]] = []
            stale: List[Tuple[RingSlot, int, object]] = []
            total = 0
            epoch = self.session.resets
            taken_slots = 0
            while self._dirty and total < max_records:
                sid = self._dirty[0]
                slot = self._slots.get(sid)
                if slot is None or not slot.pending:
                    self._dirty.pop(0)
                    self._dirty_set.discard(sid)
                    continue
                idx, done, chunk_epoch = slot.pending[0]
                if chunk_epoch != epoch:
                    # encoded before a session reset: the ids name
                    # rows that no longer exist (the CHUNK's epoch —
                    # a post-reset submit into the same slot must not
                    # launder this one through)
                    slot.pending.pop(0)
                    stale.append((slot, len(idx), done))
                    continue
                if total + len(idx) > max_records and batch:
                    break  # next cycle picks it up — no host barrier
                slot.pending.pop(0)
                batch.append((slot, idx, done, chunk_epoch))
                total += len(idx)
                if not slot.pending:
                    self._dirty.pop(0)
                    self._dirty_set.discard(sid)
                taken_slots += 1
            if not batch:
                return [(s, n, d, None) for s, n, d in stale]
            packed = np.concatenate([idx for _, idx, _, _ in batch])
        # dispatch OUTSIDE the ring lock (slot/lease ops stay
        # responsive) but UNDER the session lock: a submit-side
        # encode may reset the session or consume a policy delta,
        # and must not mutate the tables a dispatch is reading
        orphans: List[Tuple[int, object]] = []
        try:
            with self._session_lock:
                if self.session.resets != epoch:
                    # a submit-triggered reset landed between the
                    # drain and the dispatch: the whole batch's ids
                    # are orphaned — same staleness as the per-chunk
                    # check, caught one window later
                    stale.extend((slot, len(idx), done)
                                 for slot, idx, done, _ in batch)
                    return [(s, n, d, None) for s, n, d in stale]
                verdicts = self.session.serve_ids(
                    packed, authed_pairs=authed_pairs,
                    provenance=self.provenance)
        except Exception:
            # dispatch failed (injected fault, sick device): put the
            # batch BACK at the slots' heads — the next cycle retries
            # it (transient faults recover), and no ticket is lost.
            # A slot released while the dispatch was in flight is no
            # longer ring-resident (acquire() builds a fresh RingSlot
            # for its id): its chunks cannot ride a retry, so their
            # tickets fail NOW instead of stranding the submitters
            with self._lock:
                for slot, idx, done, ce in reversed(batch):
                    if self._slots.get(slot.slot_id) is not slot:
                        orphans.append((len(idx), done))
                        continue
                    slot.pending.insert(0, (idx, done, ce))
                    if slot.slot_id not in self._dirty_set:
                        self._dirty_set.add(slot.slot_id)
                        self._dirty.insert(0, slot.slot_id)
            for _n, done in orphans:
                if done is not None:
                    done.resolve(None, error="slot-released")
            raise
        # the pack's lanes cross back to the host ONCE (the provenance
        # lanes stacked into one copy, ServedPack.host) and are sliced
        # there: one read back per pack, not one per chunk
        verdicts = (verdicts.host() if isinstance(verdicts, ServedPack)
                    else verdicts.cpu().numpy())
        # pack/record totals race the submit path's occupancy reads
        # and a concurrent drain() pack cycle — bump under the ring
        # lock like every other book
        with self._lock:
            self.packs += 1
            self.records_packed += int(total)
        METRICS.observe(SERVE_PACK_RECORDS, float(total),
                        labels=self._host_labels)
        METRICS.observe(SERVE_PACK_STREAMS,
                        float(len({s.slot_id for s, _, _, _ in batch})),
                        labels=self._host_labels)
        if isinstance(verdicts, ServedPack):
            # stamp the pack-cycle id on the bundle before slicing —
            # every chunk of this dispatch shares it
            verdicts.pack_cycle = self.packs
        out: List[Tuple[RingSlot, int, object, object]] = []
        base = 0
        for slot, idx, done, _ in batch:
            n = len(idx)
            piece = (verdicts.slice(base, n)
                     if isinstance(verdicts, ServedPack)
                     else verdicts[base:base + n])
            out.append((slot, n, done, piece))
            slot.records_out += n
            base += n
        out.extend((s, n, d, None) for s, n, d in stale)
        return out

    def memo_stats(self) -> Dict[str, int]:
        m = self.session.memo
        if m is None:
            return {}
        return {"hits": m.hits, "misses": m.misses,
                "invalidations": m.invalidations}

    # -- fleet handoff ----------------------------------------------------
    def resident_keys(self) -> frozenset:
        """Content hashes of every session-resident unique row — the
        cross-host handoff manifest. Row hashes are content-addressed
        (``engine/memo.hash_rows``), so two hosts that interned the
        same row hold the same key even though their row ids differ."""
        with self._lock:
            with self._session_lock:
                return frozenset(self.session.row_ids.keys())

    def handoff_overlap(self, keys) -> Tuple[int, int]:
        """How much of a peer's residency manifest is already resident
        HERE: ``(rows, bytes_avoided)``, in the per-chunk
        ``bytes_saved`` currency (row block minus the 4-byte id)."""
        with self._lock:
            with self._session_lock:
                mine = self.session.row_ids
                rows = sum(1 for k in keys if k in mine)
                row_bytes = self.session.row_width * 4
        return rows, rows * max(0, row_bytes - 4)
