"""Continuously-batched device-resident serving loop: stream slot
leases over the persistent verdict ring (counterpart of the reference's
``runtime/serveloop.py``).

* **Slot leases.** A stream is admitted ONCE, through the optional
  :class:`~cilium_tpu_torch.runtime.admission.AdmissionGate`, into a
  ring slot lease with a TTL. Chunks then ride the lease — no per-chunk
  admission, no per-wave barrier. A lease renews on activity and
  EXPIRES when idle past its TTL, returning the slot; a
  reconnect-with-resume that finds its lease alive reuses it without a
  second grant.
* **Continuous batching.** The pack cycle drains whatever slots have
  pending encoded chunks into ONE dispatch (the verdict step for the
  delta rows, one device memo gather for everything).
* **Explicit shed, never queue-forever.** Ring at capacity →
  ``ring-full``; per-slot pending at bound → ``queue-full``; draining →
  ``draining``; armed ``serve.lease`` fault → ``fault``. All counted on
  the shared admission series, surface ``serve``.
* **Hot-swap safe.** The ring's shared session consumes committed
  PolicyDeltas: a bank-scoped commit refills only the memo rows whose
  identity, family and port read the swapped bank.
* **Canary double dispatch.** With a :class:`~cilium_tpu_torch.
  runtime.canary.CanaryController` wired and sampling, a deterministic
  fraction of chunks evaluates through the STAGED generation N+1 as
  well — in the same pack cycle, off the already-resolved verdicts —
  feeding the verdict-diff gate. Shadow work is advisory: its wall is
  metered (``canary_seconds`` vs ``pack_seconds``) and a shadow failure
  aborts the canary, never the chunk.
* **Tenant attribution.** The tenant rides the lease and every chunk
  ticket, so sheds, SLO windows and explain entries attribute to it.

Two driving modes: ``start()`` spawns the pack thread (paced by
``simclock.sleep``, so a virtual clock drives it unrestructured);
``step()`` is the inline pack cycle.

``loader`` is any object with an ``.engine`` (a
:class:`~cilium_tpu_torch.engine.verdict.TorchVerdictEngine`) and,
optionally, a ``.config`` carrying ``provenance``/``slo`` sections.

Fault points: ``serve.lease`` fires at every lease decision (a fired
fault is an explicit shed); ``serve.ring_slot`` fires at every chunk
submit (a fired fault fails THAT chunk).
"""

from __future__ import annotations

import heapq
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from cilium_tpu_torch.engine.attribution import ServedPack
from cilium_tpu_torch.engine.ring import (
    RingFull,
    RingSlot,
    SlotNotResident,
    VerdictRing,
)
from cilium_tpu_torch.engine.verdict import TorchVerdictEngine
from cilium_tpu_torch.runtime import admission, faults, simclock
from cilium_tpu_torch.runtime.logging import get_logger
from cilium_tpu_torch.runtime.metrics import (
    METRICS,
    SERVE_LATENCY,
    SERVE_LEASE_EXPIRIES,
    SERVE_LEASE_GRANTS,
    SERVE_LEASE_RELEASES,
    SERVE_PACK_DISPATCH_SECONDS,
    SERVE_PACK_OCCUPANCY,
    SERVE_RING_OCCUPANCY,
)

LOG = get_logger("serveloop")

#: fires at every lease decision in ServeLoop.connect — an injected
#: fault forces an explicit shed (reason "fault"), never a half-grant
LEASE_POINT = faults.register_point(
    "serve.lease", "slot-lease decision in ServeLoop.connect")
#: fires at every chunk submit into a ring slot — an injected fault
#: fails ONLY that chunk
RING_SLOT_POINT = faults.register_point(
    "serve.ring_slot", "chunk submit into a ring slot in "
                       "ServeLoop.submit")

class ShedError(RuntimeError):
    """An explicit, counted shed: the stream/chunk was refused with a
    reason, never silently queued."""

    def __init__(self, reason: str):
        super().__init__(f"shed: {reason}")
        self.reason = reason


class LeaseExpired(RuntimeError):
    """The stream's slot lease lapsed (idle past TTL): the caller
    re-connects (reconnect-with-resume grants a fresh slot)."""


class SlotLease:
    """One stream's ring residency grant. Renewed by activity;
    expired by the pack cycle when idle past ``ttl_s``."""

    __slots__ = ("stream_id", "slot", "ttl_s", "granted_at",
                 "expires_at", "active", "tenant")

    def __init__(self, stream_id: str, slot: RingSlot, ttl_s: float,
                 now: float, tenant: str = ""):
        self.stream_id = stream_id
        self.slot = slot
        self.ttl_s = float(ttl_s)
        self.granted_at = now
        self.expires_at = now + self.ttl_s
        self.active = True
        #: the stream's tenant — rides every chunk this lease submits
        self.tenant = str(tenant)

    def renew(self, now: float) -> None:
        self.expires_at = now + self.ttl_s

    def expired(self, now: float) -> bool:
        # the exact tick expires: expires_at <= now (zero budget =
        # lapsed)
        return self.expires_at <= now


class ChunkTicket:
    """Completion token for one submitted chunk: the submitter parks
    on a clock-integrated event; the pack cycle resolves it with host
    verdicts or an error string. ``trace_id`` is the submitting
    stream's trace context, stamped at submit so the pack thread can
    still attribute its work; ``prov`` is the chunk's
    :class:`~cilium_tpu_torch.engine.attribution.ServedPack` slice
    (host lanes) when the ring serves with provenance on."""

    __slots__ = ("ev", "n", "t_submit", "t_done", "verdicts", "error",
                 "trace_id", "prov", "sample_flows", "epoch",
                 "tenant", "canary")

    def __init__(self, n: int, trace_id: str = "", epoch: int = 0):
        self.ev = simclock.event()
        self.n = n
        self.t_submit = simclock.now()
        self.t_done: Optional[float] = None
        self.verdicts: Optional[np.ndarray] = None
        self.error: Optional[str] = None
        self.trace_id = trace_id
        #: the trace's causal epoch at submit
        self.epoch = int(epoch)
        self.prov = None
        self.sample_flows = None
        #: tenant attribution (from the lease) for SLO/explain
        self.tenant = ""
        #: True when this chunk was canary-sampled: its sampled flows
        #: double-dispatch through the staged generation at resolve
        self.canary = False

    def resolve(self, verdicts: Optional[np.ndarray],
                error: Optional[str] = None, prov=None) -> None:
        self.verdicts = verdicts
        self.error = error
        self.prov = prov
        self.t_done = simclock.now()
        self.ev.set()

    @property
    def latency(self) -> Optional[float]:
        return (None if self.t_done is None
                else max(0.0, self.t_done - self.t_submit))

    @property
    def done(self) -> bool:
        return self.ev.is_set()

    def wait(self, timeout: float = 30.0) -> np.ndarray:
        if not simclock.wait_on(self.ev, timeout):
            raise TimeoutError("no verdict from the serve loop")
        if self.error is not None:
            raise ShedError(self.error)
        return self.verdicts


class ServeLoop:
    """The serving loop. One instance per service; owns the ring and
    every lease. Thread-safe: connects/submits land from connection
    threads while the single pack thread (or an inline ``step()``)
    cycles."""

    def __init__(self, loader, capacity: int = 1024,
                 lease_ttl_s: float = 30.0,
                 pack_interval_s: float = 0.002,
                 max_slot_pending: int = 64,
                 gate: Optional[admission.AdmissionGate] = None,
                 authed_pairs_fn=None,
                 widths: Optional[Dict[str, int]] = None,
                 memo: bool = True,
                 provenance: Optional[bool] = None,
                 slo=None,
                 explain_store=None,
                 host_id: str = "",
                 canary=None):
        from cilium_tpu_torch.hubble.flowagg import FlowAggregator
        from cilium_tpu_torch.runtime.explain import EXPLAIN
        from cilium_tpu_torch.runtime.slo import SLOTracker

        engine = loader.engine
        if not isinstance(engine, TorchVerdictEngine):
            raise RuntimeError(
                "the serve loop needs the device engine "
                "(TorchVerdictEngine) — the oracle has no ring to be "
                "resident in")
        self.loader = loader
        root_cfg = getattr(loader, "config", None)
        prov_cfg = getattr(root_cfg, "provenance", None)
        if provenance is None:
            provenance = bool(getattr(prov_cfg, "enabled", True))
        self.provenance = bool(provenance)
        self.explain_sample = int(getattr(prov_cfg, "sample_per_chunk",
                                          8) or 0)
        #: which host this loop serves AS (a standalone loop is
        #: anonymous) — rides every explain entry
        self.host_id = str(host_id)
        #: serve-plane metric labels: host-scoped for fleet replicas,
        #: unlabeled for a standalone loop
        self._host_labels = ({"host": self.host_id}
                             if self.host_id else None)
        self.explain = explain_store if explain_store is not None \
            else EXPLAIN
        if prov_cfg is not None:
            self.explain.configure(
                capacity=getattr(prov_cfg, "explain_capacity", None))
        self.slo = (SLOTracker.from_config(slo) if slo is not None
                    else SLOTracker.from_config(
                        getattr(root_cfg, "slo", None)))
        if self.slo is not None and self.host_id:
            self.slo.host = self.host_id
        #: per-host bounded flow aggregation fed from the resolve path
        self.flows = FlowAggregator(host=self.host_id)
        self.ring = VerdictRing(engine, capacity, loader=loader,
                                widths=widths, memo=memo,
                                provenance=self.provenance,
                                host=self.host_id)
        self.lease_ttl_s = float(lease_ttl_s)
        self.pack_interval_s = float(pack_interval_s)
        #: per-slot pending-chunk bound: a producer outrunning the
        #: pack cycle sheds (queue-full) instead of buffering forever
        self.max_slot_pending = max(1, int(max_slot_pending))
        self.gate = gate
        self.authed_pairs_fn = authed_pairs_fn
        self._lock = threading.Lock()
        #: serializes pack cycles: step() may be driven inline AND by
        #: the pack thread, and drain() packs too — the shared
        #: session's device tables are single-writer
        self._pack_lock = threading.Lock()
        self._leases: Dict[str, SlotLease] = {}
        #: lazy expiry heap of (expires_at-at-push, stream_id): a
        #: renewed lease's stale entries re-push at pop time, so expiry
        #: sweeps are O(lapsed log n), never O(all leases)
        self._expiry_heap: list = []
        self._draining = False
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        #: leaf lock for the lifetime counters below: they are bumped
        #: from client threads AND the pack thread, sometimes while
        #: self._lock is held and sometimes not (`_shed`)
        self._stats_lock = threading.Lock()
        #: lifetime counters
        self.grants = 0
        self.expiries = 0
        self.releases = 0
        self.sheds = 0
        self.served_records = 0
        self.chunk_errors = 0
        self.pack_failures = 0
        #: explanation coverage: served records that carried a
        #: provenance bundle vs not
        self.records_explained = 0
        self.records_unexplained = 0
        #: wall seconds spent on observability bookkeeping
        self.obs_seconds = 0.0
        #: a CanaryController whose sampling window double-dispatches a
        #: deterministic fraction of chunks through the staged
        #: generation N+1. It stages and commits through its own
        #: loader, so one bound to another loader would diff and commit
        #: a generation this loop never serves: refused
        if canary is not None and canary.loader is not loader:
            raise ValueError(
                "the canary controller is bound to another loader than "
                "the serve loop's")
        self.canary = canary
        #: monotone chunk counter driving the canary's counter-walk
        #: sample selection (never an RNG or an id hash)
        self._canary_counter = 0
        #: wall seconds spent double-dispatching sampled chunks ...
        self.canary_seconds = 0.0
        #: ... and the pack-cycle wall (dispatch + resolution, shadow
        #: included) it is measured against
        self.pack_seconds = 0.0

    @classmethod
    def from_config(cls, loader, cfg, gate=None,
                    authed_pairs_fn=None) -> "ServeLoop":
        """Build from a ``serve`` config section (absent knobs take the
        defaults). Provenance and SLO knobs come off the loader's root
        config inside ``__init__``."""
        return cls(
            loader,
            capacity=getattr(cfg, "slot_capacity", 1024),
            lease_ttl_s=getattr(cfg, "lease_ttl_s", 30.0),
            pack_interval_s=getattr(cfg, "pack_interval_ms", 2.0) / 1e3,
            max_slot_pending=getattr(cfg, "max_slot_pending", 64),
            gate=gate, authed_pairs_fn=authed_pairs_fn)

    # -- leases -----------------------------------------------------------
    def _shed(self, reason: str, tenant: str = "") -> None:
        with self._stats_lock:
            self.sheds += 1
        admission.count_shed("serve", admission.CLASS_DATA, reason,
                             tenant=tenant)
        if self.slo is not None:
            self.slo.observe_request(shed=True, tenant=tenant)

    def connect(self, stream_id: str, resume: bool = False,
                tenant: str = "") -> SlotLease:
        """Admit one stream into a slot lease. ``resume=True`` is
        reconnect-with-resume: a still-live lease for the stream is
        RENEWED and returned — never granted (counted) twice; an
        expired/absent one falls through to a fresh grant. Raises
        :class:`ShedError` (reason ``fault`` / ``draining`` /
        ``ring-full`` / gate reason) instead of queueing."""
        try:
            faults.maybe_fail(LEASE_POINT)
        except Exception:  # noqa: BLE001 — plan-chosen exception
            self._shed(admission.SHED_FAULT, tenant=tenant)
            raise ShedError(admission.SHED_FAULT)
        now = simclock.now()
        with self._lock:
            if self._draining:
                self._shed(admission.SHED_DRAINING, tenant=tenant)
                raise ShedError(admission.SHED_DRAINING)
            if resume:
                lease = self._leases.get(stream_id)
                if lease is not None and lease.active:
                    if not lease.expired(now):
                        lease.renew(now)
                        return lease
                    # expired but not yet swept: release the slot NOW
                    # (counted as an expiry) before re-granting
                    self._release_locked(lease, "expired")
            elif stream_id in self._leases:
                # duplicate connect without resume: one stream, one
                # lease — the old one is released first
                self._release_locked(self._leases[stream_id],
                                     "superseded")
        if self.gate is not None:
            ok, reason = self.gate.admit(admission.CLASS_DATA,
                                         tenant=tenant)
            if not ok:
                with self._stats_lock:
                    self.sheds += 1  # counted by the gate already
                raise ShedError(reason)
        now = simclock.now()
        with self._lock:
            if self._draining:
                self._shed(admission.SHED_DRAINING, tenant=tenant)
                raise ShedError(admission.SHED_DRAINING)
            # the lock was dropped around gate.admit: a concurrent
            # connect for the SAME stream may have granted meanwhile —
            # reuse or release the racer's lease, one stream = one slot
            racer = self._leases.get(stream_id)
            if racer is not None and racer.active:
                if resume and not racer.expired(now):
                    racer.renew(now)
                    return racer
                self._release_locked(
                    racer, "expired" if racer.expired(now)
                    else "superseded")
            try:
                slot = self.ring.acquire(stream_id)
            except RingFull:
                self._shed(admission.SHED_RING_FULL, tenant=tenant)
                raise ShedError(admission.SHED_RING_FULL)
            lease = SlotLease(stream_id, slot, self.lease_ttl_s, now,
                              tenant=tenant)
            self._leases[stream_id] = lease
            heapq.heappush(self._expiry_heap,
                           (lease.expires_at, stream_id))
            self.grants += 1
            METRICS.inc(SERVE_LEASE_GRANTS, labels=self._host_labels)
            METRICS.set_gauge(SERVE_RING_OCCUPANCY,
                              float(len(self._leases)),
                              labels=self._host_labels)
            return lease

    def _release_locked(self, lease: SlotLease, how: str) -> None:
        """Caller holds self._lock. Resolves the slot's pending
        chunks as errors, returns the slot, counts by ``how``."""
        if not lease.active:
            return
        lease.active = False
        # release pops the slot's pending under the RING lock, so a
        # chunk resolves through exactly one of (pack → verdicts,
        # release → error)
        dropped = self.ring.release(lease.slot)
        if self._leases.get(lease.stream_id) is lease:
            self._leases.pop(lease.stream_id, None)
        for _idx, done, _epoch in dropped:
            if done is not None:
                done.resolve(None, error=f"lease-{how}")
                tid = getattr(done, "trace_id", "")
                if tid:
                    from cilium_tpu_torch.runtime.tracing import TRACER

                    TRACER.event_remote(
                        tid, "serve.abandon", host=self.host_id,
                        epoch=getattr(done, "epoch", 0),
                        error=f"lease-{how}")
        if how == "expired":
            self.expiries += 1
            METRICS.inc(SERVE_LEASE_EXPIRIES,
                        labels=self._host_labels)
        else:
            self.releases += 1
            METRICS.inc(SERVE_LEASE_RELEASES,
                        labels=self._host_labels)
        METRICS.set_gauge(SERVE_RING_OCCUPANCY,
                          float(len(self._leases)),
                          labels=self._host_labels)

    def disconnect(self, lease: SlotLease) -> None:
        """Clean stream end: release the slot (pending unpacked chunks
        resolve as ``lease-closed`` errors — callers flush with a final
        ``step()`` before disconnecting)."""
        with self._lock:
            self._release_locked(lease, "closed")

    # -- data path --------------------------------------------------------
    def submit(self, lease: SlotLease, rec, l7, offsets, blob,
               gen=None) -> ChunkTicket:
        """Encode one chunk into the stream's slot (host work only)
        and return its completion ticket; the next pack cycle serves
        it. Raises :class:`LeaseExpired` when the lease lapsed
        (reconnect first) and :class:`ShedError` on backpressure
        (``queue-full``) or an armed ``serve.ring_slot`` fault."""
        try:
            faults.maybe_fail(RING_SLOT_POINT)
        except Exception:  # noqa: BLE001 — plan-chosen exception
            with self._stats_lock:
                self.chunk_errors += 1
            self._shed(admission.SHED_FAULT, tenant=lease.tenant)
            raise ShedError(admission.SHED_FAULT)
        now = simclock.now()
        with self._lock:
            if not lease.active or lease.expired(now):
                if lease.active:
                    self._release_locked(lease, "expired")
                raise LeaseExpired(
                    f"lease for {lease.stream_id} lapsed")
            if len(lease.slot.pending) >= self.max_slot_pending:
                self._shed(admission.SHED_QUEUE_FULL,
                           tenant=lease.tenant)
                raise ShedError(admission.SHED_QUEUE_FULL)
            lease.renew(now)
        # the stream's trace context rides the TICKET: the pack thread
        # has no contextvar
        from cilium_tpu_torch.runtime.tracing import TRACER

        ctx = TRACER.current()
        ticket = ChunkTicket(
            len(rec),
            trace_id=ctx.trace_id if ctx is not None else "",
            epoch=getattr(ctx, "epoch", 0) if ctx is not None else 0)
        ticket.tenant = lease.tenant
        # canary sample selection: a monotone chunk counter walked
        # through the controller's deterministic fraction
        if self.canary is not None and self.canary.active():
            with self._stats_lock:
                self._canary_counter += 1
                c = self._canary_counter
            ticket.canary = self.canary.should_sample(c)
        want_explain = (ticket.trace_id and self.provenance
                        and self.explain_sample > 0)
        if want_explain or ticket.canary:
            # sampled flows for the explain plane (traced chunks) and
            # the canary's shadow dispatch: one bounded host
            # reconstruction serves both
            t_obs = simclock.perf()
            try:
                from cilium_tpu_torch.ingest.binary import (
                    records_to_flows_l7,
                )

                k = min(self.explain_sample or 8, len(rec))
                ticket.sample_flows = records_to_flows_l7(
                    rec[:k], l7[:k], offsets, blob,
                    gen=(gen[:k] if gen is not None else None))
            except Exception:  # noqa: BLE001 — explain/canary are
                ticket.sample_flows = None  # advisory; never fail
                ticket.canary = False       # the chunk
            with self._stats_lock:
                self.obs_seconds += max(0.0, simclock.perf() - t_obs)
        # ring.submit takes its own lock; encoding outside ours keeps
        # lease ops responsive while a big chunk featurizes
        try:
            self.ring.submit(lease.slot, rec, l7, offsets, blob,
                             gen=gen, done=ticket)
        except SlotNotResident:
            # the pack thread expired the lease (or a concurrent
            # disconnect released it) between our lease check and the
            # ring call: the lease-lapsed contract
            with self._lock:
                if lease.active:
                    self._release_locked(lease, "closed")
            raise LeaseExpired(
                f"lease for {lease.stream_id} lost its ring slot")
        return ticket

    # -- the pack cycle ---------------------------------------------------
    def _expire_leases(self, now: float) -> int:
        lapsed = 0
        with self._lock:
            heap = self._expiry_heap
            while heap and heap[0][0] <= now:
                _, stream_id = heapq.heappop(heap)
                lease = self._leases.get(stream_id)
                if lease is None or not lease.active:
                    continue          # released/superseded: stale entry
                if lease.expired(now):
                    self._release_locked(lease, "expired")
                    lapsed += 1
                else:
                    # renewed since this entry was pushed: re-arm at
                    # the lease's REAL deadline
                    heapq.heappush(heap, (lease.expires_at, stream_id))
        return lapsed

    def _amap_for(self, engine):
        """AttributionMap for the serving engine, rebuilt on swap."""
        if getattr(self, "_amap_engine", None) is not engine:
            from cilium_tpu_torch.engine.attribution import AttributionMap

            try:
                self._amap = AttributionMap.from_policy(engine.policy)
            except Exception:  # noqa: BLE001 — attribution is
                self._amap = None  # advisory; never fail serving
            self._amap_engine = engine
        return self._amap

    def _resolve_ticket(self, ticket: ChunkTicket, n: int, dev) -> int:
        """Resolve one packed chunk's ticket (verdicts + provenance),
        feed the SLO trackers, and record explain entries for traced
        chunks. Returns records served."""
        prov = None
        if isinstance(dev, ServedPack):  # host lanes: the ring read the
            prov = dev.host()            # pack back once
            verdicts = prov.verdict[:n].astype(np.int32)
        else:
            verdicts = np.asarray(dev)[:n].astype(np.int32)
        ticket.resolve(verdicts, prov=prov)
        lat = max(0.0, simclock.now() - ticket.t_submit)
        METRICS.observe(SERVE_LATENCY, lat, labels=self._host_labels)
        if self.slo is not None:
            self.slo.observe_latency(lat, tenant=ticket.tenant)
            self.slo.observe_request(shed=False,
                                     tenant=ticket.tenant)
        if ticket.canary and self.canary is not None \
                and ticket.sample_flows:
            # the double dispatch: the sampled flows re-evaluate
            # through the STAGED generation, diffed against what N
            # just served — in this pack cycle, metered against it
            t_can = simclock.perf()
            self.canary.observe_chunk(
                ticket.sample_flows,
                verdicts[:len(ticket.sample_flows)])
            with self._stats_lock:
                self.canary_seconds += max(
                    0.0, simclock.perf() - t_can)
        with self._stats_lock:
            if prov is not None:
                self.records_explained += n
            else:
                self.records_unexplained += n
        self.flows.note_served(n)
        if ticket.trace_id:
            # the serving host's span, appended BY id: the pack thread
            # holds no contextvar for the submitter's trace
            from cilium_tpu_torch.runtime.tracing import TRACER

            TRACER.record_remote(
                ticket.trace_id, "serve.chunk", phase="device-dispatch",
                t0=ticket.t_submit, dur=lat, host=self.host_id,
                epoch=ticket.epoch, records=n)
        if ticket.trace_id and ticket.sample_flows and prov is not None:
            from cilium_tpu_torch.runtime.explain import build_entries

            amap = self._amap_for(self.ring.session.engine)
            entries = build_entries(
                ticket.trace_id, "serve", ticket.sample_flows,
                prov.verdict, prov.l7_match, amap,
                gens=prov.gens, memo_hit=prov.memo_hit,
                match_spec=prov.match_spec, kernel=prov.kernel,
                pack_cycle=prov.pack_cycle,
                generation=prov.generation,
                host_id=self.host_id,
                sample=len(ticket.sample_flows),
                tenant=ticket.tenant)
            self.explain.record(ticket.trace_id, entries)
            self.flows.observe_entries(entries)
            LOG.debug("serve chunk explained", extra={"fields": {
                "trace_id": ticket.trace_id, "records": n,
                "sampled": len(entries)}})
        return n

    def _resolve_results(self, results) -> int:
        """Resolve every ticket of one pack's results; chunks whose ids
        predate a session reset resolve as ``session-reset`` errors
        (the payload is gone; the stream retries the chunk)."""
        served = 0
        for _slot, n, ticket, dev in results:
            if ticket is None:
                continue
            if dev is None:
                with self._stats_lock:
                    self.chunk_errors += 1
                ticket.resolve(None, error="session-reset")
                continue
            served += self._resolve_ticket(ticket, n, dev)
        return served

    def step(self) -> int:
        """One pack cycle: expire idle leases, pack + dispatch pending
        chunks, resolve tickets. Returns records served."""
        now = simclock.now()
        self._expire_leases(now)
        pairs = (self.authed_pairs_fn()
                 if self.authed_pairs_fn is not None else None)
        t0 = simclock.perf()
        with self._pack_lock:
            results = self.ring.pack(authed_pairs=pairs)
        if results:
            # per-pack-cycle telemetry: dispatch wall, slot occupancy
            # (SERVE_PACK_RECORDS rides ring.pack)
            METRICS.observe(SERVE_PACK_DISPATCH_SECONDS,
                            max(0.0, simclock.perf() - t0),
                            labels=self._host_labels)
            with self._lock:
                occ = float(len(self._leases))
            METRICS.observe(SERVE_PACK_OCCUPANCY, occ,
                            labels=self._host_labels)
        served = self._resolve_results(results)
        with self._stats_lock:
            self.served_records += served
            if results:
                self.pack_seconds += max(0.0, simclock.perf() - t0)
        if results and self.slo is not None:
            self.slo.publish()
        return served

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._stop:
                    return
            # hold a virtual clock while the pack's REAL compute runs:
            # a dispatch must not read as idle time
            with simclock.hold():
                try:
                    self.step()
                except Exception as e:  # noqa: BLE001 — degrade,
                    # never die: the ring put the batch back, the
                    # next cycle retries (transient faults recover)
                    with self._stats_lock:
                        self.pack_failures += 1
                    LOG.warning("pack cycle failed; retrying next "
                                "interval", extra={"fields": {
                                    "error": f"{type(e).__name__}: "
                                             f"{e}"}})
            simclock.sleep(self.pack_interval_s)

    def start(self) -> "ServeLoop":
        """Spawn the pack thread (virtual-time ready: the interval is a
        ``simclock.sleep``)."""
        if self._thread is None:
            self._thread = threading.Thread(target=self._run,
                                            daemon=True,
                                            name="serve-pack-loop")
            self._thread.start()
        return self

    # -- drain ------------------------------------------------------------
    def drain(self, max_cycles: int = 64) -> int:
        """Stop admitting new leases, pack out every pending chunk
        (bounded cycles — a wedged engine must not wedge the drain),
        then release every lease. Returns records flushed."""
        with self._lock:
            self._draining = True
        flushed = 0
        for _ in range(max_cycles):
            # no lease expiry here: work still pending on live leases
            # flushes even if their TTL lapses mid-drain
            pairs = (self.authed_pairs_fn()
                     if self.authed_pairs_fn is not None else None)
            t0 = simclock.perf()
            with self._pack_lock:
                results = self.ring.pack(authed_pairs=pairs)
            if not results:
                break
            flushed += self._resolve_results(results)
            with self._stats_lock:
                self.pack_seconds += max(0.0, simclock.perf() - t0)
        with self._stats_lock:
            self.served_records += flushed
        with self._lock:
            for lease in list(self._leases.values()):
                self._release_locked(lease, "drained")
        return flushed

    def abandon(self, how: str = "closed") -> int:
        """Host-death face: release EVERY lease without a final pack;
        pending chunks resolve as ``lease-{how}`` errors. Returns the
        number of leases dropped."""
        with self._lock:
            self._draining = True
            dropped = 0
            for lease in list(self._leases.values()):
                self._release_locked(lease, how)
                dropped += 1
        return dropped

    def lease_ids(self) -> list:
        """Stream ids currently holding a live lease here."""
        with self._lock:
            return [sid for sid, lease in self._leases.items()
                    if lease.active]

    def stop(self) -> None:
        with self._lock:
            self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- introspection ----------------------------------------------------
    def lease_books(self) -> Tuple[int, int]:
        """(grants − expiries − releases, occupancy), read together
        under the lease lock: the two sides of the lease-accounting
        invariant without the rest of :meth:`status` (the fleet checks
        them after every driver event)."""
        with self._lock:
            return (self.grants - self.expiries - self.releases,
                    len(self._leases))

    def status(self) -> Dict[str, object]:
        with self._lock:
            occupancy = len(self._leases)
        served = max(1, self.records_explained
                     + self.records_unexplained)
        out = {
            "occupancy": occupancy,
            "capacity": self.ring.capacity,
            "grants": self.grants,
            "expiries": self.expiries,
            "releases": self.releases,
            "sheds": self.sheds,
            "packs": self.ring.packs,
            "records_packed": self.ring.records_packed,
            "served_records": self.served_records,
            "chunk_errors": self.chunk_errors,
            "pack_failures": self.pack_failures,
            "bytes_saved": self.ring.bytes_saved,
            "bytes_shipped": self.ring.bytes_shipped,
            "memo": self.ring.memo_stats(),
            "draining": self._draining,
            "provenance": {
                "enabled": self.provenance,
                "records_explained": self.records_explained,
                "records_unexplained": self.records_unexplained,
                "explain_coverage": round(
                    self.records_explained / served, 6),
                "explain_entries": len(self.explain),
            },
            "flows": {
                "records": self.flows.records,
                "aggregated": self.flows.aggregated,
                "overflow": self.flows.overflow,
                "keys": self.flows.key_count(),
            },
        }
        if self.slo is not None:
            out["slo"] = self.slo.status()
        if self.canary is not None:
            report = self.canary.report()
            report["canary_seconds"] = round(self.canary_seconds, 6)
            report["pack_seconds"] = round(self.pack_seconds, 6)
            out["canary"] = report
        return out
