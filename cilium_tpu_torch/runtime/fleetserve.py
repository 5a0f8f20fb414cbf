"""The horizontal serving FLEET: stream-affinity routing over N agent
replicas, host-death failover with zero stale verdicts, and
fleet-coherent shedding (the reference's ``runtime/fleetserve.py``; the
replicas' loaders stage their engines on the card).

One ServeLoop (runtime/serveloop.py) holds ~100k virtual streams on
one host (runtime/loadmodel.py). The million-stream question is
the next order of magnitude, and it is not a bigger ring — it is a
FLEET: N replicas, each owning a real ServeLoop + VerdictRing +
IncrementalSession, behind a router that keeps every stream's chunks
landing on the replica whose session already knows the stream's rows.
Three properties carry the whole design:

* **Stream affinity by rendezvous.** Placement is highest-random-
  weight (HRW) hashing of (stream, host) over the LIVE host set — no
  central placement table to rebuild, and a host death moves ONLY the
  dead host's streams (every survivor's placement is unchanged by
  construction). A pinned placement survives reconnect-with-resume:
  the stream re-dials, the router routes it home, the live lease
  RENEWS (never a second grant).
* **Host death drains nothing.** A replica's death (hard kill, or
  heartbeats lost past the suspicion TTL) abandons its leases — the
  in-flight chunks resolve as typed errors, which is what the client's
  connection reset looks like, and the chunks REPLAY through the same
  reconnect-with-resume protocol a lease expiry already exercises.
  The router re-grants the dead host's streams on survivors
  (``cilium_tpu_fleet_handoffs_total``); survivors fetch nothing and
  compile nothing — every replica loaded the same policy through the
  content-addressed BankArtifactStore, so the swap path is
  zero-recompile by construction, and the warm rejoin of the dead
  host restores from the same artifacts. No verdict is ever served
  stale: every served verdict cites its generation and
  re-resolves at that citation on whichever replica served it.
* **Shedding is fleet-coherent.** Admission pressure is exchanged as
  per-host occupancy digests on the heartbeat: a saturated host sheds
  explicitly with reason ``host-overloaded`` only when NO live host
  has spill headroom; otherwise the router spills the new stream to
  the next host in its rendezvous order
  (``cilium_tpu_fleet_spilled_streams_total``). A draining host
  refuses new streams with ``host-draining`` (retryable — the router
  re-places on retry). A PARTITIONED host — one that can no longer
  reach the heartbeat plane — fails CLOSED: it refuses to serve
  possibly-stale policy with reason ``partitioned`` rather than
  answer from a world it can no longer verify.

The cross-host handoff also ships a Libra-style residency manifest:
the dead ring exports the content hashes of its session-resident rows
(``VerdictRing.resident_keys``) and each survivor reports how much of
that residency it ALREADY holds (``handoff_overlap``) — the measured
bytes a selective row-id copy avoids re-shipping host-to-device.

Fault points: ``fleet.heartbeat`` fires at every per-host beat (a
fired fault LOSES the beat; enough lost beats push the host through
suspicion into fail-closed death); ``fleet.handoff`` fires at every
per-stream lease migration (a fired fault interrupts the transfer
mid-batch; the unmigrated remainder re-grants through the client
resume path — never on two live hosts, which is the fleet's
lease-conservation invariant).

The lane (:func:`main`) drives the ≥1M-concurrent-stream fleet across
≥4 simulated hosts under the virtual clock, kills a host mid-storm,
partitions another, drains a third, warm-rejoins them all, and prints
one provenance-stamped line (``--out`` appends it to a file). Its
latencies are VIRTUAL, set by the pack interval on the simulation
clock, never a time the card took. All replicas share one process,
one interpreter and one card.

    python -m cilium_tpu_torch.runtime.fleetserve --streams 1050000
"""

from __future__ import annotations

import argparse
import hashlib
import heapq
import json
import os
import random
import shutil
import sys
import tempfile
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from cilium_tpu_torch.parallel.multihost import host_id
from cilium_tpu_torch.runtime import admission, faults, simclock
from cilium_tpu_torch.runtime.explain import ExplainStore, resolve_explain
from cilium_tpu_torch.runtime.loadmodel import (
    Violation,
    _build_policy,
    _Chunk,
)
from cilium_tpu_torch.runtime.logging import get_logger
from cilium_tpu_torch.runtime.metrics import (
    FLEET_FAILOVER_SECONDS,
    FLEET_HANDOFFS,
    FLEET_HOST_DEATHS,
    FLEET_HOST_OCCUPANCY,
    FLEET_JOURNAL_EVENTS,
    FLEET_REJOINS,
    FLEET_SLO_BURN_RATE,
    FLEET_SPILLED_STREAMS,
    FLEET_TRACE_STITCHES,
    METRICS,
)
from cilium_tpu_torch.runtime.serveloop import (
    LeaseExpired,
    ServeLoop,
    ShedError,
)
from cilium_tpu_torch.runtime.tracing import TRACER, TraceContext

LOG = get_logger("fleetserve")

#: fires at every per-host heartbeat in FleetRouter.beat — a fired
#: fault LOSES that beat; beats lost past the suspicion TTL push the
#: host through suspicion into fail-closed death
HEARTBEAT_POINT = faults.register_point(
    "fleet.heartbeat", "per-host heartbeat in FleetRouter.beat (a "
                       "fired fault loses the beat)")
#: fires at every per-stream lease migration during a host-death
#: handoff — a fired fault interrupts the transfer mid-batch; the
#: unmigrated remainder re-grants through the client resume path
HANDOFF_POINT = faults.register_point(
    "fleet.handoff", "per-stream lease migration in "
                     "FleetRouter._handoff (a fired fault interrupts "
                     "the transfer mid-batch)")


#: the fleet event-journal catalog: every membership / suspicion /
#: handoff / drain / rejoin transition the router makes, as an
#: exactly-tick-stamped, causally-ordered journal entry.
JOURNAL_KINDS = (
    "host-join",
    "beat-lost",
    "host-death",
    "handoff",
    "handoff-interrupted",
    "host-partitioned",
    "drain-begin",
    "host-restart",
    "host-rejoin",
)


class FleetJournal:
    """The fleet's membership timeline: bounded, append-only, stamped
    with the installed clock's EXACT tick and a monotone sequence
    number taken under one lock — so two events at the same virtual
    tick (a suspicion death and its handoff) still order causally.
    The DST fleet arm holds the journal consistent with the router's
    exact books after every membership change."""

    def __init__(self, capacity: int = 65536):
        self._lock = threading.Lock()
        self._events: List[Dict] = []
        self.capacity = max(1, int(capacity))
        self._seq = 0
        #: events dropped at the bound (consistency folding refuses
        #: to pretend it saw a truncated history)
        self.dropped = 0

    def record(self, kind: str, host: str = "", **detail) -> None:
        if kind not in JOURNAL_KINDS:
            raise ValueError(f"unknown journal event kind: {kind!r}")
        now = simclock.now()
        with self._lock:
            self._seq += 1
            if len(self._events) >= self.capacity:
                self.dropped += 1
            else:
                self._events.append({
                    "seq": self._seq, "t": round(now, 9),
                    "kind": kind, "host": host,
                    **({"detail": detail} if detail else {})})
        METRICS.inc(FLEET_JOURNAL_EVENTS, labels={"kind": kind})

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return self._seq

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events():
            out[e["kind"]] = out.get(e["kind"], 0) + 1
        return out


class HostDead(RuntimeError):
    """The stream's host died between admit and submit (or its
    placement was dropped by an interrupted handoff). TYPED so the
    client treats it exactly like a lease lapse — reconnect with
    resume and replay the chunk — never as a stream-fatal error."""

    def __init__(self, host: str, detail: str = ""):
        super().__init__(
            f"host {host or '<unplaced>'} is dead{': ' if detail else ''}"
            f"{detail}")
        self.host = host


class HostReplica:
    """One simulated fleet host: a stable identity
    (``parallel/multihost.host_id``), its own ServeLoop (ring +
    incremental session) and its own bounded ExplainStore. The store
    OUTLIVES the loop across death/rejoin — a trace served before the
    host died still resolves after its warm restore, which is what
    keeps ``GET /v1/explain`` regression-pinned across a handoff."""

    def __init__(self, index: int, loader, capacity: int = 1024,
                 lease_ttl_s: float = 300.0,
                 pack_interval_s: float = 0.05,
                 max_slot_pending: int = 8):
        self.index = int(index)
        self.name = host_id(index)
        self.loader = loader
        self.capacity = int(capacity)
        self.lease_ttl_s = float(lease_ttl_s)
        self.pack_interval_s = float(pack_interval_s)
        self.max_slot_pending = int(max_slot_pending)
        #: per-replica explain store (persists across death/rejoin)
        self.explain = ExplainStore()
        self.alive = True
        #: partitioned from the heartbeat plane: the host itself
        #: fails CLOSED (sheds ``partitioned``) while the router's
        #: suspicion clock runs it down
        self.cut = False
        #: planned drain toward a restart: existing leases keep
        #: serving, NEW streams shed ``host-draining``
        self.draining = False
        self.last_beat = simclock.now()
        self.deaths = 0
        self.loop = self._make_loop()

    def _make_loop(self) -> ServeLoop:
        return ServeLoop(self.loader, capacity=self.capacity,
                         lease_ttl_s=self.lease_ttl_s,
                         pack_interval_s=self.pack_interval_s,
                         max_slot_pending=self.max_slot_pending,
                         explain_store=self.explain,
                         host_id=self.name)

    def guard(self, new_stream: bool = False) -> None:
        """The host's own fail-closed gate, checked before any lease
        or chunk touches the loop. Dead → :class:`HostDead` (typed;
        the client resumes elsewhere). Partitioned → shed
        ``partitioned`` (the host refuses possibly-stale service).
        Draining refuses only NEW streams (``host-draining``)."""
        if not self.alive:
            raise HostDead(self.name)
        if self.cut:
            admission.count_shed("fleet", admission.CLASS_DATA,
                                 admission.SHED_PARTITIONED)
            raise ShedError(admission.SHED_PARTITIONED)
        if new_stream and self.draining:
            admission.count_shed("fleet", admission.CLASS_DATA,
                                 admission.SHED_HOST_DRAINING)
            raise ShedError(admission.SHED_HOST_DRAINING)

    def revive(self, loader=None) -> None:
        """Warm restore: a FRESH loop (empty ring — the dead ring's
        residency is gone with the device) over a loader rebuilt from
        the shared bank artifacts; the explain store persists."""
        if loader is not None:
            self.loader = loader
        self.alive = True
        self.cut = False
        self.draining = False
        self.last_beat = simclock.now()
        self.loop = self._make_loop()


class FleetRouter:
    """Stream-affinity router + health plane over the replicas.

    One lock serializes placement mutation (connect / handoff /
    rejoin), which is what makes the lease-conservation invariant —
    no stream holds leases on two LIVE hosts — checkable as a simple
    sweep rather than a protocol. Heartbeats ride the installed
    simulation clock; suspicion is the closed boundary the lease TTL
    already uses (age ≥ TTL = lapsed)."""

    def __init__(self, replicas: Sequence[HostReplica],
                 heartbeat_interval_s: float = 1.0,
                 suspicion_ttl_s: float = 5.0,
                 spill_headroom: float = 0.1):
        self.replicas = list(replicas)
        self._by_name: Dict[str, HostReplica] = {
            r.name: r for r in self.replicas}
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.suspicion_ttl_s = float(suspicion_ttl_s)
        self.spill_headroom = float(spill_headroom)
        self._lock = threading.Lock()
        #: stream id → host name (the affinity table; absent =
        #: unplaced, the next connect re-places by rendezvous)
        self.placements: Dict[str, str] = {}
        #: the exchanged occupancy digest (refreshed per beat, bumped
        #: locally per grant so a burst between beats doesn't
        #: overshoot) — spill/shed decisions read THIS, never a
        #: remote host's instantaneous state
        self._digest: Dict[str, int] = {r.name: 0 for r in self.replicas}
        self.handoffs = 0
        self.host_deaths = 0
        self.rejoins = 0
        self.spilled = 0
        #: handoffs interrupted mid-batch by a ``fleet.handoff`` fault
        #: (the remainder re-granted through client resume)
        self.partial_handoffs = 0
        #: Libra-style selective-copy ledger: dead-ring resident rows
        #: already resident on survivors, and the H2D bytes that
        #: residency avoids re-shipping
        self.handoff_rows_resident = 0
        self.handoff_bytes_avoided = 0
        #: the fleet event journal: every membership
        #: transition, exactly tick-stamped and causally ordered
        self.journal = FleetJournal()
        #: stream id → {"tid", "epoch"}: the stitch context that rides
        #: the lease handoff — a traced stream's replayed chunks adopt
        #: the SAME trace id with a bumped causal epoch, so the kill →
        #: abandon → re-grant → replay sequence is ONE timeline.
        #: Bounded: only traced streams get entries
        self._trace_ctx: Dict[str, Dict] = {}
        self._trace_ctx_cap = 8192
        #: stream id → failover stamps ({"death", "regrant"}): the
        #: death-declared → re-grant → first-verdict-after-replay
        #: latency ledger, bounded per death (histograms need volume,
        #: not totality)
        self._failover: Dict[str, Dict] = {}
        self._failover_cap = 4096
        self.failover_samples: List[float] = []
        #: wall seconds spent on observability bookkeeping (journal,
        #: stitch plumbing, roll-ups) — the ≤2% budget's numerator
        self.obs_seconds = 0.0
        #: last fleet burn-rate roll-up ({slo: {window: {view: rate}}})
        self._fleet_burn: Dict = {}
        for r in self.replicas:
            self.journal.record("host-join", host=r.name,
                                index=r.index)

    # -- placement --------------------------------------------------------
    @staticmethod
    def _score(name: str, stream_id: str) -> int:
        return zlib.crc32(f"{name}|{stream_id}".encode())

    def _rank(self, stream_id: str,
              hosts: Sequence[HostReplica]) -> List[HostReplica]:
        return sorted(hosts, key=lambda r: self._score(r.name,
                                                       stream_id),
                      reverse=True)

    def _headroom_ok(self, r: HostReplica) -> bool:
        cap = r.loop.ring.capacity
        return self._digest.get(r.name, 0) < cap * (
            1.0 - self.spill_headroom)

    def connect(self, stream_id: str, resume: bool = False
                ) -> Tuple[str, object]:
        """Place + admit one stream; returns ``(host name, lease)``.
        A live pinned placement routes home (resume renews, never a
        second grant). A pinned host that DIED unpins and re-places by
        rendezvous over live hosts, spilling past saturated ones;
        every live host past its spill headroom is the fleet-coherent
        shed (``host-overloaded``). A pinned host that is suspected
        but not yet declared (partitioned: cut, still alive) fences
        the stream instead — the host may still think it owns the
        lease and the router cannot reach it to release, so re-placing
        NOW would put the stream live on two hosts; the client sheds
        ``partitioned`` (retryable) until suspicion declares the death
        and the handoff re-grants on a survivor."""
        with self._lock:
            target: Optional[HostReplica] = None
            placed = self.placements.get(stream_id)
            if placed is not None:
                r = self._by_name.get(placed)
                if r is not None and r.alive and r.cut:
                    admission.count_shed("fleet", admission.CLASS_DATA,
                                         admission.SHED_PARTITIONED)
                    raise ShedError(admission.SHED_PARTITIONED)
                if r is not None and r.alive and not r.cut:
                    if r.draining:
                        # pinned to a draining host: refuse
                        # (retryable) and unpin so the retry lands on
                        # a serving host
                        self.placements.pop(stream_id, None)
                        admission.count_shed(
                            "fleet", admission.CLASS_DATA,
                            admission.SHED_HOST_DRAINING)
                        raise ShedError(admission.SHED_HOST_DRAINING)
                    target = r
                else:
                    self.placements.pop(stream_id, None)
            fresh = target is None
            if fresh:
                live = [r for r in self.replicas
                        if r.alive and not r.cut and not r.draining]
                ranked = self._rank(stream_id, live)
                for cand in ranked:
                    if self._headroom_ok(cand):
                        target = cand
                        break
                if target is None:
                    # every live host is past its spill headroom (or
                    # none is live): coherent, explicit shed
                    admission.count_shed(
                        "fleet", admission.CLASS_DATA,
                        admission.SHED_HOST_OVERLOADED)
                    raise ShedError(admission.SHED_HOST_OVERLOADED)
                if ranked and target is not ranked[0]:
                    self.spilled += 1
                    METRICS.inc(FLEET_SPILLED_STREAMS)
            target.guard(new_stream=fresh)
            lease = target.loop.connect(stream_id, resume=resume)
            self.placements[stream_id] = target.name
            self._digest[target.name] = \
                self._digest.get(target.name, 0) + 1
        # a doomed stream re-placing through lazy client resume (the
        # fault-interrupted handoff remainder) closes its death→
        # re-grant stage here instead of in the handoff loop
        self._note_regrant(stream_id)
        return target.name, lease

    def replica_of(self, stream_id: str) -> Optional[HostReplica]:
        with self._lock:
            name = self.placements.get(stream_id)
        return self._by_name.get(name) if name is not None else None

    def submit(self, stream_id: str, lease, sections):
        """Route one chunk (parsed capture sections, ``gen`` rides as
        the fifth section) to the stream's placed host. Raises
        :class:`HostDead` (typed) when the placement died or was
        dropped between admit and submit — the client's resume path,
        never a stream failure — and passes the loop's own
        :class:`LeaseExpired` / :class:`ShedError` through."""
        replica = self.replica_of(stream_id)
        if replica is None:
            raise HostDead("", f"stream {stream_id} has no live "
                               f"placement")
        replica.guard(new_stream=False)
        ctx = TRACER.current()
        if ctx is not None:
            # a client-side trace is active: remember its id so the
            # handoff can carry it to the survivor. Same
            # id → keep the stored entry (its epoch may already be
            # bumped past the client's stale context)
            with self._lock:
                entry = self._trace_ctx.get(stream_id)
                if (entry is None or entry["tid"] != ctx.trace_id) \
                        and len(self._trace_ctx) < self._trace_ctx_cap:
                    self._trace_ctx[stream_id] = {
                        "tid": ctx.trace_id,
                        "epoch": getattr(ctx, "epoch", 0)}
            return replica.loop.submit(lease, *sections)
        with self._lock:
            entry = self._trace_ctx.get(stream_id)
        if entry is not None and TRACER.enabled:
            # client replay with no active context (the reconnect-
            # with-resume path after a host death): the chunk rides
            # the stream's STITCHED trace — same id, bumped epoch —
            # so both hosts' spans land on one timeline
            resume_ctx = TraceContext(entry["tid"], "stream.resume",
                                      epoch=entry["epoch"])
            with TRACER.activate(resume_ctx):
                return replica.loop.submit(lease, *sections)
        return replica.loop.submit(lease, *sections)

    # -- health plane -----------------------------------------------------
    def beat(self) -> List[str]:
        """One heartbeat round on the installed clock: collect each
        live host's beat (an armed ``fleet.heartbeat`` fault LOSES
        it; a partitioned host's beats never arrive), refresh the
        exchanged occupancy digest, then run the suspicion sweep —
        any host whose last beat aged past the suspicion TTL is
        declared dead and handed off. Returns hosts declared dead
        this round."""
        now = simclock.now()
        for r in self.replicas:
            if not r.alive:
                continue
            lost = r.cut
            if not lost:
                try:
                    faults.maybe_fail(HEARTBEAT_POINT)
                except Exception:  # noqa: BLE001 — plan-chosen exc
                    lost = True
                if lost:
                    self.journal.record("beat-lost", host=r.name,
                                        reason="fault")
            if not lost:
                r.last_beat = now
            occ = r.loop.lease_books()[1]
            with self._lock:
                self._digest[r.name] = occ
            METRICS.set_gauge(FLEET_HOST_OCCUPANCY, float(occ),
                              labels={"host": r.name})
        died: List[str] = []
        for r in self.replicas:
            if r.alive and now - r.last_beat >= self.suspicion_ttl_s:
                self._declare_dead(r, partitioned=True)
                died.append(r.name)
        t_obs = simclock.perf()
        self._publish_fleet_slo()
        with self._lock:
            self.obs_seconds += max(0.0, simclock.perf() - t_obs)
        return died

    def _publish_fleet_slo(self) -> Dict:
        """Fleet burn-rate roll-up over the per-replica SLO trackers:
        ``worst`` is the worst single host (the paging
        view — one burning host must not hide behind a quiet fleet),
        ``weighted`` is fleet-weighted by each host's request volume
        over the same window (the capacity view)."""
        per_slo: Dict[str, Dict[str, Dict[str, float]]] = {}
        acc: Dict = {}
        for r in self.replicas:
            if not r.alive:
                continue
            slo = r.loop.slo
            if slo is None:
                continue
            rates = slo.burn_rates()
            totals = slo.window_totals()
            for name, per_window in rates.items():
                for window, rate in per_window.items():
                    key = (name, window)
                    worst, wsum, tsum = acc.get(key, (0.0, 0.0, 0))
                    weight = totals.get(window, 0)
                    acc[key] = (max(worst, rate),
                                wsum + rate * weight, tsum + weight)
        for (name, window), (worst, wsum, tsum) in acc.items():
            weighted = round(wsum / tsum, 4) if tsum else 0.0
            per_slo.setdefault(name, {})[window] = {
                "worst": worst, "weighted": weighted}
            METRICS.set_gauge(FLEET_SLO_BURN_RATE, worst,
                              labels={"slo": name, "window": window,
                                      "view": "worst"})
            METRICS.set_gauge(FLEET_SLO_BURN_RATE, weighted,
                              labels={"slo": name, "window": window,
                                      "view": "weighted"})
        self._fleet_burn = per_slo
        return per_slo

    def partition(self, name: str) -> None:
        """Cut the host off the heartbeat plane: it fails CLOSED on
        its own (sheds ``partitioned``) while suspicion runs down."""
        self._by_name[name].cut = True
        self.journal.record("host-partitioned", host=name)

    def kill(self, name: str) -> int:
        """Hard host death (power loss): declare dead NOW and hand
        the leases off. Returns streams migrated."""
        return self._declare_dead(self._by_name[name],
                                  partitioned=False)

    def begin_drain(self, name: str) -> None:
        """Planned restart, phase 1: stop placing NEW streams on the
        host (they shed ``host-draining`` / re-place); existing
        leases keep serving until :meth:`restart_host`."""
        self._by_name[name].draining = True
        self.journal.record("drain-begin", host=name)

    def restart_host(self, name: str) -> int:
        """Planned restart, phase 2: graceful — pack out every
        pending chunk (nothing is lost), release every lease, leave
        the rotation. The host comes back via :meth:`rejoin`.
        Returns records flushed by the final drain."""
        r = self._by_name[name]
        flushed = r.loop.drain()
        r.alive = False
        with self._lock:
            for sid in [s for s, n in self.placements.items()
                        if n == name]:
                self.placements.pop(sid, None)
        self.journal.record("host-restart", host=name,
                            flushed=flushed)
        return flushed

    def _declare_dead(self, r: HostReplica, partitioned: bool) -> int:
        """Death + handoff, atomically from the fleet's view: the
        dead host's leases are abandoned (in-flight chunks resolve as
        typed errors → client replay) BEFORE any survivor re-grant,
        so no stream ever holds leases on two live hosts. Survivors'
        re-grants ride the normal resume path; an armed
        ``fleet.handoff`` fault interrupts the migration mid-batch
        and the remainder re-grants lazily through client resume."""
        r.alive = False
        r.cut = r.cut or partitioned
        r.deaths += 1
        with self._lock:
            self.host_deaths += 1
        METRICS.inc(FLEET_HOST_DEATHS)
        dropped = r.loop.abandon("closed")
        manifest = r.loop.ring.resident_keys()
        with self._lock:
            doomed = [s for s, n in self.placements.items()
                      if n == r.name]
            for s in doomed:
                self.placements.pop(s, None)
        t_obs = simclock.perf()
        t_death = simclock.now()
        self.journal.record("host-death", host=r.name,
                            partitioned=partitioned,
                            leases=len(doomed))
        with self._lock:
            for s in doomed:
                # the trace context rides the handoff: bump the
                # stream's causal epoch BEFORE any re-grant, so even
                # a fault-interrupted remainder (re-granted lazily
                # through client resume) replays onto the stitched
                # timeline — the fleet.handoff marker is the seam
                # the merged trace shows between the two hosts
                entry = self._trace_ctx.get(s)
                if entry is not None:
                    entry["epoch"] += 1
                    TRACER.event_remote(
                        entry["tid"], "fleet.handoff", host=r.name,
                        epoch=entry["epoch"], stream=s,
                        partitioned=partitioned)
                # failover latency ledger, bounded per death
                if len(self._failover) < self._failover_cap:
                    self._failover[s] = {"death": t_death}
            self.obs_seconds += max(0.0, simclock.perf() - t_obs)
        survivors = [x for x in self.replicas
                     if x.alive and not x.cut]
        for x in survivors:
            rows, avoided = x.loop.ring.handoff_overlap(manifest)
            with self._lock:
                self.handoff_rows_resident += rows
                self.handoff_bytes_avoided += avoided
        migrated = 0
        interrupted = False
        for s in doomed:
            if not survivors:
                break
            try:
                faults.maybe_fail(HANDOFF_POINT)
            except Exception:  # noqa: BLE001 — plan-chosen exception
                # mid-batch interruption: the unmigrated remainder is
                # simply UNPLACED — each stream re-grants through its
                # own reconnect-with-resume, never on two live hosts
                with self._lock:
                    self.partial_handoffs += 1
                interrupted = True
                break
            ranked = self._rank(s, survivors)
            with self._lock:
                target = next((c for c in ranked
                               if self._headroom_ok(c)), ranked[0])
            try:
                target.loop.connect(s, resume=True)
            except ShedError:
                continue  # stays unplaced; client resume retries
            with self._lock:
                # a lost race is self-healing: if a concurrent
                # connect() placed this stream while the lock was
                # dropped for the blocking connect above, the orphaned
                # re-grant lease expires and the client's own
                # placement wins on reconnect
                self.placements[s] = target.name
                self._digest[target.name] = \
                    self._digest.get(target.name, 0) + 1
                self.handoffs += 1
            migrated += 1
            METRICS.inc(FLEET_HANDOFFS)
            self._note_regrant(s)
        t_obs = simclock.perf()
        self.journal.record("handoff", host=r.name,
                            streams=migrated)
        if interrupted:
            self.journal.record("handoff-interrupted", host=r.name,
                                remainder=len(doomed) - migrated)
        with self._lock:
            self.obs_seconds += max(0.0, simclock.perf() - t_obs)
        LOG.warning("host death handled", extra={"fields": {
            "host": r.name, "partitioned": partitioned,
            "leases_dropped": dropped, "migrated": migrated,
            "resident_rows_on_survivors": self.handoff_rows_resident}})
        return migrated

    def _note_regrant(self, stream_id: str) -> None:
        """Stamp the death→re-grant stage of the failover latency
        ledger (called at the handoff re-grant AND at a lazy client
        resume that re-places a doomed stream). The ledger mutates
        under ``_lock`` — a racing ``note_failover_verdict`` pop
        would otherwise leave this stamp on an orphaned dict — and
        the metric is emitted after release (no lock-order edge into
        the metrics registry)."""
        now = simclock.now()
        with self._lock:
            fo = self._failover.get(stream_id)
            if fo is None or "regrant" in fo:
                return
            fo["regrant"] = now
            death = fo["death"]
        METRICS.observe(FLEET_FAILOVER_SECONDS,
                        max(0.0, now - death),
                        labels={"stage": "death-to-regrant"})

    def note_failover_verdict(self, stream_id: str) -> None:
        """Close a stream's failover ledger at its first verdict
        after replay: observes the regrant→verdict and end-to-end
        death→verdict latencies and frees the entry. The driving
        model calls this when a replayed ticket resolves cleanly."""
        now = simclock.now()
        with self._lock:
            fo = self._failover.pop(stream_id, None)
        if fo is None:
            return
        if "regrant" in fo:
            METRICS.observe(FLEET_FAILOVER_SECONDS,
                            max(0.0, now - fo["regrant"]),
                            labels={"stage": "regrant-to-verdict"})
        total = max(0.0, now - fo["death"])
        METRICS.observe(FLEET_FAILOVER_SECONDS, total,
                        labels={"stage": "death-to-verdict"})
        self.failover_samples.append(total)

    def rejoin(self, name: str, loader=None) -> None:
        """Warm restore the dead host back into rotation: fresh loop,
        loader rebuilt from the shared bank artifacts (zero
        recompile), explain store intact, rendezvous set regains the
        host — NEW streams start landing there immediately."""
        r = self._by_name[name]
        r.revive(loader)
        with self._lock:
            self._digest[name] = 0
            self.rejoins += 1
        METRICS.inc(FLEET_REJOINS)
        self.journal.record("host-rejoin", host=name)

    # -- fleet-wide invariants & introspection ----------------------------
    def books(self) -> Tuple[int, int]:
        """(grants − expiries − releases, occupancy) summed over the
        WHOLE fleet — dead hosts balance at zero because abandonment
        releases every lease, so the equality is exact at all
        times."""
        lhs = rhs = 0
        for r in self.replicas:
            books, occupancy = r.loop.lease_books()
            lhs += books
            rhs += occupancy
        return lhs, rhs

    def conservation_violation(self) -> Optional[Tuple[str, str, str]]:
        """The fleet's cardinal invariant: no stream holds leases on
        two LIVE hosts. Returns ``(stream, host_a, host_b)`` on
        violation, ``None`` when conserved."""
        seen: Dict[str, str] = {}
        for r in self.replicas:
            if not r.alive:
                continue
            for sid in r.loop.lease_ids():
                if sid in seen:
                    return sid, seen[sid], r.name
                seen[sid] = r.name
        return None

    def journal_consistent(self) -> Optional[str]:
        """The journal's DST invariant: folding the event
        journal forward must reproduce the router's EXACT fleet books
        — per-host liveness/cut/drain state and the death / rejoin /
        handoff / interruption counters. Returns a description of the
        first divergence, ``None`` when consistent. A truncated
        journal (events dropped at the bound) refuses to certify."""
        if self.journal.dropped:
            return (f"journal truncated: {self.journal.dropped} "
                    f"events dropped at the bound")
        folded: Dict[str, Dict[str, bool]] = {}
        deaths = rejoins = handoffs = interrupted = 0
        for e in self.journal.events():
            host, kind = e["host"], e["kind"]
            st = folded.setdefault(host, {
                "alive": False, "cut": False, "draining": False})
            if kind == "host-join":
                st.update(alive=True, cut=False, draining=False)
            elif kind == "host-partitioned":
                st["cut"] = True
            elif kind == "drain-begin":
                st["draining"] = True
            elif kind == "host-death":
                st["alive"] = False
                if (e.get("detail") or {}).get("partitioned"):
                    st["cut"] = True
                deaths += 1
            elif kind == "host-restart":
                st["alive"] = False
            elif kind == "host-rejoin":
                st.update(alive=True, cut=False, draining=False)
                rejoins += 1
            elif kind == "handoff":
                handoffs += int((e.get("detail") or {})
                                .get("streams", 0))
            elif kind == "handoff-interrupted":
                interrupted += 1
        for r in self.replicas:
            st = folded.get(r.name)
            if st is None:
                return f"host {r.name} never joined the journal"
            actual = {"alive": r.alive, "cut": r.cut,
                      "draining": r.draining}
            if st != actual:
                return (f"host {r.name}: journal folds to {st}, "
                        f"router books say {actual}")
        for label, got, want in (
                ("host-death", deaths, self.host_deaths),
                ("host-rejoin", rejoins, self.rejoins),
                ("handoff streams", handoffs, self.handoffs),
                ("handoff-interrupted", interrupted,
                 self.partial_handoffs)):
            if got != want:
                return (f"{label}: journal folds to {got}, router "
                        f"counters say {want}")
        return None

    def flows(self, limit: Optional[int] = None) -> Dict:
        """The fleet's continuous flow export: per-replica
        FlowAggregator snapshots merged by aggregation key with
        per-host attribution (``hubble/flowagg.merge_snapshots``)."""
        from cilium_tpu_torch.hubble.flowagg import merge_snapshots

        return merge_snapshots(
            r.loop.flows.snapshot(limit=limit)
            for r in self.replicas)

    def trace(self, trace_id: str) -> Dict:
        """The stitched cross-host timeline for one trace id: spans
        merged across every replica that served the stream, ordered
        by (causal epoch, timestamp), host-attributed. In-process
        replicas share the flight recorder, so the fan-out/merge
        degenerates to one stitch over the shared ring."""
        return TRACER.stitch(trace_id)

    def step_all(self) -> int:
        """One pack cycle on every live replica (the driven face)."""
        served = 0
        for r in self.replicas:
            if r.alive:
                served += r.loop.step()
        return served

    def explain(self, trace_id: str) -> Dict:
        """Router-forwarded explain: resolve the trace against
        whichever replica served it — each replica records into its
        OWN store, so the router finds the owner first and re-resolves
        there (at the owner's loader, i.e. the policy the verdict was
        actually served under)."""
        for r in self.replicas:
            if r.explain.get(trace_id):
                out = resolve_explain(r.loader, trace_id,
                                      store=r.explain)
                out["host"] = r.name
                return out
        anchor = self.replicas[0] if self.replicas else None
        return resolve_explain(
            anchor.loader if anchor is not None else None, trace_id,
            store=anchor.explain if anchor is not None else None)

    def status(self) -> Dict[str, object]:
        with self._lock:
            digest = dict(self._digest)
            placements = len(self.placements)
        return {
            "hosts": [{
                "host": r.name, "alive": r.alive, "cut": r.cut,
                "draining": r.draining, "deaths": r.deaths,
                "occupancy_digest": digest.get(r.name, 0),
            } for r in self.replicas],
            "placements": placements,
            "handoffs": self.handoffs,
            "partial_handoffs": self.partial_handoffs,
            "host_deaths": self.host_deaths,
            "rejoins": self.rejoins,
            "spilled_streams": self.spilled,
            "handoff_rows_resident": self.handoff_rows_resident,
            "handoff_bytes_avoided": self.handoff_bytes_avoided,
            "journal": {
                "events": len(self.journal),
                "counts": self.journal.counts(),
                "consistent": self.journal_consistent() is None,
            },
            "fleet_burn_rates": self._fleet_burn,
            "failover_tracked": len(self.failover_samples),
        }


# -- the million-stream fleet load model -------------------------------------

#: event kinds, processed in virtual-time order
(_ARRIVE, _EMIT, _STORM, _BEAT, _KILL, _REJOIN, _PARTITION, _DRAIN,
 _RESTART) = range(9)


class FleetModel:
    """The ≥1M-stream fleet soak (driven mode — byte-deterministic,
    the DST ``fleet`` arm's face). Mirrors
    :class:`~cilium_tpu_torch.runtime.loadmodel.LoadModel` one level up:
    virtual streams arrive through the ROUTER, a seeded active subset
    emits heavy-tailed chunk traffic, reconnect storms churn leases —
    and mid-storm one host is KILLED, another PARTITIONED, a third
    drained for a planned restart, each warm-rejoining later.

    Invariants, checked after every driver event: fleet books exact
    (Σ grants − expiries − releases == Σ occupancy), lease
    conservation after every membership change (no stream leased on
    two live hosts), sampled verdict correctness against the engine's
    ground truth, sampled explanation decode at the CITED generation,
    and no silent losses — every errored in-flight chunk REPLAYS
    through resume until served (bounded attempts, counted)."""

    def __init__(self, seed: int = 0, streams: int = 1_000_000,
                 hosts: int = 4, virtual_s: float = 120.0,
                 ramp_s: float = 30.0, capacity: Optional[int] = None,
                 pack_interval_ms: float = 50.0,
                 lease_ttl_s: float = 600.0,
                 chunk_flows: int = 8, pool_chunks: int = 64,
                 n_rules: int = 60, storms: int = 3,
                 storm_size: int = 2000,
                 active_fraction: float = 0.05,
                 heartbeat_interval_s: float = 1.0,
                 suspicion_ttl_s: float = 5.0,
                 spill_headroom: float = 0.1,
                 pareto_xm_s: float = 30.0, pareto_alpha: float = 1.3,
                 fault_rules: Optional[Sequence] = None,
                 sample_every: int = 64,
                 max_replays: int = 4,
                 trace_sample_every: int = 8, device=None):
        if hosts < 2:
            raise ValueError("a fleet needs >= 2 hosts")
        self.seed = seed
        self.streams = int(streams)
        self.hosts = int(hosts)
        self.virtual_s = float(virtual_s)
        self.ramp_s = float(ramp_s)
        per_host = max(64, int(self.streams / self.hosts * 2))
        self.capacity = (int(capacity) if capacity
                         else 1 << (per_host - 1).bit_length())
        self.pack_interval_s = pack_interval_ms / 1e3
        self.lease_ttl_s = float(lease_ttl_s)
        self.chunk_flows = int(chunk_flows)
        self.pool_chunks = int(pool_chunks)
        self.n_rules = int(n_rules)
        self.storms = int(storms)
        self.storm_size = int(storm_size)
        #: fraction of streams that EMIT chunks (the rest hold leases
        #: — concurrency is a property of residency, not chatter; at
        #: 1M streams the emitting subset keeps wall time sane while
        #: every lease still exercises placement/expiry/handoff)
        self.active_fraction = min(1.0, max(0.0,
                                            float(active_fraction)))
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.suspicion_ttl_s = float(suspicion_ttl_s)
        self.spill_headroom = float(spill_headroom)
        self.pareto_xm_s = float(pareto_xm_s)
        self.pareto_alpha = float(pareto_alpha)
        self.fault_rules = list(fault_rules or ())
        self.sample_every = max(1, int(sample_every))
        self.max_replays = max(1, int(max_replays))
        #: every Nth EMITTING stream carries a trace context end to
        #: end (0 disables) — the stitched-coverage population
        self.trace_sample_every = max(0, int(trace_sample_every))
        #: every replica loader's device (``cuda`` unless named)
        self.device = device
        self.rng = random.Random(seed)
        self.violations: List[Dict] = []
        self.latencies: List[float] = []
        self.submissions = 0
        self.resolved = 0
        self.shed_submits = 0
        self.shed_connects = 0
        self.retries = 0
        self.replays = 0
        self.unrecovered = 0
        self.concurrency_peak = 0
        self.sampled_checks = 0
        self.rejoin_compiles = 0
        self.rejoin_artifact_hits = 0
        #: rejoins whose loader came up with ZERO bank compiles — the
        #: whole compiled policy (or every bank of it) was satisfied
        #: from the shared artifact cache; a cold build of this
        #: policy registers compiles > 0, so zero is real evidence
        self.rejoin_warm_restores = 0
        self.survivor_recompiles = 0
        #: chunk submits made under an active trace context
        self.traced_chunks = 0
        #: replayed chunks whose original ticket died traced on a
        #: closing lease (the stitch-coverage denominator) and the
        #: subset whose replacement ticket carried the SAME trace id
        #: at a HIGHER causal epoch (the numerator)
        self.handoff_replays = 0
        self.stitched_replays = 0

    # -- world ------------------------------------------------------------
    def _build_fleet(self):
        """Shared policy + per-host loaders over ONE artifact cache
        dir (a temporary directory, removed when :meth:`run` ends):
        host 0 compiles, every later host (and every warm
        rejoin) is satisfied from the content-addressed
        BankArtifactStore — the zero-recompile swap path, measured."""
        from cilium_tpu_torch.core.config import Config
        from cilium_tpu_torch.ingest.binary import (
            capture_from_bytes,
            capture_to_bytes,
        )
        from cilium_tpu_torch.runtime.loader import Loader

        per_identity, scenario_flows, _proto = _build_policy(
            self.n_rules, self.chunk_flows)
        self._per_identity = per_identity
        self._cache_dir = tempfile.mkdtemp(prefix="ct_fleet_")

        def mk_loader():
            cfg = Config()
            cfg.enable_tpu_offload = True
            cfg.loader.cache_dir = self._cache_dir
            loader = Loader(cfg, device=self.device)
            loader.regenerate(per_identity, revision=1)
            return loader

        self._mk_loader = mk_loader
        loaders = [mk_loader() for _ in range(self.hosts)]
        engine = loaders[0].engine
        rng = random.Random(self.seed ^ 0x5EED)
        pool: List[_Chunk] = []
        for _ in range(self.pool_chunks):
            flows = [scenario_flows[rng.randrange(len(scenario_flows))]
                     for _ in range(self.chunk_flows)]
            sections = capture_from_bytes(capture_to_bytes(flows))
            truth = [int(v) for v in
                     engine.verdict_flows(flows)["verdict"]]
            pool.append(_Chunk(sections, truth))
        replicas = [HostReplica(i, loaders[i], capacity=self.capacity,
                                lease_ttl_s=self.lease_ttl_s,
                                pack_interval_s=self.pack_interval_s)
                    for i in range(self.hosts)]
        router = FleetRouter(
            replicas, heartbeat_interval_s=self.heartbeat_interval_s,
            suspicion_ttl_s=self.suspicion_ttl_s,
            spill_headroom=self.spill_headroom)
        # compile counters AFTER the build: any later motion on a
        # survivor is a recompile the artifact store failed to avoid
        self._compiles_after_build = {
            r.name: r.loader.bank_status().get("compiles", 0)
            for r in replicas}
        return router, pool

    # -- schedule ---------------------------------------------------------
    def _diurnal(self, t: float) -> float:
        import math

        return 1.0 + 0.6 * math.sin(
            2.0 * math.pi * t / self.virtual_s)

    def _next_interval(self, t: float) -> float:
        u = max(1e-9, 1.0 - self.rng.random())
        gap = self.pareto_xm_s / (u ** (1.0 / self.pareto_alpha))
        return min(gap, self.virtual_s) / self._diurnal(t)

    def _build_events(self) -> List[Tuple[float, int, int, int]]:
        events: List[Tuple[float, int, int, int]] = []
        seq = 0
        stride = max(1, int(round(1.0 / self.active_fraction))) \
            if self.active_fraction > 0 else 0
        for i in range(self.streams):
            t = self.rng.random() * self.ramp_s
            events.append((t, seq, _ARRIVE, i))
            seq += 1
            if stride and i % stride == 0:
                t_emit = t + self.rng.random() * self.pareto_xm_s
                events.append((t_emit, seq, _EMIT, i))
                seq += 1
        span = self.virtual_s - self.ramp_s
        storm_ts = [self.ramp_s + (k + 1) * (span / (self.storms + 1))
                    for k in range(self.storms)]
        for k, t in enumerate(storm_ts):
            events.append((t, seq, _STORM, k))
            seq += 1
        t = self.heartbeat_interval_s
        while t < self.virtual_s:
            events.append((t, seq, _BEAT, 0))
            seq += 1
            t += self.heartbeat_interval_s
        # the failure schedule, pinned to the storm windows: host 1
        # dies mid-storm-1 (hard kill, in-flight chunks replay), host
        # 2 partitions mid-storm-2 (suspicion runs it down), host 3
        # drains for a planned restart after storm 3; all rejoin warm
        half_pack = self.pack_interval_s / 2.0
        if self.storms >= 1 and self.hosts >= 2:
            events.append((storm_ts[0] + half_pack, seq, _KILL, 1))
            seq += 1
            events.append((min(storm_ts[0] + span / 8.0,
                               self.virtual_s - 2.0), seq,
                           _REJOIN, 1))
            seq += 1
        if self.storms >= 2 and self.hosts >= 3:
            events.append((storm_ts[1] + half_pack, seq,
                           _PARTITION, 2))
            seq += 1
            events.append((min(storm_ts[1] + self.suspicion_ttl_s
                               + span / 8.0, self.virtual_s - 1.5),
                           seq, _REJOIN, 2))
            seq += 1
        if self.storms >= 3 and self.hosts >= 4:
            events.append((storm_ts[2] + half_pack, seq, _DRAIN, 3))
            seq += 1
            events.append((storm_ts[2] + half_pack + 2.0, seq,
                           _RESTART, 3))
            seq += 1
            events.append((min(storm_ts[2] + span / 8.0,
                               self.virtual_s - 1.0), seq,
                           _REJOIN, 3))
            seq += 1
        heapq.heapify(events)
        self._seq = seq
        return events

    def _bump(self) -> int:
        self._seq += 1
        return self._seq

    # -- invariants -------------------------------------------------------
    def _check(self, router: FleetRouter, index: int) -> None:
        lhs, rhs = router.books()
        occ = rhs
        self.concurrency_peak = max(self.concurrency_peak, occ)
        if lhs != rhs:
            raise Violation(
                index, "fleet-lease-accounting",
                f"Σ(grants-expiries-releases) {lhs} != Σ occupancy "
                f"{rhs}")

    def _check_conservation(self, router: FleetRouter,
                            index: int) -> None:
        bad = router.conservation_violation()
        if bad is not None:
            raise Violation(
                index, "lease-conservation",
                f"stream {bad[0]} leased on BOTH {bad[1]} and "
                f"{bad[2]}")

    def _sweep(self, router, pool, leases, outstanding,
               index: int) -> None:
        """Collect resolved tickets. An errored ticket (host death,
        lease lapse, drain) REPLAYS through reconnect-with-resume —
        at-least-once, bounded attempts, every loss counted."""
        keep = []
        for ticket, chunk, stream, attempt in outstanding:
            if not ticket.done:
                keep.append((ticket, chunk, stream, attempt))
                continue
            self.resolved += 1
            if ticket.error is not None:
                self.retries += 1
                if attempt + 1 >= self.max_replays:
                    self.unrecovered += 1
                    continue
                t2 = self._replay(router, leases, pool, chunk,
                                  stream)
                if t2 is not None:
                    # stitch coverage, measured STRUCTURALLY: a chunk
                    # that died traced on a closing lease must replay
                    # under the SAME trace id at a HIGHER causal
                    # epoch — one timeline across both hosts,
                    # independent of trace-ring retention
                    if ticket.error == "lease-closed" \
                            and ticket.trace_id:
                        self.handoff_replays += 1
                        if t2.trace_id == ticket.trace_id \
                                and t2.epoch > ticket.epoch:
                            self.stitched_replays += 1
                            METRICS.inc(FLEET_TRACE_STITCHES)
                    keep.append((t2, chunk, stream, attempt + 1))
                continue
            if attempt > 0:
                # first clean verdict after a replay closes the
                # stream's failover-latency ledger on the router
                router.note_failover_verdict(f"vs{stream}")
            lat = ticket.latency
            if lat is not None:
                self.latencies.append(lat)
            if self.resolved % self.sample_every == 0:
                self.sampled_checks += 1
                got = [int(v) for v in ticket.verdicts]
                if got != chunk.truth:
                    raise Violation(
                        index, "verdict-correctness",
                        f"stream {stream}: fleet verdicts diverged "
                        f"from the engine's direct verdicts")
                self._check_explainable(router, ticket, chunk,
                                        stream, index)
        outstanding[:] = keep

    def _replay(self, router, leases, pool, chunk, stream):
        """One resume-and-resubmit attempt for an errored chunk."""
        sid = f"vs{stream}"
        try:
            _, lease = router.connect(sid, resume=True)
            leases[stream] = lease
            ticket = router.submit(sid, lease, chunk.sections)
            self.replays += 1
            self.submissions += 1
            return ticket
        except (ShedError, LeaseExpired, HostDead):
            self.unrecovered += 1
            return None

    def _check_explainable(self, router, ticket, chunk, stream,
                           index: int) -> None:
        """Sampled explanation decode at the CITED generation — the
        fleet face of the provenance honesty invariant: no matter which
        replica served (or re-served, post-handoff) the chunk, its
        provenance must decode and its cited generations must be in
        (0, current]."""
        import numpy as np

        from cilium_tpu_torch.engine.memo import policy_generation

        prov = ticket.prov
        if prov is None:
            raise Violation(index, "explain-coverage",
                            f"stream {stream}: served chunk carried "
                            f"no provenance bundle")
        gens = np.asarray(prov.gens)
        gen_now = policy_generation()
        for r in range(len(gens)):
            if not (0 < int(gens[r]) <= gen_now):
                raise Violation(
                    index, "explain-undecodable",
                    f"stream {stream} row {r}: cited generation "
                    f"{int(gens[r])} outside (0, {gen_now}]")

    # -- events -----------------------------------------------------------
    def _arrive(self, router, leases, i, events) -> None:
        try:
            _, leases[i] = router.connect(f"vs{i}")
        except (ShedError, HostDead):
            self.shed_connects += 1
            heapq.heappush(events, (simclock.now() + 1.0,
                                    self._bump(), _ARRIVE, i))

    def _emit(self, router, leases, pool, outstanding, i, events,
              index) -> None:
        lease = leases.get(i)
        if lease is None:
            return
        chunk = pool[(i * 2654435761 + index) % len(pool)]
        sid = f"vs{i}"
        traced = (self.trace_sample_every > 0
                  and i % self.trace_sample_every == 0)
        try:
            if traced:
                # deterministic stride: every Nth emitting stream
                # carries a trace context; the router pins it so
                # post-handoff replays resume the SAME timeline
                with TRACER.trace("stream.chunk", stream=sid):
                    ticket = router.submit(sid, lease,
                                           chunk.sections)
                self.traced_chunks += 1
            else:
                ticket = router.submit(sid, lease, chunk.sections)
            outstanding.append((ticket, chunk, i, 0))
            self.submissions += 1
        except (LeaseExpired, HostDead):
            # lease lapsed OR the host died under the stream: the
            # SAME client protocol recovers both — reconnect with
            # resume, replay the chunk
            leases.pop(i, None)
            try:
                _, leases[i] = router.connect(sid, resume=True)
                ticket = router.submit(sid, leases[i],
                                       chunk.sections)
                outstanding.append((ticket, chunk, i, 0))
                self.submissions += 1
                self.retries += 1
            except (ShedError, LeaseExpired, HostDead):
                self.shed_connects += 1
        except ShedError:
            self.shed_submits += 1
        t_next = simclock.now() + self._next_interval(simclock.now())
        if t_next < self.virtual_s:
            heapq.heappush(events, (t_next, self._bump(), _EMIT, i))

    def _storm(self, router, leases, pool, outstanding,
               index) -> None:
        """Reconnect storm through the ROUTER: live leases renew on
        their placed host without a second grant (affinity held);
        streams whose host died re-place on a survivor."""
        ids = [self.rng.randrange(self.streams)
               for _ in range(min(self.storm_size, self.streams))]
        for i in ids:
            old = leases.get(i)
            grants_before = sum(r.loop.grants
                                for r in router.replicas)
            try:
                _, lease = router.connect(f"vs{i}", resume=True)
            except (ShedError, HostDead):
                self.shed_connects += 1
                leases.pop(i, None)
                continue
            if lease is old and sum(
                    r.loop.grants
                    for r in router.replicas) != grants_before:
                raise Violation(
                    index, "lease-double-grant",
                    f"stream {i}: reconnect-with-resume renewed a "
                    f"live lease AND counted a grant")
            leases[i] = lease
            chunk = pool[i % len(pool)]
            try:
                ticket = router.submit(f"vs{i}", lease,
                                       chunk.sections)
                outstanding.append((ticket, chunk, i, 0))
                self.submissions += 1
            except (ShedError, LeaseExpired, HostDead):
                self.shed_submits += 1

    def _survivor_compile_delta(self, router) -> int:
        delta = 0
        for r in router.replicas:
            base = self._compiles_after_build.get(r.name)
            if base is None:
                continue
            delta += max(0, r.loader.bank_status().get("compiles", 0)
                         - base)
        return delta

    def _kill(self, router, index, host_idx) -> None:
        name = router.replicas[host_idx].name
        before = self._survivor_compile_delta(router)
        router.kill(name)
        self.survivor_recompiles += \
            self._survivor_compile_delta(router) - before
        self._check_conservation(router, index)

    def _rejoin(self, router, index, host_idx) -> None:
        name = router.replicas[host_idx].name
        if router.replicas[host_idx].alive:
            return  # suspicion never fired (no-op rejoin)
        loader = self._mk_loader()
        bs = loader.bank_status()
        self.rejoin_compiles += bs.get("compiles", 0)
        self.rejoin_artifact_hits += bs.get("artifact_hits", 0)
        if bs.get("compiles", 0) == 0:
            self.rejoin_warm_restores += 1
        router.rejoin(name, loader)
        # track the restored host's compile counter from here on
        self._compiles_after_build[name] = bs.get("compiles", 0)
        self._check_conservation(router, index)

    def _run_event(self, router, pool, events, leases, outstanding,
                   kind, arg, index) -> None:
        membership = kind in (_KILL, _REJOIN, _PARTITION, _DRAIN,
                              _RESTART)
        if kind == _ARRIVE:
            self._arrive(router, leases, arg, events)
        elif kind == _EMIT:
            self._emit(router, leases, pool, outstanding, arg,
                       events, index)
        elif kind == _STORM:
            self._storm(router, leases, pool, outstanding, index)
        elif kind == _BEAT:
            before = self._survivor_compile_delta(router)
            died = router.beat()
            if died:
                membership = True
                self.survivor_recompiles += \
                    self._survivor_compile_delta(router) - before
                self._check_conservation(router, index)
        elif kind == _KILL:
            self._kill(router, index, arg)
        elif kind == _REJOIN:
            self._rejoin(router, index, arg)
        elif kind == _PARTITION:
            router.partition(router.replicas[arg].name)
        elif kind == _DRAIN:
            router.begin_drain(router.replicas[arg].name)
        elif kind == _RESTART:
            router.restart_host(router.replicas[arg].name)
            self._check_conservation(router, index)
        if membership:
            # the journal's DST invariant: after EVERY membership
            # change, folding the event journal must reproduce the
            # router's exact fleet books
            msg = router.journal_consistent()
            if msg is not None:
                raise Violation(index, "fleet-journal-consistency",
                                msg)
        self._check(router, index)

    # -- the run ----------------------------------------------------------
    def run(self) -> Dict:
        clock = simclock.VirtualClock(poll=0.001)
        plan = faults.FaultPlan(rules=self.fault_rules,
                                seed=self.seed)
        result: Dict = {}
        # the model owns its trace sampling stride (every Nth
        # emitting stream), so the flight recorder itself runs
        # unsampled for the run; restored after — callers (tests,
        # the DST arm) keep their own tracer state
        prev_enabled, prev_rate = TRACER.enabled, TRACER.sample_rate
        TRACER.configure(enabled=True, sample_rate=1.0)
        try:
            result = self._run(clock, plan)
        finally:
            TRACER.configure(enabled=prev_enabled,
                             sample_rate=prev_rate)
            cache_dir = getattr(self, "_cache_dir", None)
            if cache_dir is not None:
                shutil.rmtree(cache_dir, ignore_errors=True)
        return result

    def _run(self, clock, plan) -> Dict:
        result: Dict = {}
        with simclock.use(clock):
            router, pool = self._build_fleet()
            self._router = router
            base = self._baseline(router, pool, clock)
            with faults.inject(plan):
                try:
                    index = self._drive(router, pool, clock)
                except Violation as v:
                    index = v.index
                    self.violations.append({
                        "index": v.index, "invariant": v.invariant,
                        "detail": v.detail})
            # graceful end: drain every live replica, then the final
            # invariant sweep over the whole fleet
            for r in router.replicas:
                if r.alive:
                    r.loop.drain()
            try:
                self._check(router, index + 1)
                self._check_conservation(router, index + 1)
            except Violation as v:
                self.violations.append({
                    "index": v.index, "invariant": v.invariant,
                    "detail": v.detail})
            result = self._result(router, base, clock)
        return result

    def _baseline(self, router: FleetRouter, pool, clock) -> float:
        """Unloaded p99 on one replica — the intra-run denominator
        (the cross-round single-host baseline comes from the
        serve-soak artifact in :func:`main`)."""
        r0 = router.replicas[0]
        lease = r0.loop.connect("baseline")
        lats: List[float] = []
        for k in range(20):
            chunk = pool[k % len(pool)]
            ticket = r0.loop.submit(lease, *chunk.sections)
            clock.advance(self.pack_interval_s)
            r0.loop.step()
            if ticket.done and ticket.latency is not None:
                lats.append(ticket.latency)
        r0.loop.disconnect(lease)
        lats.sort()
        return lats[min(len(lats) - 1, int(0.99 * len(lats)))] \
            if lats else self.pack_interval_s

    def _drive(self, router, pool, clock) -> int:
        events = self._build_events()
        leases: Dict[int, object] = {}
        outstanding: List = []
        index = 0
        next_step = clock.now() + self.pack_interval_s
        while events:
            if events[0][0] <= next_step:
                t, _seq, kind, arg = heapq.heappop(events)
                clock.advance_to(t)
                index += 1
                self._run_event(router, pool, events, leases,
                                outstanding, kind, arg, index)
            else:
                clock.advance_to(next_step)
                router.step_all()
                next_step += self.pack_interval_s
                self._sweep(router, pool, leases, outstanding, index)
        # settle the tail: packs + replays until quiet (bounded)
        for _ in range(self.max_replays * 2):
            clock.advance(self.pack_interval_s)
            router.step_all()
            self._sweep(router, pool, leases, outstanding, index)
            if not outstanding:
                break
        for _ticket, _chunk, _stream, _attempt in outstanding:
            self.unrecovered += 1
        return index

    def _result(self, router: FleetRouter, base_p99: float,
                clock) -> Dict:
        lats = sorted(self.latencies)

        def pct(q):
            return (lats[min(len(lats) - 1, int(q * len(lats)))]
                    if lats else 0.0)

        shed_total = self.shed_submits + self.shed_connects
        denom = max(1, self.submissions + shed_total)
        explained = unexplained = served = packs = 0
        flow_records = flows_aggregated = 0
        flow_keys = flow_overflow = 0
        obs_seconds = router.obs_seconds
        for r in router.replicas:
            st = r.loop.status()
            prov = st.get("provenance", {})
            explained += prov.get("records_explained", 0)
            unexplained += prov.get("records_unexplained", 0)
            served += st["served_records"]
            packs += st["packs"]
            fl = r.loop.flows
            flow_records += fl.records
            flows_aggregated += fl.aggregated
            flow_keys += fl.key_count()
            flow_overflow += fl.overflow
            obs_seconds += r.loop.obs_seconds
        fleet = router.status()
        p99_burn = (fleet.get("fleet_burn_rates") or {}).get(
            "serve-p99") or {}
        wkey = min(p99_burn, key=lambda w: int(w.rstrip("s"))) \
            if p99_burn else None
        fo = sorted(router.failover_samples)
        failover_p99 = fo[min(len(fo) - 1, int(0.99 * len(fo)))] \
            if fo else 0.0
        return {
            "seed": self.seed,
            "streams": self.streams,
            "hosts": self.hosts,
            "capacity_per_host": self.capacity,
            "concurrency_peak": self.concurrency_peak,
            "virtual_s": self.virtual_s,
            "simulated_s": round(clock.simulated, 3),
            "active_fraction": self.active_fraction,
            "submissions": self.submissions,
            "resolved": self.resolved,
            "served_records": served,
            "packs": packs,
            "sheds": shed_total,
            "shed_rate": round(shed_total / denom, 6),
            "retries": self.retries,
            "replays": self.replays,
            "unrecovered": self.unrecovered,
            "sampled_checks": self.sampled_checks,
            "handoffs": fleet["handoffs"],
            "partial_handoffs": fleet["partial_handoffs"],
            "host_deaths": fleet["host_deaths"],
            "rejoins": fleet["rejoins"],
            "spilled_streams": fleet["spilled_streams"],
            "handoff_rows_resident": fleet["handoff_rows_resident"],
            "handoff_bytes_avoided": fleet["handoff_bytes_avoided"],
            "survivor_recompiles": self.survivor_recompiles,
            "rejoin_compiles": self.rejoin_compiles,
            "rejoin_artifact_hits": self.rejoin_artifact_hits,
            "rejoin_warm_restores": self.rejoin_warm_restores,
            "records_explained": explained,
            "records_unexplained": unexplained,
            "explain_coverage": round(
                explained / max(1, explained + unexplained), 6),
            "traced_chunks": self.traced_chunks,
            "handoff_replays": self.handoff_replays,
            "stitched_replays": self.stitched_replays,
            "stitch_coverage": round(
                self.stitched_replays / self.handoff_replays, 6)
            if self.handoff_replays else 1.0,
            "flow_records": flow_records,
            "flows_aggregated": flows_aggregated,
            "flow_keys": flow_keys,
            "flow_overflow": flow_overflow,
            "journal_events": fleet["journal"]["events"],
            "journal_consistent": fleet["journal"]["consistent"],
            "burn_worst": p99_burn[wkey]["worst"] if wkey else 0.0,
            "burn_weighted": p99_burn[wkey]["weighted"]
            if wkey else 0.0,
            "failover_p99_ms": round(failover_p99 * 1e3, 3),
            "failover_tracked": len(router.failover_samples),
            "obs_seconds": round(obs_seconds, 6),
            "obs_budget_pct": 2.0,
            "p50_ms": round(pct(0.50) * 1e3, 3),
            "p99_ms": round(pct(0.99) * 1e3, 3),
            "p99_unloaded_ms": round(base_p99 * 1e3, 3),
            "p99_ratio": round(pct(0.99) / max(base_p99, 1e-9), 3),
            "violations": list(self.violations),
        }


# -- the serve-fleet lane -----------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    from cilium_tpu_torch.core.config import Config

    # the [fleet] config block (core/config.FleetConfig, env
    # CILIUM_TPU_FLEET_*) seeds the lane's topology/health defaults;
    # flags override per-run
    fcfg = Config.from_env().fleet
    ap = argparse.ArgumentParser(
        description="million-stream serving-fleet soak: stream-"
                    "affinity routing, host-death failover, "
                    "fleet-coherent shedding (DST driven)")
    ap.add_argument("--streams", type=int, default=1_050_000)
    ap.add_argument("--hosts", type=int, default=fcfg.replicas)
    ap.add_argument("--seed", type=int,
                    default=int(os.environ.get("CILIUM_TPU_DST_SEED",
                                               "0") or 0))
    ap.add_argument("--virtual-s", type=float, default=120.0)
    ap.add_argument("--pack-interval-ms", type=float, default=50.0)
    ap.add_argument("--lease-ttl-s", type=float, default=600.0)
    ap.add_argument("--active-fraction", type=float, default=0.02,
                    help="fraction of streams emitting chunk traffic "
                         "(every stream holds a lease)")
    ap.add_argument("--storms", type=int, default=3)
    ap.add_argument("--storm-size", type=int, default=2000)
    ap.add_argument("--heartbeat-interval-s", type=float,
                    default=fcfg.heartbeat_interval_s)
    ap.add_argument("--suspicion-ttl-s", type=float,
                    default=fcfg.suspicion_ttl_s)
    ap.add_argument("--spill-headroom", type=float,
                    default=fcfg.spill_headroom)
    ap.add_argument("--faults", type=int, default=8,
                    help="fleet.heartbeat/fleet.handoff fires to arm "
                         "(seeded; 0 disables)")
    ap.add_argument("--p99-factor", type=float, default=2.0,
                    help="aggregate p99 ceiling as a multiple of the "
                         "single-host serve-soak baseline")
    ap.add_argument("--max-shed-rate", type=float, default=0.02)
    ap.add_argument("--target-concurrency", type=int, default=0,
                    help="gate floor (default: 95%% of --streams)")
    ap.add_argument("--no-p99-gate", action="store_true",
                    help="smoke mode: skip the p99-vs-baseline gate "
                         "(tiny runs are all fixed overhead)")
    ap.add_argument("--min-handoffs", type=int, default=400,
                    help="gate floor on handed-off streams (the "
                         "stitch-coverage population; smoke runs "
                         "set 1)")
    ap.add_argument("--trace-sample-every", type=int, default=8,
                    help="every Nth emitting stream carries a trace "
                         "context end to end (0 disables)")
    ap.add_argument("--single-host-p99-ms", type=float, default=None,
                    help="the serve soak's virtual p99 on this device "
                         "(the p99 gate's denominator; default: the "
                         "run's own unloaded baseline)")
    ap.add_argument("--device", default=None,
                    help="the replicas' device (default cuda)")
    ap.add_argument("--out", default="",
                    help="append the stamped line to this file too")
    args = ap.parse_args(argv)

    rules = []
    if args.faults > 0:
        rules = [
            faults.FaultRule("fleet.heartbeat", prob=0.002,
                             times=args.faults),
            faults.FaultRule("fleet.handoff", prob=0.01,
                             times=args.faults),
        ]
    t0 = simclock.perf()
    model = FleetModel(
        seed=args.seed, streams=args.streams, hosts=args.hosts,
        virtual_s=args.virtual_s,
        pack_interval_ms=args.pack_interval_ms,
        lease_ttl_s=args.lease_ttl_s,
        active_fraction=args.active_fraction,
        storms=args.storms, storm_size=args.storm_size,
        heartbeat_interval_s=args.heartbeat_interval_s,
        suspicion_ttl_s=args.suspicion_ttl_s,
        spill_headroom=args.spill_headroom,
        fault_rules=rules,
        trace_sample_every=args.trace_sample_every,
        device=args.device)
    result = model.run()
    wall_s = simclock.perf() - t0
    result["wall_s"] = round(wall_s, 3)
    result["speedup_vs_real_time"] = round(
        result["simulated_s"] / max(wall_s, 1e-9), 1)
    result["obs_overhead_pct"] = round(
        100.0 * result["obs_seconds"] / max(wall_s, 1e-9), 3)

    base_ms = args.single_host_p99_ms
    result["single_host_p99_ms"] = base_ms
    target = args.target_concurrency or int(0.95 * args.streams)
    p99_ok = True
    if not args.no_p99_gate:
        if base_ms is not None:
            p99_ok = result["p99_ms"] <= args.p99_factor * base_ms
        else:
            p99_ok = result["p99_ratio"] <= args.p99_factor
    gates = {
        "violations": len(result["violations"]) == 0,
        "concurrency": result["concurrency_peak"] >= target,
        "hosts": args.hosts >= 4,
        "p99": p99_ok,
        "shed_rate": result["shed_rate"] <= args.max_shed_rate,
        "deaths": result["host_deaths"] >= 1,
        "rejoins": result["rejoins"] >= 1,
        "handoffs": result["handoffs"] >= max(1, args.min_handoffs),
        # fleet observability plane: handoff-replayed
        # chunks keep ONE causally-ordered trace (≥99%), flows export
        # continuously, the event journal folds to the router's exact
        # books, and the whole plane stays under its ≤2% wall budget
        "stitch_coverage": result["stitch_coverage"] >= 0.99,
        "flow_export": result["flows_aggregated"] > 0,
        "journal_consistent": bool(result["journal_consistent"]),
        "obs_overhead": (result["obs_overhead_pct"]
                         <= result["obs_budget_pct"]),
        # the zero-recompile swap path: survivors compiled nothing
        # during any handoff, and every warm rejoin came entirely
        # from the shared policy/bank artifact store (a cold build
        # of this policy registers compiles > 0)
        "zero_recompile": (result["survivor_recompiles"] == 0
                           and result["rejoin_compiles"] == 0
                           and result["rejoin_warm_restores"] >= 1),
        # zero stale / zero lost: every error replayed to a verdict
        "no_losses": result["unrecovered"] == 0,
    }
    result["gates"] = {k: bool(v) for k, v in gates.items()}

    from cilium_tpu_torch.runtime.provenance import stamp

    os.environ["CILIUM_TPU_DST_SEED"] = str(args.seed)
    os.environ["CILIUM_TPU_DST_DIGEST"] = hashlib.sha256(
        json.dumps({"streams": args.streams, "hosts": args.hosts,
                    "seed": args.seed, "virtual_s": args.virtual_s},
                   sort_keys=True).encode()).hexdigest()[:16]
    line = stamp({
        "metric": "fleet_serve_p99_ms",
        "value": result["p99_ms"],
        "unit": "ms submit->verdict aggregate p99 (virtual)",
        "lane": "serve-fleet",
        **{k: v for k, v in result.items() if k != "violations"},
        "violations": len(result["violations"]),
    })
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as fp:
            fp.write(json.dumps(line) + "\n")

    ok = all(gates.values())
    print(f"[serve-fleet] {result['concurrency_peak']} concurrent "
          f"virtual streams (target {target}) across {args.hosts} "
          f"hosts; {result['host_deaths']} deaths / "
          f"{result['rejoins']} rejoins / {result['handoffs']} "
          f"handoffs ({result['partial_handoffs']} interrupted), "
          f"{result['spilled_streams']} spilled; "
          f"{result['submissions']} chunks / "
          f"{result['served_records']} records over "
          f"{result['packs']} packs; virtual p99 {result['p99_ms']}ms "
          f"(single-host {base_ms}ms), shed rate "
          f"{result['shed_rate']}, replays {result['replays']}, "
          f"unrecovered {result['unrecovered']}; "
          f"{result['rejoin_warm_restores']} warm restores / "
          f"{result['rejoin_compiles']} rejoin compiles; stitch "
          f"coverage {result['stitch_coverage']} over "
          f"{result['handoff_replays']} handoff replays "
          f"({result['traced_chunks']} traced chunks), "
          f"{result['flows_aggregated']} flows aggregated into "
          f"{result['flow_keys']} keys "
          f"(overflow {result['flow_overflow']}), journal "
          f"{result['journal_events']} events "
          f"{'consistent' if result['journal_consistent'] else 'INCONSISTENT'}, "
          f"burn worst/weighted {result['burn_worst']}/"
          f"{result['burn_weighted']}, failover p99 "
          f"{result['failover_p99_ms']}ms "
          f"({result['failover_tracked']} tracked), obs overhead "
          f"{result['obs_overhead_pct']}%; simulated "
          f"{result['simulated_s']:.0f}s in {wall_s:.1f}s wall "
          f"({result['speedup_vs_real_time']}x); gates "
          f"{'OK' if ok else 'FAILED ' + str(result['gates'])}",
          flush=True)
    if result["violations"]:
        print(f"[serve-fleet] violations: {result['violations']}",
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
