"""DST-driven load model for the serving loop: production scale
without production hardware (the reference's ``runtime/loadmodel.py``,
serving from the port's ``Loader`` on the card).

The serve soak's question is the million-stream one:
does the continuously-batched serving plane (runtime/serveloop.py +
engine/ring.py) hold its latency and shed discipline with ≥100k
CONCURRENT streams? Real traffic at that scale can't run on a CI
host — but its *statistics* can, as virtual streams under the
simulation clock (runtime/simclock.py):

* **Heavy-tailed emission.** Per-stream chunk cadence is Pareto — a
  few chatty streams, a long quiet tail — which is what makes
  continuous batching the right shape: any single pack cycle sees a
  small, changing subset of streams.
* **Diurnal swing.** The emission rate swells and ebbs over one
  compressed virtual "day", so the loop crosses load levels instead
  of sitting at one operating point.
* **Reconnect storms.** Burst reconnect-with-resume over a seeded
  sample of streams — live leases must be RENEWED (never granted, so
  never double-counted), expired ones re-granted, and the at-least-
  once chunk replay must stay verdict-deterministic.
* **Seeded faults.** ``serve.lease`` / ``serve.ring_slot`` fire per
  the plan; every fired fault is an explicit counted shed, never a
  hang or a wrong verdict.

Invariants, checked after EVERY driver event (a violation names the
event index): lease accounting exact (grants − expiries − releases ==
occupancy ≤ capacity), sampled verdict correctness (resolved tickets
bit-equal to the engine's direct verdicts for the chunk's flows),
memo-accounting honesty, and no silent losses (every submission
resolves, sheds, or errors — nothing vanishes). End-of-run gates:
zero violations, concurrency peak ≥ target, p99 ≤ ``p99-factor`` ×
the unloaded baseline, shed rate ≤ bound.

Two clock modes: ``thread`` (default — the PRODUCTION pack thread
under an autojumping VirtualClock) and ``driven`` (inline
``ServeLoop.step``, byte-deterministic). Latencies (``p50_ms``,
``p99_ms``) are VIRTUAL: set by the pack interval on the simulation
clock, never a time the card took. The lane prints one
provenance-stamped line (``--out`` appends it to a file too).

The reference blends protocol-frontend traffic into the pool
(``protocol_mix``, its lane default 0.2); the cassandra, memcache and
r2d2 frontends are not ported yet (queue 1, Q5), so any
``protocol_mix`` other than 0 raises ``NotImplementedError`` naming
Q5.

    python -m cilium_tpu_torch.runtime.loadmodel --streams 100000
"""

from __future__ import annotations

import argparse
import hashlib
import heapq
import json
import math
import os
import random
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from cilium_tpu_torch.runtime import faults, simclock
from cilium_tpu_torch.runtime.serveloop import (
    LeaseExpired,
    ServeLoop,
    ShedError,
)

#: event kinds, processed in virtual-time order
_ARRIVE, _EMIT, _STORM = 0, 1, 2


class _Chunk:
    """One pooled chunk: parsed capture sections + the engine's
    ground-truth verdicts (the sampled-correctness oracle)."""

    __slots__ = ("sections", "truth", "n")

    def __init__(self, sections, truth):
        self.sections = sections
        self.truth = truth
        self.n = len(truth)


class Violation(AssertionError):
    def __init__(self, index: int, name: str, detail: str):
        super().__init__(f"event {index}: [{name}] {detail}")
        self.index = index
        self.invariant = name
        self.detail = detail


def _require_http_only(protocol_mix: float) -> None:
    if protocol_mix != 0:
        raise NotImplementedError(
            f"protocol_mix={protocol_mix}: the protocol frontends "
            f"(cassandra, memcache, r2d2) arrive with queue 1, Q5; "
            f"this port serves protocol_mix=0 only")


def _build_policy(n_rules: int, chunk_flows: int,
                  protocol_mix: float = 0.0):
    """The policy half of the world: the http synth scenario → realized
    per-identity rule sets + the flow pool chunks draw from. Split out of
    :func:`_build_world` so the serving FLEET (runtime/fleetserve.py)
    can regenerate the SAME policy on every replica loader — identical
    rules per host is the precondition for cross-host handoff serving
    identical verdicts, and for the bank-artifact store satisfying
    every host after the first without a recompile."""
    from cilium_tpu_torch.ingest import synth

    _require_http_only(protocol_mix)
    n_flows = max(1024, chunk_flows * 8)
    sc_http = synth.scenario_by_name("http", n_rules, n_flows)
    per_identity, sc_http = synth.realize_scenario(sc_http)
    return per_identity, list(sc_http.flows)


def _build_world(seed: int, n_rules: int, pool_chunks: int,
                 chunk_flows: int, protocol_mix: float = 0.0,
                 device=None):
    """A real compiled serving slice: synth policy → loader →
    chunk pool with engine ground truth. ``protocol_mix`` > 0 (the
    reference blends protocol-frontend chunks into the pool at that
    fraction) raises naming Q5. The loader stages its engine on
    ``device`` (``cuda`` unless named)."""
    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.ingest.binary import (
        capture_from_bytes,
        capture_to_bytes,
    )
    from cilium_tpu_torch.runtime.loader import Loader

    per_identity, scenario_flows = _build_policy(
        n_rules, chunk_flows, protocol_mix=protocol_mix)
    cfg = Config()
    cfg.enable_tpu_offload = True
    loader = Loader(cfg, device=device)
    loader.regenerate(per_identity, revision=1)
    engine = loader.engine
    rng = random.Random(seed ^ 0x5EED)
    pool: List[_Chunk] = []
    for _ in range(pool_chunks):
        flows = [scenario_flows[rng.randrange(len(scenario_flows))]
                 for _ in range(chunk_flows)]
        sections = capture_from_bytes(capture_to_bytes(flows))
        truth = [int(v) for v in
                 engine.verdict_flows(flows)["verdict"]]
        pool.append(_Chunk(sections, truth))
    return loader, pool


class LoadModel:
    """The 100k-stream soak. ``run()`` returns the result dict the
    lane stamps; ``violations`` carries any invariant failures."""

    def __init__(self, seed: int = 0, streams: int = 100_000,
                 virtual_s: float = 120.0, ramp_s: float = 30.0,
                 capacity: Optional[int] = None,
                 pack_interval_ms: float = 50.0,
                 lease_ttl_s: float = 300.0,
                 chunk_flows: int = 8, pool_chunks: int = 64,
                 n_rules: int = 60, storms: int = 3,
                 storm_size: int = 2000,
                 pareto_xm_s: float = 30.0, pareto_alpha: float = 1.3,
                 fault_rules: Optional[Sequence] = None,
                 sample_every: int = 64, mode: str = "thread",
                 protocol_mix: float = 0.0, device=None):
        _require_http_only(protocol_mix)
        self.seed = seed
        self.streams = int(streams)
        self.virtual_s = float(virtual_s)
        self.ramp_s = float(ramp_s)
        self.capacity = (int(capacity) if capacity
                         else max(1024, 1 << (self.streams - 1)
                                  .bit_length()))
        self.pack_interval_s = pack_interval_ms / 1e3
        self.lease_ttl_s = float(lease_ttl_s)
        self.chunk_flows = int(chunk_flows)
        self.pool_chunks = int(pool_chunks)
        self.n_rules = int(n_rules)
        self.storms = int(storms)
        self.storm_size = int(storm_size)
        self.pareto_xm_s = float(pareto_xm_s)
        self.pareto_alpha = float(pareto_alpha)
        self.fault_rules = list(fault_rules or ())
        self.sample_every = max(1, int(sample_every))
        self.mode = mode
        #: fraction of pool chunks carrying protocol-frontend traffic
        #: (cassandra/memcache/r2d2) instead of http; 0 only (Q5)
        self.protocol_mix = float(protocol_mix)
        #: the loader's device (``cuda`` unless named)
        self.device = device
        self.rng = random.Random(seed)
        self.violations: List[Dict] = []
        self.latencies: List[float] = []
        self.submissions = 0
        self.resolved = 0
        self.shed_submits = 0
        self.shed_connects = 0
        self.retries = 0
        self.concurrency_peak = 0
        self.sampled_checks = 0

    # -- schedule construction -------------------------------------------
    def _diurnal(self, t: float) -> float:
        """Emission-rate multiplier: one compressed virtual day over
        the run, ±60% swing."""
        return 1.0 + 0.6 * math.sin(2.0 * math.pi * t / self.virtual_s)

    def _next_interval(self, t: float) -> float:
        """Heavy-tailed (Pareto) inter-chunk gap, diurnally scaled."""
        u = max(1e-9, 1.0 - self.rng.random())
        gap = self.pareto_xm_s / (u ** (1.0 / self.pareto_alpha))
        return min(gap, self.virtual_s) / self._diurnal(t)

    def _build_events(self) -> List[Tuple[float, int, int, int]]:
        """(t, seq, kind, stream) heap — seeded, self-contained."""
        events: List[Tuple[float, int, int, int]] = []
        seq = 0
        for i in range(self.streams):
            t = self.rng.random() * self.ramp_s
            events.append((t, seq, _ARRIVE, i))
            seq += 1
            # first emission shortly after arrival, then Pareto gaps
            # (scheduled lazily as each emission fires)
            t_emit = t + self.rng.random() * self.pareto_xm_s
            events.append((t_emit, seq, _EMIT, i))
            seq += 1
        for k in range(self.storms):
            t = self.ramp_s + (k + 1) * (
                (self.virtual_s - self.ramp_s) / (self.storms + 1))
            events.append((t, seq, _STORM, k))
            seq += 1
        heapq.heapify(events)
        self._seq = seq
        return events

    # -- invariants -------------------------------------------------------
    def _check(self, loop: ServeLoop, index: int) -> None:
        st = loop.status()
        occ = st["occupancy"]
        self.concurrency_peak = max(self.concurrency_peak, occ)
        if occ > loop.ring.capacity:
            raise Violation(index, "ring-occupancy",
                            f"{occ} leased > capacity "
                            f"{loop.ring.capacity}")
        books = st["grants"] - st["expiries"] - st["releases"]
        if books != occ:
            raise Violation(
                index, "lease-accounting",
                f"grants {st['grants']} - expiries {st['expiries']} "
                f"- releases {st['releases']} = {books} != occupancy "
                f"{occ}")
        memo = st["memo"]
        if memo and (memo["hits"] < 0 or memo["misses"] < 0
                     or memo["hits"] + memo["misses"] < 0):
            raise Violation(index, "memo-accounting", str(memo))

    def _sweep(self, outstanding: List, index: int) -> None:
        """Collect resolved tickets: latencies, sampled correctness
        AND sampled explanation decode, retry bookkeeping. Nothing
        may vanish."""
        keep = []
        for ticket, chunk, stream in outstanding:
            if not ticket.done:
                keep.append((ticket, chunk, stream))
                continue
            self.resolved += 1
            if ticket.error is not None:
                # session-reset / lease-expired: a retryable loss the
                # stream re-submits; counted, never silent
                self.retries += 1
                continue
            lat = ticket.latency
            if lat is not None:
                self.latencies.append(lat)
            if self.resolved % self.sample_every == 0:
                self.sampled_checks += 1
                got = [int(v) for v in ticket.verdicts]
                if got != chunk.truth:
                    raise Violation(
                        index, "verdict-correctness",
                        f"stream {stream}: ring verdicts diverged "
                        f"from the engine's direct verdicts")
                self._check_explainable(ticket, chunk, stream, index)
        outstanding[:] = keep

    def _check_explainable(self, ticket, chunk, stream,
                           index: int) -> None:
        """Sampled explanation decode: a served chunk's provenance
        must be present, its L7 winners must resolve through the
        policy's AttributionMap, and cited generations must be sane
        (in (0, current])."""
        import numpy as np

        from cilium_tpu_torch.engine.memo import policy_generation

        prov = ticket.prov
        if prov is None:
            raise Violation(index, "explain-coverage",
                            f"stream {stream}: served chunk carried "
                            f"no provenance bundle")
        amap = self._loop._amap_for(self._loop.ring.session.engine)
        l7m = np.asarray(prov.l7_match)
        gens = np.asarray(prov.gens)
        l7t = np.asarray(chunk.sections[0]["l7_type"])
        if chunk.sections[4] is not None:
            # protocol-frontend records decode on their FAMILY lane
            raise NotImplementedError(
                "explaining protocol-frontend records needs the "
                "frontends (queue 1, Q5)")
        gen_now = policy_generation()
        for r in range(min(len(l7m), len(l7t))):
            code = int(l7m[r])
            if code >= 0 and (amap is None
                              or amap.resolve(int(l7t[r]),
                                              code) is None):
                raise Violation(
                    index, "explain-undecodable",
                    f"stream {stream} row {r}: l7_match={code} does "
                    f"not resolve to a live rule")
            if not (0 < int(gens[r]) <= gen_now):
                raise Violation(
                    index, "explain-undecodable",
                    f"stream {stream} row {r}: cited generation "
                    f"{int(gens[r])} outside (0, {gen_now}]")

    # -- the run ----------------------------------------------------------
    def run(self) -> Dict:
        loader, pool = _build_world(self.seed, self.n_rules,
                                    self.pool_chunks, self.chunk_flows,
                                    protocol_mix=self.protocol_mix,
                                    device=self.device)
        autojump = self.mode == "thread"
        clock = simclock.VirtualClock(
            autojump=0.001 if autojump else None, poll=0.001)
        plan = faults.FaultPlan(rules=self.fault_rules, seed=self.seed)
        result: Dict = {}
        with simclock.use(clock):
            loop = ServeLoop(loader, capacity=self.capacity,
                             lease_ttl_s=self.lease_ttl_s,
                             pack_interval_s=self.pack_interval_s,
                             max_slot_pending=8)
            self._loop = loop
            # -- unloaded baseline: one stream, quiet ring -------------
            base = self._baseline(loop, pool, clock, autojump)
            with faults.inject(plan):
                if autojump:
                    loop.start()
                try:
                    self._drive(loop, pool, clock, autojump)
                except Violation as v:
                    self.violations.append({
                        "index": v.index, "invariant": v.invariant,
                        "detail": v.detail})
            # drain flushes whatever the tail left pending
            loop.drain()
            loop.stop()
            st = loop.status()
            result = self._result(loop, st, base, clock)
        return result

    def _baseline(self, loop: ServeLoop, pool, clock,
                  autojump: bool) -> float:
        """Unloaded p99: one stream, one chunk per pack cycle. Driven
        inline — the production thread isn't running yet, so the
        driver advances (or virtually sleeps) one interval per chunk."""
        lease = loop.connect("baseline")
        lats: List[float] = []
        for k in range(20):
            chunk = pool[k % len(pool)]
            ticket = loop.submit(lease, *chunk.sections)
            if autojump:
                simclock.sleep(self.pack_interval_s)
            else:
                clock.advance(self.pack_interval_s)
            loop.step()
            if ticket.done and ticket.latency is not None:
                lats.append(ticket.latency)
        loop.disconnect(lease)
        lats.sort()
        return lats[min(len(lats) - 1, int(0.99 * len(lats)))] \
            if lats else self.pack_interval_s

    def _drive(self, loop: ServeLoop, pool, clock, autojump: bool
               ) -> None:
        events = self._build_events()
        leases: Dict[int, object] = {}
        outstanding: List = []
        if autojump:
            index = self._drive_thread(loop, pool, clock, events,
                                       leases, outstanding)
            simclock.sleep(2 * self.pack_interval_s)
        else:
            index = self._drive_driven(loop, pool, clock, events,
                                       leases, outstanding)
            clock.advance(2 * self.pack_interval_s)
            loop.step()
        self._sweep(outstanding, index)

    def _run_event(self, loop, pool, events, leases, outstanding,
                   kind, arg, index) -> None:
        if kind == _ARRIVE:
            self._arrive(loop, leases, arg, events)
        elif kind == _EMIT:
            self._emit(loop, leases, pool, outstanding, arg,
                       events, index)
        elif kind == _STORM:
            self._storm(loop, leases, pool, outstanding, index)
        self._check(loop, index)

    def _drive_thread(self, loop, pool, clock, events, leases,
                      outstanding) -> int:
        """Autojump mode: the PRODUCTION pack thread dispatches; the
        driver wakes once per pack interval and replays that bucket's
        events — 100k streams cost one wake per cycle, not one per
        event."""
        index = 0
        while events:
            bucket_end = events[0][0] + self.pack_interval_s
            batch = []
            while events and events[0][0] <= bucket_end:
                batch.append(heapq.heappop(events))
            target = max(bucket_end, batch[-1][0])
            now = clock.now()
            if target > now:
                simclock.sleep(target - now)
            # the driver is CPU-busy, not idle, while it replays the
            # bucket: hold the autojump so host work doesn't read as
            # quiet and race virtual time ahead of the submissions
            with simclock.hold():
                for _t, _seq, kind, arg in batch:
                    index += 1
                    self._run_event(loop, pool, events, leases,
                                    outstanding, kind, arg, index)
                self._sweep(outstanding, index)
        return index

    def _drive_driven(self, loop, pool, clock, events, leases,
                      outstanding) -> int:
        """Driven mode (deterministic, the DST arm's face): pack
        ticks are first-class — the clock advances event-by-event and
        the loop steps exactly every pack interval, so latency is a
        pure function of the schedule."""
        index = 0
        next_step = clock.now() + self.pack_interval_s
        while events:
            if events[0][0] <= next_step:
                t, _seq, kind, arg = heapq.heappop(events)
                clock.advance_to(t)
                index += 1
                self._run_event(loop, pool, events, leases,
                                outstanding, kind, arg, index)
            else:
                clock.advance_to(next_step)
                loop.step()
                next_step += self.pack_interval_s
                self._sweep(outstanding, index)
        return index

    def _arrive(self, loop, leases, i, events) -> None:
        try:
            leases[i] = loop.connect(f"vs{i}")
        except ShedError:
            self.shed_connects += 1
            # retry once, later — the model's clients back off
            heapq.heappush(events, (simclock.now() + 1.0,
                                    self._bump(), _ARRIVE, i))

    def _emit(self, loop, leases, pool, outstanding, i, events,
              index) -> None:
        lease = leases.get(i)
        if lease is None:
            return  # never admitted (shed twice): stays departed
        chunk = pool[(i * 2654435761 + index) % len(pool)]
        try:
            ticket = loop.submit(lease, *chunk.sections)
            outstanding.append((ticket, chunk, i))
            self.submissions += 1
        except LeaseExpired:
            # idle past TTL: reconnect-with-resume grants a fresh
            # slot, then the chunk re-sends
            leases.pop(i, None)
            try:
                leases[i] = loop.connect(f"vs{i}", resume=True)
                ticket = loop.submit(leases[i], *chunk.sections)
                outstanding.append((ticket, chunk, i))
                self.submissions += 1
                self.retries += 1
            except (ShedError, LeaseExpired):
                self.shed_connects += 1
        except ShedError:
            self.shed_submits += 1
        # schedule the stream's next emission (heavy-tailed)
        t_next = simclock.now() + self._next_interval(simclock.now())
        if t_next < self.virtual_s:
            heapq.heappush(events, (t_next, self._bump(), _EMIT, i))

    def _storm(self, loop, leases, pool, outstanding, index) -> None:
        """Reconnect storm: a seeded burst of streams drops and
        re-dials with resume. Live leases renew WITHOUT a second
        grant; expired ones re-grant; each resumed stream replays one
        chunk (at-least-once — verdicts are deterministic)."""
        ids = [self.rng.randrange(self.streams)
               for _ in range(min(self.storm_size, self.streams))]
        for i in ids:
            old = leases.get(i)
            grants_before = loop.grants
            try:
                lease = loop.connect(f"vs{i}", resume=True)
            except ShedError:
                self.shed_connects += 1
                leases.pop(i, None)
                continue
            # the never-double-counted property, exactly: a resume
            # that found its lease alive returns the SAME lease and
            # must not have granted (only this driver thread ever
            # connects, so the grants counter is race-free here)
            if lease is old and loop.grants != grants_before:
                raise Violation(
                    index, "lease-double-grant",
                    f"stream {i}: reconnect-with-resume renewed a "
                    f"live lease AND counted a grant")
            leases[i] = lease
            chunk = pool[i % len(pool)]
            try:
                ticket = loop.submit(lease, *chunk.sections)
                outstanding.append((ticket, chunk, i))
                self.submissions += 1
            except (ShedError, LeaseExpired):
                self.shed_submits += 1

    def _bump(self) -> int:
        self._seq += 1
        return self._seq

    def _result(self, loop, st, base_p99, clock) -> Dict:
        lats = sorted(self.latencies)

        def pct(q):
            return (lats[min(len(lats) - 1, int(q * len(lats)))]
                    if lats else 0.0)

        shed_total = self.shed_submits + self.shed_connects
        denom = max(1, self.submissions + shed_total)
        prov = st.get("provenance", {})
        slo = st.get("slo", {})
        burn = slo.get("burn_rates", {})
        # gate on the LONGEST window: it covers the whole virtual run
        long_w = (f"{int(max(loop.slo.windows_s))}s"
                  if loop.slo is not None else "")
        return {
            "explain_coverage": prov.get("explain_coverage", 0.0),
            "records_explained": prov.get("records_explained", 0),
            "records_unexplained": prov.get("records_unexplained", 0),
            "slo_burn": burn,
            "slo_burn_p99": burn.get("serve-p99", {}).get(long_w, 0.0),
            "slo_burn_shed": burn.get("serve-shed", {}).get(long_w,
                                                            0.0),
            "seed": self.seed,
            "mode": self.mode,
            "streams": self.streams,
            "concurrency_peak": self.concurrency_peak,
            "virtual_s": self.virtual_s,
            "simulated_s": round(clock.simulated, 3),
            "submissions": self.submissions,
            "resolved": self.resolved,
            "served_records": st["served_records"],
            "packs": st["packs"],
            "records_packed": st["records_packed"],
            "grants": st["grants"],
            "expiries": st["expiries"],
            "releases": st["releases"],
            "sheds": shed_total,
            "shed_rate": round(shed_total / denom, 6),
            "retries": self.retries,
            "chunk_errors": st["chunk_errors"],
            "bytes_saved": st["bytes_saved"],
            "bytes_shipped": st["bytes_shipped"],
            "memo": st["memo"],
            "sampled_checks": self.sampled_checks,
            "p50_ms": round(pct(0.50) * 1e3, 3),
            "p99_ms": round(pct(0.99) * 1e3, 3),
            "p99_unloaded_ms": round(base_p99 * 1e3, 3),
            "p99_ratio": round(pct(0.99) / max(base_p99, 1e-9), 3),
            "violations": list(self.violations),
        }


# -- the serve-soak lane ------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="100k-virtual-stream serving-loop soak (DST load "
                    "model over the verdict ring)")
    ap.add_argument("--streams", type=int, default=100_000)
    ap.add_argument("--seed", type=int,
                    default=int(os.environ.get("CILIUM_TPU_DST_SEED",
                                               "0") or 0))
    ap.add_argument("--virtual-s", type=float, default=120.0)
    ap.add_argument("--pack-interval-ms", type=float, default=50.0)
    ap.add_argument("--lease-ttl-s", type=float, default=300.0)
    ap.add_argument("--mode", choices=("thread", "driven"),
                    default="thread")
    ap.add_argument("--storms", type=int, default=3)
    ap.add_argument("--storm-size", type=int, default=2000)
    ap.add_argument("--faults", type=int, default=12,
                    help="serve.lease/serve.ring_slot fires to arm "
                         "(seeded; 0 disables)")
    ap.add_argument("--p99-factor", type=float, default=2.0)
    ap.add_argument("--max-shed-rate", type=float, default=0.02)
    ap.add_argument("--min-explain-coverage", type=float,
                    default=0.999,
                    help="served verdicts carrying decodable "
                         "provenance, as a fraction")
    ap.add_argument("--max-burn", type=float, default=1.0,
                    help="whole-run SLO burn-rate ceiling "
                         "(1.0 = exactly the declared budget)")
    ap.add_argument("--protocol-mix", type=float, default=0.0,
                    help="fraction of traffic chunks carrying "
                         "protocol-frontend records (0 only: the "
                         "frontends are queue 1, Q5)")
    ap.add_argument("--target-concurrency", type=int, default=0,
                    help="gate floor (default: 95%% of --streams)")
    ap.add_argument("--device", default=None,
                    help="the loader's device (default cuda)")
    ap.add_argument("--out", default="",
                    help="append the stamped line to this file too")
    args = ap.parse_args(argv)

    rules = []
    if args.faults > 0:
        rules = [
            faults.FaultRule("serve.lease", prob=0.0005,
                             times=args.faults),
            faults.FaultRule("serve.ring_slot", prob=0.0005,
                             times=args.faults),
        ]
    t0 = simclock.perf()
    model = LoadModel(seed=args.seed, streams=args.streams,
                      virtual_s=args.virtual_s,
                      pack_interval_ms=args.pack_interval_ms,
                      lease_ttl_s=args.lease_ttl_s,
                      storms=args.storms, storm_size=args.storm_size,
                      fault_rules=rules, mode=args.mode,
                      protocol_mix=args.protocol_mix,
                      device=args.device)
    result = model.run()
    wall_s = simclock.perf() - t0
    result["wall_s"] = round(wall_s, 3)
    result["speedup_vs_real_time"] = round(
        result["simulated_s"] / max(wall_s, 1e-9), 1)

    target = args.target_concurrency or int(0.95 * args.streams)
    gates = {
        "violations": len(result["violations"]) == 0,
        "concurrency": result["concurrency_peak"] >= target,
        "p99": result["p99_ratio"] <= args.p99_factor,
        "shed_rate": result["shed_rate"] <= args.max_shed_rate,
        "bytes_saved": result["bytes_saved"] > 0,
        # provenance gates: ≥99.9% of served verdicts carry
        # a decodable provenance bundle, and the declared-SLO burn
        # rates over the whole-run window stay within budget
        "explain_coverage":
            result["explain_coverage"] >= args.min_explain_coverage,
        "burn_rate": (result["slo_burn_p99"] <= args.max_burn
                      and result["slo_burn_shed"] <= args.max_burn),
    }
    result["gates"] = {k: bool(v) for k, v in gates.items()}

    from cilium_tpu_torch.runtime.provenance import stamp

    os.environ["CILIUM_TPU_DST_SEED"] = str(args.seed)
    os.environ["CILIUM_TPU_DST_DIGEST"] = hashlib.sha256(
        json.dumps({"streams": args.streams, "seed": args.seed,
                    "virtual_s": args.virtual_s, "mode": args.mode},
                   sort_keys=True).encode()).hexdigest()[:16]
    line = stamp({
        "metric": "serve_soak_p99_ms",
        "value": result["p99_ms"],
        "unit": "ms submit->verdict p99 (virtual)",
        "lane": "serve-soak",
        **{k: v for k, v in result.items() if k != "violations"},
        "violations": len(result["violations"]),
    })
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as fp:
            fp.write(json.dumps(line) + "\n")

    ok = all(gates.values())
    print(f"[serve-soak] {result['concurrency_peak']} concurrent "
          f"virtual streams (target {target}), "
          f"{result['submissions']} chunks / "
          f"{result['served_records']} records over "
          f"{result['packs']} packs; virtual p99 {result['p99_ms']}ms "
          f"({result['p99_ratio']}x unloaded), shed rate "
          f"{result['shed_rate']}, {result['bytes_saved']} H2D bytes "
          f"saved by memo bypass; explain coverage "
          f"{result['explain_coverage']}, burn p99/shed "
          f"{result['slo_burn_p99']}/{result['slo_burn_shed']}; "
          f"simulated "
          f"{result['simulated_s']:.0f}s in {wall_s:.1f}s wall "
          f"({result['speedup_vs_real_time']}x); gates "
          f"{'OK' if ok else 'FAILED ' + str(result['gates'])}",
          flush=True)
    if result["violations"]:
        print(f"[serve-soak] violations: {result['violations']}",
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
