"""Deterministic simulation testing: seeded fault-schedule search over
the serving plane (counterpart of the reference's ``runtime/dst.py``).

Chaos and churn lanes replay the handful of fault schedules a human
had patience to write; this module SEARCHES the schedule space. A
schedule is a seeded list of events — fault arms at named injection
points (runtime/faults.py), policy churn, identity churn storms,
traffic rounds, drain→warm-restore cycles, virtual-time advances —
executed against a small but real serving world (Loader + compiled
engine on the world's device + circuit breaker + capture-replay
session + kvstore) under a driven
:class:`~cilium_tpu_torch.runtime.simclock.VirtualClock`, with
standing invariants checked after every event:

* **Oracle agreement** — served verdicts match a freshly-resolved CPU
  oracle of the COMMITTED rule set whenever the loader is not
  degraded (no stale reads, whatever faults fired), and are never
  ERROR.
* **Fail closed** — under bank quarantine the plane may deny more,
  never serve ERROR; probes for never-allowed traffic always deny.
* **Session honesty** — the live replay session's verdicts are
  bit-equal to the serving engine's, and its memo accounting
  (hits+misses == lookups) never lies.
* **O(Δ) compile** — bank compiles grow with the CHANGE count, never
  with policy size × updates.
* **Explanation honesty** — every sampled ring-served verdict's
  provenance is trustworthy: the cited rule re-resolves to the served
  verdict under the committed rule set AT THE CITED GENERATION, rows
  computed this round cite the current generation, and memo-served
  rows cite the (possibly older) generation they were actually
  computed under.
* **Liveness** — with faults exhausted, bounded virtual time recovers
  everything: the breaker re-closes past its probe interval and
  quarantined banks clear past their TTL.

Determinism: the same ``CILIUM_TPU_DST_SEED`` replays a byte-identical
event trace, across runs and ``PYTHONHASHSEED``\\ s, and on the CPU
that trace equals the reference's for the same events, field for
field (``tests/test_torch_dst*.py``). A violating schedule is shrunk by
delta debugging (:func:`shrink`) to a minimal event list and emitted
as a committable JSON regression case. Planted-bug validation
(``faults.mutation_active``) re-introduces a known fixed bug behind
``CILIUM_TPU_DST_MUTATION`` and proves the search catches it within a
bounded seed budget.

The world runs on ``device`` (``cuda`` unless the caller names
another): its loader's engine, the session's memo, the serving ring
and the fleet's replicas all stage there. The multichip arm runs the
DP and CP lanes on two ranks of a
:class:`~cilium_tpu_torch.parallel.mesh.LocalWorld` (``gloo``; on the
card both ranks share the one GPU), spawned once per world.

``python -m cilium_tpu_torch.runtime.dst`` sweeps
``Config.dst.schedules`` seeds and writes one provenance-stamped
summary line (the ``dst_seed``/``schedule_digest`` stamp —
runtime/provenance.py).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import sys
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from cilium_tpu_torch.core.device import DeviceLike, resolve_device
from cilium_tpu_torch.runtime import faults, simclock


def _single_device_step(arrays, host, device):
    """The single-device reference step of the multichip arm: the
    legacy ``verdict_step`` over the policy's arrays and the packed
    host batch on ``device``, read back as numpy."""
    from cilium_tpu_torch.engine.verdict import batch_to_device, verdict_step
    from cilium_tpu_torch.weights import arrays_from_reference

    out = verdict_step(arrays_from_reference(arrays, device),
                       batch_to_device(host, device))
    return {k: v.cpu().numpy() for k, v in out.items()}


def _multichip_rank(arrays, host, device, cp_block):
    """One rank's body of the multichip arm: the DP lane
    (``sharding.make_sharded_step``) and the CP lane
    (``cp.make_cp_verdict_step``) over the same global host inputs,
    each read back globally (numpy on rank 0, None elsewhere). Runs in
    a spawned rank, where no fault plan is installed."""
    from cilium_tpu_torch.tools.parallel_lanes import run_lane

    return {lane: run_lane(lane, {"arrays": arrays, "batch": host},
                           device=device, cp_block=cp_block)["out"]
            for lane in ("dp", "cp")}


#: schedule format epoch, stamped on every trace + shrunken case
SCHEDULE_FORMAT = 1

#: injection points the generator arms (all pre-registered by their
#: owning modules)
FAULT_POINTS = (
    "engine.dispatch",
    "loader.swap",
    "loader.bank_compile",
    "kvstore.churn_storm",
    "serve.lease",
    "serve.ring_slot",
    # the fleet compile plane's fault surface: a worker
    # dying mid-compile (retried with backoff; exhaustion quarantines
    # with cover) and a lost/corrupt distributed bank artifact
    # (degrades to a counted recompile)
    "compile.worker",
    "artifact.fetch",
    # the cross-cluster surface: a remote-cluster event
    # ingest dying mid-delivery (isolated by the kvstore watch; the
    # re-announce repairs it) and a publisher heartbeat miss (the
    # lease keeps state alive until the next beat)
    "clustermesh.session",
    "clustermesh.heartbeat",
    # the horizontal serving fleet's fault surface: a lost
    # replica heartbeat (suspicion runs on the virtual clock; aging
    # past the TTL is a fail-closed death + handoff) and a handoff
    # interrupted mid-re-grant (the un-re-granted remainder rides the
    # client resume protocol instead of double-granting)
    "fleet.heartbeat",
    "fleet.handoff",
    # the multi-tenant control plane's fault surface: a
    # lost per-tenant quota-store read (falls to the conservative
    # default share, never unbounded) and a failed shadow dispatch
    # (aborts the canary safely; serving generation N untouched)
    "tenant.quota",
    "canary.dispatch",
)

#: breaker/quarantine timings the schedules steer around; small so
#: liveness checks cross them with single advances
PROBE_INTERVAL_S = 5.0
QUARANTINE_TTL_S = 30.0

#: virtual advances the generator picks from — chosen to straddle the
#: probe interval and quarantine TTL boundaries
ADVANCES = (0.5, 2.0, 6.0, 31.0)

#: bank compiles per committed change the O(Δ) invariant tolerates
#: (matches the churn soak's acceptance bound)
COMPILES_PER_CHANGE_BOUND = 4.0


class InvariantViolation(AssertionError):
    """One failed standing invariant, anchored to the event index."""

    def __init__(self, index: int, name: str, detail: str):
        super().__init__(f"event {index}: [{name}] {detail}")
        self.index = index
        self.invariant = name
        self.detail = detail


class SchedulePlan(faults.FaultPlan):
    """A FaultPlan armed incrementally by schedule events: each
    ``arm`` grants a point N one-shot fires consumed by its next
    hits. Decisions are a pure function of the arm/hit sequence, so
    the recorded trace replays byte-identically."""

    def __init__(self):
        super().__init__(rules=(), seed=0)
        self._budget: Dict[str, int] = {}
        self._lock = threading.Lock()
        #: (point, hit-ordinal-at-fire) — the replayable fire log
        self.fires: List[Tuple[str, int]] = []
        self._hits: Dict[str, int] = {}

    def arm(self, point: str, times: int = 1) -> None:
        with self._lock:
            self._budget[point] = self._budget.get(point, 0) + times

    def disarm_all(self) -> None:
        with self._lock:
            self._budget.clear()

    def check(self, point: str) -> Optional[Exception]:
        with self._lock:
            idx = self._hits.get(point, 0)
            # ctlint: disable=unbounded-registry  # keyed by registered fault points (finite)
            self._hits[point] = idx + 1
            left = self._budget.get(point, 0)
            if left <= 0:
                return None
            self._budget[point] = left - 1
            self.fires.append((point, idx))
        return faults.FaultInjected(
            f"dst scheduled fault at {point} (hit {idx})")


# -- the world ---------------------------------------------------------------


class DSTWorld:
    """A small, real slice of the serving plane: resolved policy →
    Loader → compiled engine + CPU oracle, breaker-guarded verdictor,
    a live capture-replay session with the device-resident memo, and
    a kvstore-backed identity allocator. Everything time-driven reads
    the installed (virtual) clock.

    ``device`` (``cuda`` unless the caller names another; raises
    without CUDA) is where the loader stages the engine — and with it
    the session's memo, the serving ring and the fleet's replicas."""

    N_IDS = 3
    BASE_PATHS = 4

    def __init__(self, cache_dir: str, device: DeviceLike = None):
        from cilium_tpu_torch.core.config import Config
        from cilium_tpu_torch.core.identity import IdentityAllocator
        from cilium_tpu_torch.core.labels import LabelSet
        from cilium_tpu_torch.runtime.loader import Loader
        from cilium_tpu_torch.runtime.service import (
            CircuitBreaker,
            ResilientVerdictor,
        )

        self.device = resolve_device(device)
        cfg = Config()
        cfg.enable_tpu_offload = True
        cfg.engine.bank_size = 2       # many small banks: O(Δ) visible
        cfg.loader.cache_dir = cache_dir
        cfg.loader.bank_quarantine_ttl_s = QUARANTINE_TTL_S
        cfg.breaker.failure_threshold = 2
        cfg.breaker.probe_interval = PROBE_INTERVAL_S
        # ONE compile worker: the queue machinery (deadlines, backoff,
        # priority pops, worker-death respawn) is fully armed, but
        # per-bank fault ATTRIBUTION stays a pure function of the
        # schedule — with N workers racing, WHICH bank an armed
        # loader.bank_compile/compile.worker fault hits would depend
        # on thread scheduling and byte-identical replay would break
        cfg.compile.workers = 1
        self.cfg = cfg
        self.alloc = IdentityAllocator()
        self.web = self.alloc.allocate(LabelSet.from_dict({"app": "web"}))
        self.dbs = [self.alloc.allocate(
            LabelSet.from_dict({"app": f"db{i}"}))
            for i in range(self.N_IDS)]
        #: identity index → list of (kind, pattern); the DESIRED
        #: state. The protocol-frontend kinds put one
        #: cassandra/memcache/r2d2 rule per identity in the BASE
        #: policy, so the oracle-agreement + fail-closed invariants
        #: arm over the new families on every schedule and a
        #: loader.bank_compile fault can land on an l7g bank
        self.rules_of = {
            i: [("http", f"/svc{i}/p{j}/.*")
                for j in range(self.BASE_PATHS)]
            + [("dns", f"api{i}.corp.io"),
               ("cass", f"tbl{i}"), ("mc", f"k{i}"),
               ("r2d2", f"f{i}.dat")]
            for i in range(self.N_IDS)}
        # the world is TENANT-PARTITIONED — db0 is tenant
        # "a", db1 is tenant "b", db2 rides the default namespace.
        # Partitioning is on for EVERY schedule (the namespaced bank
        # planner lives inside the whole searched fault space), and
        # the `tenant` arm proves A's faults never move B's verdicts,
        # banks, or admission outcomes.
        cfg.tenant.enabled = True
        cfg.tenant.ranges = (f"a:{self.dbs[0]}-{self.dbs[0]}",
                             f"b:{self.dbs[1]}-{self.dbs[1]}")
        #: the last state a successful commit (or warm restore) staged
        #: — the oracle the serving plane is held to
        self.committed = {i: list(v) for i, v in self.rules_of.items()}
        self.loader = Loader(cfg, device=self.device)
        self.loader.regenerate(self._resolve(), revision=1)
        self.revision = 1
        self.breaker = CircuitBreaker(
            failure_threshold=cfg.breaker.failure_threshold,
            probe_interval=cfg.breaker.probe_interval)
        self.verdictor = ResilientVerdictor(self.loader,
                                            breaker=self.breaker)
        self._session = None
        self._session_cols = None
        #: bank compiles carried across warm-restart loader swaps so
        #: the O(Δ) bound sees the whole schedule's work
        self._compiles_carry = 0
        self.compiles0 = self.bank_compiles()
        self.changes = 0
        #: regenerate ATTEMPTS (committed, rolled back, and liveness
        #: retries alike) — the denominator of the O(Δ) bound: every
        #: attempt may compile its delta, rollbacks included
        self.attempts = 0
        #: kvstore identity plane for churn storms
        from cilium_tpu_torch.identity_kvstore import ClusterIdentityAllocator
        from cilium_tpu_torch.kvstore import KVStore

        self.store = KVStore()
        self.cluster_alloc = ClusterIdentityAllocator(self.store).start()
        self.storm_pool = [LabelSet.from_dict({"storm": f"s{i}"})
                           for i in range(8)]
        #: lazily-built clustermesh slice (publisher → kvstore →
        #: remote watcher): (store, remote ipcache, local
        #: ipcache, publisher, RemoteCluster)
        self._mesh = None
        self._mesh_n = 0
        #: lazily-built continuously-batched serving loop
        #: (runtime/serveloop.py) — a SMALL ring (capacity 4, short
        #: lease TTL) so ring-full sheds and TTL expiries are
        #: reachable inside a 12-event schedule; dropped on
        #: drain-restore (a restarted process builds a fresh one)
        self._serve = None
        self._serve_streams = 0
        #: lazily-built horizontal serving fleet
        #: (runtime/fleetserve.py): 3 simulated host replicas SHARING
        #: this world's loader behind a stream-affinity router, tiny
        #: rings so saturation/spill/shed are reachable in-schedule;
        #: dropped on drain-restore like the single loop
        self._fleet = None
        #: generation → (committed rules at that epoch, degraded?) —
        #: the explanation-honesty invariant's re-resolve base:
        #: memo-served rows cite the generation they were computed
        #: under, and the cited rule set must still produce the
        #: served verdict. Recorded lazily at every serve round (the
        #: only place ring memo fills happen), bounded.
        self._gen_snapshots: Dict[int, tuple] = {}
        self._serve_gen = -1
        #: the multichip arm's two ranks, spawned at its first round
        #: and kept for the world's life (a spawn costs seconds)
        self._ranks = None

    def bank_compiles(self) -> int:
        """Compile-or-fetch WORK units: with bank artifacts on, a
        wholesale membership shift can serve from artifacts compiled
        earlier in the same schedule — cheaper than recompiling, but
        still O(policy) plan churn. The O(Δ) invariant bounds work
        per change, so fetches count (a fetch-masked positional-banks
        regression must still trip it — the planted-bug search)."""
        reg = self.loader.bank_registry
        return self._compiles_carry + (
            (reg.compiles + reg.artifact_hits) if reg else 0)

    # -- policy ----------------------------------------------------------
    def _resolve(self):
        from cilium_tpu_torch.core.flow import Protocol
        from cilium_tpu_torch.policy.api import (
            EndpointSelector,
            IngressRule,
            PortProtocol,
            PortRule,
            Rule,
        )
        from cilium_tpu_torch.policy.api.l7 import (
            L7Rules,
            PortRuleDNS,
            PortRuleHTTP,
        )
        from cilium_tpu_torch.policy.mapstate import PolicyResolver
        from cilium_tpu_torch.policy.repository import Repository
        from cilium_tpu_torch.policy.selectorcache import SelectorCache

        from cilium_tpu_torch.policy.api.l7 import PortRuleL7

        repo = Repository()
        rules = []
        for i in range(self.N_IDS):
            http = tuple(PortRuleHTTP(path=p, method="GET")
                         for k, p in self.rules_of[i] if k == "http")
            dns = tuple(PortRuleDNS(match_name=p)
                        for k, p in self.rules_of[i] if k == "dns")
            cass = tuple(PortRuleL7.from_dict(
                {"query_action": "select", "query_table": p})
                for k, p in self.rules_of[i] if k == "cass")
            mc = tuple(PortRuleL7.from_dict({"cmd": "get", "key": p})
                       for k, p in self.rules_of[i] if k == "mc")
            r2 = tuple(PortRuleL7.from_dict(
                {"cmd": "READ", "file": p})
                for k, p in self.rules_of[i] if k == "r2d2")
            ports = [
                PortRule(ports=(PortProtocol(80, Protocol.TCP),),
                         rules=L7Rules(http=http)),
                PortRule(ports=(PortProtocol(53, Protocol.UDP),),
                         rules=L7Rules(dns=dns)),
            ]
            for proto, port, rr in (("cassandra", 9042, cass),
                                    ("memcache", 11211, mc),
                                    ("r2d2", 4040, r2)):
                if rr:
                    ports.append(PortRule(
                        ports=(PortProtocol(port, Protocol.TCP),),
                        rules=L7Rules(l7proto=proto, l7=rr)))
            rules.append(Rule(
                endpoint_selector=EndpointSelector.from_labels(
                    app=f"db{i}"),
                ingress=(IngressRule(
                    from_endpoints=(
                        EndpointSelector.from_labels(app="web"),),
                    to_ports=tuple(ports)),),
            ))
        repo.add(rules, sanitize=False)
        resolver = PolicyResolver(repo, SelectorCache(self.alloc))
        return {db: resolver.resolve(self.alloc.lookup(db))
                for db in self.dbs}

    def _http(self, i: int, path: str):
        from cilium_tpu_torch.core.flow import (
            Flow,
            HTTPInfo,
            L7Type,
            Protocol,
            TrafficDirection,
        )

        return Flow(src_identity=self.web, dst_identity=self.dbs[i],
                    dport=80, protocol=Protocol.TCP,
                    direction=TrafficDirection.INGRESS, l7=L7Type.HTTP,
                    http=HTTPInfo(method="GET", path=path))

    def _dns(self, i: int, qname: str):
        from cilium_tpu_torch.core.flow import (
            DNSInfo,
            Flow,
            L7Type,
            Protocol,
            TrafficDirection,
        )

        return Flow(src_identity=self.web, dst_identity=self.dbs[i],
                    dport=53, protocol=Protocol.UDP,
                    direction=TrafficDirection.INGRESS, l7=L7Type.DNS,
                    dns=DNSInfo(query=qname))

    #: frontend probe shapes per rules_of kind: (l7proto, dport,
    #: record-fields builder). The record matching the committed
    #: pattern must be ALLOWED; the fixed never-records are the
    #: fail-closed canaries of the new families.
    _FE_KINDS = {
        "cass": ("cassandra", 9042,
                 lambda p: {"query_action": "select",
                            "query_table": p}),
        "mc": ("memcache", 11211, lambda p: {"cmd": "get", "key": p}),
        "r2d2": ("r2d2", 4040, lambda p: {"cmd": "READ", "file": p}),
    }

    def _fe(self, i: int, proto: str, dport: int, fields):
        from cilium_tpu_torch.core.flow import (
            Flow,
            GenericL7Info,
            L7Type,
            Protocol,
            TrafficDirection,
        )

        return Flow(src_identity=self.web, dst_identity=self.dbs[i],
                    dport=dport, protocol=Protocol.TCP,
                    direction=TrafficDirection.INGRESS,
                    l7=L7Type.GENERIC,
                    generic=GenericL7Info(proto=proto,
                                          fields=dict(fields)))

    def corpus(self):
        """The probe corpus: every pattern in the UNION of committed
        and desired states, plus never-allowed probes. Probing
        desired-but-rolled-back patterns is what catches a plane
        serving an aborted revision (it allows what the committed
        oracle denies); the fixed probes are the fail-closed
        canaries. Deterministic order. The frontend kinds
        probe their families the same way — the oracle here is the
        parser-semantics CPU matcher, so oracle-agreement covers the
        l7g automaton + enum-predicate lowering end to end."""
        flows = []
        for i in range(self.N_IDS):
            pats = list(self.committed[i])
            pats += [kp for kp in self.rules_of[i] if kp not in pats]
            for kind, pat in pats:
                if kind == "http":
                    flows.append(self._http(
                        i, pat.replace("/.*", "/x")))
                elif kind == "dns":
                    flows.append(self._dns(i, pat))
                else:
                    proto, dport, mk = self._FE_KINDS[kind]
                    flows.append(self._fe(i, proto, dport, mk(pat)))
            flows.append(self._http(i, "/never/allowed"))
            flows.append(self._dns(i, "evil.example"))
            flows.append(self._fe(i, "cassandra", 9042,
                                  {"query_action": "drop",
                                   "query_table": "forbidden"}))
            flows.append(self._fe(i, "memcache", 11211,
                                  {"cmd": "flush_all"}))
            flows.append(self._fe(i, "r2d2", 4040, {"cmd": "HALT"}))
        return flows

    def oracle_verdicts(self, flows) -> List[int]:
        """Ground truth: an OracleVerdictEngine over a FRESH resolve
        of the committed rule set — independent of every staged/cached
        structure the faults may have corrupted."""
        from cilium_tpu_torch.policy.oracle import OracleVerdictEngine

        saved = {i: list(v) for i, v in self.rules_of.items()}
        self.rules_of = {i: list(v) for i, v in self.committed.items()}
        try:
            per_identity = self._resolve()
        finally:
            self.rules_of = saved
        oracle = OracleVerdictEngine(per_identity)
        return [int(v) for v in
                oracle.verdict_flows(flows)["verdict"]]

    # -- event executors --------------------------------------------------
    def churn(self, op: str, i: int, step: int) -> Dict:
        """One policy update (add/delete a pattern) committed through
        the loader; a swap/bank fault may make it roll back or commit
        degraded — both recorded."""
        if op == "delete":
            extras = [(k, p) for k, p in self.rules_of[i]
                      if "/churn" in p or p.startswith("churn")
                      or p.startswith("ctbl")]
            if not extras:
                op = "add"  # nothing churned-in yet: degrade to add
            else:
                self.rules_of[i].remove(extras[0])
        if op == "add":
            # every 4th churned-in pattern lands on the cassandra
            # frontend: l7g bank churn rides the same O(Δ)
            # bound, bank-compile faults, and memo-refill machinery
            # as the http banks
            if step % 4 == 3:
                self.rules_of[i].append(("cass", f"ctbl{step}"))
            else:
                self.rules_of[i].append(("http", f"/churn{step}/.*"))
        self.revision += 1
        rolled_back = False
        reg = self.loader.bank_registry
        quarantined_before = reg.status()["quarantined"] if reg else 0
        # a registry with no cached groups (fresh process after a warm
        # restore) legitimately compiles the whole plan on its first
        # build — the adjacency bound only holds for a warm registry
        warm_registry = bool(reg and reg.status()["groups"])
        compiles_before = self.bank_compiles()
        self.attempts += 1
        try:
            self.loader.regenerate(self._resolve(),
                                   revision=self.revision)
        except Exception:
            # rollback path: the previous revision keeps serving and
            # the DESIRED state stays un-committed
            rolled_back = True
        else:
            self.committed = {j: list(v)
                              for j, v in self.rules_of.items()}
            self.changes += 1
        compiles = self.bank_compiles() - compiles_before
        if not warm_registry:
            # cold-start rebuild: baseline it out of the O(Δ) window
            self.compiles0 += compiles
            self.attempts -= 1
        quarantined_after = reg.status()["quarantined"] if reg else 0
        if (op == "delete" and not rolled_back and warm_registry
                and quarantined_before == 0 and quarantined_after == 0
                and compiles > COMPILES_PER_CHANGE_BOUND):
            # the content-defined partition's core property: a delete
            # perturbs only the adjacent bank(s). The positional-banks
            # planted bug shifts every later bank and trips this.
            raise InvariantViolation(
                step, "o-delta-compile",
                f"one clean delete compiled {compiles} banks "
                f"(> {COMPILES_PER_CHANGE_BOUND}: membership shifted "
                f"wholesale)")
        return {"op": op, "identity": i, "rolled_back": rolled_back,
                "compiles": compiles,
                "degraded": bool(self.loader.bank_status().get(
                    "degraded"))}

    def churn_burst(self, n: int, step: int) -> Dict:
        """A churn STORM: ``n`` CNP pattern mutations land
        between regenerations (the debounced-identity-storm shape),
        then ONE regenerate drives the whole multi-bank delta through
        the parallel compile queue. The O(Δ) accounting charges the
        attempt ``n`` change-units, so the per-change compile bound
        still holds — a storm may compile many banks, but only O(its
        own size)."""
        applied = 0
        for k in range(n):
            i = (step + k) % self.N_IDS
            if k % 3 == 2:
                extras = [(kk, p) for kk, p in self.rules_of[i]
                          if "/storm" in p or "/churn" in p]
                if extras:
                    self.rules_of[i].remove(extras[0])
                    applied += 1
                    continue
            self.rules_of[i].append(("http", f"/storm{step}k{k}/.*"))
            applied += 1
        self.revision += 1
        rolled_back = False
        reg = self.loader.bank_registry
        warm_registry = bool(reg and reg.status()["groups"])
        compiles_before = self.bank_compiles()
        self.attempts += max(1, applied)
        try:
            self.loader.regenerate(self._resolve(),
                                   revision=self.revision)
        except Exception:
            rolled_back = True
        else:
            self.committed = {j: list(v)
                              for j, v in self.rules_of.items()}
            self.changes += applied
        compiles = self.bank_compiles() - compiles_before
        if not warm_registry:
            self.compiles0 += compiles
            self.attempts -= max(1, applied)
        return {"mutations": applied, "rolled_back": rolled_back,
                "compiles": compiles,
                "degraded": bool(self.loader.bank_status().get(
                    "degraded"))}

    def traffic(self, index: int) -> Dict:
        """One verdict round through the breaker-guarded verdictor +
        the live session, with the oracle/fail-closed/session
        invariants."""
        from cilium_tpu_torch.core.flow import Verdict

        flows = self.corpus()
        want = self.oracle_verdicts(flows)
        got = self.verdictor.verdicts(flows)
        if int(Verdict.ERROR) in got:
            raise InvariantViolation(index, "no-error-verdicts",
                                     f"served ERROR: {got}")
        degraded = bool(self.loader.bank_status().get("degraded"))
        if not degraded and got != want:
            raise InvariantViolation(
                index, "oracle-agreement",
                f"served {got} != oracle {want} (not degraded)")
        if degraded:
            # fail-closed: a quarantined plane may deny more than the
            # oracle, never allow what the oracle denies
            for k, (g, w) in enumerate(zip(got, want)):
                if w == int(Verdict.DROPPED) and g != w:
                    raise InvariantViolation(
                        index, "fail-closed",
                        f"flow {k}: oracle denies, degraded plane "
                        f"served {g}")
        sess = self.session_verdicts(index)
        return {"verdicts": _digest(got), "degraded": degraded,
                "breaker": self.breaker.state, "session": sess}

    def session_verdicts(self, index: int) -> Dict:
        """The live capture-replay session must follow every commit
        (bit-equal to the serving engine) with honest memo accounting."""
        from cilium_tpu_torch.core.flow import Verdict

        try:
            if self._session is None:
                from cilium_tpu_torch.engine.replay import CaptureReplay
                from cilium_tpu_torch.ingest.columnar import flows_to_columns

                # the staged capture is pinned at session birth: later
                # churn invalidates memo rows bank-scoped, it does not
                # change which rows the session replays
                self._session_flows = self.corpus() * 4
                cols = flows_to_columns(self._session_flows)
                self._session_cols = cols
                replay = CaptureReplay(self.loader.engine, cols.l7,
                                       cols.offsets, cols.blob,
                                       self.cfg.engine, gen=cols.gen,
                                       loader=self.loader)
                replay.stage_rows(cols.rec, cols.l7)
                replay.stage_unique()
                self._session = replay
            cols = self._session_cols
            out = self._session.verdict_chunk(cols.rec, cols.l7)
        except InvariantViolation:
            raise
        except Exception as e:  # noqa: BLE001 — an injected dispatch
            # fault failing the session chunk is a legitimate outcome
            # (the stream path rebuilds its session the same way);
            # the NEXT round must stage fresh and agree again
            self._session = None
            return {"faulted": type(e).__name__}
        got = [int(v) for v in out["verdict"]]
        if int(Verdict.ERROR) in got:
            raise InvariantViolation(index, "session-no-error",
                                     "session served ERROR")
        engine = self.loader.engine
        try:
            want = [int(v) for v in engine.verdict_flows(
                self._session_flows)["verdict"]]
        except Exception as e:  # noqa: BLE001 — injected dispatch fault
            # on the comparison round: skip the bit-equality check,
            # keep the session; its verdicts were already checked
            # ERROR-free above
            return {"verdicts": _digest(got),
                    "compare_faulted": type(e).__name__}
        if got != want:
            raise InvariantViolation(
                index, "session-stale",
                "session verdicts diverged from the serving engine")
        m = self._session.memo
        memo = {}
        if m is not None:
            if m.hits + m.misses < m.hits or m.hits < 0 or m.misses < 0:
                raise InvariantViolation(index, "memo-accounting",
                                         f"hits={m.hits} "
                                         f"misses={m.misses}")
            memo = {"hits": m.hits, "misses": m.misses,
                    "invalidations": m.invalidations}
        return {"verdicts": _digest(got), "memo": memo}

    def serve(self, n_streams: int, index: int) -> Dict:
        """One round through the continuously-batched serving loop:
        ``n_streams`` virtual streams connect (reconnect-with-resume
        — a live lease renews, never re-grants), each submits the
        probe corpus as a chunk, ONE inline pack cycle serves them.
        Invariants: every chunk resolves or sheds explicitly (nothing
        vanishes), ring verdicts are bit-equal to the serving engine
        when not degraded and never ERROR, and lease accounting is
        exact. Armed ``serve.lease``/``serve.ring_slot`` faults are
        explicit sheds, recorded in the trace."""
        from cilium_tpu_torch.core.flow import Verdict
        from cilium_tpu_torch.ingest.columnar import flows_to_columns
        from cilium_tpu_torch.runtime.serveloop import (
            LeaseExpired,
            ServeLoop,
            ShedError,
        )

        from cilium_tpu_torch.engine.memo import policy_generation

        if self._serve is None:
            self._serve = ServeLoop(self.loader, capacity=4,
                                    lease_ttl_s=10.0,
                                    pack_interval_s=0.01)
        loop = self._serve
        flows = self.corpus()
        # explanation-honesty base: pin what "the committed rule set
        # at this generation" MEANS before any fill can cite it. Ring
        # memo fills only happen inside serve rounds, so lazily
        # snapshotting here covers every citable generation.
        self._serve_gen = policy_generation()
        degraded_now = bool(self.loader.bank_status().get("degraded"))
        self._gen_snapshots.setdefault(
            self._serve_gen,
            ({i: list(v) for i, v in self.committed.items()},
             degraded_now))
        while len(self._gen_snapshots) > 128:
            self._gen_snapshots.pop(min(self._gen_snapshots))
        cols = flows_to_columns(flows)
        sections = (cols.rec, cols.l7, cols.offsets, cols.blob,
                    cols.gen)
        tickets = []
        sheds = 0
        grants_before = loop.grants
        for k in range(n_streams):
            sid = f"dst-s{k}"
            try:
                lease = loop.connect(sid, resume=True)
            except ShedError:
                sheds += 1
                continue
            try:
                tickets.append(loop.submit(lease, *sections))
            except (ShedError, LeaseExpired):
                sheds += 1
        try:
            loop.step()
        except Exception as e:  # noqa: BLE001 — an injected dispatch
            # fault failing the pack is a legitimate outcome; the
            # restarted loop must converge next round
            self._serve = None
            return {"faulted": type(e).__name__, "sheds": sheds}
        degraded = bool(self.loader.bank_status().get("degraded"))
        want = None
        got_digest = ""
        prov_checked = 0
        for t in tickets:
            if not t.done:
                raise InvariantViolation(
                    index, "serve-liveness",
                    "a submitted chunk neither resolved nor shed "
                    "after the pack cycle")
            if t.error is not None:
                sheds += 1  # session-reset/lease loss: explicit
                continue
            got = [int(v) for v in t.verdicts]
            if int(Verdict.ERROR) in got:
                raise InvariantViolation(index, "serve-no-error",
                                         "ring served ERROR")
            if want is None:
                try:
                    want = [int(v) for v in
                            self.loader.engine.verdict_flows(
                                flows)["verdict"]]
                except Exception:  # noqa: BLE001 — injected dispatch
                    want = got  # comparison round faulted: skip
            if not degraded and got != want:
                raise InvariantViolation(
                    index, "serve-stale",
                    "ring verdicts diverged from the serving engine")
            got_digest = _digest(got)
            if not prov_checked and t.prov is not None:
                # one ticket's worth of sampled explanation-honesty
                # checks per round (tickets share the corpus; one
                # bound keeps the schedule cost flat)
                prov_checked = self._check_explanation_honesty(
                    t, flows, index, degraded)
        st = loop.status()
        if st["grants"] - st["expiries"] - st["releases"] \
                != st["occupancy"]:
            raise InvariantViolation(
                index, "serve-lease-accounting",
                f"grants {st['grants']} - expiries {st['expiries']} "
                f"- releases {st['releases']} != occupancy "
                f"{st['occupancy']}")
        return {"streams": n_streams, "sheds": sheds,
                "grants_new": loop.grants - grants_before,
                "occupancy": st["occupancy"],
                "bytes_saved": st["bytes_saved"],
                "verdicts": got_digest,
                "prov_checked": prov_checked}

    def _check_explanation_honesty(self, ticket, flows, index: int,
                                   degraded_now: bool) -> int:
        """The explanation-honesty invariant over one resolved
        ticket's provenance: sampled rows must (a) cite a generation
        whose committed rule set was recorded, (b) cite the CURRENT
        generation when computed this round (memo-hit rows may
        legitimately cite older epochs — that is the point), and (c)
        re-resolve, under the cited generation's committed rules, to
        the served verdict (fail-closed comparison when either epoch
        was degraded). Returns sampled-row count."""
        import numpy as np

        from cilium_tpu_torch.core.flow import Verdict
        from cilium_tpu_torch.policy.oracle import OracleVerdictEngine

        prov = ticket.prov
        l7m = np.asarray(prov.l7_match)
        gens = np.asarray(prov.gens)
        hits = np.asarray(prov.memo_hit)
        verd = np.asarray(prov.verdict)
        n = min(len(flows), len(verd))
        step = max(1, n // 8)
        oracles: Dict[int, object] = {}
        checked = 0
        for r in range(0, n, step):
            gen = int(gens[r])
            snap = self._gen_snapshots.get(gen)
            if snap is None:
                raise InvariantViolation(
                    index, "explanation-honesty",
                    f"row {r} cites generation {gen} — no committed "
                    f"snapshot ever recorded for it (a fabricated or "
                    f"pre-fill citation)")
            if not bool(hits[r]) and gen != self._serve_gen:
                raise InvariantViolation(
                    index, "explanation-honesty",
                    f"row {r} was computed this round but cites "
                    f"generation {gen} != current {self._serve_gen}")
            rules_at, degraded_at = snap
            oracle = oracles.get(gen)
            if oracle is None:
                saved = self.rules_of
                self.rules_of = {i: list(v)
                                 for i, v in rules_at.items()}
                try:
                    per_identity = self._resolve()
                finally:
                    self.rules_of = saved
                oracle = oracles[gen] = OracleVerdictEngine(
                    per_identity)
            want = int(oracle.verdict_flows([flows[r]])["verdict"][0])
            got = int(verd[r])
            if degraded_at or degraded_now:
                # a degraded epoch may deny more, never allow what
                # the cited oracle denies
                if want == int(Verdict.DROPPED) and got != want:
                    raise InvariantViolation(
                        index, "explanation-honesty",
                        f"row {r}: degraded plane allowed what the "
                        f"cited-generation {gen} oracle denies")
            elif got != want:
                hint = ("memo-served" if bool(hits[r])
                        else "computed")
                raise InvariantViolation(
                    index, "explanation-honesty",
                    f"row {r} ({hint}, l7_match={int(l7m[r])}): "
                    f"served {got} != cited-generation {gen} oracle "
                    f"{want}")
            checked += 1
        return checked

    def multichip(self, index: int) -> Dict:
        """Sampled invariant checks through the SHARDED verdict lanes
        on two ranks of a ``gloo`` world: the DP-sharded step and the
        payload-sharded CP step must match the single-device step
        bit-for-bit on EVERY output lane, serve no ERROR, and hold
        oracle agreement / fail-closed exactly like the single-device
        plane — so mesh configs enter the searched fault space
        instead of living only in the bench. The ranks run no fault
        point: the plan lives in this process only."""
        import numpy as np

        from cilium_tpu_torch.core.flow import Verdict
        from cilium_tpu_torch.engine.compiled import (
            encode_flows,
            flowbatch_to_host_dict,
        )
        from cilium_tpu_torch.parallel.mesh import LocalWorld, WorldError

        n = 2
        flows = self.corpus()
        pad = (-len(flows)) % n
        padded = flows + flows[:pad]
        policy = self.loader.engine.policy
        try:
            host = flowbatch_to_host_dict(encode_flows(
                padded, policy.kafka_interns, self.cfg.engine))
            ref = _single_device_step(policy.arrays, host, self.device)
            if self._ranks is None:
                self._ranks = LocalWorld(n)
            lanes = self._ranks.run(
                _multichip_rank, dict(policy.arrays), host,
                str(self.device), self.cfg.parallel.cp_block)[0]
            out, cout = lanes["dp"], lanes["cp"]
        except InvariantViolation:
            raise
        except WorldError as e:
            # a failed rank tore the world down: respawn next round
            self._ranks = None
            return {"faulted": type(e).__name__}
        except Exception as e:  # noqa: BLE001 — an injected fault
            # failing the staging/dispatch is a legitimate outcome;
            # the next round must stage fresh and agree again
            return {"faulted": type(e).__name__}
        for lane, sharded in (("dp", out), ("cp", cout)):
            for key in ref:
                if not np.array_equal(np.asarray(sharded[key]),
                                      np.asarray(ref[key])):
                    raise InvariantViolation(
                        index, f"multichip-{lane}-parity",
                        f"sharded output lane {key!r} diverged from "
                        f"the single-device step")
        got = [int(v) for v in np.asarray(out["verdict"])[:len(flows)]]
        if int(Verdict.ERROR) in got:
            raise InvariantViolation(index, "multichip-no-error",
                                     "sharded step served ERROR")
        want = self.oracle_verdicts(flows)
        degraded = bool(self.loader.bank_status().get("degraded"))
        if not degraded and got != want:
            raise InvariantViolation(
                index, "multichip-oracle-agreement",
                f"sharded step served {got} != oracle {want} "
                f"(not degraded)")
        if degraded:
            for k, (g, w) in enumerate(zip(got, want)):
                if w == int(Verdict.DROPPED) and g != w:
                    raise InvariantViolation(
                        index, "multichip-fail-closed",
                        f"flow {k}: oracle denies, degraded sharded "
                        f"plane served {g}")
        return {"devices": n, "flows": len(flows),
                "verdicts": _digest(got), "degraded": degraded}

    def fleet(self, n_streams: int, action: str, index: int) -> Dict:
        """One round through the HORIZONTAL serving fleet:
        a scheduled fleet action (host kill / partition / heartbeat
        round / rejoin), then ``n_streams`` virtual streams connect
        through the stream-affinity router and submit the probe
        corpus. Armed ``fleet.heartbeat``/``fleet.handoff`` faults
        land on the beat and the death handoff. Invariants on every
        round: chunks resolve or shed explicitly (a HostDead submit
        resumes, never vanishes), no ERROR / stale verdicts off any
        replica ring, the fleet lease books are EXACT (sum over all
        replicas, dead ones included), and lease conservation — no
        stream holds leases on two live hosts, however the kill /
        handoff-interrupt / rejoin events interleave."""
        from cilium_tpu_torch.core.flow import Verdict
        from cilium_tpu_torch.ingest.columnar import flows_to_columns
        from cilium_tpu_torch.runtime.fleetserve import (
            FleetRouter,
            HostDead,
            HostReplica,
        )
        from cilium_tpu_torch.runtime.serveloop import LeaseExpired, ShedError

        if self._fleet is None:
            replicas = [HostReplica(i, self.loader, capacity=4,
                                    lease_ttl_s=10.0,
                                    pack_interval_s=0.01)
                        for i in range(3)]
            self._fleet = FleetRouter(replicas,
                                      heartbeat_interval_s=0.5,
                                      suspicion_ttl_s=2.0,
                                      spill_headroom=0.0)
        router = self._fleet
        # -- the scheduled fleet action (deterministic target pick:
        # the highest-index live replica, never the last one standing)
        live = [r for r in router.replicas if r.alive]
        did = action
        if action == "kill" and len(live) >= 2:
            router.kill(live[-1].name)
        elif action == "partition" and len(live) >= 2 \
                and not live[-1].cut:
            # the cut host fails CLOSED immediately (sheds
            # ``partitioned``); the suspicion sweep declares it dead
            # only once virtual time advances past the TTL — exactly
            # the window the conservation invariant must survive
            router.partition(live[-1].name)
        elif action == "rejoin":
            dead = [r for r in router.replicas if not r.alive]
            if dead:
                # loader=None: the revived replica keeps the world's
                # shared loader — the zero-recompile warm-restore path
                router.rejoin(dead[0].name)
            else:
                did = "rejoin-noop"
        else:
            did = f"{action}-noop" if action != "beat" else "beat"
        died = router.beat()
        # -- the serve round through the router ---------------------------
        flows = self.corpus()
        cols = flows_to_columns(flows)
        sections = (cols.rec, cols.l7, cols.offsets, cols.blob,
                    cols.gen)
        tickets = []
        sheds = 0
        replays = 0
        for k in range(n_streams):
            sid = f"dstf-s{k}"
            for _attempt in (0, 1):
                try:
                    _host, lease = router.connect(sid, resume=True)
                except ShedError:
                    sheds += 1
                    break
                except HostDead:
                    replays += 1
                    continue
                try:
                    tickets.append(router.submit(sid, lease, sections))
                    break
                except HostDead:
                    # died between admit and submit: the typed resume
                    # path — reconnect and replay, never stream-fatal
                    replays += 1
                    continue
                except (ShedError, LeaseExpired):
                    sheds += 1
                    break
            else:
                sheds += 1  # resume budget exhausted: explicit shed
        try:
            router.step_all()
        except Exception as e:  # noqa: BLE001 — an injected dispatch
            # fault failing a pack is a legitimate outcome; the fresh
            # fleet must converge next round
            self._fleet = None
            return {"faulted": type(e).__name__, "sheds": sheds}
        degraded = bool(self.loader.bank_status().get("degraded"))
        want = None
        resolved = 0
        for t in tickets:
            if not t.done:
                raise InvariantViolation(
                    index, "fleet-liveness",
                    "a chunk submitted through the router neither "
                    "resolved nor shed after the fleet pack cycle")
            if t.error is not None:
                sheds += 1  # lease-closed from a death: explicit
                continue
            resolved += 1
            got = [int(v) for v in t.verdicts]
            if int(Verdict.ERROR) in got:
                raise InvariantViolation(
                    index, "fleet-no-error",
                    "a replica ring served ERROR")
            if want is None:
                try:
                    want = [int(v) for v in
                            self.loader.engine.verdict_flows(
                                flows)["verdict"]]
                except Exception:  # noqa: BLE001 — injected dispatch
                    want = got  # comparison round faulted: skip
            if not degraded and got != want:
                raise InvariantViolation(
                    index, "fleet-stale",
                    "a replica ring's verdicts diverged from the "
                    "shared serving engine")
        bal, occ = router.books()
        if bal != occ:
            raise InvariantViolation(
                index, "fleet-lease-accounting",
                f"fleet-wide grants - expiries - releases = {bal} != "
                f"occupancy {occ} (summed over ALL replicas)")
        dup = router.conservation_violation()
        if dup is not None:
            raise InvariantViolation(
                index, "lease-conservation",
                f"stream {dup[0]!r} holds live leases on {dup[1]} "
                f"and {dup[2]}")
        journal_bad = router.journal_consistent()
        if journal_bad is not None:
            raise InvariantViolation(
                index, "fleet-journal-consistency",
                f"folding the fleet event journal diverged from the "
                f"router's books: {journal_bad}")
        return {"streams": n_streams, "action": did,
                "beat_deaths": list(died), "sheds": sheds,
                "replays": replays, "resolved": resolved,
                "live_hosts": sum(1 for r in router.replicas
                                  if r.alive),
                "handoffs": router.handoffs,
                "partial_handoffs": router.partial_handoffs,
                "occupancy": occ}

    def _tenant_probe_flows(self, i: int):
        """Tenant ``i``'s slice of the probe corpus (its committed
        patterns + a never-allowed canary), deterministic order."""
        flows = []
        for kind, pat in self.committed[i]:
            if kind == "http":
                flows.append(self._http(i, pat.replace("/.*", "/x")))
            elif kind == "dns":
                flows.append(self._dns(i, pat))
            else:
                proto, dport, mk = self._FE_KINDS[kind]
                flows.append(self._fe(i, proto, dport, mk(pat)))
        flows.append(self._http(i, "/never/allowed"))
        return flows

    def tenant_isolation(self, mode: str, index: int) -> Dict:
        """The tenant-isolation invariant: tenant A's faults
        — an A-only churn storm (with whatever bank-compile faults
        the schedule armed), a quota lapse/fault while A floods a
        congested admission window, or a bad canary rollout scoped to
        A's entries — must provably never move tenant B's served
        verdicts, B's compiled banks (namespace-attributed keys), or
        B's admission outcomes."""
        A, B = 0, 1
        reg = self.loader.bank_registry
        flows_b = self._tenant_probe_flows(B)

        def b_verdicts():
            try:
                return [int(v) for v in self.loader.engine
                        .verdict_flows(flows_b)["verdict"]]
            except Exception:  # noqa: BLE001 — an injected dispatch
                return None    # fault: skip the equality leg

        before = b_verdicts()
        keys_before = tuple(reg.keys_in_namespace("b")) if reg else ()
        out: Dict = {"mode": mode}
        if mode == "churn-storm":
            # tenant A's churn storm: 3 A-only mutations, one
            # regenerate — with the namespaced planner, only A (and
            # shared) banks may compile; an armed loader.bank_compile
            # fault can only quarantine those
            # 6 patterns: enough banks in A's namespace (bank_size 2)
            # that a positional wholesale shift on the delete leg
            # below exceeds the O(Δ) adjacency bound — the planted
            # positional-banks mutation stays catchable in the
            # NAMESPACED world (the planted-bug search's seed budget)
            applied = 6
            for k in range(applied):
                # the "/churn" stem keeps these deletable by the churn
                # executor: the storm's delete leg below rides the
                # same O(Δ) adjacency check as plain churn deletes
                self.rules_of[A].append(
                    ("http", f"/churnt{index}k{k}/.*"))
            self.revision += 1
            rolled_back = False
            warm_registry = bool(reg and reg.status()["groups"])
            compiles_before = self.bank_compiles()
            self.attempts += applied
            try:
                self.loader.regenerate(self._resolve(),
                                       revision=self.revision)
            except Exception:
                rolled_back = True
            else:
                self.committed = {j: list(v)
                                  for j, v in self.rules_of.items()}
                self.changes += applied
            compiles = self.bank_compiles() - compiles_before
            if not warm_registry:
                self.compiles0 += compiles
                self.attempts -= applied
            out.update({"mutations": applied,
                        "rolled_back": rolled_back,
                        "compiles": compiles,
                        "degraded": bool(self.loader.bank_status()
                                         .get("degraded"))})
            if not rolled_back:
                # the storm's DELETE leg: tenant A retracts one of its
                # churned-in patterns through the ordinary churn
                # executor — a warm A-namespace delete must perturb
                # only the adjacent A bank(s) (the o-delta-compile
                # check inside churn() enforces it), and B's banks/
                # verdicts stay unmoved either way
                out["delete"] = self.churn("delete", A, index)
        elif mode == "quota":
            from cilium_tpu_torch.runtime import admission as adm
            from cilium_tpu_torch.runtime.tenant import (
                FairShareWindow,
                TenantMap,
                TenantQuotas,
            )

            tmap = TenantMap.from_config(self.cfg)
            quotas = TenantQuotas.from_config(self.cfg)
            # A's generous share lapses AT the tick (ttl 0, closed
            # boundary): every read from here is the conservative
            # default — and an armed tenant.quota fault forces the
            # same default, so A is bounded either way
            quotas.set_share("a", 0.9, ttl_s=0.0)
            fair = FairShareWindow(
                quantum_s=self.cfg.tenant.quantum_s,
                max_share=self.cfg.tenant.max_share,
                weight_of=tmap.weight_of)
            gate = adm.AdmissionGate(
                max_pending=8, control_reserve=2,
                depth_fn=lambda: 6,  # congested: fairness armed
                fairness=fair, quotas=quotas)
            for _ in range(3):   # B establishes presence first
                ok, _r = gate.admit(adm.CLASS_DATA, tenant="b")
                if not ok:
                    raise InvariantViolation(
                        index, "tenant-isolation",
                        "tenant B shed before tenant A stormed")
            a_ok = a_shed = 0
            for _ in range(12):  # tenant A floods the window
                ok, reason = gate.admit(adm.CLASS_DATA, tenant="a")
                if ok:
                    a_ok += 1
                    continue
                a_shed += 1
                if reason != adm.SHED_TENANT_QUOTA:
                    raise InvariantViolation(
                        index, "tenant-isolation",
                        f"tenant A's flood shed with reason "
                        f"{reason!r} — not tenant-attributed")
            if a_shed == 0:
                raise InvariantViolation(
                    index, "tenant-isolation",
                    "tenant A stormed 12 admits past its share and "
                    "never shed tenant-quota")
            # B's outcomes unmoved by A's storm: B's fair allotment
            # (2 more of this window under equal weights) must admit
            for _ in range(2):
                ok, reason = gate.admit(adm.CLASS_DATA, tenant="b")
                if not ok:
                    raise InvariantViolation(
                        index, "tenant-isolation",
                        f"tenant B shed ({reason}) while only tenant "
                        f"A stormed the window")
            out.update({"a_admitted": a_ok, "a_shed": a_shed,
                        "quota": quotas.status()["default_share"]})
        else:  # canary
            if bool(self.loader.bank_status().get("degraded")):
                # a quarantined plane may already DENY A's flows —
                # the bad rollout would legitimately diff zero; the
                # arm only proves the gate on a healthy plane
                out["skipped"] = "degraded"
            else:
                import copy

                from cilium_tpu_torch.runtime.canary import (
                    CanaryController,
                    CanaryRefused,
                )

                rev_before = self.loader.revision
                try:
                    flows = self.corpus()
                    served = [int(v) for v in self.loader.engine
                              .verdict_flows(flows)["verdict"]]
                except Exception as e:  # noqa: BLE001 — injected
                    out["faulted"] = type(e).__name__
                    return out
                bad = copy.deepcopy(self._resolve())
                for entry in bad[self.dbs[A]].entries.values():
                    entry.is_deny = True  # A's bad CNP: mass-deny
                ctl = CanaryController(self.loader,
                                       sample_fraction=1.0,
                                       diff_budget=0.0,
                                       min_samples=1)
                ctl.stage(bad, revision=rev_before + 1)
                ctl.observe_chunk(flows, served)
                refused = aborted = False
                try:
                    ctl.try_commit()
                except CanaryRefused:
                    refused = True
                except RuntimeError:
                    # an armed canary.dispatch fault aborted the
                    # rollout before commit — the safe degradation
                    aborted = ctl.state == "aborted"
                if not (refused or aborted):
                    raise InvariantViolation(
                        index, "tenant-isolation",
                        "a bad tenant-A canary COMMITTED through "
                        "the verdict-diff gate")
                if self.loader.revision != rev_before:
                    raise InvariantViolation(
                        index, "tenant-isolation",
                        "a refused/aborted canary moved the serving "
                        "revision")
                out.update({"refused": refused, "aborted": aborted,
                            "diffs": ctl.report()["diffs"]})
        keys_after = tuple(reg.keys_in_namespace("b")) if reg else ()
        if keys_before and keys_after != keys_before:
            raise InvariantViolation(
                index, "tenant-isolation",
                f"tenant A's {mode} moved tenant B's bank keys "
                f"({len(keys_before)} -> {len(keys_after)})")
        after = b_verdicts()
        if before is not None and after is not None \
                and after != before:
            raise InvariantViolation(
                index, "tenant-isolation",
                f"tenant A's {mode} changed tenant B's served "
                f"verdicts")
        out["b_verdicts"] = _digest(after if after is not None
                                    else [])
        return out

    def storm(self, n: int, index: int) -> Dict:
        """A burst of identity add/delete through the kvstore watch
        (the churn_storm point may lose deliveries); local allocation
        and a fresh replay-then-follow must converge regardless."""
        from cilium_tpu_torch.identity_kvstore import (
            ClusterIdentityAllocator,
            VALUE_PREFIX,
        )

        for k in range(n):
            labels = self.storm_pool[k % len(self.storm_pool)]
            if k % 3 == 2:
                nid = self.cluster_alloc.lookup_by_labels(labels)
                if nid is not None:
                    enc = ";".join(sorted(labels.format()))
                    self.store.delete(VALUE_PREFIX + enc)
            else:
                self.cluster_alloc.allocate(labels)
        # convergence: a fresh allocator replaying the store agrees
        # with the store's authoritative mappings
        fresh = ClusterIdentityAllocator(self.store).start()
        try:
            for key, raw in self.store.list_prefix(
                    VALUE_PREFIX).items():
                enc = key[len(VALUE_PREFIX):]
                from cilium_tpu_torch.identity_kvstore import _decode_enc

                nid = fresh.lookup_by_labels(_decode_enc(enc))
                if nid != int(raw):
                    raise InvariantViolation(
                        index, "identity-convergence",
                        f"fresh replay maps {enc!r} to {nid}, "
                        f"store says {raw}")
        finally:
            fresh.close()
        return {"events": n, "store_keys": len(self.store)}

    def clustermesh_sync(self, n: int, index: int) -> Dict:
        """A remote-cluster sync round: ``n`` remote
        endpoint announcements ride a LocalStatePublisher → kvstore →
        RemoteCluster watch into the LOCAL allocator/ipcache, with
        the ``clustermesh.session``/``clustermesh.heartbeat`` fault
        points live on the path. A session fault eats one delivery
        (isolated by the kvstore watch) and a heartbeat fault skips a
        lease keepalive — both must CONVERGE under the bounded repair
        loop (re-upsert + heartbeat), or the mesh is silently
        diverging: every published prefix must resolve locally to an
        identity tagged with the remote cluster's name."""
        import json as _json

        from cilium_tpu_torch.clustermesh import (
            CLUSTER_LABEL_KEY,
            IP_PREFIX,
            LocalStatePublisher,
            RemoteCluster,
        )
        from cilium_tpu_torch.core.labels import SOURCE_K8S, LabelSet
        from cilium_tpu_torch.ipcache import IPCache
        from cilium_tpu_torch.kvstore import KVStore

        if self._mesh is None:
            store = KVStore()
            remote_alloc_ipc = IPCache(self.alloc)
            local_ipc = IPCache(self.alloc)
            pub = LocalStatePublisher(store, "alpha", self.alloc,
                                      remote_alloc_ipc,
                                      lease_ttl=3600.0)
            rc = RemoteCluster("alpha", store, self.alloc,
                               local_ipc).connect()
            self._mesh = (store, remote_alloc_ipc, local_ipc, pub, rc)
            self._mesh_n = 0
        store, remote_ipc, local_ipc, pub, rc = self._mesh
        faulted = 0
        for k in range(n):
            idx = self._mesh_n
            self._mesh_n += 1
            nid = self.alloc.allocate(LabelSet.from_dict(
                {"meshapp": f"m{idx % 6}"}))
            try:
                remote_ipc.upsert(f"10.9.{idx // 200}."
                                  f"{idx % 200 + 1}/32", nid)
            except Exception:  # noqa: BLE001 — injected session fault
                faulted += 1
        try:
            pub.heartbeat()
        except Exception:  # noqa: BLE001 — injected heartbeat fault
            faulted += 1
        # bounded repair: re-announce every published entry (value
        # bumped so the watch re-delivers) + heartbeat, then REQUIRE
        # convergence — the re-announce is exactly the reference's
        # reconcile loop, so an unconverged mesh is a real bug
        for _attempt in range(3):
            try:
                for e in remote_ipc.dump():
                    nid = int(e["identity"])
                    labels = self.alloc.lookup(nid)
                    store.set(
                        f"{IP_PREFIX}alpha/{e['cidr']}",
                        _json.dumps({
                            "prefix": e["cidr"], "identity": nid,
                            "labels": (list(labels.format())
                                       if labels else []),
                            "cluster": "alpha",
                            "seq": _attempt}))
                pub.heartbeat()
                break
            except Exception:  # noqa: BLE001 — still-armed faults
                faulted += 1
        for e in remote_ipc.dump():
            nid = local_ipc.lookup(e["cidr"].split("/")[0])
            if nid is None:
                raise InvariantViolation(
                    index, "clustermesh-convergence",
                    f"published prefix {e['cidr']} missing from the "
                    f"local ipcache after repair")
            labels = self.alloc.lookup(nid)
            tag = (labels.get(CLUSTER_LABEL_KEY, SOURCE_K8S)
                   if labels else None)
            if tag is None or tag.value != "alpha":
                raise InvariantViolation(
                    index, "clustermesh-convergence",
                    f"prefix {e['cidr']} resolved without the remote "
                    f"cluster tag")
        return {"announced": n, "entries": rc.num_entries(),
                "faulted": faulted}

    def drain_restore(self, index: int) -> Dict:
        """Warm-restart cycle: snapshot the serving state, restore it
        into a FRESH loader (the restarted process), and re-point the
        verdictor/session at it — first answers must be verdict-
        identical (the traffic invariant right after proves it)."""
        from cilium_tpu_torch.runtime.loader import Loader
        from cilium_tpu_torch.runtime.service import ResilientVerdictor

        warm = self.loader.snapshot_warm()
        restored = False
        crashed = ""
        if warm:
            fresh = Loader(self.cfg, device=self.device)
            try:
                restored = fresh.restore_warm()
            except Exception as e:  # noqa: BLE001 — an injected swap
                # fault mid-restore models a crash during warm boot;
                # the OLD process keeps serving (restored stays False)
                crashed = type(e).__name__
            if restored:
                self._compiles_carry = self.bank_compiles()
                self.loader.close()   # old incarnation's workers die
                self.loader = fresh
                self.verdictor = ResilientVerdictor(
                    self.loader, breaker=self.breaker)
                # the restarted process stages a fresh session, and
                # its empty bank registry re-compiles the plan once —
                # cold-start cost, not churn cost: reset the O(Δ)
                # accounting window to this incarnation
                self._session = None
                # ...and a fresh serving loop: ring/lease state is
                # process-resident, not snapshot state
                self._serve = None
                # ...the fleet too: the replicas' rings died with the
                # old process, and they must share the NEW loader
                self._fleet = None
                self.compiles0 = self.bank_compiles()
                self.attempts = 0
        return {"warm_snapshot": warm, "restored": restored,
                "crashed": crashed, "revision": self.loader.revision}

    # -- end-of-schedule liveness -----------------------------------------
    def check_liveness(self, plan: SchedulePlan, clock, index: int,
                      ) -> Dict:
        """With faults exhausted, bounded virtual time recovers the
        plane: breaker re-closes, quarantines clear, verdicts match."""
        from cilium_tpu_torch.runtime.service import CircuitBreaker

        plan.disarm_all()
        clock.advance(PROBE_INTERVAL_S + 0.1)
        out = self.traffic(index)
        if self.breaker.state != CircuitBreaker.CLOSED:
            raise InvariantViolation(
                index, "breaker-liveness",
                f"breaker state {self.breaker.state} after a healthy "
                f"round past the probe interval")
        if out["degraded"]:
            clock.advance(QUARANTINE_TTL_S + 0.1)
            reg = self.loader.bank_registry
            quarantined = reg.status()["quarantined"] if reg else 0
            self.revision += 1
            self.attempts += 1
            self.loader.regenerate(self._resolve(),
                                   revision=self.revision)
            # the recovery regenerate recompiles each previously-
            # quarantined bank once — O(injected faults), the cost of
            # RECOVERY, not wholesale churn work: baseline it out of
            # the O(Δ) window like cold-start rebuilds (a schedule
            # arming 5 bank-compile faults must not read as 5
            # compiles/attempt)
            self.compiles0 += quarantined
            self.committed = {j: list(v)
                              for j, v in self.rules_of.items()}
            if self.loader.bank_status().get("degraded"):
                raise InvariantViolation(
                    index, "quarantine-liveness",
                    "bank quarantine survived TTL + regeneration "
                    "with faults exhausted")
            out = self.traffic(index)
        compiles = self.bank_compiles() - self.compiles0
        if self.attempts and compiles / self.attempts > \
                COMPILES_PER_CHANGE_BOUND:
            raise InvariantViolation(
                index, "o-delta-compile",
                f"{compiles} bank compiles over {self.attempts} "
                f"regenerate attempts "
                f"(> {COMPILES_PER_CHANGE_BOUND}/attempt: "
                f"wholesale recompiles)")
        # restart survivability: with faults exhausted, a clean
        # drain → warm-restore cycle must stage the SERVING policy —
        # a poisoned artifact pointer left behind by an earlier
        # faulted sequence (the rollback-artifact-key shape)
        # surfaces HERE as oracle disagreement on the restarted
        # process's first round, however the faults masked it while
        # they were armed (a crashed restore hides the bad pointer;
        # the exhausted retry does not)
        restart = self.drain_restore(index)
        out = self.traffic(index)
        return {"final": out, "bank_compiles": compiles,
                "changes": self.changes, "attempts": self.attempts,
                "restart": restart}

    def close(self) -> None:
        if self._mesh is not None:
            self._mesh[4].disconnect()
            self._mesh = None
        if self._ranks is not None:
            self._ranks.close()
            self._ranks = None
        self.cluster_alloc.close()
        self.loader.close()


def _digest(verdicts: Sequence[int]) -> str:
    return hashlib.sha256(bytes(int(v) & 0xFF
                                for v in verdicts)).hexdigest()[:16]


# -- schedules ---------------------------------------------------------------


def generate(seed: int, max_events: int = 12) -> List[List]:
    """The seeded schedule: a concrete event list (JSON-serializable,
    self-contained) so a shrunken subset re-runs without the RNG."""
    rng = random.Random(seed)
    n = rng.randint(max(3, max_events // 2), max_events)
    events: List[List] = []
    for k in range(n):
        roll = rng.random()
        if roll < 0.22:
            point = rng.choice(FAULT_POINTS)
            events.append(["fault", point, rng.randint(1, 3)])
        elif roll < 0.36:
            events.append(["churn",
                           rng.choice(["add", "add", "delete"]),
                           rng.randrange(DSTWorld.N_IDS)])
        elif roll < 0.44:
            # a churn STORM through the parallel compile
            # queue — n mutations, one regenerate, O(Δ) still bounded.
            # Sizes stay small: every net-new pattern grows the probe
            # corpus, and each distinct corpus size re-traces the
            # jitted step — a size-9 burst tripled the sweep's wall
            # time for no extra invariant coverage.
            events.append(["churn-burst", rng.randint(2, 5)])
        elif roll < 0.56:
            events.append(["traffic"])
        elif roll < 0.66:
            events.append(["serve", rng.randint(2, 6)])
        elif roll < 0.70:
            # the horizontal fleet enters the searched
            # space — a scheduled host kill/partition/beat/rejoin
            # with the heartbeat+handoff fault points armable, then a
            # routed serve round; lease conservation and exact
            # fleet-wide books checked every time
            events.append(["fleet", rng.randint(2, 6),
                           rng.choice(["kill", "partition", "beat",
                                       "rejoin"])])
        elif roll < 0.72:
            # sharded-lane checks ride the schedule space —
            # a fault armed two events earlier now also hits the mesh
            events.append(["multichip"])
        elif roll < 0.77:
            # a cross-cluster sync round — remote-identity
            # announcements through the clustermesh watch, with the
            # session/heartbeat fault points in the armable set and a
            # convergence invariant after the bounded repair loop
            events.append(["clustermesh", rng.randint(2, 6)])
        elif roll < 0.83:
            events.append(["advance", rng.choice(ADVANCES)])
        elif roll < 0.88:
            # the tenant-isolation invariant enters the
            # searched space — tenant A storms/lapses/stages a bad
            # canary (whatever faults are armed land on it) and
            # tenant B's verdicts, banks, and admission outcomes are
            # checked unmoved
            events.append(["tenant",
                           rng.choice(["churn-storm", "quota",
                                       "canary"])])
        elif roll < 0.91:
            events.append(["storm", rng.randint(4, 24)])
        else:
            events.append(["drain-restore"])
    # every schedule ends with the liveness epilogue (implicit)
    return events


def schedule_digest(events: Sequence[Sequence]) -> str:
    return hashlib.sha256(json.dumps(
        list(events), sort_keys=True).encode()).hexdigest()[:16]


def run_schedule(seed: int, events: Optional[List[List]] = None,
                 cache_dir: Optional[str] = None,
                 max_events: int = 12, device: DeviceLike = None) -> Dict:
    """Execute one schedule under a fresh world + driven VirtualClock,
    the world on ``device`` (``cuda`` unless named; raises without
    CUDA). Returns ``{"seed", "events", "trace", "digest",
    "violation"}``; the trace is byte-identical for identical (seed,
    events), whatever the device."""
    device = resolve_device(device)
    if events is None:
        events = generate(seed, max_events=max_events)
    # a FRESH artifact-cache dir per schedule: a pre-warmed cache
    # would skip bank compiles and change the trace's compile counts —
    # byte-identical replay requires a byte-identical starting state
    import shutil
    import tempfile

    own_cache = cache_dir is None
    if own_cache:
        cache_dir = tempfile.mkdtemp(prefix="ct_dst_")
    trace: List[Dict] = []
    violation: Optional[Dict] = None
    plan = SchedulePlan()
    clock = simclock.VirtualClock()
    with simclock.use(clock):
        world = DSTWorld(cache_dir, device=device)
        try:
            with faults.inject(plan):
                for i, ev in enumerate(events):
                    kind = ev[0]
                    try:
                        if kind == "fault":
                            plan.arm(ev[1], int(ev[2]))
                            out = {"armed": ev[1], "times": int(ev[2])}
                        elif kind == "churn":
                            out = world.churn(ev[1], int(ev[2]) %
                                              DSTWorld.N_IDS, step=i)
                        elif kind == "churn-burst":
                            out = world.churn_burst(int(ev[1]), step=i)
                        elif kind == "traffic":
                            out = world.traffic(i)
                        elif kind == "serve":
                            out = world.serve(int(ev[1]), i)
                        elif kind == "fleet":
                            out = world.fleet(int(ev[1]), str(ev[2]), i)
                        elif kind == "multichip":
                            out = world.multichip(i)
                        elif kind == "clustermesh":
                            out = world.clustermesh_sync(int(ev[1]), i)
                        elif kind == "advance":
                            clock.advance(float(ev[1]))
                            out = {"now": round(clock.now(), 6)}
                        elif kind == "tenant":
                            out = world.tenant_isolation(str(ev[1]), i)
                        elif kind == "storm":
                            out = world.storm(int(ev[1]), i)
                        elif kind == "drain-restore":
                            out = world.drain_restore(i)
                        else:
                            raise ValueError(f"unknown event {ev!r}")
                    except InvariantViolation as v:
                        violation = {"index": v.index,
                                     "invariant": v.invariant,
                                     "detail": v.detail}
                        trace.append({"i": i, "t": round(clock.now(), 6),
                                      "event": list(ev),
                                      "violation": violation})
                        break
                    trace.append({"i": i, "t": round(clock.now(), 6),
                                  "event": list(ev), "out": out})
                if violation is None:
                    try:
                        out = world.check_liveness(plan, clock,
                                                   len(events))
                        trace.append({"i": len(events),
                                      "t": round(clock.now(), 6),
                                      "event": ["liveness"],
                                      "out": out})
                    except InvariantViolation as v:
                        violation = {"index": v.index,
                                     "invariant": v.invariant,
                                     "detail": v.detail}
                        trace.append({"i": len(events),
                                      "t": round(clock.now(), 6),
                                      "event": ["liveness"],
                                      "violation": violation})
        finally:
            world.close()
            if own_cache:
                shutil.rmtree(cache_dir, ignore_errors=True)
    blob = json.dumps({"format": SCHEDULE_FORMAT, "seed": seed,
                       "events": events, "trace": trace},
                      sort_keys=True)
    return {"seed": seed, "events": events, "trace": trace,
            "digest": hashlib.sha256(blob.encode()).hexdigest(),
            "schedule_digest": schedule_digest(events),
            "violation": violation}


# -- search + shrink ---------------------------------------------------------


def search(schedules: int, seed0: int = 0, max_events: int = 12,
           cache_dir: Optional[str] = None,
           progress=None, device: DeviceLike = None
           ) -> Tuple[int, Optional[Dict]]:
    """Run ``schedules`` seeded schedules; returns (count_run, first
    violating result or None)."""
    for k in range(schedules):
        res = run_schedule(seed0 + k, cache_dir=cache_dir,
                           max_events=max_events, device=device)
        if progress is not None:
            progress(k, res)
        if res["violation"] is not None:
            return k + 1, res
    return schedules, None


def shrink(seed: int, events: List[List],
           cache_dir: Optional[str] = None,
           device: DeviceLike = None) -> Dict:
    """Delta-debug a violating schedule to a (1-)minimal event list:
    repeatedly drop chunks, keeping any subset that still violates.
    Returns the final violating result (its ``events`` are minimal —
    removing any single event no longer violates)."""
    def violates(evs: List[List]) -> Optional[Dict]:
        res = run_schedule(seed, events=evs, cache_dir=cache_dir,
                           device=device)
        return res if res["violation"] is not None else None

    best = violates(events)
    assert best is not None, "shrink() needs a violating schedule"
    n = 2
    evs = list(events)
    while len(evs) >= 2:
        chunk = max(1, len(evs) // n)
        shrunk = False
        for start in range(0, len(evs), chunk):
            cand = evs[:start] + evs[start + chunk:]
            if not cand:
                continue
            res = violates(cand)
            if res is not None:
                evs, best = cand, res
                n = max(n - 1, 2)
                shrunk = True
                break
        if not shrunk:
            if n >= len(evs):
                break
            n = min(len(evs), n * 2)
    return best


def emit_regression(result: Dict, out_dir: str) -> str:
    """Write a violating (ideally shrunken) schedule as a committable
    regression case (the port's DST tests replay the committed
    corpus)."""
    os.makedirs(out_dir, exist_ok=True)
    name = (f"dst_seed{result['seed']}_"
            f"{result['schedule_digest']}.json")
    path = os.path.join(out_dir, name)
    with open(path, "w") as fp:
        json.dump({"format": SCHEDULE_FORMAT,
                   "seed": result["seed"],
                   "events": result["events"],
                   "violation": result["violation"],
                   "mutation": os.environ.get(faults.MUTATION_ENV, "")},
                  fp, indent=2, sort_keys=True)
        fp.write("\n")
    return path


# -- the sweep lane ----------------------------------------------------------


def sweep(schedules: int, seed0: int = 0, max_events: int = 12,
          device: DeviceLike = None, log=print,
          on_result=None) -> Tuple[Dict, Optional[Dict], List[str]]:
    """The lane: ``schedules`` seeded schedules from ``seed0`` on
    ``device``, a progress line every 25, ``on_result(result)`` after
    each → (the lane's summary line, unstamped, with the reference
    lane's fields — schedules explored, distinct schedules, violations,
    simulated and wall seconds and their ratio; the first violating
    result or None; the distinct schedules' digests, sorted)."""
    device = resolve_device(device)
    distinct = set()
    sim_s = [0.0]

    def progress(k, res):
        if on_result is not None:
            on_result(res)
        distinct.add(res["schedule_digest"])
        sim_s[0] += res["trace"][-1]["t"] if res["trace"] else 0.0
        if (k + 1) % 25 == 0:
            log(f"[dst] {k + 1}/{schedules} schedules, "
                f"{len(distinct)} distinct, {sim_s[0]:.0f}s simulated")

    t0 = simclock.perf()
    ran, failing = search(schedules, seed0=seed0, max_events=max_events,
                          progress=progress, device=device)
    wall_s = simclock.perf() - t0
    line = {
        "metric": "dst_schedules_explored",
        "value": ran,
        "unit": "schedules",
        "lane": "dst",
        "distinct_schedules": len(distinct),
        "violations": 0 if failing is None else 1,
        "simulated_s": round(sim_s[0], 3),
        "wall_s": round(wall_s, 3),
        "speedup_vs_real_time": round(sim_s[0] / max(wall_s, 1e-9), 1),
        "seed0": seed0,
        "max_events": max_events,
        "mutation": os.environ.get(faults.MUTATION_ENV, ""),
        "device": str(device),
    }
    if failing is not None:
        line["failing_seed"] = failing["seed"]
        line["failing_invariant"] = failing["violation"]["invariant"]
    return line, failing, sorted(distinct)


def main(argv: Optional[Sequence[str]] = None) -> int:
    from cilium_tpu_torch.core.config import Config

    cfg = Config.from_env()
    ap = argparse.ArgumentParser(
        description="seeded fault-schedule search (DST)")
    ap.add_argument("--schedules", type=int, default=cfg.dst.schedules)
    ap.add_argument("--seed", type=int, default=cfg.dst.seed,
                    help="first seed (CILIUM_TPU_DST_SEED)")
    ap.add_argument("--max-events", type=int, default=cfg.dst.max_events)
    ap.add_argument("--replay", action="store_true",
                    help="run ONLY --seed and print its trace")
    ap.add_argument("--shrink", action="store_true",
                    help="delta-debug the first violation to a "
                         "minimal schedule")
    ap.add_argument("--device", default=None,
                    help="the world's device (default cuda)")
    ap.add_argument("--out", default="BENCH_DST_torch.jsonl")
    ap.add_argument("--regressions", default="tests/torch_dst_regressions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.replay:
        res = run_schedule(args.seed, max_events=args.max_events,
                           device=device)
        print(json.dumps(res, indent=2, sort_keys=True))
        return 1 if res["violation"] else 0

    line, failing, digests = sweep(args.schedules, seed0=args.seed,
                                   max_events=args.max_events,
                                   device=device,
                                   log=lambda m: print(m, flush=True))
    if failing is not None:
        print(f"[dst] VIOLATION at seed {failing['seed']}: "
              f"{failing['violation']}", flush=True)
        if args.shrink:
            small = shrink(failing["seed"], failing["events"],
                           device=device)
            path = emit_regression(small, args.regressions)
            line["shrunk_events"] = len(small["events"])
            line["regression_case"] = path
            print(f"[dst] shrunk to {len(small['events'])} events "
                  f"-> {path}", flush=True)
    from cilium_tpu_torch.runtime.provenance import stamp

    # the lane's own bench line rides the dst provenance stamp: seed0
    # + a digest over the distinct schedules explored
    os.environ["CILIUM_TPU_DST_SEED"] = str(args.seed)
    os.environ["CILIUM_TPU_DST_DIGEST"] = hashlib.sha256(
        ",".join(digests).encode()).hexdigest()[:16]
    stamp(line)
    with open(args.out, "a") as fp:
        fp.write(json.dumps(line) + "\n")
    print(json.dumps(line), flush=True)
    print(f"[dst] {line['value']} schedules ({line['distinct_schedules']} "
          f"distinct), {line['violations']} violation(s); simulated "
          f"{line['simulated_s']:.0f}s of virtual time in "
          f"{line['wall_s']:.1f}s wall ({line['speedup_vs_real_time']}x)",
          flush=True)
    return 1 if failing is not None else 0


if __name__ == "__main__":
    sys.exit(main())
