"""Bank-compile work queue (a copy of the reference's
``policy/compiler/compilequeue.py``).

Per-bank compiles become WORK:

* a **bounded worker pool** (``[compile] workers``) drains a priority
  queue of content-addressed compile tasks;
* **priority classes**: serving-blocking delta compiles
  (:data:`PRIO_SERVING`) always pop before background quarantine-TTL
  rebuilds (:data:`PRIO_BACKGROUND`);
* a **per-bank deadline**: a serving-blocking waiter that lapses stops
  blocking the regeneration — the bank rides its last-good cover
  (uncovered patterns fail CLOSED) while the compile finishes in the
  background and lands in the registry for the next regeneration
  (late results are counted, never wasted);
* **bounded retries with exponential backoff + deterministic jitter**
  for worker death (the ``compile.worker`` injection point). Compile
  EXCEPTIONS are deterministic and fail immediately: the quarantine
  TTL is their retry schedule;
* **bounded in-flight memory**: past ``max_pending`` tasks,
  ``submit`` blocks the producer;
* **work-key dedup**: two submitters racing on the same
  content-addressed bank produce ONE task and ONE registry insert;
* **per-tenant weighted-fair queueing** within a priority class, with
  a per-tenant occupancy bound (``tenant_max_share`` of
  ``max_pending``).

Everything timed — deadlines, backoff, idle worker reaping — reads the
installed :mod:`~cilium_tpu_torch.runtime.simclock` clock, so a
``VirtualClock`` drives deadline lapses at an exact tick.
"""


from __future__ import annotations

import threading
import time
import zlib
from typing import Callable, Dict, List, Optional

from cilium_tpu_torch.runtime import faults, simclock
from cilium_tpu_torch.runtime.checkpoint import ruleset_fingerprint
from cilium_tpu_torch.runtime.logging import get_logger
from cilium_tpu_torch.runtime.metrics import (
    COMPILE_DEADLINE_LAPSES,
    COMPILE_LATE_RESULTS,
    COMPILE_QUEUE_COMPLETED,
    COMPILE_QUEUE_DEDUP,
    COMPILE_QUEUE_DEPTH,
    COMPILE_QUEUE_RETRIES,
    COMPILE_QUEUE_SUBMITTED,
    COMPILE_WORKER_DEATHS,
    METRICS,
)

LOG = get_logger("compilequeue")

#: fires once per task claim in a worker thread: a fired fault models
#: the worker DYING mid-compile — the task re-queues with backoff (an
#: attempt is consumed; exhaustion fails the task into quarantine) and
#: the pool respawns a replacement worker
WORKER_POINT = faults.register_point(
    "compile.worker",
    "worker thread in policy/compiler/compilequeue.CompileQueue "
    "(fired fault kills the worker mid-compile; task retries with "
    "backoff, pool respawns)")

#: serving-blocking: a regeneration is waiting on this compile
PRIO_SERVING = 0
#: proactive: quarantine-TTL rebuilds, pre-warming — never delays
#: serving-class work (strict priority pop)
PRIO_BACKGROUND = 1

_PRIO_NAMES = {PRIO_SERVING: "serving", PRIO_BACKGROUND: "background"}

#: work-key format epoch — bump on any change to key derivation so
#: cross-process consumers never mix generations
WORK_FORMAT = "work-v1"

#: idle workers reap themselves after this long without a task, so
#: short-lived loaders (tests, simulated schedules) don't strand parked
#: threads; the pool respawns lazily on the next submit
IDLE_REAP_S = 5.0


def work_key(bank_key: str) -> str:
    """Content-addressed work key of one bank-compile task — a pure
    function of the bank key (itself a pure function of the pattern
    tuple + compile opts), cross-process-stable under any
    PYTHONHASHSEED. Distinct from the bank key so queue logs/metrics
    can never be confused with registry/artifact addresses."""
    return ruleset_fingerprint(WORK_FORMAT, bank_key)


class WorkerDied(Exception):
    """A task's retry budget was exhausted by worker deaths."""


class QueueDraining(Exception):
    """submit() refused: the queue is draining or closed."""


class CompileTask:
    """One unit of compile work. ``done`` flips exactly once; after it,
    ``result`` XOR ``error`` is set. ``event`` integrates with the
    installed clock so waiters park virtually under a VirtualClock."""

    __slots__ = ("key", "fn", "prio", "deadline", "on_done",
                 "attempts", "seq", "not_before", "not_before_real",
                 "done", "result", "error", "event", "payload_bytes",
                 "lapsed", "tenant")

    def __init__(self, key: str, fn: Callable, prio: int,
                 deadline: float, on_done: Optional[Callable],
                 seq: int, payload_bytes: int, tenant: str = ""):
        self.key = key
        self.fn = fn
        self.prio = prio
        #: owning tenant namespace ("" = tenant-blind): the WFQ pick
        #: and the per-tenant occupancy bound key off it
        self.tenant = tenant
        self.deadline = deadline        # absolute, installed clock
        self.on_done = on_done
        self.attempts = 0
        self.seq = seq
        self.not_before = 0.0           # backoff gate (installed clock)
        #: REAL-time release valve for the backoff gate: under a
        #: driven VirtualClock the thread that would advance virtual
        #: time is often the regeneration BLOCKED on this very task —
        #: without a real release the retry would deadlock until the
        #: clock's failsafe. The gate opens at whichever of
        #: (virtual not_before, real not_before) comes first.
        self.not_before_real = 0.0
        self.done = False
        self.result = None
        self.error: Optional[BaseException] = None
        self.event = simclock.event()
        self.payload_bytes = payload_bytes
        #: a serving waiter gave up on this task (deadline) — a later
        #: completion is a LATE result (counted, still stored)
        self.lapsed = False


class CompileQueue:
    """The bounded, clock-driven bank-compile worker pool. One per
    loader (the registry hands it compile closures); thread-safe for
    concurrent submitters — that is the 8-worker same-key race the
    dedup map collapses to one insert."""

    def __init__(self, workers: int = 2, deadline_s: float = 30.0,
                 max_retries: int = 3, backoff_base_s: float = 0.25,
                 backoff_max_s: float = 8.0, max_pending: int = 256,
                 weight_of=None, tenant_max_share: float = 1.0):
        self.workers = max(1, int(workers))
        self.deadline_s = float(deadline_s)
        self.max_retries = max(0, int(max_retries))
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.max_pending = max(1, int(max_pending))
        #: tenant → fair-queueing weight (default 1.0 for every
        #: tenant): each claim charges ``1/weight`` of virtual time
        self.weight_of = weight_of or (lambda tenant: 1.0)
        #: per-tenant occupancy ceiling as a fraction of
        #: ``max_pending`` — 1.0 disables the bound (single-tenant
        #: deployments keep the pre-tenant submit semantics)
        self.tenant_max_share = float(tenant_max_share)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        #: work key → live task (pending or running); completed tasks
        #: leave the map so a later submit re-runs (post-eviction
        #: recompile). Bounded by max_pending + workers.
        self._tasks: Dict[str, CompileTask] = {}
        self._pending: List[CompileTask] = []
        self._running = 0
        self._threads: List[threading.Thread] = []
        self._seq = 0
        self._draining = False
        self._closed = False
        #: tenant → virtual finish time, the WFQ pick's memory; keyed
        #: by the configured tenant set (plus "" for tenant-blind
        #: submits), so its size is bounded by the declared tenants
        self._vtime: Dict[str, float] = {}
        #: lifetime counters (the fleet lane's ledger; METRICS mirrors)
        self.submitted = 0
        self.dedup_hits = 0
        self.completed = 0
        self.failed = 0
        self.retries = 0
        self.worker_deaths = 0
        self.deadline_lapses = 0
        self.late_results = 0

    # -- introspection ----------------------------------------------------
    def depth(self) -> int:
        with self._lock:
            return len(self._pending) + self._running

    def inflight_bytes(self) -> int:
        with self._lock:
            return sum(t.payload_bytes for t in self._tasks.values())

    def status(self) -> Dict:
        with self._lock:
            tenants: Dict[str, int] = {}
            for t in self._tasks.values():
                if t.tenant:
                    tenants[t.tenant] = tenants.get(t.tenant, 0) + 1
            return {
                "workers": len(self._threads),
                "pending": len(self._pending),
                "running": self._running,
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "retries": self.retries,
                "dedup_hits": self.dedup_hits,
                "worker_deaths": self.worker_deaths,
                "deadline_lapses": self.deadline_lapses,
                "late_results": self.late_results,
                "tenant_inflight": tenants,
            }

    def _tenant_live_locked(self, tenant: str) -> int:
        return sum(1 for t in self._tasks.values()
                   if t.tenant == tenant and not t.done)

    # -- submit / wait ----------------------------------------------------
    def submit(self, key: str, fn: Callable,
               prio: int = PRIO_SERVING,
               on_done: Optional[Callable] = None,
               payload_bytes: int = 0,
               deadline_s: Optional[float] = None,
               tenant: str = "") -> CompileTask:
        """Enqueue one compile (or join the in-flight task with the
        same work key). Blocks while the queue is at ``max_pending``
        — bounded in-flight memory beats an unbounded buffer, and the
        producer is the regeneration thread, which has nothing better
        to do than wait for compile capacity. A TENANT at its
        occupancy bound (``tenant_max_share × max_pending`` live
        tasks) blocks the same way, but only for ITS OWN submits —
        the storming tenant waits on itself while everyone else's
        capacity stays untouched."""
        budget = self.deadline_s if deadline_s is None else deadline_s
        tenant_cap = self.max_pending
        if tenant and self.tenant_max_share < 1.0:
            tenant_cap = max(1, int(self.tenant_max_share
                                    * self.max_pending))
        with self._work:
            if self._draining or self._closed:
                raise QueueDraining("compile queue is draining")
            existing = self._tasks.get(key)
            if existing is not None and not existing.done:
                self.dedup_hits += 1
                METRICS.inc(COMPILE_QUEUE_DEDUP)
                if prio < existing.prio:
                    # a serving submit outranks the background task it
                    # found in flight
                    existing.prio = prio
                    self._work.notify_all()
                return existing
            while ((len(self._tasks) >= self.max_pending
                    or (tenant and self._tenant_live_locked(tenant)
                        >= tenant_cap))
                   and not self._draining and not self._closed):
                simclock.wait_cond(self._work, timeout=0.25)
            if self._draining or self._closed:
                raise QueueDraining("compile queue is draining")
            self._seq += 1
            task = CompileTask(key, fn, prio,
                               simclock.now() + budget, on_done,
                               self._seq, payload_bytes,
                               tenant=tenant)
            self._tasks[key] = task
            self._pending.append(task)
            self.submitted += 1
            METRICS.inc(COMPILE_QUEUE_SUBMITTED,
                        labels={"prio": _PRIO_NAMES.get(prio, "other")})
            METRICS.set_gauge(COMPILE_QUEUE_DEPTH,
                              len(self._pending) + self._running)
            self._ensure_workers_locked()
            self._work.notify_all()
            return task

    def wait(self, task: CompileTask,
             timeout: Optional[float] = None) -> bool:
        """Block until ``task`` completes, up to ``timeout`` (default:
        the remainder of the task's own deadline) on the installed
        clock. False = the deadline lapsed with the compile still in
        flight — the caller serves the cover and moves on; the result
        will land late."""
        if timeout is None:
            timeout = max(0.0, task.deadline - simclock.now())
        fired = simclock.wait_on(task.event, timeout)
        if fired or task.done:
            return True
        with self._lock:
            if task.done:
                return True
            task.lapsed = True
            self.deadline_lapses += 1
        METRICS.inc(COMPILE_DEADLINE_LAPSES)
        return False

    # -- worker pool ------------------------------------------------------
    def _ensure_workers_locked(self) -> None:
        self._threads = [t for t in self._threads if t.is_alive()]
        while len(self._threads) < self.workers:
            t = threading.Thread(target=self._worker,
                                 name="ct-compile-worker", daemon=True)
            self._threads.append(t)
            t.start()

    def _pop_locked(self) -> Optional[CompileTask]:
        """The scheduling decision: among runnable tasks (backoff gate
        passed), strictly lowest priority class first; WITHIN a class,
        the task whose tenant has the lowest virtual finish time
        (weighted-fair: each claim charges ``1/weight``), tie-broken
        deterministically on (tenant, submit order) — tenant-blind
        tasks all share the "" tenant, which degenerates to the
        pre-tenant pure submit order. Backoff gates wait on the
        installed clock (behavioral time, exact-tick semantics); the IDLE park is a plain condition
        wait with a real-time reap — resource hygiene, not behavioral
        time, so an idle worker costs zero wake-ups under a driven
        VirtualClock and reaps itself after IDLE_REAP_S real seconds
        without work (the pool respawns lazily on the next submit)."""
        while True:
            if self._closed:
                return None
            now = simclock.now()
            best = None
            best_key = None
            next_gate = None
            # wall-clock read is the gate's REAL release valve, by
            # design (see CompileTask.not_before_real)
            # ctlint: disable=wall-clock  # real release valve for virtual-gated retries
            real_now = time.monotonic()
            for t in self._pending:
                if t.not_before > now and t.not_before_real > real_now:
                    if next_gate is None or t.not_before < next_gate:
                        next_gate = t.not_before
                    continue
                key = (t.prio, self._vtime.get(t.tenant, 0.0),
                       t.tenant, t.seq)
                if best_key is None or key < best_key:
                    best, best_key = t, key
            if best is not None:
                self._pending.remove(best)
                self._running += 1
                # charge the claim to the tenant's virtual time; a
                # first-seen tenant starts at the current floor so it
                # gets a fair turn, not an unbounded historical credit
                floor = min(self._vtime.values(), default=0.0)
                vt = max(self._vtime.get(best.tenant, floor), floor)
                weight = max(self.weight_of(best.tenant), 1e-9)
                # ctlint: disable=unbounded-registry  # keyed by configured tenant set
                self._vtime[best.tenant] = vt + 1.0 / weight
                return best
            if self._draining and not self._pending:
                return None
            if next_gate is not None:
                # short REAL slices: re-check both the virtual gate
                # (a virtual-clock driver advanced the clock) and the real
                # release valve each wake — never a virtual park that
                # a blocked driver can't satisfy
                self._work.wait(0.25)
                continue
            if not self._work.wait(IDLE_REAP_S):
                return None          # idle reap: pool respawns lazily

    def _backoff(self, task: CompileTask) -> float:
        base = min(self.backoff_max_s,
                   self.backoff_base_s * (2.0 ** (task.attempts - 1)))
        # deterministic jitter (±10%): a pure function of (key,
        # attempt) so simulated replays are byte-identical — never the RNG
        frac = (zlib.crc32(f"{task.key}:{task.attempts}".encode())
                % 2001 - 1000) / 10000.0
        return max(0.0, base * (1.0 + frac))

    def _finish(self, task: CompileTask, result=None,
                error: Optional[BaseException] = None) -> None:
        with self._work:
            self._running -= 1
            task.result = result
            task.error = error
            task.done = True
            self._tasks.pop(task.key, None)
            self.completed += 1
            if error is not None:
                self.failed += 1
            if task.lapsed:
                self.late_results += 1
                METRICS.inc(COMPILE_LATE_RESULTS)
            METRICS.inc(COMPILE_QUEUE_COMPLETED)
            METRICS.set_gauge(COMPILE_QUEUE_DEPTH,
                              len(self._pending) + self._running)
            self._work.notify_all()
        # the registry-store callback runs OUTSIDE the queue lock (it
        # takes shard locks; lock-order stays a DAG) and before the
        # waiter wakes, so a woken waiter always observes the insert
        if task.on_done is not None:
            try:
                task.on_done(task)
            except Exception:
                LOG.exception("compile on_done callback failed",
                              extra={"fields": {"key": task.key}})
        task.event.set()

    def _requeue_locked(self, task: CompileTask) -> None:
        self._running -= 1
        backoff = self._backoff(task)
        task.not_before = simclock.now() + backoff
        # ctlint: disable=wall-clock  # real release valve for virtual-gated retries
        task.not_before_real = time.monotonic() + backoff
        self._pending.append(task)
        self.retries += 1
        METRICS.inc(COMPILE_QUEUE_RETRIES)
        self._work.notify_all()

    def _worker(self) -> None:
        me = threading.current_thread()
        while True:
            with self._work:
                task = self._pop_locked()
                if task is None:
                    if me in self._threads:
                        self._threads.remove(me)
                    return
            # the worker-death seam: fires AFTER the claim, so the
            # task is genuinely in flight when its worker vanishes
            try:
                faults.maybe_fail(WORKER_POINT)
            except BaseException as death:
                with self._work:
                    task.attempts += 1
                    self.worker_deaths += 1
                    METRICS.inc(COMPILE_WORKER_DEATHS)
                    if task.attempts > self.max_retries:
                        # budget exhausted mid-outage: fail the task;
                        # the caller quarantines it with cover
                        self._running -= 1
                        self._tasks.pop(task.key, None)
                        task.error = WorkerDied(
                            f"{task.attempts} worker deaths compiling "
                            f"{task.key}: {death}")
                        task.done = True
                        self.completed += 1
                        self.failed += 1
                        self._work.notify_all()
                        failed_task = task
                    else:
                        self._requeue_locked(task)
                        failed_task = None
                    if me in self._threads:
                        self._threads.remove(me)
                    self._ensure_workers_locked()   # respawn
                if failed_task is not None:
                    if failed_task.on_done is not None:
                        try:
                            failed_task.on_done(failed_task)
                        except Exception:
                            LOG.exception(
                                "compile on_done callback failed",
                                extra={"fields": {"key": task.key}})
                    failed_task.event.set()
                return                               # this worker dies
            try:
                task.attempts += 1
                result = task.fn()
            except Exception as e:
                # a compile exception is deterministic — retrying the
                # same pattern set reproduces it. Fail now; the bank
                # quarantine TTL is the retry schedule.
                self._finish(task, error=e)
            else:
                self._finish(task, result=result)

    # -- lifecycle --------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop accepting work, let in-flight tasks finish. Returns
        True when the queue emptied inside ``timeout`` (installed
        clock). The drain-while-compiling boundary: a task running at
        drain time completes and stores; nothing is abandoned."""
        with self._work:
            self._draining = True
            self._work.notify_all()
            deadline = None if timeout is None \
                else simclock.now() + timeout

            def empty() -> bool:
                return not self._pending and self._running == 0

            while not empty():
                left = None if deadline is None \
                    else deadline - simclock.now()
                if left is not None and left <= 0:
                    return False
                simclock.wait_cond(self._work, timeout=left)
            return True

    def resume(self) -> None:
        """Re-open a drained queue (a warm-restarted loader reuses its
        process-resident pool)."""
        with self._work:
            if self._closed:
                raise QueueDraining("compile queue is closed")
            self._draining = False
            self._work.notify_all()

    def close(self) -> None:
        """Tear the pool down (tests, schedule teardown, loader
        replacement). Pending tasks fail with QueueDraining so no
        waiter hangs."""
        with self._work:
            self._closed = True
            pending, self._pending = self._pending, []
            for t in pending:
                t.result = None
                t.error = QueueDraining("compile queue closed")
                t.done = True
                self._tasks.pop(t.key, None)
            self._work.notify_all()
        for t in pending:
            t.event.set()
