"""Controllers: named retry loops with backoff.

Reference: ``pkg/controller`` (SURVEY.md §2.4) — "the agent's universal
async primitive": a named function re-run on an interval, with
exponential backoff on failure, individually stoppable, all registered
in a manager for introspection (``cilium-dbg status --all-controllers``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from cilium_tpu_torch.runtime import simclock
from cilium_tpu_torch.runtime.logging import get_logger
from cilium_tpu_torch.runtime.metrics import METRICS

LOG = get_logger("controller")


class Controller:
    def __init__(self, name: str, fn: Callable[[], None],
                 interval: float = 10.0, max_backoff: float = 300.0):
        self.name = name
        self.fn = fn
        self.interval = interval
        self.max_backoff = max_backoff
        self.failures = 0
        self.success_count = 0
        self.last_error: Optional[str] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"ctrl-{name}")

    def start(self) -> "Controller":
        self._thread.start()
        return self

    def trigger(self) -> None:
        """Run now (used instead of waiting out the interval)."""
        self._wake.set()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        # Join so no in-flight fn() run survives stop(): an unjoined
        # first-run checkpoint writing stale state after the caller's
        # final synchronous checkpoint corrupts restore.
        if (self._thread.is_alive()
                and threading.current_thread() is not self._thread):
            self._thread.join(timeout=30.0)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.fn()
                self.success_count += 1
                self.failures = 0
                self.last_error = None
                METRICS.inc("cilium_tpu_controller_runs_total",
                            labels={"controller": self.name,
                                    "status": "success"})
                delay = self.interval
            except Exception as e:
                self.failures += 1
                self.last_error = f"{type(e).__name__}: {e}"
                LOG.error("controller run failed",
                          extra={"fields": {"controller": self.name,
                                            "failures": self.failures,
                                            "error": self.last_error}})
                METRICS.inc("cilium_tpu_controller_runs_total",
                            labels={"controller": self.name,
                                    "status": "failure"})
                delay = min(self.max_backoff,
                            self.interval * (2 ** min(self.failures, 8)))
            # the interval/backoff wait rides the process clock: under
            # a VirtualClock the next run is one advance() away, so
            # heartbeat/reconcile controllers simulate hours in ms
            simclock.wait_on(self._wake, delay)
            self._wake.clear()


class ControllerManager:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._controllers: Dict[str, Controller] = {}
        # Per-name locks serialize update/remove for one controller
        # name without making one name's slow stop() (thread join)
        # block every other name — while stop()/status() stay on the
        # cheap manager lock.
        self._name_locks: Dict[str, threading.Lock] = {}
        self._closed = False
        # bumped at the START of every stop_all: an update() that began
        # before the bump (and so may have been missed by stop_all's
        # snapshot) sees the change and stops its own controller
        self._gen = 0

    def _name_lock(self, name: str) -> threading.Lock:
        with self._lock:
            lk = self._name_locks.get(name)
            if lk is None:
                lk = self._name_locks[name] = threading.Lock()
            return lk

    def update(self, name: str, fn: Callable[[], None],
               interval: float = 10.0) -> Controller:
        with self._name_lock(name):
            with self._lock:
                gen = self._gen
                old = self._controllers.pop(name, None)
            if old is not None:
                old.stop()  # joins the thread; only this name waits
            c = Controller(name, fn, interval=interval).start()
            with self._lock:
                if not self._closed and self._gen == gen:
                    self._controllers[name] = c
                    return c
        # stop_all() started or ran while we were in flight: our pop
        # may have hidden the old controller from its snapshot, so
        # honor the stop ourselves instead of leaking a running thread
        c.stop()
        return c

    def remove(self, name: str) -> None:
        with self._name_lock(name):
            with self._lock:
                c = self._controllers.pop(name, None)
            if c is not None:
                c.stop()

    def trigger(self, name: str) -> None:
        with self._lock:
            c = self._controllers.get(name)
        if c is not None:
            c.trigger()

    def status(self) -> Dict[str, Dict]:
        with self._lock:
            return {
                name: {
                    "success-count": c.success_count,
                    "failure-count": c.failures,
                    "last-error": c.last_error,
                }
                for name, c in self._controllers.items()
            }

    def stop_all(self) -> None:
        """Stop every controller. An update() racing this call has its
        controller stopped instead of leaking an unstoppable thread;
        updates after stop_all() returns register normally (the agent
        is restartable)."""
        with self._lock:
            self._closed = True
            self._gen += 1
            controllers = list(self._controllers.values())
            self._controllers.clear()
        try:
            for c in controllers:  # join outside the lock: a slow
                c.stop()           # in-flight fn must not block status()
        finally:
            with self._lock:
                self._closed = False

