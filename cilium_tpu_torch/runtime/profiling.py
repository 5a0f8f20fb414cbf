"""On-demand profiling for long-running processes — the ``pkg/pprof``
analog: capture either a device trace of the card or a sampled
host-stack profile from the running process, behind the REST API
(``PUT /v1/profile``) and the verdict service (``{"op": "profile"}``).

Host mode is a dependency-free sampling profiler: ``sys._current_frames``
polled at ``hz`` for ``seconds``, aggregated into collapsed-stack lines
(``frame;frame;frame count``) — the flamegraph input format, readable
with any pprof/speedscope tooling. It is the reference's, line for line.

Device mode is where the port differs from the reference, on purpose:
the reference wraps ``jax.profiler.start_trace``/``stop_trace``; the
port runs ``torch.profiler.profile(activities=[CPU, CUDA])`` over the
same real-time window and exports a Chrome trace (``device_trace.json``
in ``out_dir``) whose CUDA kernel events name the kernels that ran on
the card in that window. Without CUDA device mode raises: it never
profiles the CPU in the card's place.
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time
from collections import Counter
from typing import Dict, Optional


class ProfileBusy(RuntimeError):
    pass


def default_profile_dir() -> str:
    """Where a capture lands when the caller names no ``out``: under
    the process's temporary directory (``TMPDIR``)."""
    return os.path.join(tempfile.gettempdir(), "cilium_tpu_torch_profile")


class Profiler:
    """One capture at a time per process (both backends are global)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._active: Optional[str] = None

    def capture(self, out_dir: str, seconds: float = 2.0,
                mode: str = "host", hz: int = 97) -> Dict[str, object]:
        # bounded: this BLOCKS the calling handler. The cap stays
        # under common client socket timeouts (APIClient defaults to
        # 30s) — a capture the client can't wait out would leave it
        # with neither the path nor a retry (ProfileBusy until done)
        seconds = min(max(seconds, 0.1), 20.0)
        with self._lock:
            if self._active is not None:
                raise ProfileBusy(f"{self._active} capture in progress")
            self._active = mode
        try:
            os.makedirs(out_dir, exist_ok=True)
            if mode == "device":
                return self._capture_device(out_dir, seconds)
            if mode == "host":
                return self._capture_host(out_dir, seconds, hz)
            raise ValueError(f"unknown profile mode {mode!r}")
        finally:
            with self._lock:
                self._active = None

    def _capture_device(self, out_dir: str, seconds: float) -> Dict:
        import torch
        from torch.profiler import ProfilerActivity, profile

        if not torch.cuda.is_available():
            # a device profile of the CPU would pass for the card's
            raise RuntimeError(
                "device profile needs CUDA: no card to trace (mode "
                "'host' samples the process's stacks)")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # ctlint: disable=wall-clock  # the device trace window is real seconds of real execution by definition
            time.sleep(seconds)
            # the window's kernels land in the trace only once the
            # card has finished them
            torch.cuda.synchronize()
        # ctlint: disable=wall-clock  # filename uniqueness stamp
        path = os.path.join(out_dir, f"device_trace_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        kernels = sorted({
            e.key for e in prof.key_averages()
            if getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0)) > 0})
        return {"mode": "device", "path": path,
                "seconds": seconds, "device_events": kernels,
                "hint": "Chrome trace (chrome://tracing / Perfetto)"}

    def _capture_host(self, out_dir: str, seconds: float,
                      hz: int) -> Dict:
        me = threading.get_ident()
        stacks: Counter = Counter()
        samples = 0
        interval = 1.0 / hz
        # sampling profiler: the capture window measures real
        # execution, never simulated time
        # ctlint: disable=wall-clock  # sampling profiler: the capture window measures real execution, never simulated time
        deadline = time.monotonic() + seconds
        # ctlint: disable=wall-clock  # see above — real capture window
        while time.monotonic() < deadline:
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue  # don't profile the profiler
                parts = []
                while frame is not None:
                    code = frame.f_code
                    parts.append(
                        f"{code.co_name} "
                        f"({os.path.basename(code.co_filename)}:"
                        f"{frame.f_lineno})")
                    frame = frame.f_back
                stacks[";".join(reversed(parts))] += 1
            samples += 1
            # ctlint: disable=wall-clock  # real sampling cadence (hz is a real-time rate)
            time.sleep(interval)
        # ns resolution: two quick captures in one wall-clock second
        # must not overwrite each other
        path = os.path.join(
            # ctlint: disable=wall-clock  # filename uniqueness stamp
            out_dir, f"host_profile_{time.time_ns()}.collapsed")
        with open(path, "w") as fp:
            for stack, count in stacks.most_common():
                fp.write(f"{stack} {count}\n")
        return {"mode": "host", "path": path, "seconds": seconds,
                "samples": samples, "distinct_stacks": len(stacks),
                "hint": "collapsed-stack format (flamegraph.pl / "
                        "speedscope)"}


#: process-wide instance (both the REST API and the verdict service
#: route here; the reference's pprof server is process-global too)
PROFILER = Profiler()
