"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload http-1k.replay-unique \\
        --seed 7 --seconds 10 --trace 0

Set-up: the deployment's rules and identities from its configuration
file, the capture written from the seed under ``TMPDIR``, the policy
resolved and compiled through the program's loader (its artifact cache
in ``benchmark/.cache/<config>``), the capture staged as a replay
session, every chunk replayed once. Then the window: one caller replays
the capture chunk after chunk through ``CaptureReplay.verdict_chunk``
for ``--seconds``, with nothing of the harness's own on the heap but
the lanes it compares (the records are drawn again from the seed
after the window). After the window, in both modes, one chunk a start,
three times over, under ``torch.profiler``: ``--trace 0`` prints the
end-to-end metrics (``setup_s`` from the clock, the others read from
that trace or the window by their readers in ``benchmark/metrics``),
``--trace 1`` the per-layer metrics. Last, with the program's state
freed, the reference works out every record's verdict again and every
chunk the window returned is compared with it.

The last line of standard output is the result's JSON; the numbers
compared, each beside its limit, are the last lines of standard error
and the result's last key.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from typing import Callable, Dict, Optional  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from benchmark import capture, check, deployment, reference  # noqa: E402
from benchmark import registry, traffic, window  # noqa: E402
from benchmark.metrics import step_roofline_pct  # noqa: E402

#: top-level module names that may not be loaded in the process that
#: prints a result: JAX, and the JAX package this program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "cilium_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def _tasks() -> int:
    try:
        return len(os.listdir("/proc/self/task"))
    except OSError:
        return -1


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(bench: Dict, cell: Dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, config: Optional[Dict] = None,
             traffic_params: Optional[Dict] = None,
             wrap: Optional[Callable] = None) -> Dict:
    """One run of ``cell``; returns the result (without the printing).
    ``config`` and ``traffic_params`` replace the files' contents (the
    tests run small sizes), ``wrap`` wraps the timed entry."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    if config is None:
        with open(registry.config_path(bench, cell["config"])) as fh:
            config = json.load(fh)
    dep = deployment.from_dict(config)
    tr = traffic_params or traffic.load_traffic(
        registry.traffic_path(cell["traffic"]))
    chunk = int(tr["chunk"])
    starts = list(range(0, int(tr["records"]), chunk))

    t0 = time.perf_counter()
    rec = traffic.generate(dep, tr, seed)
    spans: Dict[str, float] = {"generate_s": time.perf_counter() - t0}
    tmp = tempfile.mkdtemp(prefix="benchmark-")
    system = None
    try:
        t0 = time.perf_counter()
        cap = os.path.join(tmp, "capture.bin")
        info = capture.write(cap, rec)
        spans["write_s"] = time.perf_counter() - t0
        log(f"capture: {info} in {spans['write_s']:.3f} s "
            f"(generated in {spans['generate_s']:.3f} s)")
        del rec          # drawn again from the seed after the window

        from benchmark.system import System

        system = System(dep, registry.cache_dir(cell["config"]), device)
        split = system.stage(cap)
        spans.update(system.spans)
        log(f"resolve {spans['resolve_s']:.3f} s, regenerate "
            f"{spans['regen_s']:.3f} s, stage {spans['stage_s']:.3f} s "
            f"(split {json.dumps(split)}; unique ratio "
            f"{system.unique_ratio:.4f}, dedup "
            f"{'kept' if system.deduped else 'declined'})")
        entry = system.verdict_chunk if wrap is None \
            else wrap(system.verdict_chunk)
        lane_bytes = 0
        twins = {}
        for start in starts:                 # every shape, once
            out = entry(start, chunk)
            lane_bytes = sum(v.dtype.itemsize for v in out.values())
            twins[start] = window.keep(out)
        del out
        row_bytes = system.rows(0, 1).shape[1] * system.rows(0, 1).itemsize
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s; threads {threading.active_count()} "
            f"in Python, {_tasks()} in the process")

        win = window.run_window(entry, starts, chunk, seconds, twins)
        reading = None
        cuda = device == "cuda"
        if cuda:
            from benchmark.trace import trace_chunks

            reading = trace_chunks(entry, starts, chunk, tmp)
        found = forbidden_modules()
        if found:
            raise ForbiddenImport(found)
        peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        kind = torch.cuda.get_device_name(0) if cuda else "cpu"
        system.close()
        system = None
        if cuda:
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        rec = traffic.generate(dep, tr, seed)
        expected = reference.decide(dep, rec)
        readings = check.compare(win.kept, expected.lanes())
        log(f"reference {time.perf_counter() - t0:.3f} s; expected "
            f"verdicts {np.bincount(expected.verdict).tolist()}")
    finally:
        if system is not None:
            system.close()
        shutil.rmtree(tmp, ignore_errors=True)

    res = {
        "correct": check.passed(readings),
        "attempted": win.records,
        "failed": readings["mismatched_records"]
        + readings["missing_records"],
        "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": peak},
        "window": win, "readings": readings, "spans": spans,
        "reading": reading,
    }
    ctx = {"trace": reading, "spans": spans, "window": win, "chunk": chunk}
    if trace:
        words = step_roofline_pct.pattern_words(dep)
        ctx["step_bytes"] = [
            step_roofline_pct.chunk_bytes(dep, rec, expected, s, chunk,
                                          row_bytes, lane_bytes, words)
            for s in starts]
    res["metrics"] = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in registry.metrics_for(bench, cell["name"], kind):
        v = setup_s if m["name"] == "setup_s" \
            else registry.metric_reader(m["name"])(ctx)
        if v is not None:
            res["metrics"][m["name"]] = float(v)
    if not trace:
        return res
    res["device"]["busy_s"] = reading.busy_s
    res["device"]["window_s"] = reading.window_s
    res["breakdown"] = {"device_ops": [list(x) for x in
                                       reading.device_ops[:10]],
                        "idle_gaps": [list(x) for x in reading.gaps[:10]]}
    res["step_bytes"] = ctx["step_bytes"]
    return res


class ForbiddenImport(RuntimeError):
    def __init__(self, names):
        super().__init__(f"modules loaded that the benchmark may not load: "
                         f"{', '.join(names)}")
        self.names = names


def result_line(bench: Dict, cell: Dict, res: Dict) -> Dict:
    kind = "per_layer" if "breakdown" in res else "end_to_end"
    units = {m["name"]: m["unit"]
             for m in registry.metrics_for(bench, cell["name"], kind)}
    line = {
        "correct": res["correct"], "attempted": res["attempted"],
        "failed": res["failed"],
        "metrics": {k: {"value": v, "unit": units[k]}
                    for k, v in res["metrics"].items() if k in units},
        "device": res["device"],
    }
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = {k: {"value": res["readings"][k], "limit": lim}
                      for k, lim in check.LIMITS.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = registry.load_benchmark()
    cell = registry.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {power_limit()}")
    try:
        res = run_cell(bench, cell, args.seed, args.seconds,
                       bool(args.trace), t_start=T_START)
    except ForbiddenImport as e:
        log(str(e))
        return 3
    win = res["window"]
    log(f"window: {win.chunks} chunks, {win.records} records in "
        f"{win.seconds:.6f} s; chunk median {win.median_ms():.4f} ms, "
        f"p95 {win.p95_ms():.4f} ms over {win.chunks} calls")
    log("chunk ms in order: " + " ".join(f"{x * 1e3:.1f}"
                                          for x in win.latencies))

    r = res["reading"]
    log(f"traced: {r.chunks} chunks in {r.window_s:.6f} s, device busy "
        f"{r.busy_s:.6f} s, kernels {r.kernel_s:.6f} s, copies "
        f"{r.copy_s:.6f} s, {r.kernels} kernels")
    if args.trace:
        log(f"step bytes {res['step_bytes']}")
        by_label: Dict[str, float] = {}
        for label, s in r.gaps:
            by_label[label] = by_label.get(label, 0.0) + s
        log(f"idle by host phase (s): {json.dumps(by_label)}")
    line = result_line(bench, cell, res)
    found = forbidden_modules()
    if found:
        log(str(ForbiddenImport(found)))
        return 3
    log(f"records compared: {res['readings']['records_compared']}")
    for k, v in line["checks"].items():
        log(f"check {k} {v['value']} limit {v['limit']}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
