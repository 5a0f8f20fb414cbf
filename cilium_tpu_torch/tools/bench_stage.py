#!/usr/bin/env python
"""Staging microbench: capture → staged replay session, decomposed
(the counterpart of the reference's ``bench_stage.py``).

Measures only the ingest/staging pipeline: the columnar capture write
(``synth.write_scenario_capture``), the file open and section reads,
and the ``CaptureReplay`` staging phases (string tables scanned on the
card / whole-file featurize / hash dedup / unique-table copy to the
card), plus the verdict-memo fill. Two sessions are staged in one
process: ``cold`` (the first: pays each kernel's first launch and the
allocator's growth) and ``warm`` (a second over the same shapes). The
headline ``stage_ms`` is the cold number: what a fresh replay pays.

    python -m cilium_tpu_torch.tools.bench_stage [--config http]
        [--rules 1000] [--capture-flows 200000] [--device cpu]
        [--capture FILE]

Prints one provenance-stamped JSON line. The capture goes to a
temporary directory unless ``--capture`` names a file. Runs on
``cuda`` unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from cilium_tpu_torch.runtime.metrics import CAPTURE_STAGE_SECONDS, METRICS

#: the staging split's phases (the memo fill is NOT in it: stage_ms
#: covers ingest staging only, the fill is reported as memo_fill_ms)
PHASES = ("tables", "featurize", "dedup", "table-h2d")


def run(config: str = "http", rules: int = 1000,
        capture_flows: int = 200000, scenario_flows: int = 10000,
        device=None, capture=None, cache_dir=None,
        log=lambda msg: None) -> dict:
    """The lane's line (not stamped)."""
    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.core.device import resolve_device
    from cilium_tpu_torch.engine.replay import CaptureReplay
    from cilium_tpu_torch.ingest import binary, synth
    from cilium_tpu_torch.runtime.loader import Loader

    dev = resolve_device(device)
    cfg = Config.from_env()
    cfg.enable_tpu_offload = True
    if cache_dir is not None:
        cfg.loader.cache_dir = cache_dir
    scenario = synth.scenario_by_name(config, rules, scenario_flows)
    per_identity, scenario = synth.realize_scenario(scenario)
    loader = Loader(cfg, device=dev)
    tmp = None
    try:
        engine = loader.regenerate(per_identity, revision=1)
        if capture is None:
            tmp = tempfile.TemporaryDirectory(prefix="ct_stage_")
            capture = os.path.join(tmp.name, "capture.bin")
        t0 = time.perf_counter()
        n = synth.write_scenario_capture(capture, scenario, capture_flows)
        write_ms = round((time.perf_counter() - t0) * 1e3, 1)
        log(f"columnar capture write: {n} records in {write_ms}ms")

        t0 = time.perf_counter()
        rec_all = binary.map_capture(capture)
        l7_all, offsets, blob = binary.read_l7_sidecar(capture)
        gen_all = binary.read_gen_sidecar(capture)
        open_ms = round((time.perf_counter() - t0) * 1e3, 1)

        def marks():
            return {ph: METRICS.histo_sum(CAPTURE_STAGE_SECONDS,
                                          {"phase": ph})
                    for ph in PHASES}

        def stage_once():
            mark0 = marks()
            t0 = time.perf_counter()
            replay = CaptureReplay(engine, l7_all, offsets, blob,
                                   cfg.engine, gen=gen_all)
            replay.stage_rows(rec_all, l7_all)
            ratio = replay.stage_unique(
                drop_if_ratio_at_least=cfg.engine.stage_unique_drop_ratio)
            if replay.row_idx is not None:
                replay.stage_unique_device()
            stage_ms = round((time.perf_counter() - t0) * 1e3, 1)
            memo_fill_ms = None
            if replay.row_idx is not None and cfg.engine.verdict_memo:
                t1 = time.perf_counter()
                memo = replay.stage_verdict_memo()
                memo.table[:2].cpu()   # completion-forced
                memo_fill_ms = round((time.perf_counter() - t1) * 1e3, 1)
            split = {ph: round((after - mark0[ph]) * 1e3, 1)
                     for ph, after in marks().items()}
            return replay, stage_ms, split, ratio, memo_fill_ms

        replay, cold_ms, cold_split, ratio, cold_fill = stage_once()
        _, warm_ms, warm_split, _, warm_fill = stage_once()
    finally:
        loader.close()
        if tmp is not None:
            tmp.cleanup()
    log(f"stage cold {cold_ms}ms {cold_split}; warm {warm_ms}ms "
        f"{warm_split}")
    return {"metric": f"stage_ms_{config}_{rules}rules",
            "value": cold_ms, "unit": "ms (cold session staging)",
            "vs_baseline": 0.0,
            "stage_ms": cold_ms, "stage_phases_ms": cold_split,
            "stage_warm_ms": warm_ms, "stage_warm_phases_ms": warm_split,
            "memo_fill_ms": cold_fill, "memo_fill_warm_ms": warm_fill,
            "capture_records": int(len(rec_all)),
            "unique_rows": int(replay.n_unique),
            "dedup_ratio": round(ratio, 6),
            "capture_write_ms": write_ms, "capture_open_ms": open_ms,
            "device": str(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cilium_tpu_torch.tools.bench_stage")
    ap.add_argument("--config", default="http",
                    choices=["http", "fqdn", "kafka", "generic"])
    ap.add_argument("--rules", type=int, default=1000)
    ap.add_argument("--capture-flows", type=int, default=200000)
    ap.add_argument("--scenario-flows", type=int, default=10000)
    ap.add_argument("--capture", default=None,
                    help="write the capture here (default: a temporary "
                         "directory, removed after)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the "
                         "plain versions)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    def log(msg: str) -> None:
        if args.verbose:
            print(msg, file=sys.stderr, flush=True)

    from cilium_tpu_torch.runtime.provenance import stamp

    line = stamp(run(args.config, args.rules, args.capture_flows,
                     args.scenario_flows, device=args.device,
                     capture=args.capture, log=log))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
