"""The control of a cell: the reference with one guarantee of its
configuration broken (the config's ``control``), put in the program's
place at the cell's own size and compared, chunk by chunk, as a run
compares the program. It has to come out not correct.

    python3 -m benchmark.control --workload http-1k.replay-unique \\
        --seeds 1,2,3

Prints one JSON line a seed with the numbers compared and their limits.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from benchmark import check, deployment, reference, registry, traffic


def control_readings(config, tr, seed: int, control=None):
    """(readings, passed) of the control against the reference."""
    dep = deployment.from_dict(config)
    rec = traffic.generate(dep, tr, seed)
    want = reference.decide(dep, rec).lanes()
    got = reference.decide(dep, rec,
                           control=control or config["control"]).lanes()
    chunk = int(tr["chunk"])
    kept = [(s, chunk, {k: v[s:s + chunk] for k, v in got.items()})
            for s in range(0, int(tr["records"]), chunk)]
    readings = check.compare(kept, want)
    return readings, check.passed(readings)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default=None, choices=reference.CONTROLS)
    args = ap.parse_args(argv)
    bench = registry.load_benchmark()
    cell = registry.workload(bench, args.workload)
    with open(registry.config_path(bench, cell["config"])) as fh:
        config = json.load(fh)
    tr = traffic.load_traffic(registry.traffic_path(cell["traffic"]))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        readings, ok = control_readings(config, tr, seed, args.control)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "control": args.control or config["control"], "correct": ok,
            "checks": {k: {"value": readings[k], "limit": lim}
                       for k, lim in check.LIMITS.items()},
            "records_compared": readings["records_compared"],
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
