#!/usr/bin/env python
"""Protocol-frontend bench lane: per-protocol verdict throughput and
the cross-cluster churn leg (the counterpart of the reference's
``bench_protocols.py``).

For each frontend family (cassandra / memcache / r2d2) plus the mixed
``protocols`` scenario, the policy compiles through the frontend
registry and the port's ``Loader`` on the card, and a capture-shaped
corpus (``flows_to_columns``: a v3 image with the GENERIC section)
replays through a staged ``CaptureReplay`` session — the fused step
for the memo fill, then the device memo's gather — reporting
verdicts/s a lane. An ``http`` reference lane runs in the same process,
so a host-speed change shows on the lines themselves. Each lane is a
correctness gate too: no ``ERROR`` verdict, and 512 flows equal to the
loader's CPU oracle.

    python -m cilium_tpu_torch.tools.bench_protocols [--flows-scale 1.0]
        [--device cpu] [--out FILE]

The cross-cluster churn leg (:func:`run_crosscluster`) runs two live
agents, ``alpha`` and ``beta``, joined over clustermesh: endpoints
added and removed in ``alpha`` are remote identities that ``beta``'s
cassandra policy must enforce (update → enforcement p50/p99), with
every live remote identity re-verdicted after each update (0 stale, 0
``ERROR``). Its p99 gate is ``P99_FACTOR`` x the 27-bank churn lane's
p99 on the same device (``--base-p99-ms``, from
``tools/churn_lane.run``), as ``runtime/fleet.run`` takes it: the
reference reads its denominator from a committed CPU bench file, which
the port does not read. A miss raises ``fleet.P99GateError``, as
the storm's gate does.

    python -m cilium_tpu_torch.tools.bench_protocols --skip-throughput \
        --updates 50 --base-p99-ms 120.0

Prints one provenance-stamped JSON line a lane. Runs on ``cuda``
unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Optional

from cilium_tpu_torch.runtime.fleet import P99GateError

#: per-protocol throughput lanes (scenario name, rules, flows)
PROTO_LANES = (("cassandra", 40, 120000), ("memcache", 40, 120000),
               ("r2d2", 40, 120000), ("protocols", 120, 200000),
               ("http", 200, 120000))

#: flows of each lane's oracle sample
ORACLE_SAMPLE = 512

#: the cross-cluster p99 gate: this many times the 27-bank churn
#: lane's p99 (the reference's factor)
P99_FACTOR = 2.0


def _proto_scenario(name: str, n_rules: int, n_flows: int):
    """Single-protocol scenarios reuse the mixed generator with a 1.0
    share; http and protocols use their own generators."""
    from cilium_tpu_torch.ingest import synth

    if name in ("http", "protocols"):
        return synth.scenario_by_name(name, n_rules, n_flows)
    return synth.synth_protocols_scenario(
        n_rules=n_rules, n_flows=n_flows, mix=((name, 1.0),))


def run_throughput(name: str, n_rules: int, n_flows: int,
                   cache_dir: str, log, device=None,
                   reps: int = 3) -> dict:
    """One lane → its line (not stamped). Raises AssertionError on an
    ``ERROR`` verdict or an oracle disagreement."""
    import numpy as np

    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.core.flow import Verdict
    from cilium_tpu_torch.engine.replay import CaptureReplay
    from cilium_tpu_torch.ingest import synth
    from cilium_tpu_torch.ingest.columnar import flows_to_columns
    from cilium_tpu_torch.runtime.loader import Loader

    scenario = _proto_scenario(name, n_rules, n_flows)
    per_identity, scenario = synth.realize_scenario(scenario)
    cfg = Config()
    cfg.enable_tpu_offload = True
    cfg.loader.cache_dir = cache_dir
    loader = Loader(cfg, device=device)
    try:
        t0 = time.perf_counter()
        loader.regenerate(per_identity, revision=1)
        compile_s = time.perf_counter() - t0
        cols = flows_to_columns(scenario.flows)
        t0 = time.perf_counter()
        replay = CaptureReplay(loader.engine, cols.l7, cols.offsets,
                               cols.blob, cfg.engine, gen=cols.gen,
                               loader=loader)
        replay.stage_rows(cols.rec, cols.l7)
        replay.stage_unique()
        stage_s = time.perf_counter() - t0
        # the memo fill: outside the throughput window by methodology
        out = replay.verdict_chunk(cols.rec, cols.l7)
        if int(Verdict.ERROR) in out["verdict"]:
            raise AssertionError(f"{name}: ERROR verdicts")
        first = np.asarray(out["verdict"]).copy()
        sample = scenario.flows[:ORACLE_SAMPLE]
        want = loader.fallback_engine.verdict_flows(sample)["verdict"]
        got = loader.engine.verdict_flows(sample)["verdict"]
        if list(map(int, got)) != list(map(int, want)):
            raise AssertionError(f"{name}: engine disagrees with oracle")
        n = len(scenario.flows)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = replay.verdict_chunk(cols.rec, cols.l7)
        dt = time.perf_counter() - t0
        m = replay.memo
        verdicts = np.asarray(out["verdict"])
        if not np.array_equal(verdicts, first):
            raise AssertionError(
                f"{name}: the memo's replay differs from its fill")
        allowed = float(np.mean(verdicts == int(Verdict.REDIRECTED)))
        device_name = str(loader.engine.device)
    finally:
        loader.close()
    vps = reps * n / dt
    log(f"[{name}] {vps / 1e6:.2f}M verdicts/s "
        f"(compile {compile_s:.2f}s, stage {stage_s * 1e3:.0f}ms, "
        f"allow {allowed:.2f})")
    return {
        "metric": f"proto_{name}_verdicts_per_s",
        "value": round(vps, 1),
        "unit": "verdicts/s (memo-gather replay)",
        "lane": "bench-protocols",
        "protocol": name,
        "rules": n_rules,
        "flows": n,
        "compile_s": round(compile_s, 3),
        "stage_ms": round(stage_s * 1e3, 1),
        "memo_hit_ratio": round(m.hits / max(1, m.hits + m.misses), 6)
        if m else None,
        "allow_fraction": round(allowed, 4),
        "stream": "id+memo",
        "oracle_sample": len(sample),
        "device": device_name,
        "verdict_mix": np.bincount(verdicts, minlength=6).tolist(),
    }


# ---------------------------------------------------------------------------
# cross-cluster churn


_BETA_CNP = """\
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata:
  name: allow-remote-cassandra
spec:
  endpointSelector:
    matchLabels:
      app: store
  ingress:
    - fromEndpoints:
        - matchLabels:
            app: db
      toPorts:
        - ports:
            - port: "9042"
              protocol: TCP
          rules:
            l7proto: cassandra
            l7:
              - query_action: select
                query_table: users
              - query_action: batch
"""


def run_crosscluster(updates: int, log, gate_p99: bool = True,
                     base_p99_ms: Optional[float] = None,
                     device=None) -> dict:
    """The cross-cluster churn leg → its line (not stamped). ``beta``
    (and ``alpha``, whose gate is off as in the reference, so it never
    stages an engine) build their agents on ``device`` (default
    ``cuda``). Stale or ``ERROR`` verdicts raise AssertionError; the
    p99 gate, checked last, ``fleet.P99GateError``. ``gate_p99``
    needs ``base_p99_ms``."""
    from cilium_tpu_torch.agent import Agent
    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.core.flow import (
        Flow,
        GenericL7Info,
        L7Type,
        Protocol,
        TrafficDirection,
        Verdict,
    )

    if gate_p99 and base_p99_ms is None:
        raise ValueError("the p99 gate needs base_p99_ms: the 27-bank "
                         "churn lane's p99 on the same device")
    tmp = tempfile.mkdtemp(prefix="ct_xc_")
    cfg_a = Config(cluster_name="alpha")
    cfg_a.enable_tpu_offload = False
    cfg_b = Config(cluster_name="beta")
    cfg_b.enable_tpu_offload = True
    for c, sub in ((cfg_a, "alpha"), (cfg_b, "beta")):
        # the lane's agents leave the process's logging alone
        c.configure_logging = False
        c.loader.cache_dir = os.path.join(tmp, sub)
    # per-event regeneration: the lane measures the un-coalesced
    # update→enforcement path (the debounced path coalesces storms —
    # a different, cheaper number)
    cfg_b.loader.identity_regen_debounce_s = 0.0
    a = b = None
    try:
        a = Agent(cfg_a, device=device).start()
        b = Agent(cfg_b, device=device).start()
        b.endpoint_add(1, {"app": "store"}, ipv4="10.2.0.1")
        path = os.path.join(tmp, "beta-cnp.yaml")
        with open(path, "w") as f:
            f.write(_BETA_CNP)
        b.policy_add_file(path)
        b.clustermesh.connect("alpha", a.kvstore)
        store_id = b.endpoint_manager.get(1).identity

        def probe(remote_id: int, table: str, action="select"):
            return Flow(
                src_identity=remote_id, dst_identity=store_id,
                dport=9042, protocol=Protocol.TCP,
                direction=TrafficDirection.INGRESS,
                l7=L7Type.GENERIC,
                generic=GenericL7Info(
                    proto="cassandra",
                    fields={"query_action": action,
                            "query_table": table}))

        def enforced(remote_id) -> bool:
            out = b.loader.engine.verdict_flows(
                [probe(remote_id, "users"),
                 probe(remote_id, "secrets")])["verdict"]
            return (int(out[0]) == int(Verdict.REDIRECTED)
                    and int(out[1]) == int(Verdict.DROPPED))

        lat_ms = []
        errors = stale = 0
        live = []
        for step in range(updates):
            if live and step % 3 == 2:
                eid, ip = live.pop(0)
                a.endpoint_remove(eid)
                # removal propagates: the identity must stop being
                # resolvable in beta's ipcache
                t0 = time.perf_counter()
                while b.ipcache.lookup(ip) is not None:
                    if time.perf_counter() - t0 > 30:
                        raise AssertionError("remote delete stuck")
                    time.sleep(0.001)
                lat_ms.append((time.perf_counter() - t0) * 1e3)
                continue
            eid = 100 + step
            ip = f"10.1.{step // 200}.{step % 200 + 1}"
            t0 = time.perf_counter()
            a.endpoint_add(eid, {"app": "db", "pod": f"p{step}"},
                           ipv4=ip)
            remote_id = b.ipcache.lookup(ip)
            assert remote_id is not None, "remote identity missing"
            while not enforced(remote_id):
                if time.perf_counter() - t0 > 60:
                    raise AssertionError(
                        f"update {step} never enforced")
                time.sleep(0.001)
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            live.append((eid, ip))
            # staleness + ERROR sweep over every LIVE remote identity
            for _eid, lip in live:
                rid = b.ipcache.lookup(lip)
                out = b.loader.engine.verdict_flows(
                    [probe(rid, "users"), probe(rid, "secrets"),
                     probe(rid, "users", action="batch")])["verdict"]
                vals = list(map(int, out))
                if int(Verdict.ERROR) in vals:
                    errors += 1
                # batch rule carries no table constraint → allows
                want = [int(Verdict.REDIRECTED), int(Verdict.DROPPED),
                        int(Verdict.REDIRECTED)]
                if vals != want:
                    stale += 1
        assert errors == 0, f"{errors} ERROR verdicts under churn"
        assert stale == 0, f"{stale} stale verdicts under churn"
    finally:
        for x in (b, a):
            if x is not None:
                x.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    lat_ms.sort()
    p99 = lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))]
    p50 = lat_ms[len(lat_ms) // 2]
    bound = P99_FACTOR * base_p99_ms if base_p99_ms is not None else None
    line = {
        "metric": "crosscluster_update_p99_ms",
        "value": round(p99, 3),
        "unit": "ms remote-identity update->enforcement p99",
        "lane": "bench-protocols",
        "updates": updates,
        "p50_ms": round(p50, 3),
        "p99_bound_ms": round(bound, 3) if bound is not None else None,
        "baseline_churn_p99_ms": base_p99_ms,
        "p99_gated": bool(gate_p99),
        "stale": stale,
        "errors": errors,
        "protocol": "cassandra",
    }
    log(f"[crosscluster] {updates} remote-identity updates: "
        f"p50 {p50:.0f}ms p99 {p99:.0f}ms (bound "
        f"{'-' if bound is None else f'{bound:.0f}ms'}), 0 stale / 0 ERROR")
    if gate_p99 and p99 > bound:
        raise P99GateError(
            f"cross-cluster update->enforcement p99 {p99:.0f}ms blew the "
            f"bound {bound:.0f}ms (= {P99_FACTOR} x the 27-bank churn "
            f"lane's {base_p99_ms:.0f}ms)", line)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cilium_tpu_torch.tools.bench_protocols",
        description="protocol-frontend throughput + cross-cluster "
                    "churn lane")
    ap.add_argument("--updates", type=int, default=50)
    ap.add_argument("--flows-scale", type=float, default=1.0,
                    help="scale every lane's flow count (smoke runs)")
    ap.add_argument("--skip-throughput", action="store_true")
    ap.add_argument("--skip-crosscluster", action="store_true")
    ap.add_argument("--no-p99-gate", action="store_true")
    ap.add_argument("--base-p99-ms", type=float, default=None,
                    help="the 27-bank churn lane's p99 on the same "
                         "device (tools/churn_lane): the cross-cluster "
                         "gate's denominator")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed whole-capture replays a lane")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the "
                         "plain versions)")
    ap.add_argument("--out", default="",
                    help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    if (not args.skip_crosscluster and not args.no_p99_gate
            and args.base_p99_ms is None):
        ap.error("the cross-cluster p99 gate needs --base-p99-ms (or "
                 "--no-p99-gate, or --skip-crosscluster)")

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    from cilium_tpu_torch.runtime.provenance import stamp

    lines = []
    if not args.skip_throughput:
        with tempfile.TemporaryDirectory(prefix="ct_proto_") as cache:
            for name, rules, flows in PROTO_LANES:
                lines.append(stamp(run_throughput(
                    name, rules, max(2048, int(flows * args.flows_scale)),
                    cache, log, device=args.device, reps=args.reps)))
    if not args.skip_crosscluster:
        lines.append(stamp(run_crosscluster(
            args.updates, log, gate_p99=not args.no_p99_gate,
            base_p99_ms=args.base_p99_ms, device=args.device)))
    if args.out:
        with open(args.out, "a") as fp:
            for ln in lines:
                fp.write(json.dumps(ln) + "\n")
    for ln in lines:
        print(json.dumps(ln), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
