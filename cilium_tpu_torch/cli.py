"""cilium-tpu debug CLI (the reference's ``cli.py``, on the port's
modules): ``python -m cilium_tpu_torch.cli``.

Reference: ``cilium-dbg``: introspection commands over the agent's
sockets plus offline tooling. Every subcommand of the reference, with
its arguments, exit codes and standard output. Subcommands:

* ``status``      — agent status over the service socket
* ``policy get``  — installed rules over the socket
* ``metrics``     — Prometheus text exposition over the socket
* ``inspect``     — offline dump of a compiled-policy artifact
  (the ``cilium-dbg bpf policy get`` analog: what the datapath —
  here, the staged tensors — actually enforces)
* ``replay``      — run a Hubble JSONL capture through the engine
  offline and print a verdict summary (``--trace-out`` dumps the
  flight-recorder Chrome trace-event JSON for the run)
* ``trace dump``  — fetch the live agent's flight recorder
  (runtime/tracing.py) as Perfetto-loadable Chrome trace-event JSON
* ``explain``     — verdict provenance for one trace id
  (runtime/explain.py): which rule/bank/generation produced the
  served verdicts, re-resolved on the CPU oracle (served vs fresh)
* ``bugtool``     — collect a diagnostics bundle from the agent
  (the ``cilium-bugtool`` analog)
* ``lint``        — the ctlint static analysis; registered with the
  reference's arguments, it answers an error naming queue 1's Q12b
  (the analysis package is not ported yet) and exits 2

REST-API commands (``--api <socket>``, runtime/api.py — the
``pkg/client`` consumer role): ``endpoint list|get|add|delete``,
``identity list``, ``ip list``, ``fqdn cache``, ``service list``,
``config get|set``, ``policy import|delete``, ``healthz``.

Where the port differs from the reference:

* ``replay`` builds its agent on ``--device`` (default ``cuda``; it
  raises without CUDA unless given ``--device cpu``). Its gate is the
  port's ``Config.from_env()`` (on unless set off), and ``--tpu`` sets
  it on, as in the reference. "Is the engine a device engine?" is
  ``isinstance(engine, TorchVerdictEngine)``. The agent is stopped when
  the replay ends, so no compile thread outlives the command;
* ``k8s apply`` reads YAML with the port's own reader
  (``policy/api/_yaml.safe_load_all``), not PyYAML;
* ``profile`` and ``bugtool`` send no ``out`` unless ``--out`` names
  one: the service then writes under its ``TMPDIR`` (the reference's
  defaults are ``/tmp/cilium_tpu_profile`` and ``/tmp``).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def cmd_status(args) -> int:
    from cilium_tpu_torch.runtime.service import VerdictClient

    c = VerdictClient(args.socket)
    print(json.dumps(c.call({"op": "status"}), indent=2, default=str))
    c.close()
    return 0


def cmd_drain(args) -> int:
    """Graceful drain: stop admitting data-path verdicts, flush — not
    error — pending batches, snapshot warm-restart state. The service
    keeps answering control ops; restart with loader.warm_restore to
    complete the warm cycle."""
    from cilium_tpu_torch.runtime.service import VerdictClient

    c = VerdictClient(args.socket)
    resp = c.call({"op": "drain"})
    print(json.dumps(resp, indent=2, default=str))
    c.close()
    return 0 if resp.get("ok") else 1


def cmd_policy_get(args) -> int:
    from cilium_tpu_torch.runtime.service import VerdictClient

    c = VerdictClient(args.socket)
    resp = c.call({"op": "policy_get"})
    print(json.dumps(resp, indent=2))
    c.close()
    return 0 if "error" not in resp else 1


def cmd_metrics(args) -> int:
    from cilium_tpu_torch.runtime.service import VerdictClient

    c = VerdictClient(args.socket)
    resp = c.call({"op": "metrics"})
    print(resp.get("text", ""))
    c.close()
    return 0


def cmd_inspect(args) -> int:
    """Dump the shape/stats of a compiled policy artifact."""
    import pickle

    with open(args.artifact, "rb") as f:
        policy = pickle.load(f)
    info = {
        "revision": policy.revision,
        "mapstate_entries": policy.mapstate.n_entries,
        "http_rules": len(policy.http_rules),
        "kafka_rules": len(policy.kafka_rules),
        "dns_rules": len(policy.dns_rules),
        "tensors": {
            k: {"shape": list(v.shape), "dtype": str(v.dtype),
                "bytes": int(v.nbytes)}
            for k, v in sorted(policy.arrays.items())
        },
        "matchers": {
            name: {
                "patterns": len(m.banked.patterns),
                "banks": m.banked.n_banks,
                "states": [b.n_states for b in m.banked.banks],
                "byte_classes": [b.n_classes for b in m.banked.banks],
            }
            for name, m in (
                ("path", policy.path_matcher),
                ("method", policy.method_matcher),
                ("host", policy.host_matcher),
                ("headers", policy.header_matcher),
                ("dns", policy.dns_matcher),
            )
        },
    }
    print(json.dumps(info, indent=2))
    return 0


def cmd_replay(args) -> int:
    """Replay a Hubble capture (JSONL, flowpb or binary) against a CNP
    ruleset."""
    from cilium_tpu_torch.agent import Agent
    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.runtime.logging import get_logger, setup as log_setup

    cfg = Config.from_env()
    # install the JSONL handler (stderr): replay is a one-shot daemon
    # run, and its chunk log lines carry the flight-recorder trace_id
    log_setup(cfg.log_level)
    replay_log = get_logger("replay")
    if args.tpu:
        cfg.enable_tpu_offload = True
    agent = Agent(cfg, device=args.device)
    try:
        return _replay(args, cfg, agent, replay_log)
    finally:
        agent.stop()


def _replay(args, cfg, agent, replay_log) -> int:
    import numpy as np

    from cilium_tpu_torch.core.flow import Verdict
    from cilium_tpu_torch.engine.verdict import TorchVerdictEngine
    from cilium_tpu_torch.hubble import FlowMetrics, Observer, annotate_flows
    from cilium_tpu_torch.runtime.tracing import (
        PHASE_FALLBACK,
        PHASE_HOST,
        TRACER,
    )

    for path in args.policy or ():
        agent.policy_add_file(path, wait=False)
    for i, spec in enumerate(args.endpoint or ()):
        labels = dict(kv.split("=", 1) for kv in spec.split(","))
        agent.endpoint_add(1000 + i, labels)
    agent.endpoint_manager.regenerate_all(wait=True)

    engine = agent.loader.engine
    if engine is None:
        print("no engine (no endpoints?)", file=sys.stderr)
        return 1
    from cilium_tpu_torch.ingest.binary import CaptureError
    from cilium_tpu_torch.ingest.cursor import ReplayCursor, replay_chunks

    # the fast path skips per-flow observability by design, so its
    # Observer is never built
    observer = None if args.fast else Observer(handlers=[FlowMetrics()])
    cursor = (ReplayCursor(args.cursor, args.capture)
              if args.cursor else None)
    counts: dict = {}
    total = 0
    try:
        # engine.batch_size (CILIUM_TPU_BATCH_SIZE / [engine] TOML)
        # is the replay chunk unit — the batch shape the jitted step
        # compiles for
        chunks = replay_chunks(args.capture, cursor=cursor,
                               chunk_size=cfg.engine.batch_size,
                               start=args.start, limit=args.limit,
                               decode=not args.fast)
        # offline replay has no live handshake state: drop-until-authed
        # enforcement is explicitly waived (the fail-closed None default
        # would report every auth-gated flow DROPPED, misstating what
        # the datapath did); the auth demand still surfaces per flow
        from cilium_tpu_torch.auth import AUTH_UNENFORCED

        # captures from another cluster carry foreign NUMERIC ids but
        # flowpb labels; re-map by EXACT label set against local
        # identities (subset matching would let {app=x} remap onto a
        # narrower {app=x, env=prod} identity and satisfy requirements
        # the flow never carried). The cluster-name label is excluded
        # from the comparison on both sides — it differs by definition
        # between the capturing and replaying clusters.
        from cilium_tpu_torch.core.labels import ParseLabel
        from cilium_tpu_torch.policy.api.rule import CLUSTER_LABEL_KEY

        def _norm(label_strs) -> frozenset:
            out = set()
            for s in label_strs:
                lbl = ParseLabel(s)
                if lbl.key != CLUSTER_LABEL_KEY:
                    out.add((lbl.source, lbl.key, lbl.value))
            return frozenset(out)

        by_labels = {}
        for cand, lbls in sorted(
                agent.selector_cache.identities().items()):
            by_labels.setdefault(_norm(l.format() for l in lbls), cand)
        remap_cache: dict = {}
        unmapped = [0]

        def _identity_for(labels) -> int:
            nid = remap_cache.get(labels)
            if nid is None:
                nid = by_labels.get(_norm(labels), -1)
                remap_cache[labels] = nid
            return nid

        def _remap(flow) -> None:
            # labels with NO local match map to identity 0 (unknown),
            # never the foreign NUMBER — sequential id spaces collide
            # across clusters, so keeping it would silently evaluate
            # the flow against an unrelated local workload's policy
            if flow.src_labels:
                nid = _identity_for(flow.src_labels)
                flow.src_identity = nid if nid >= 0 else 0
                if nid < 0:
                    unmapped[0] += 1
            if flow.dst_labels:
                nid = _identity_for(flow.dst_labels)
                flow.dst_identity = nid if nid >= 0 else 0
                if nid < 0:
                    unmapped[0] += 1

        replay_session = None
        # the device engine records its own host-prep/device-dispatch
        # spans; the oracle records none — attribute its whole
        # evaluation to the fallback phase so every replay trace shows
        # phases regardless of the gate
        engine_is_device = isinstance(engine, TorchVerdictEngine)

        def _verdict_span():
            import contextlib

            if engine_is_device:
                return contextlib.nullcontext()
            return TRACER.span("oracle.verdict", phase=PHASE_FALLBACK)

        for commit_index, chunk in chunks:
            # one flight-recorder trace per replayed chunk: the engine
            # spans (host-prep/device-dispatch or fallback) land under
            # it, flows are stamped at annotate, and the chunk log
            # line below carries the same id
            with TRACER.trace("replay.chunk",
                              chunk=int(commit_index)) as tctx:
              if args.fast:
                # columnar: records → verdicts, no Flow objects. v2
                # chunks (RawChunk.l7 set) carry the whole-capture
                # sidecar + widths, so nothing re-reads the file; v1
                # records are L3/L4-only.
                if chunk.l7 is not None and replay_session is None:
                    from cilium_tpu_torch.engine.replay import CaptureReplay

                    if engine_is_device:
                        # one CaptureReplay session for the stream —
                        # string tables DFA-scanned ONCE on device,
                        # chunks verdict from [B,15] row blocks (the
                        # oracle keeps the per-chunk object path).
                        # loader= makes the session swap-safe: a
                        # policy committed mid-replay re-stages and
                        # drops the verdict memo (zero stale verdicts)
                        replay_session = CaptureReplay(
                            engine, chunk.l7_all, chunk.offsets,
                            chunk.blob, cfg.engine, gen=chunk.gen_all,
                            loader=agent.loader)
                        # featurize the whole file once — chunks then
                        # slice (the staged-table discipline applied
                        # to the row block too). Only when the run
                        # actually covers the file: a --limit/--start/
                        # cursor-bounded replay must not pay (or
                        # allocate) whole-capture featurization for a
                        # few chunks
                        if args.limit is None and chunk.start == 0:
                            replay_session.stage_rows(
                                chunk.records_all, chunk.l7_all)
                            # dedup + device verdict memo: unique
                            # rows verdict once, chunks gather — the
                            # ratio guard falls back to row streaming
                            # when the capture doesn't repeat
                            replay_session.stage_unique(
                                cfg.engine.stage_unique_drop_ratio)
                    else:
                        replay_session = False
                if chunk.l7 is not None and replay_session:
                    from cilium_tpu_torch.runtime.tracing import (
                        PHASE_DEVICE as _PHD,
                    )

                    # CaptureReplay is device-engine-only: one span
                    # at the call site, over the session's own spans
                    # (replay.upload, replay.step with the step's
                    # gather / lookup / resolve / assemble,
                    # replay.readback)
                    with TRACER.span("replay.dispatch", phase=_PHD,
                                     records=len(chunk)):
                        out = replay_session.verdict_chunk(
                            chunk.records, chunk.l7,
                            authed_pairs=AUTH_UNENFORCED,
                            start=chunk.start)
                elif chunk.l7 is not None:
                    with _verdict_span():
                        out = engine.verdict_l7_records(
                            chunk.records, chunk.l7, chunk.offsets,
                            chunk.blob, authed_pairs=AUTH_UNENFORCED,
                            widths=chunk.widths, gen=chunk.gen)
                else:
                    with _verdict_span():
                        out = engine.verdict_records(
                            chunk.records, authed_pairs=AUTH_UNENFORCED)
                with TRACER.span("replay.account", phase=PHASE_HOST):
                    for v, c in zip(*np.unique(out["verdict"],
                                               return_counts=True)):
                        name = Verdict(int(v)).name
                        counts[name] = counts.get(name, 0) + int(c)
              else:
                with TRACER.span("replay.remap", phase=PHASE_HOST,
                                 records=len(chunk)):
                    for f in chunk:
                        _remap(f)
                with _verdict_span():
                    out = engine.verdict_flows(
                        chunk, authed_pairs=AUTH_UNENFORCED)
                with TRACER.span("replay.account", phase=PHASE_HOST):
                    if "match_spec" not in out:
                        out = {"verdict": np.asarray(out["verdict"])}
                    annotate_flows(chunk, out,
                                   amap=getattr(engine, "attribution",
                                                None))
                    observer.observe(chunk)
                    for f in chunk:
                        counts[Verdict(f.verdict).name] = counts.get(
                            Verdict(f.verdict).name, 0) + 1
              if tctx is not None:
                  # the JSONL correlate: this record's trace_id equals
                  # the chunk's span trace id and the flow stamps
                  replay_log.info("chunk replayed", extra={"fields": {
                      "chunk": int(commit_index),
                      "records": len(chunk)}})
            total += len(chunk)
            if cursor is not None:  # commit AFTER processing (§5.4):
                cursor.commit(commit_index)  # a kill re-runs ≤1 chunk
    except CaptureError as e:
        if args.fast and "bad magic" in str(e):
            print("error: --fast needs a binary capture "
                  "(cilium-tpu capture convert)", file=sys.stderr)
            return 1
        raise  # missing/truncated: main()'s handler reports precisely
    if cursor is not None and (args.limit is None or total < args.limit):
        # ran to EOF: a finished replay must not pin the cursor there —
        # re-running the same command should replay, not print 0 flows
        cursor.clear()
    summary = {"flows": total, "verdicts": counts}
    if not args.fast and unmapped[0]:
        # flows whose capture labels matched no local identity were
        # evaluated as identity 0 — surface it, don't hide it
        summary["unmapped_labels"] = unmapped[0]
    if args.trace_out:
        # the whole run's flight-recorder ring as Chrome trace-event
        # JSON (load at ui.perfetto.dev): per-chunk traces with
        # queue/host/device (or fallback) phase spans
        with open(args.trace_out, "w") as fp:
            json.dump(TRACER.chrome_trace(), fp)
        summary["trace_out"] = args.trace_out
        summary["trace_ids"] = len(TRACER.trace_ids())
    print(json.dumps(summary))
    return 0


def cmd_explain(args) -> int:
    """Explain one served verdict chain: recorded provenance for a
    trace id — (rule id, bank key, policy generation, memo-hit,
    kernel impl) per sampled record — re-resolved through the CPU
    oracle at the current revision so the output shows SERVED vs
    FRESH agreement per record."""
    from cilium_tpu_torch.runtime.service import VerdictClient

    c = VerdictClient(args.socket)
    resp = c.call({"op": "explain", "trace_id": args.trace_id})
    c.close()
    if "error" in resp:
        print(json.dumps(resp))
        return 1
    if args.json:
        print(json.dumps(resp, indent=2, default=str))
        return 0 if resp.get("found") else 1
    if not resp.get("found"):
        print(f"trace {args.trace_id}: no recorded provenance "
              f"(expired from the explain store, or the chunk was "
              f"not traced)")
        return 1
    print(f"trace {args.trace_id} — revision "
          f"{resp.get('revision')}, generation "
          f"{resp.get('generation_now')}"
          + (" [DEGRADED]" if resp.get("degraded") else ""))
    for r in resp.get("records", ()):
        p = r.get("provenance", {})
        agree = r.get("agreement")
        mark = ("==" if agree else
                "!=" if agree is not None else "??")
        fresh = r.get("fresh_verdict_name", "?")
        print(f"  [{r.get('index')}] served={r.get('verdict_name')} "
              f"{mark} fresh={fresh}  rule={p.get('rule', '-')}  "
              f"bank={p.get('bank_key', '') or '-'}  "
              f"gen={p.get('generation')}"
              f"{' memo' if p.get('memo_hit') else ''}"
              f"  kernel={p.get('kernel') or '-'}")
    ok = resp.get("served_equals_fresh", True) \
        or resp.get("degraded", False)
    return 0 if ok else 1


def cmd_canary(args) -> int:
    """Shadow/canary rollout status (`/v1/canary`): the staged
    generation, the live verdict-diff ledger, and the commit gate's
    decision surface. Exit status mirrors the gate: 0 while the
    rollout is healthy (idle/sampling/committed), 1 when the staged
    generation was refused or aborted — scriptable as a rollout
    health probe."""
    resp = _api(args).canary()
    if args.json:
        print(json.dumps(resp, indent=2, default=str))
    else:
        state = resp.get("state", "idle")
        if state == "idle":
            print("canary: idle (no staged generation)")
        else:
            print(f"canary: {state} — staged revision "
                  f"{resp.get('revision', resp.get('staged_revision'))}"
                  f", {resp.get('samples', 0)} sampled verdicts, "
                  f"{resp.get('diffs', 0)} diffs "
                  f"(diff_fraction {resp.get('diff_fraction', 0.0)}, "
                  f"budget {resp.get('diff_budget', 0.0)})")
            if resp.get("reason"):
                print(f"  reason: {resp['reason']}")
    return 1 if resp.get("state") in ("refused", "aborted") else 0


def cmd_trace(args) -> int:
    """Dump the live agent's flight recorder (`/v1/trace`).

    Default output is Chrome trace-event JSON — load it at
    https://ui.perfetto.dev (same family as the jax.profiler dumps).
    ``--spans`` prints the raw span records instead."""
    c = _api(args)
    body = c.traces(trace_id=args.trace_id, limit=args.limit,
                    chrome=not args.spans)
    text = json.dumps(body, indent=2, default=str)
    if args.out:
        with open(args.out, "w") as fp:
            fp.write(text)
        n = (len(body.get("traceEvents", ()))
             if not args.spans else len(body.get("spans", ())))
        print(json.dumps({"out": args.out, "events": n}))
    else:
        print(text)
    return 0


def cmd_flows(args) -> int:
    """Aggregated Hubble flow export (`/v1/flows`).

    Per-host flow counts keyed by (src identity, dst identity,
    verdict, rule, bank, generation), router-merged with host
    attribution when the agent fronts a serving fleet. ``--out``
    writes exporter-enveloped JSONL (``{"flow": {...}}`` lines) that
    ``ingest/hubble.read_jsonl`` parses straight back."""
    c = _api(args)
    body = c.flows(limit=args.limit)
    if args.out:
        n = 0
        with open(args.out, "w") as fp:
            for row in body.get("flows", ()):
                fp.write(json.dumps({
                    "flow": row.get("flow") or {},
                    "count": row.get("count", 0),
                    **({"node_name": row["host"]}
                       if row.get("host") else {}),
                }) + "\n")
                n += 1
        print(json.dumps({"out": args.out, "flows": n,
                          "records": body.get("records", 0)}))
        return 0
    if args.json:
        print(json.dumps(body, indent=2, default=str))
        return 0
    hosts = body.get("hosts") or ([body["host"]]
                                  if body.get("host") else [])
    print(f"{body.get('records', 0)} records, "
          f"{body.get('aggregated', 0)} aggregated into "
          f"{body.get('keys', 0)} keys, overflow "
          f"{body.get('overflow', 0)}"
          + (f"  hosts={','.join(hosts)}" if hosts else ""))
    for row in body.get("flows", ()):
        where = ""
        if row.get("hosts"):
            where = "  hosts=" + ",".join(
                f"{h}:{n}" for h, n in sorted(row["hosts"].items()))
        elif row.get("host"):
            where = f"  host={row['host']}"
        print(f"  {row.get('src_identity')}->"
              f"{row.get('dst_identity')} {row.get('verdict')} "
              f"x{row.get('count')}  rule={row.get('rule') or '-'} "
              f"gen={row.get('generation')}{where}")
    return 0


def cmd_auth(args) -> int:
    """Mutual-auth pair management over the REST API."""
    c = _api(args)
    if args.auth_cmd == "list":
        return _print(c.auth_list())
    if args.auth_cmd == "add":
        code, body = c.auth_put(args.src, args.dst, ttl=args.ttl)
        ok = code == 201
    else:
        code, body = c.auth_delete(args.src, args.dst)
        ok = code == 200
    _print(body)  # error bodies included — a silent rc 1 helps nobody
    return 0 if ok else 1


def cmd_capture(args) -> int:
    """Binary capture tooling (perf-ring-analog format)."""
    import os

    from cilium_tpu_torch.core.flow import L7Type
    from cilium_tpu_torch.ingest import binary

    if args.capture_cmd == "synth":
        # reproducible BASELINE-shaped captures for demos/benches
        # (shared dispatch with bench.py; identity fixup only — a
        # capture writer doesn't need policy resolution)
        from cilium_tpu_torch.ingest import synth as synthmod

        try:
            scenario = synthmod.scenario_by_name(
                args.scenario, args.rules, args.flows, seed=args.seed)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        _, scenario = synthmod.realize_scenario(scenario,
                                                resolve=False)
        n = binary.write_capture_l7(args.output, scenario.flows)
        print(json.dumps({"records": n,
                          "version": binary.capture_version(args.output),
                          "scenario": args.scenario,
                          "rules": args.rules, "seed": args.seed}))
        return 0
    if args.capture_cmd == "stream":
        import threading
        import time as _time

        import numpy as np

        from cilium_tpu_torch.ingest.binary import (
            CaptureError,
            capture_field_widths,
            read_gen_sidecar,
            read_l7_sidecar,
            sections_to_bytes,
        )
        from cilium_tpu_torch.runtime.stream import StreamClient

        try:
            rec = binary.map_capture(args.file)
            l7, offsets, blob = read_l7_sidecar(args.file)
        except CaptureError as e:
            print(f"error: {e} (stream needs a v2/v3 capture — "
                  f"cilium-tpu capture convert)", file=sys.stderr)
            return 1
        gen = read_gen_sidecar(args.file)
        # gen_dtype(fmax): "pairs" subdtype shape is (fmax, 2)
        fmax = (int(gen.dtype["pairs"].shape[0])
                if gen is not None else 0)
        client = StreamClient(args.socket,
                              widths=capture_field_widths(l7, offsets))
        bs = max(1, args.chunk)
        counts = np.zeros(6, dtype=np.int64)
        state = {"n": 0, "errors": 0}
        t0 = _time.monotonic()

        from cilium_tpu_torch.runtime.tracing import TRACER

        def sender():
            # each frame is self-contained (carries the file's string
            # table) — simple and correct; the bench path amortizes
            # tables via the server's incremental session anyway
            try:
                for i in range(0, len(rec), bs):
                    g = gen[i:i + bs] if gen is not None else None
                    # one trace per chunk: the id rides the traced
                    # frame, so the SERVER's flight recorder shows
                    # this chunk's queue/host/device phases
                    with TRACER.trace("capture.stream", chunk=i // bs):
                        client.send_image(sections_to_bytes(
                            np.asarray(rec[i:i + bs]), l7[i:i + bs],
                            offsets, blob, g, fmax))
                client.finish()
            except (OSError, ConnectionError, TimeoutError):
                # a dead/hung service: the drain below reports the
                # truncation; a thread traceback helps nobody
                pass

        th = threading.Thread(target=sender, daemon=True)
        th.start()
        stalled = False
        try:
            for _seq, v in client.results():
                if isinstance(v, Exception):
                    state["errors"] += 1
                    continue
                counts += np.bincount(v, minlength=6)[:6]
                state["n"] += len(v)
        except TimeoutError:
            # a hung service stalls results() (no frame within the
            # client timeout): the replay is truncated — report it in
            # the summary JSON with exit 1, never as a traceback
            stalled = True
        th.join(timeout=30)
        client.close()
        dt = max(_time.monotonic() - t0, 1e-9)
        # a dead service mid-stream drains results() cleanly with the
        # sender's BrokenPipeError swallowed — a truncated replay must
        # exit nonzero, never report partial success
        truncated = stalled or state["n"] != len(rec) or th.is_alive()
        print(json.dumps({
            "records": state["n"],
            "expected": int(len(rec)),
            "verdicts": counts.tolist(),
            "seconds": round(dt, 3),
            "records_per_sec": round(state["n"] / dt, 1),
            "errors": state["errors"],
            "truncated": truncated,
            "stalled": stalled,
            "revision": client.revision,
        }))
        return 1 if (state["errors"] or truncated) else 0
    if args.capture_cmd == "info":
        from cilium_tpu_torch.ingest.flowpb import (
            iter_pb_capture,
            looks_like_pb_capture,
        )

        if looks_like_pb_capture(args.file):
            from cilium_tpu_torch.ingest.flowpb import PBError

            try:
                n = sum(1 for _ in iter_pb_capture(args.file))
            except PBError as e:
                # arbitrary bytes can sniff as a varint prefix — a
                # torn/garbage file must report cleanly, not traceback
                print(f"error: invalid capture: {e}", file=sys.stderr)
                return 1
            print(json.dumps({"records": n, "format": "flowpb-stream",
                              "bytes": os.path.getsize(args.file)}))
            return 0
        n = binary.capture_count(args.file)
        info = {"records": n, "bytes": os.path.getsize(args.file),
                "version": binary.capture_version(args.file)}
        if info["version"] in (binary.VERSION_L7, binary.VERSION_L7G):
            n_strings, blob_bytes = binary.l7_info(args.file)  # O(1)
            info["strings"] = n_strings
            info["blob_bytes"] = blob_bytes
        if info["version"] == binary.VERSION_L7G:
            gen = binary.read_gen_sidecar(args.file)
            info["gen_fmax"] = int(gen.dtype["pairs"].shape[0])
            info["gen_records"] = int((gen["proto"] != 0).sum())
        print(json.dumps(info))
        return 0
    # convert JSONL → binary. L7 payloads ride the v2 sidecar (string
    # table + fixed L7 records) unless --l4-only asks for the compact
    # v1 tuple form (the reference's ring-event shape), in which case
    # count what was flattened
    from cilium_tpu_torch.ingest.flowpb import (
        looks_like_pb_capture,
        read_pb_capture,
    )

    if not looks_like_pb_capture(args.input):
        # JSONL converts COLUMNAR: lines parse straight into capture
        # sections (ingest/columnar.py), no Flow objects between the
        # file and the arrays — the zero-object half of "replaying a
        # Hubble capture"
        import numpy as np

        from cilium_tpu_torch.ingest.columnar import jsonl_to_columns

        cols = jsonl_to_columns(args.input)
        n_l7 = int((cols.rec["l7_type"] != int(L7Type.NONE)).sum())
        if n_l7 and not args.l4_only:
            n = binary.write_capture_columns(args.output, cols)
            out = {"records": n,
                   "version": binary.capture_version(args.output),
                   "l7_payloads": n_l7}
            if cols.gen_dropped:
                out["l7_payloads_dropped"] = cols.gen_dropped
            print(json.dumps(out))
        else:
            rec = np.array(cols.rec)
            # v1 carries no payload; an L7-typed record would
            # re-verdict against EMPTY fields on replay
            rec["l7_type"] = int(L7Type.NONE)
            n = binary.write_capture_records(args.output, rec)
            print(json.dumps({
                "records": n, "version": binary.VERSION,
                "l7_payloads_dropped": n_l7 + cols.gen_dropped}))
        return 0
    # protobuf flow streams convert too (the full format matrix:
    # JSONL | pb → CTCAP v1/v2)
    flows = read_pb_capture(args.input)
    # generic l7proto payloads ride the v3 GENERIC section (a capture
    # with none stays v2); --l4-only still flattens everything. A
    # GENERIC flow with no payload/proto is uncarriable (and
    # unmatchable) either way — counted as dropped, not hidden.
    n_gen_drop = sum(1 for f in flows if f.l7 == L7Type.GENERIC
                     and (f.generic is None or not f.generic.proto))
    n_l7 = sum(1 for f in flows if f.l7 != L7Type.NONE) - n_gen_drop
    if n_l7 and not args.l4_only:
        n = binary.write_capture_l7(args.output, flows)
        out = {"records": n,
               "version": binary.capture_version(args.output),
               "l7_payloads": n_l7}
        if n_gen_drop:
            out["l7_payloads_dropped"] = n_gen_drop
        print(json.dumps(out))
    else:
        n = binary.write_capture(args.output, flows)
        print(json.dumps({"records": n, "version": binary.VERSION,
                          "l7_payloads_dropped": n_l7 + n_gen_drop}))
    return 0


def cmd_profile(args) -> int:
    """Profile a LIVE serving process on demand (pkg/pprof analog)."""
    from cilium_tpu_torch.runtime.service import VerdictClient

    c = VerdictClient(args.socket)
    resp = c.call({"op": "profile", "mode": args.mode,
                   "seconds": args.seconds, "out": args.out})
    c.close()
    if "error" in resp:
        print(f"error: {resp['error']}", file=sys.stderr)
        return 1
    print(json.dumps(resp))
    return 0


def cmd_bugtool(args) -> int:
    from cilium_tpu_torch.runtime.service import VerdictClient

    c = VerdictClient(args.socket)
    resp = c.call({"op": "bugtool", "out": args.out})
    c.close()
    if "error" in resp:
        print(f"error: {resp['error']}", file=sys.stderr)
        return 1
    print(resp["path"])
    return 0


def cmd_lint(args) -> int:
    """ctlint: the `make lint` gate as a subcommand, over the port's
    tree by default (exit 1 on any non-allowlisted finding, 2 on an
    unknown rule)."""
    from cilium_tpu_torch.analysis import run_cli

    argv: List[str] = list(args.targets or [])
    argv += ["--format", args.format]
    if args.root:
        argv += ["--root", args.root]
    if args.rules:
        argv += ["--rules", args.rules]
    for rule in args.rule or ():
        argv += ["--rule", rule]
    if args.changed_only:
        argv += ["--changed-only"]
    if args.out:
        argv += ["--out", args.out]
    if args.wall_budget_ms is not None:
        argv += ["--wall-budget-ms", str(args.wall_budget_ms)]
    if args.list_rules:
        argv += ["--list-rules"]
    return run_cli(argv)


def cmd_perf_report(args) -> int:
    """perf-report: normalize bench artifacts into the trajectory and
    gate on unexplained regressions (docs/OBSERVABILITY.md)."""
    from cilium_tpu_torch.perf_report import run_cli

    argv: List[str] = []
    if args.root:
        argv += ["--root", args.root]
    if args.out:
        argv += ["--out", args.out]
    if args.threshold is not None:
        argv += ["--threshold", str(args.threshold)]
    if args.strict:
        argv += ["--strict"]
    if args.no_fail:
        argv += ["--no-fail"]
    if args.verbose:
        argv += ["--verbose"]
    argv += ["--format", args.format]
    return run_cli(argv)


def _api(args):
    from cilium_tpu_torch.runtime.api import APIClient

    return APIClient(args.api)


def _print(obj) -> int:
    print(json.dumps(obj, indent=2, default=str))
    return 0


def cmd_healthz(args) -> int:
    return _print(_api(args).healthz())


def cmd_endpoint(args) -> int:
    c = _api(args)
    if args.ep_cmd == "list":
        return _print(c.endpoints())
    if args.ep_cmd == "get":
        code, body = c.request("GET", f"/v1/endpoint/{args.id}")
        _print(body)
        return 0 if code == 200 else 1
    if args.ep_cmd == "add":
        labels = dict(kv.split("=", 1) for kv in (args.labels or "").split(
            ",")) if args.labels else {}
        code, body = c.endpoint_put(args.id, labels, ipv4=args.ipv4)
        _print(body)
        return 0 if code in (200, 201) else 1
    if args.ep_cmd == "config":
        # `cilium-dbg endpoint config <id> PolicyAuditMode=...` analog
        opts = {}
        for kv in args.options:
            k, _, v = kv.partition("=")
            if k.lower() not in ("policyauditmode", "policy_audit_mode"):
                print(f"error: unknown option {k!r}", file=sys.stderr)
                return 1
            vl = v.strip().lower()
            if vl in ("true", "enabled", "1", "yes"):
                opts["policy_audit_mode"] = True
            elif vl in ("false", "disabled", "0", "no"):
                opts["policy_audit_mode"] = False
            else:
                # a typo'd value must error, never silently disable
                print(f"error: bad value {v!r} for {k} "
                      f"(Enabled|Disabled)", file=sys.stderr)
                return 1
        code, body = c.request("PATCH",
                               f"/v1/endpoint/{args.id}/config",
                               body=opts)
        _print(body)
        return 0 if code == 200 else 1
    code, body = c.endpoint_delete(args.id)
    _print(body)
    return 0 if code == 200 else 1


def cmd_identity_list(args) -> int:
    return _print(_api(args).identities())


def cmd_ip_list(args) -> int:
    return _print(_api(args).ipcache())


def cmd_proxy_list(args) -> int:
    return _print(_api(args).proxy_redirects())


def cmd_policy_trace(args) -> int:
    """`cilium policy trace` analog over the REST API."""
    def _labels(specs):
        # pass label STRINGS through verbatim so source prefixes
        # ("cidr:10.0.0.0/8", "reserved:world") survive the transport
        out = []
        for spec in specs or ():
            out.extend(s for s in spec.split(",") if s)
        return out

    named_ports = {}
    for spec in args.named_port or ():
        name, _, port = spec.partition("=")
        if not name or not port.isdecimal():
            print(f"error: --named-port wants name=port, got {spec!r}",
                  file=sys.stderr)
            return 2
        named_ports[name] = int(port)
    return _print(_api(args).policy_trace(
        _labels(args.src), _labels(args.dst),
        dport=args.dport, protocol=args.protocol,
        direction="egress" if args.egress else "ingress",
        named_ports=named_ports or None))


def cmd_fqdn_cache(args) -> int:
    return _print(_api(args).fqdn_cache())


def cmd_service_list(args) -> int:
    return _print(_api(args).services())


def cmd_config(args) -> int:
    c = _api(args)
    if args.cfg_cmd == "get":
        return _print(c.config())
    fields = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        fields[k] = {"true": True, "false": False}.get(v.lower(), v)
    code, body = c.patch_config(**fields)
    _print(body)
    return 0 if code == 200 else 1


def cmd_policy_import(args) -> int:
    with open(args.file) as f:
        code, body = _api(args).policy_put_yaml(f.read())
    _print(body)
    return 0 if code == 200 else 1


def cmd_policy_delete(args) -> int:
    code, body = _api(args).policy_delete(args.labels)
    _print(body)
    return 0 if code == 200 else 1


def cmd_k8s(args) -> int:
    """kubectl-shaped access to the fake-apiserver (SURVEY §2.4 K8s
    layer): apply/get/delete/list Cilium CRDs over its socket."""
    from cilium_tpu_torch.k8s.apiserver import K8sClient, NotFound
    from cilium_tpu_torch.policy.api import _yaml

    c = K8sClient(args.socket)
    if args.k8s_cmd == "apply":
        applied = []
        with open(args.file) as f:
            for doc in _yaml.safe_load_all(f.read()):
                if not doc:
                    continue
                plural = _k8s_plural_of(doc)
                applied.append(c.apply(plural, doc)["metadata"])
        return _print(applied)
    if args.k8s_cmd == "get":
        try:
            if args.name:
                return _print(c.get(args.plural, args.name,
                                    args.namespace))
            return _print(c.list(args.plural, args.namespace)["items"])
        except NotFound as e:
            print(str(e), file=sys.stderr)
            return 1
    if args.k8s_cmd == "delete":
        try:
            gone = c.delete(args.plural, args.name, args.namespace)
        except NotFound as e:
            print(str(e), file=sys.stderr)
            return 1
        return _print({"deleted": gone["metadata"]})
    raise AssertionError(args.k8s_cmd)


def _k8s_plural_of(doc) -> str:
    from cilium_tpu_torch.k8s.apiserver import RESOURCES

    kind = doc.get("kind", "")
    for plural, (k, _) in RESOURCES.items():
        if k == kind:
            return plural
    raise SystemExit(f"unsupported kind {kind!r} "
                     f"(known: {[k for k, _ in RESOURCES.values()]})")


def cmd_monitor(args) -> int:
    """`cilium-dbg monitor` analog: attach to the agent's monitor
    socket and stream PolicyVerdict/Drop/Trace events as JSON lines,
    with a per-subscription aggregation level."""
    from cilium_tpu_torch.monitor import monitor_follow

    n = 0
    try:
        for ev in monitor_follow(args.socket, level=args.level,
                                 types=args.type):
            print(json.dumps(ev), flush=True)
            n += 1
            if args.count is not None and n >= args.count:
                return 0
    except KeyboardInterrupt:
        return 0
    except ConnectionError:
        # the agent shut down: the stream ENDING is not an error
        # (cilium-dbg monitor reports the end, not a failure)
        print("monitor stream closed by agent", file=sys.stderr)
        return 0
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


def cmd_observe(args) -> int:
    """`hubble observe` analog: stream flows from the hubble socket."""
    from cilium_tpu_torch.hubble.server import HubbleClient

    flt = {}
    if args.verdict:
        flt["verdict"] = args.verdict.upper()
    if args.dport is not None:      # 0 is a valid filter value
        flt["dport"] = args.dport
    if args.identity is not None:   # identity 0 = unidentified source
        flt["src_identity"] = args.identity
    for name in ("http_method", "http_path", "dns_query", "node_name",
                 "source_label", "destination_label"):
        v = getattr(args, name, None)
        if v:
            flt[name] = v
    c = HubbleClient(args.hubble)
    if args.status:
        return _print(c.server_status())
    try:
        if args.follow:
            # indefinite live stream (hubble observe -f); --timeout only
            # bounds each server round-trip, the client auto-resumes
            for flow in c.follow(flt=flt or None):
                print(json.dumps(flow), flush=True)
        else:
            for flow in c.get_flows(flt=flt or None, limit=args.limit,
                                    timeout=args.timeout):
                print(json.dumps(flow))
    except KeyboardInterrupt:
        pass
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="cilium-tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("status", help="agent status")
    p.add_argument("--socket", required=True)
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("drain", help="gracefully drain the verdict "
                       "service (flush pending, snapshot warm state)")
    p.add_argument("--socket", required=True)
    p.set_defaults(fn=cmd_drain)

    p = sub.add_parser("policy", help="policy introspection")
    psub = p.add_subparsers(dest="policy_cmd", required=True)
    pg = psub.add_parser("get")
    pg.add_argument("--socket", required=True)
    pg.set_defaults(fn=cmd_policy_get)
    pt = psub.add_parser("trace",
                         help="explain the verdict for hypothetical "
                              "src/dst label sets")
    pt.add_argument("--api", required=True)
    pt.add_argument("--src", action="append",
                    help="source labels k=v[,k=v]")
    pt.add_argument("--dst", action="append",
                    help="destination labels k=v[,k=v]")
    pt.add_argument("--dport", type=int, default=0)
    pt.add_argument("--protocol", type=int, default=6)
    pt.add_argument("--egress", action="store_true",
                    help="trace egress (default ingress)")
    pt.add_argument("--named-port", dest="named_port", action="append",
                    help="endpoint named-port table entry name=port "
                         "(resolves named toPorts in traced rules)")
    pt.set_defaults(fn=cmd_policy_trace)
    ps_ = psub.add_parser("selectors",
                          help="live selector -> identity resolution")
    ps_.add_argument("--api", required=True)
    ps_.set_defaults(fn=lambda args: _print(_api(args).selectors()))

    p = sub.add_parser("metrics", help="Prometheus text metrics")
    p.add_argument("--socket", required=True)
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("trace",
                       help="flight-recorder traces (runtime/tracing.py)")
    trsub = p.add_subparsers(dest="trace_cmd", required=True)
    td = trsub.add_parser(
        "dump",
        help="dump recorded traces as Chrome trace-event JSON "
             "(Perfetto-loadable; --spans for raw span records)")
    td.add_argument("--api", required=True)
    td.add_argument("--out", default=None,
                    help="write to a file instead of stdout")
    td.add_argument("--trace-id", dest="trace_id", default=None,
                    help="only this trace id")
    td.add_argument("--limit", type=int, default=None,
                    help="newest N span records (raw mode)")
    td.add_argument("--spans", action="store_true",
                    help="raw span records instead of Chrome JSON")
    td.set_defaults(fn=cmd_trace)

    p = sub.add_parser(
        "flows",
        help="aggregated Hubble flow export (/v1/flows): per-host "
             "verdict counts, fleet-merged; --out writes JSONL")
    p.add_argument("--api", required=True)
    p.add_argument("--limit", type=int, default=None,
                   help="largest N aggregation keys")
    p.add_argument("--out", default=None,
                   help="write exporter-enveloped JSONL instead of "
                        "the summary lines")
    p.add_argument("--json", action="store_true",
                   help="raw JSON instead of the summary lines")
    p.set_defaults(fn=cmd_flows)

    p = sub.add_parser(
        "explain",
        help="verdict provenance for one trace id: cited rule/bank/"
             "generation, re-resolved on the CPU oracle "
             "(served vs fresh)")
    p.add_argument("trace_id")
    p.add_argument("--socket", required=True)
    p.add_argument("--json", action="store_true",
                   help="raw JSON instead of the summary lines")
    p.set_defaults(fn=cmd_explain)

    p = sub.add_parser(
        "canary",
        help="shadow/canary rollout status: staged generation, "
             "verdict-diff ledger, commit-gate decision")
    p.add_argument("--api", required=True, help="agent REST api socket")
    p.add_argument("--json", action="store_true",
                   help="raw JSON instead of the summary lines")
    p.set_defaults(fn=cmd_canary)

    p = sub.add_parser("inspect", help="dump a compiled-policy artifact")
    p.add_argument("artifact")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("profile",
                       help="profile a live service on demand "
                            "(host stacks or jax device trace)")
    p.add_argument("--socket", required=True,
                   help="verdict service unix socket")
    p.add_argument("--mode", choices=["host", "device"], default="host")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None,
                   help="profile directory (default: the service's, "
                        "under its TMPDIR)")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("bugtool", help="collect a diagnostics bundle")
    p.add_argument("--socket", required=True)
    p.add_argument("--out", default=None,
                   help="bundle directory (default: the service's "
                        "TMPDIR)")
    p.set_defaults(fn=cmd_bugtool)

    p = sub.add_parser("lint",
                       help="ctlint codebase-aware static analysis "
                            "(docs/ANALYSIS.md)")
    p.add_argument("targets", nargs="*",
                   help="repo-relative files/dirs (default: the "
                        "package)")
    p.add_argument("--format", choices=["text", "json"], default="text")
    p.add_argument("--root", default=None,
                   help="repo root (default: the installed package's "
                        "parent)")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids (default: all)")
    p.add_argument("--rule", action="append", default=None,
                   metavar="ID",
                   help="run one rule id (repeatable)")
    p.add_argument("--changed-only", action="store_true",
                   help="report findings only for git-changed files "
                        "(pre-commit face; the tree is still indexed)")
    p.add_argument("--out", default=None,
                   help="also write a JSON report here")
    p.add_argument("--wall-budget-ms", type=int, default=None,
                   metavar="MS",
                   help="fail if the lint run exceeds this wall-clock "
                        "budget (the make lint latency gate)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser("perf-report",
                       help="bench-artifact trajectory + regression "
                            "gate (docs/OBSERVABILITY.md)")
    p.add_argument("--root", default=None,
                   help="artifact directory (default: repo root)")
    p.add_argument("--out", default=None,
                   help="write PERF_TRAJECTORY.json here")
    p.add_argument("--threshold", type=float, default=None,
                   help="worse-factor-over-1 needing explanation")
    p.add_argument("--strict", action="store_true",
                   help="gate every round transition, not just the "
                        "newest")
    p.add_argument("--no-fail", action="store_true",
                   help="report-only: always exit 0")
    p.add_argument("--format", choices=["text", "json"],
                   default="text")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_perf_report)

    p = sub.add_parser("healthz", help="REST healthz")
    p.add_argument("--api", required=True)
    p.set_defaults(fn=cmd_healthz)

    p = sub.add_parser("endpoint", help="endpoint CRUD over the REST API")
    esub = p.add_subparsers(dest="ep_cmd", required=True)
    e = esub.add_parser("list")
    e.add_argument("--api", required=True)
    e.set_defaults(fn=cmd_endpoint)
    for name in ("get", "delete"):
        e = esub.add_parser(name)
        e.add_argument("id", type=int)
        e.add_argument("--api", required=True)
        e.set_defaults(fn=cmd_endpoint)
    e = esub.add_parser("add")
    e.add_argument("id", type=int)
    e.add_argument("--labels", help="k=v[,k=v...]")
    e.add_argument("--ipv4", default="")
    e.add_argument("--api", required=True)
    e.set_defaults(fn=cmd_endpoint)
    e = esub.add_parser("config",
                        help="per-endpoint options "
                             "(PolicyAuditMode=Enabled|Disabled)")
    e.add_argument("id", type=int)
    e.add_argument("options", nargs="+", metavar="K=V")
    e.add_argument("--api", required=True)
    e.set_defaults(fn=cmd_endpoint)

    p = sub.add_parser("identity", help="identity introspection")
    isub = p.add_subparsers(dest="id_cmd", required=True)
    i = isub.add_parser("list")
    i.add_argument("--api", required=True)
    i.set_defaults(fn=cmd_identity_list)

    p = sub.add_parser("ip", help="ipcache introspection")
    ipsub = p.add_subparsers(dest="ip_cmd", required=True)
    i = ipsub.add_parser("list")
    i.add_argument("--api", required=True)
    i.set_defaults(fn=cmd_ip_list)

    p = sub.add_parser("proxy", help="proxy redirect table")
    prsub = p.add_subparsers(dest="proxy_cmd", required=True)
    i = prsub.add_parser("list")
    i.add_argument("--api", required=True)
    i.set_defaults(fn=cmd_proxy_list)

    p = sub.add_parser("fqdn", help="FQDN subsystem introspection")
    fsub = p.add_subparsers(dest="fqdn_cmd", required=True)
    i = fsub.add_parser("cache")
    i.add_argument("--api", required=True)
    i.set_defaults(fn=cmd_fqdn_cache)

    p = sub.add_parser("service", help="load-balancer services")
    ssub = p.add_subparsers(dest="svc_cmd", required=True)
    i = ssub.add_parser("list")
    i.add_argument("--api", required=True)
    i.set_defaults(fn=cmd_service_list)

    p = sub.add_parser("k8s", help="kubectl-shaped fake-apiserver "
                                   "access (apply/get/delete CRDs)")
    ksub = p.add_subparsers(dest="k8s_cmd", required=True)
    k = ksub.add_parser("apply")
    k.add_argument("--socket", required=True)
    k.add_argument("-f", "--file", required=True)
    k.set_defaults(fn=cmd_k8s)
    k = ksub.add_parser("get")
    k.add_argument("--socket", required=True)
    k.add_argument("plural")
    k.add_argument("name", nargs="?")
    k.add_argument("-n", "--namespace", default=None)
    k.set_defaults(fn=cmd_k8s)
    k = ksub.add_parser("delete")
    k.add_argument("--socket", required=True)
    k.add_argument("plural")
    k.add_argument("name")
    k.add_argument("-n", "--namespace", default=None)
    k.set_defaults(fn=cmd_k8s)

    p = sub.add_parser("config", help="daemon config get/set")
    csub = p.add_subparsers(dest="cfg_cmd", required=True)
    i = csub.add_parser("get")
    i.add_argument("--api", required=True)
    i.set_defaults(fn=cmd_config)
    i = csub.add_parser("set")
    i.add_argument("set", nargs="+", metavar="k=v")
    i.add_argument("--api", required=True)
    i.set_defaults(fn=cmd_config)

    pi = psub.add_parser("import", help="PUT a CNP YAML via the REST API")
    pi.add_argument("file")
    pi.add_argument("--api", required=True)
    pi.set_defaults(fn=cmd_policy_import)
    pd = psub.add_parser("delete", help="delete rules by labels")
    pd.add_argument("labels", nargs="+")
    pd.add_argument("--api", required=True)
    pd.set_defaults(fn=cmd_policy_delete)

    p = sub.add_parser("monitor",
                       help="stream datapath events from the monitor "
                            "socket (cilium-dbg monitor analog)")
    p.add_argument("--socket", required=True,
                   help="agent monitor unix socket path")
    p.add_argument("--level",
                   choices=["none", "low", "medium", "maximum"],
                   help="aggregation level for THIS subscription "
                        "(default: the agent's level)")
    p.add_argument("--type", action="append",
                   choices=["drop", "debug", "capture", "trace",
                            "policy_verdict"],
                   help="event type filter (repeatable; default all)")
    p.add_argument("--count", type=int, default=None,
                   help="exit after N events")
    p.set_defaults(fn=cmd_monitor)

    p = sub.add_parser("observe", help="stream flows from the hubble socket")
    p.add_argument("--hubble", required=True,
                   help="hubble server unix socket path")
    p.add_argument("--follow", action="store_true")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--timeout", type=float, default=1.0)
    p.add_argument("--verdict", help="FORWARDED/DROPPED/REDIRECTED")
    p.add_argument("--dport", type=int)
    p.add_argument("--identity", type=int, help="source identity filter")
    p.add_argument("--http-method", dest="http_method",
                   help="HTTP method regex")
    p.add_argument("--http-path", dest="http_path",
                   help="HTTP path regex")
    p.add_argument("--dns-query", dest="dns_query",
                   help="DNS query regex")
    p.add_argument("--node-name", dest="node_name",
                   help="emitting node regex")
    p.add_argument("--source-label", dest="source_label",
                   help="source endpoint label substring")
    p.add_argument("--destination-label", dest="destination_label",
                   help="destination endpoint label substring")
    p.add_argument("--status", action="store_true",
                   help="print server status instead of flows")
    p.set_defaults(fn=cmd_observe)

    p = sub.add_parser("auth", help="mutual-auth pair management")
    asub = p.add_subparsers(dest="auth_cmd", required=True)
    a = asub.add_parser("list")
    a.add_argument("--api", required=True)
    a.set_defaults(fn=cmd_auth)
    for name in ("add", "delete"):
        a = asub.add_parser(name)
        a.add_argument("src", type=int, help="source identity")
        a.add_argument("dst", type=int, help="destination identity")
        if name == "add":
            a.add_argument("--ttl", type=float, default=None)
        a.add_argument("--api", required=True)
        a.set_defaults(fn=cmd_auth)

    p = sub.add_parser("capture", help="binary capture tooling")
    capsub = p.add_subparsers(dest="capture_cmd", required=True)
    ci = capsub.add_parser("info", help="validate + describe a capture")
    ci.add_argument("file")
    ci.set_defaults(fn=cmd_capture)
    cc = capsub.add_parser("convert",
                           help="JSONL → binary capture (v2 with L7 "
                                "sidecar when payloads are present)")
    cc.add_argument("input")
    cc.add_argument("output")
    cc.add_argument("--l4-only", action="store_true",
                    help="write compact v1 tuple records, flattening "
                         "L7 payloads (the ring-event shape)")
    cc.set_defaults(fn=cmd_capture)
    cs = capsub.add_parser("synth",
                           help="write a reproducible synthetic v2 "
                                "capture (BASELINE scenario shapes)")
    cs.add_argument("output")
    cs.add_argument("--scenario",
                    choices=["http", "fqdn", "kafka", "generic"],
                    default="http")
    cs.add_argument("--rules", type=int, default=100)
    cs.add_argument("--flows", type=int, default=10000)
    cs.add_argument("--seed", type=int, default=0)
    cs.set_defaults(fn=cmd_capture)
    cst = capsub.add_parser(
        "stream",
        help="replay a v2/v3 capture through a LIVE agent's verdict "
             "socket over the chunked binary stream transport "
             "(runtime/stream.py) — the online serving path, not the "
             "in-process engine")
    cst.add_argument("file")
    cst.add_argument("--socket", required=True,
                     help="verdict-service Unix socket path")
    cst.add_argument("--chunk", type=int, default=8192)
    cst.set_defaults(fn=cmd_capture)

    p = sub.add_parser("replay",
                       help="replay a Hubble capture (JSONL or binary)")
    p.add_argument("capture")
    p.add_argument("--policy", action="append",
                   help="CNP YAML file (repeatable)")
    p.add_argument("--endpoint", action="append",
                   help="endpoint labels k=v[,k=v...] (repeatable)")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--cursor",
                   help="cursor file: resume a killed replay from the "
                        "last committed chunk (kill/resume, §5.4)")
    p.add_argument("--fast", action="store_true",
                   help="columnar fast path for binary captures: no "
                        "per-flow Python objects, skips per-flow "
                        "observability (hubble/monitor fan-out)")
    p.add_argument("--tpu", action="store_true",
                   help="set the offload gate on (the port's default "
                        "is on unless CILIUM_TPU_ENABLE_OFFLOAD=0)")
    p.add_argument("--device", default=None,
                   help="torch device of the replay's agent (default "
                        "cuda; cpu runs the plain versions)")
    p.add_argument("--trace-out", dest="trace_out", default=None,
                   help="write the run's flight-recorder Chrome "
                        "trace-event JSON here (ui.perfetto.dev)")
    p.set_defaults(fn=cmd_replay)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except ConnectionError as e:
        print(f"error: cannot reach agent socket: {e}", file=sys.stderr)
        return 1
    except Exception as e:
        from cilium_tpu_torch.ingest.binary import CaptureError

        if isinstance(e, CaptureError):
            print(f"error: invalid capture: {e}", file=sys.stderr)
            return 1
        raise


if __name__ == "__main__":
    sys.exit(main())
