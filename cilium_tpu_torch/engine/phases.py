"""Device-time attribution: where a verdict batch spends it
(counterpart of the reference's ``engine/phases.py``).

The verdict step is one call by design, so per-phase numbers come from
a **probe** that re-runs the same staged batch through separate
sub-steps, each ending in a forced 2-element readback (a ``.cpu()`` of
the first output tensor's first two elements: the stream is in order,
so everything before it has run):

=================  ======================================================
``featurize``      host encode: flows → packed numpy batch
``h2d``            host→device copy of the packed batch, forced
``mapstate``       the L3/L4 mapstate lookup (``mapstate_kernel``)
``dfa-scan``       the per-field banked DFA scans (live path; kernel KD
                   on the card), or
``gather``         the staged-table match-word gathers (capture path)
``resolve``        per-rule conjunction → ruleset-any → priority/auth/
                   audit (the LEGACY formulation)
``fused-verdict``  the engine's staged step (``engine/megakernel.py``):
                   mapstate + scans + factored resolve in one call,
                   where the three rows above are three
``dfa-dense``      the planned fields' scans through the dense DFA arm,
                   per the engine's kernel plan
``nfa-bitset``     the planned fields' scans through the bitset-NFA arm
                   (kernel K1; only reported when the plan uses it)
``compile``        first-call cost minus steady state
``execute``        steady-state fused-step wall
=================  ======================================================

Coverage: ``attributed / wall``. The sub-steps run apart, each forced,
so their sum is at least the step's wall less noise; a coverage below
~0.9 means a phase is missing from the decomposition. On the card the
step is bound by the host's dispatch of some hundreds of small kernels,
so the live probe times ``mapstate``, ``dfa-scan``, ``resolve`` and the
fused step in interleaved rounds (:func:`_timed_rounds`): a host shared
with other work then slows each of them alike instead of the one timed
while it was busy. The reference's sub-steps are separately jitted
programs; here they are plain calls, so ``compile`` holds what the
first call pays: on the card, CUDA's lazy start-up and the kernels'
first build. ``fused_dispatches`` is 1 and
``three_op_dispatches`` 3 as in the reference: the count of
completion-forced calls, not of device kernels (the fused step is
hundreds of kernels on the card). Results feed the flight recorder
(spans under an ``engine.phase_probe`` root) and the
``cilium_tpu_engine_phase_seconds{phase=...}`` family; every forced
readback counts under ``cilium_tpu_engine_host_syncs_total{site=...}``.

This is an inspection instrument, not a hot-path layer: nothing here
runs per request.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from cilium_tpu_torch.core.flow import TrafficDirection
from cilium_tpu_torch.engine.compiled import (
    _ROW_COLS,
    encode_flows,
    flowbatch_to_host_dict,
)
from cilium_tpu_torch.engine.dfa_kernel import dfa_scan_banked
from cilium_tpu_torch.engine.mapstate_kernel import mapstate_lookup
from cilium_tpu_torch.engine.memo import as_index
from cilium_tpu_torch.engine.replay import _ids_to_device
from cilium_tpu_torch.engine.verdict import (
    _verdict_core,
    batch_field,
    batch_to_device,
    unpack_batch,
)
from cilium_tpu_torch.runtime import simclock
from cilium_tpu_torch.runtime.metrics import (
    ENGINE_HOST_SYNCS,
    ENGINE_PHASE_SECONDS,
    METRICS,
)
from cilium_tpu_torch.runtime.tracing import PHASE_DEVICE, PHASE_HOST, TRACER

#: phase label values the probes emit
ENGINE_PHASES = ("featurize", "h2d", "mapstate", "dfa-scan", "resolve",
                 "fused-verdict", "dfa-dense", "nfa-bitset",
                 "compile", "execute")
CAPTURE_PHASES = ("gather", "mapstate", "resolve")


def _force(out, site: str = "") -> None:
    """Force completion by a 2-element readback of the first tensor
    leaf (in-order stream: its readback implies the rest). Each call is
    an intentional host↔device sync, counted under
    ``cilium_tpu_engine_host_syncs_total{site=…}``."""
    METRICS.inc(ENGINE_HOST_SYNCS, labels={"site": site or "probe"})
    leaf = out
    while isinstance(leaf, dict):
        leaf = leaf[sorted(leaf)[0]]
    while isinstance(leaf, (tuple, list)):
        leaf = leaf[0]
    (leaf[:2] if leaf.ndim else leaf).cpu()


def _timed(fn, reps: int, site: str = ""):
    """(steady median s, first-call s, last output). Steady is the
    median of ``reps`` forced calls after the first."""
    t0 = time.perf_counter()
    out = fn()
    _force(out, site)
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        _force(out, site)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], first, out


def _timed_rounds(steps: Dict, reps: int) -> Dict:
    """:func:`_timed` for several steps at once. ``steps`` maps a phase
    to ``(fn, site)``, where ``fn`` takes the first calls' outputs so
    far (by phase). Each step's first call runs in order; then ``reps``
    rounds call every step once, so that drift on a shared host (other
    tenants, clocks) falls on each step alike and a ratio of their
    medians stays steady. Returns {phase: (steady median s, first-call
    s, first output)}."""
    outs, firsts = {}, {}
    for name, (fn, site) in steps.items():
        t0 = time.perf_counter()
        outs[name] = fn(outs)
        _force(outs[name], site)
        firsts[name] = time.perf_counter() - t0
    times = {name: [] for name in steps}
    for _ in range(reps):
        for name, (fn, site) in steps.items():
            t0 = time.perf_counter()
            _force(fn(outs), site)
            times[name].append(time.perf_counter() - t0)
    return {name: (sorted(t)[len(t) // 2], firsts[name], outs[name])
            for name, t in times.items()}


def _unpacked(batch):
    return unpack_batch(batch) if "scalars" in batch else batch


def _live_mapstate(arrays, batch):
    b = _unpacked(batch)
    return mapstate_lookup(
        arrays["ms_key_w0"], arrays["ms_key_w1"], arrays["ms_key_w2"],
        arrays["ms_deny"], arrays["ms_ruleset"],
        arrays["ms_enf_ids"], arrays["ms_enf_flags"],
        b["ep_ids"], b["peer_ids"], b["dports"],
        b["protos"], b["directions"],
        auth=arrays.get("ms_auth"),
        port_plens=arrays.get("ms_plens"),
        tmpl_ids=arrays.get("ms_tmpl_ids"))


def _live_scan(arrays, batch):
    b = _unpacked(batch)

    def scan_field(prefix, data, lengths, valid):
        words = dfa_scan_banked(
            arrays[f"{prefix}_trans"], arrays[f"{prefix}_byteclass"],
            arrays[f"{prefix}_start"], arrays[f"{prefix}_accept"],
            data, lengths)
        flat = words.reshape(words.shape[0], -1)
        return torch.where(valid[:, None], flat, 0)

    words = (scan_field("path", *batch_field(b, "path")),
             scan_field("method", *batch_field(b, "method")),
             scan_field("host", *batch_field(b, "host")),
             scan_field("hdr", *batch_field(b, "headers")),
             scan_field("dns", *batch_field(b, "qname")))
    if "l7g_trans" in arrays:   # frontend automaton staged
        words = words + (scan_field("l7g", *batch_field(b, "l7g")),)
    return words


def _live_resolve(arrays, ms, words, batch):
    b = _unpacked(batch)
    ingress = b["directions"] == int(TrafficDirection.INGRESS)
    src = torch.where(ingress, b["peer_ids"], b["ep_ids"])
    dst = torch.where(ingress, b["ep_ids"], b["peer_ids"])
    return _verdict_core(
        arrays, ms, b["l7_types"], words,
        (b["kafka_api_key"], b["kafka_api_version"],
         b["kafka_client"], b["kafka_topic"]),
        (src, dst), b, gen_cols=(b["gen_proto"], b["gen_pairs"]))


def _cap_rows(batch):
    rows = batch["rows"]
    idx = batch.get("idx")
    if idx is not None:
        rows = rows.index_select(0, as_index(idx))
    return rows


def _cap_gather(table_words, batch):
    rows = _cap_rows(batch)
    col = {c: i for i, c in enumerate(_ROW_COLS)}
    words = tuple(
        table_words[field].index_select(0, rows[:, col[f"{field}_row"]]
                                        .long())
        for field in ("path", "method", "host", "headers", "qname"))
    if "l7g" in table_words and rows.shape[1] > len(_ROW_COLS):
        # frontend serialized-record words ride the gen block's l7g
        # row column (gen layout: proto, family, l7g row, pairs...)
        words = words + (table_words["l7g"].index_select(
            0, rows[:, len(_ROW_COLS) + 2].long()),)
    return rows, words


def _cap_mapstate(arrays, batch):
    rows = _cap_rows(batch)
    col = {c: i for i, c in enumerate(_ROW_COLS)}
    return mapstate_lookup(
        arrays["ms_key_w0"], arrays["ms_key_w1"], arrays["ms_key_w2"],
        arrays["ms_deny"], arrays["ms_ruleset"],
        arrays["ms_enf_ids"], arrays["ms_enf_flags"],
        rows[:, col["ep_ids"]], rows[:, col["peer_ids"]],
        rows[:, col["dports"]], rows[:, col["protos"]],
        rows[:, col["directions"]],
        auth=arrays.get("ms_auth"),
        port_plens=arrays.get("ms_plens"),
        tmpl_ids=arrays.get("ms_tmpl_ids"))


def _cap_resolve(arrays, ms, rows, words, batch):
    col = {c: i for i, c in enumerate(_ROW_COLS)}

    def c(name):
        return rows[:, col[name]]

    ingress = c("directions") == int(TrafficDirection.INGRESS)
    src = torch.where(ingress, c("peer_ids"), c("ep_ids"))
    dst = torch.where(ingress, c("ep_ids"), c("peer_ids"))
    n = len(_ROW_COLS)
    gen_cols = ((rows[:, n], rows[:, n + 3:])
                if rows.shape[1] > n else None)
    return _verdict_core(
        arrays, ms, c("l7_types"), words,
        (c("kafka_api_key"), c("kafka_api_version"),
         c("kafka_client"), c("kafka_topic")),
        (src, dst), batch, gen_cols=gen_cols)


def _record(report: Dict, reps: int) -> None:
    """Publish a probe report into METRICS + the flight recorder."""
    now = simclock.wall()
    with TRACER.trace("engine.phase_probe", batch=report.get("batch"),
                      reps=reps) as ctx:
        for phase, ms in report["phases_ms"].items():
            METRICS.observe(ENGINE_PHASE_SECONDS, ms / 1e3,
                            labels={"phase": phase})
            TRACER.add_span(
                ctx, f"engine.phase.{phase}",
                PHASE_HOST if phase == "featurize" else PHASE_DEVICE,
                now, ms / 1e3)
        for phase, key in (("compile", "compile_ms"),
                           ("execute", "execute_ms")):
            if report.get(key) is not None:
                METRICS.observe(ENGINE_PHASE_SECONDS,
                                report[key] / 1e3,
                                labels={"phase": phase})


def _impl_scan(arrays, batch, impl_plan, wanted: str,
               dfa_impl: str, interpret: bool):
    """Scan only the fields the engine's kernel plan runs through
    ``wanted`` — the per-impl attribution lanes (dfa-dense /
    nfa-bitset phase labels). ``interpret`` is the reference's Pallas
    switch, kept for its signature: the port has no interpret mode (a
    CPU tensor runs each kernel's plain version)."""
    from cilium_tpu_torch.engine.megakernel import (
        fused_scan_field,
        scan_fields,
    )

    b = _unpacked(batch)
    impls = dict(impl_plan)
    out = []
    for prefix, field in scan_fields(arrays):
        if impls.get(prefix, "dfa-dense") != wanted:
            continue
        w, _ = fused_scan_field(
            arrays, prefix, *batch_field(b, field), impl=wanted,
            dfa_impl=dfa_impl)
        out.append(w)
    return tuple(out)


class EnginePhaseProbe:
    """Per-phase attribution of the LIVE verdict path (featurize →
    h2d → mapstate → dfa-scan → resolve, plus the fused step and its
    per-impl scan lanes) for one engine."""

    def __init__(self, engine):
        self.engine = engine
        self._ms = _live_mapstate
        self._scan = _live_scan
        self._resolve = _live_resolve
        # the engine's STAGED step (the fused step unless the engine
        # was built legacy) — the wall the decomposition covers
        self._full = engine._step
        self._impl_plan = tuple(sorted(
            getattr(engine, "impl_plan", {}).items()))

    def measure_flows(self, flows: Sequence, cfg=None, reps: int = 5
                      ) -> Dict:
        """Featurize ``flows`` (timed: the ``featurize`` phase), then
        :meth:`measure` the resulting packed batch."""
        t0 = time.perf_counter()
        host = flowbatch_to_host_dict(
            encode_flows(flows, self.engine.policy.kafka_interns, cfg))
        feat_ms = (time.perf_counter() - t0) * 1e3
        report = self.measure(host, reps=reps, _defer_record=True)
        report["phases_ms"]["featurize"] = round(feat_ms, 3)
        report["attributed_ms"] = round(
            report["attributed_ms"] + feat_ms, 3)
        _record(report, reps)
        return report

    def measure(self, host_batch: Dict[str, np.ndarray], reps: int = 5,
                authed_pairs=None, _defer_record: bool = False) -> Dict:
        """``host_batch`` is the packed host layout
        (:func:`flowbatch_to_host_dict`). Returns the phase report;
        also records it (metrics + tracer spans)."""
        engine, arrays = self.engine, self.engine._arrays

        def put():
            batch = batch_to_device(host_batch, engine.device)
            engine._stage_auth(batch, authed_pairs)
            return batch

        h2d_s, _, batch = _timed(put, reps, site="engine-h2d")
        # the covered sub-steps and the wall they cover, in rounds
        steady = _timed_rounds({
            "mapstate": (lambda o: self._ms(arrays, batch),
                         "engine-mapstate"),
            "dfa-scan": (lambda o: self._scan(arrays, batch),
                         "engine-dfa-scan"),
            "resolve": (lambda o: self._resolve(
                arrays, o["mapstate"], o["dfa-scan"], batch),
                "engine-resolve"),
            "fused-verdict": (lambda o: self._full(arrays, batch),
                              "engine-fused-verdict"),
        }, reps)
        ms_s, scan_s, res_s = (steady[p][0] for p in
                               ("mapstate", "dfa-scan", "resolve"))
        full_s, full_first, _ = steady["fused-verdict"]

        # the three-op baseline: mapstate → scan → resolve as three
        # completion-forced calls
        def three_op():
            m = self._ms(arrays, batch)
            _force(m, "engine-three-op")
            w = self._scan(arrays, batch)
            _force(w, "engine-three-op")
            return self._resolve(arrays, m, w, batch)

        three_s, _, _ = _timed(three_op, reps, site="engine-three-op")

        phases_ms = {"h2d": round(h2d_s * 1e3, 3),
                     "mapstate": round(ms_s * 1e3, 3),
                     "dfa-scan": round(scan_s * 1e3, 3),
                     "resolve": round(res_s * 1e3, 3),
                     "fused-verdict": round(full_s * 1e3, 3)}
        # per-impl scan lanes, per the engine's kernel plan
        for impl in sorted({v for _, v in self._impl_plan} or
                           {"dfa-dense"}):
            impl_s, _, _ = _timed(
                lambda: _impl_scan(
                    arrays, batch, self._impl_plan, impl,
                    getattr(self.engine, "_dfa_impl", "gather"),
                    getattr(self.engine, "_interpret", True)),
                reps, site="engine-impl-scan")
            phases_ms[impl] = round(impl_s * 1e3, 3)
        attributed = (ms_s + scan_s + res_s) * 1e3
        report = {
            "batch": int(len(host_batch["scalars"])),
            "phases_ms": phases_ms,
            "wall_ms": round(full_s * 1e3, 3),
            "attributed_ms": round(attributed, 3),
            "coverage": round(attributed / max(full_s * 1e3, 1e-9), 4),
            "compile_ms": round(max(0.0, full_first - full_s) * 1e3, 3),
            "execute_ms": round(full_s * 1e3, 3),
            "fused_ms": round(full_s * 1e3, 3),
            "fused_dispatches": 1,
            "three_op_ms": round(three_s * 1e3, 3),
            "three_op_dispatches": 3,
            "fused_speedup": round(three_s / max(full_s, 1e-9), 3),
            "impl_plan": dict(self._impl_plan),
        }
        if not _defer_record:
            _record(report, reps)
        return report


class CapturePhaseProbe:
    """Per-phase attribution of the CAPTURE-REPLAY path (h2d →
    gather → mapstate → resolve) for one staged
    :class:`~cilium_tpu_torch.engine.replay.CaptureReplay` session."""

    def __init__(self, replay):
        self.replay = replay
        self._gather = _cap_gather
        self._ms = _cap_mapstate
        self._resolve = _cap_resolve
        # the session's staged step — the wall the decomposition covers
        self._full = replay._step

    def measure(self, start: int = 0, n: Optional[int] = None,
                reps: int = 5, authed_pairs=None) -> Dict:
        """Attribute one chunk (records ``[start:start+n]`` of the
        staged capture; dedup id stream when the session staged one)."""
        replay, engine = self.replay, self.replay.engine
        arrays = engine._arrays
        if replay.rows_all is None:
            raise ValueError("stage_rows first")
        n = n if n is not None else min(len(replay.rows_all), 8192)

        if replay.row_idx is not None:
            idx_host = replay.row_idx[start:start + n]
            table = replay.stage_unique_device()

            def put():
                batch = {"rows": table,
                         "idx": _ids_to_device(idx_host, engine.device)}
                engine._stage_auth(batch, authed_pairs)
                return batch
        else:
            rows_host = replay.rows_all[start:start + n]

            def put():
                batch = {"rows": torch.from_numpy(
                    np.ascontiguousarray(rows_host)).to(engine.device)}
                engine._stage_auth(batch, authed_pairs)
                return batch

        h2d_s, _, batch = _timed(put, reps, site="capture-h2d")
        tw = replay.table_words

        # the end-to-end chunk wall the phases must cover: fresh H2D +
        # the step + forced completion, as the replay loop pays it
        def chunk():
            return self._full(arrays, tw, put())

        wall_s, wall_first, _ = _timed(chunk, reps,
                                       site="capture-chunk")
        g_s, _, (rows, words) = _timed(
            lambda: self._gather(tw, batch), reps,
            site="capture-gather")
        ms_s, _, ms = _timed(lambda: self._ms(arrays, batch), reps,
                             site="capture-mapstate")
        res_s, _, _ = _timed(
            lambda: self._resolve(arrays, ms, rows, words, batch),
            reps, site="capture-resolve")
        step_s, _, _ = _timed(
            lambda: self._full(arrays, tw, batch), reps,
            site="capture-step")

        phases_ms = {"h2d": round(h2d_s * 1e3, 3),
                     "gather": round(g_s * 1e3, 3),
                     "mapstate": round(ms_s * 1e3, 3),
                     "resolve": round(res_s * 1e3, 3)}
        attributed = (h2d_s + g_s + ms_s + res_s) * 1e3
        report = {
            "batch": int(n),
            "stream": "id" if replay.row_idx is not None else "row",
            "phases_ms": phases_ms,
            "wall_ms": round(wall_s * 1e3, 3),
            "step_ms": round(step_s * 1e3, 3),
            "attributed_ms": round(attributed, 3),
            "coverage": round(attributed / max(wall_s * 1e3, 1e-9), 4),
            "compile_ms": round(max(0.0, wall_first - wall_s) * 1e3, 3),
            "execute_ms": round(wall_s * 1e3, 3),
        }
        _record(report, reps)
        return report
