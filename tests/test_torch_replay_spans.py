"""The capture replay's spans and host-sync counter, on the CPU.

``CaptureReplay.verdict_chunk`` opens a flight-recorder span at each
layer boundary (``engine/replay.py``); under ``torch.profiler`` each is
also a ``record_function`` range, so a Chrome trace shows them nested
chunk → upload / step / readback → the step's gather, lookup, resolve
and assembly, and the readback's copy and split. With neither a trace
context nor a profiler the span is the shared no-op. The lanes do not
depend on any of it, and each chunk counts the same blocking calls
under ``cilium_tpu_engine_host_syncs_total``.

Inputs: the synth http scenario at 12 rules × 240 flows, one capture,
staged on the row stream (the dedup declined) and on the id stream.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from cilium_tpu_torch.core.config import EngineConfig
from cilium_tpu_torch.engine.compiled import CompiledPolicy
from cilium_tpu_torch.engine.replay import CaptureReplay
from cilium_tpu_torch.engine.verdict import OUTPUT_LANES, TorchVerdictEngine
from cilium_tpu_torch.ingest import binary, synth
from cilium_tpu_torch.runtime import tracing
from cilium_tpu_torch.runtime.metrics import ENGINE_HOST_SYNCS, METRICS
from cilium_tpu_torch.runtime.tracing import TRACER

CHUNK = 120
CHUNK_RANGE = "test.chunk"
#: span → the range it opens inside
PARENT = {
    "replay.upload": CHUNK_RANGE,
    "replay.step": CHUNK_RANGE,
    "replay.readback": CHUNK_RANGE,
    "step.gather": "replay.step",
    "step.lookup": "replay.step",
    "step.resolve": "replay.step",
    "step.assemble": "replay.step",
    "readback.copy": "replay.readback",
    "readback.split": "replay.readback",
}
#: the step's spans in launch order: the id stream expands its ids
#: before the lookup
STEP_ORDER = {
    "row": ["step.lookup", "step.gather", "step.resolve", "step.assemble"],
    "id": ["step.gather", "step.lookup", "step.gather", "step.resolve",
           "step.assemble"]}
#: blocking calls a chunk makes, by site: the row stream copies every
#: chunk's rows; the id stream copies the first chunk's ids and issues
#: each next chunk's ahead of use, asynchronously
SYNCS = {"row": {"replay-upload": 1, "host-lanes": 1},
         "id": {"host-lanes": 1}}
SITES = ("replay-upload", "host-lanes", "auth-stage")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pi, sc = synth.realize_scenario(synth.scenario_by_name("http", 12, 240))
    engine = TorchVerdictEngine(CompiledPolicy.build(pi, EngineConfig()),
                                device="cpu")
    path = os.path.join(str(tmp_path_factory.mktemp("spans")), "c.bin")
    binary.write_capture_l7(path, sc.flows)
    rec = np.asarray(binary.map_capture(path))
    l7, offsets, blob = binary.read_l7_sidecar(path)
    replays = {}
    for stream, drop in (("row", 0.0), ("id", None)):
        cfg = EngineConfig()
        cfg.verdict_memo = False
        r = CaptureReplay(engine, l7, offsets, blob, cfg)
        r.stage_rows(rec, l7)
        r.stage_unique(drop)
        assert (r.row_idx is None) == (stream == "row")
        replays[stream] = r
    return {"engine": engine, "rec": rec, "l7": l7, "replays": replays}


@pytest.fixture
def quiet_tracer():
    """The global recorder, armed at rate 1 and empty; restored after."""
    old = (TRACER.enabled, TRACER.sample_rate)
    TRACER.configure(enabled=True, sample_rate=1.0)
    TRACER.clear()
    yield TRACER
    TRACER.configure(enabled=old[0], sample_rate=old[1])
    TRACER.clear()


def _chunk(world, stream, start=0):
    rec, l7 = world["rec"], world["l7"]
    return world["replays"][stream].verdict_chunk(
        rec[start:start + CHUNK], l7[start:start + CHUNK], start=start)


def _profiled(world, stream, tmp_path):
    """One chunk inside a ``test.chunk`` range under the CPU profiler:
    (lanes, the trace's complete events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CHUNK_RANGE):
            out = _chunk(world, stream)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return out, [e for e in events if e.get("ph") == "X"]


def _holds(outer, inner):
    a, b = float(outer["ts"]), float(outer["ts"]) + float(outer["dur"])
    c, d = float(inner["ts"]), float(inner["ts"]) + float(inner["dur"])
    return outer.get("tid") == inner.get("tid") and a <= c and d <= b


def _lanes_equal(want, got):
    assert set(got) == set(want) == set(OUTPUT_LANES)
    for lane in OUTPUT_LANES:
        assert got[lane].dtype == want[lane].dtype, lane
        np.testing.assert_array_equal(got[lane], want[lane], lane)


@pytest.mark.parametrize("stream", ("row", "id"))
def test_profiled_chunk_nests_the_nine_spans(world, stream, tmp_path,
                                             quiet_tracer):
    _, events = _profiled(world, stream, tmp_path)
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    by_name = {}
    for e in ranges:
        by_name.setdefault(e["name"], []).append(e)
    assert set(PARENT) <= set(by_name), sorted(by_name)
    for name, parent in PARENT.items():
        for e in by_name[name]:
            assert _holds(by_name[parent][0], e), (name, parent)
    step_children = sorted((e for n, p in PARENT.items()
                            if p == "replay.step" for e in by_name[n]),
                           key=lambda e: float(e["ts"]))
    assert [e["name"] for e in step_children] == STEP_ORDER[stream]
    # the profiler alone records nothing into the flight recorder
    assert quiet_tracer.dump() == []


def test_trace_context_records_the_same_names(world, quiet_tracer):
    with TRACER.trace("replay.chunk") as ctx:
        _chunk(world, "row")
    names = [r["name"] for r in quiet_tracer.dump(trace_id=ctx.trace_id)]
    assert set(names) == set(PARENT) | {"replay.chunk"}
    assert sorted(names) == sorted(list(PARENT) + ["replay.chunk"])


def test_disarmed_span_is_the_shared_noop(world, quiet_tracer):
    assert not torch.autograd._profiler_enabled()
    assert TRACER.span("replay.step", tracing.PHASE_DEVICE) \
        is tracing._NOOP
    _chunk(world, "row")
    assert quiet_tracer.dump() == []


def test_profiler_span_records_into_the_ring_under_a_trace(quiet_tracer,
                                                           tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with TRACER.trace("root") as ctx:
            with TRACER.span("inner.span", tracing.PHASE_HOST, k=1):
                torch.ones(4).sum()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert "inner.span" in names
    recs = quiet_tracer.dump(trace_id=ctx.trace_id)
    assert [(r["name"], r.get("attrs")) for r in recs
            if r["name"] == "inner.span"] == [("inner.span", {"k": 1})]


@pytest.mark.parametrize("stream", ("row", "id"))
def test_lanes_bit_equal_with_and_without_tracing(world, stream, tmp_path,
                                                  quiet_tracer):
    plain = _chunk(world, stream)
    profiled, _ = _profiled(world, stream, tmp_path)
    with TRACER.trace("replay.chunk"):
        traced = _chunk(world, stream)
    _lanes_equal(plain, profiled)
    _lanes_equal(plain, traced)


@pytest.mark.parametrize("stream", ("row", "id"))
def test_sync_counter_rises_by_the_same_count_each_chunk(world, stream):
    def marks():
        return {s: METRICS.get(ENGINE_HOST_SYNCS, {"site": s})
                for s in SITES}

    rises = []
    for start in range(0, len(world["rec"]), CHUNK):
        before = marks()
        _chunk(world, stream, start)
        after = marks()
        rises.append({s: after[s] - before[s] for s in SITES
                      if after[s] != before[s]})
    first = {"replay-upload": 1, "host-lanes": 1}
    assert rises == [first] + [SYNCS[stream]] * (len(rises) - 1)
