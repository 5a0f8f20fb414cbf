"""The reduction of the program's spans (``benchmark/spans.py``) on a
hand-written Chrome trace, the trace's own reading unchanged by the
program's ranges, and the host-sync metric's arithmetic."""

from __future__ import annotations

import pytest

from benchmark import registry, spans, trace, window
from benchmark.metrics import host_syncs_per_chunk

HOST, DEVICE, OTHER = 1, 7, 2


def _x(name, cat, ts, dur, tid=HOST, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, ts, dur, tid=HOST):
    return _x(name, "user_annotation", ts, dur, tid)


def _launch(ts, corr):
    return _x("cudaLaunchKernel", "cuda_runtime", ts, 1, corr=corr)


def _kernel(name, ts, dur, corr):
    return _x(name, "kernel", ts, dur, DEVICE, corr)


#: two chunks; the first with every span, a kernel launched between
#: spans and a copy each way, the second with a resolve alone; a range
#: on another thread and the ranges' device copies, both ignored
EVENTS = [
    _span(trace.CHUNK_RANGE, 0, 100),
    _span("replay.upload", 2, 10),
    _x("cudaMemcpyAsync", "cuda_runtime", 3, 5),
    _x("Memcpy HtoD", "gpu_memcpy", 4, 6, DEVICE),
    _span("replay.step", 14, 36),
    _span("step.gather", 15, 5), _launch(16, 10),
    _kernel("g1", 22, 4, 10),
    _span("step.lookup", 21, 9), _launch(22, 11),
    _kernel("l1", 27, 6, 11),
    _span("step.resolve", 31, 13), _launch(32, 12), _launch(40, 13),
    _kernel("r1", 34, 6, 12), _kernel("r2", 41, 2, 13),
    _span("step.assemble", 45, 4), _launch(46, 14),
    _kernel("a1", 47, 1, 14),
    _launch(52, 16), _kernel("k_unspanned", 53, 1, 16),
    _span("replay.readback", 55, 40),
    _span("readback.copy", 56, 24), _launch(57, 15),
    _kernel("c1", 58, 2, 15),
    _x("cudaMemcpyAsync", "cuda_runtime", 61, 17),
    _x("Memcpy DtoH", "gpu_memcpy", 62, 8, DEVICE),
    _span("readback.split", 82, 12),
    _span(trace.CHUNK_RANGE, 120, 30),
    _span("replay.step", 121, 28),
    _span("step.resolve", 122, 18), _launch(123, 20),
    _kernel("r3", 125, 10, 20),
    _span("replay.upload", 0, 200, tid=OTHER),
    _x("replay.step", "gpu_user_annotation", 22, 26, DEVICE),
    _x(trace.CHUNK_RANGE, "gpu_user_annotation", 0, 150, DEVICE),
]

PROGRAM = {"replay.upload", "replay.step", "step.gather", "step.lookup",
           "step.resolve", "step.assemble", "replay.readback",
           "readback.copy", "readback.split"}


def _us(table):
    return {k: round(v * 1e6, 6) for k, v in table.items()}


def test_reduce_gives_exact_host_kernel_and_idle_figures():
    r = spans.reduce(EVENTS)
    assert r.chunks == 2
    assert _us(r.host_s) == {
        "replay.upload": 10, "replay.step": 36 + 28, "step.gather": 5,
        "step.lookup": 9, "step.resolve": 13 + 18, "step.assemble": 4,
        "replay.readback": 40, "readback.copy": 24, "readback.split": 12}
    assert _us(r.kernel_s) == {"step.gather": 4, "step.lookup": 6,
                               "step.resolve": 6 + 2 + 10,
                               "step.assemble": 1, "readback.copy": 2}
    assert r.launches == {"step.gather": 1, "step.lookup": 1,
                          "step.resolve": 3, "step.assemble": 1,
                          "readback.copy": 1}
    assert r.unattributed == 1
    # idle pieces, each under the host's innermost span (see EVENTS)
    assert _us(r.idle_s) == {
        "": 2 + 2 + 3 + 1 + 5 + 1 + 1, "replay.upload": 2 + 2,
        "replay.step": 1 + 1 + 1 + 1 + 1 + 9, "step.gather": 5,
        "step.lookup": 1 + 1, "step.resolve": 1 + 1 + 1 + 3 + 5,
        "step.assemble": 2 + 1, "replay.readback": 1 + 2 + 1,
        "readback.copy": 2 + 2 + 10, "readback.split": 12}
    assert r.per_chunk_ms(r.host_s, "step.gather") == pytest.approx(
        5e-6 * 1e3 / 2)
    assert r.per_chunk_ms(r.kernel_s, "none.such") is None


def test_the_span_tables_add_up_to_the_traces_reading():
    r, t = spans.reduce(EVENTS), trace.reduce(EVENTS)
    n = len([e for e in EVENTS if e["cat"] == "kernel"])
    assert sum(r.launches.values()) + r.unattributed == t.kernels == n
    unspanned = 1e-6                       # k_unspanned
    assert sum(r.kernel_s.values()) + unspanned == pytest.approx(t.kernel_s)
    inside = (100 + 30) * 1e-6             # the two chunk ranges
    between = 20e-6
    assert sum(r.idle_s.values()) == pytest.approx(
        t.window_s - t.busy_s - between)
    assert sum(r.idle_s.values()) <= inside


def test_the_traces_reading_is_the_same_without_the_program_ranges():
    bare = [e for e in EVENTS if e["name"] not in PROGRAM]
    assert trace.reduce(bare) == trace.reduce(EVENTS)
    r = spans.reduce(bare)
    assert (r.host_s, r.kernel_s, r.launches) == ({}, {}, {})
    assert r.unattributed == len([e for e in EVENTS
                                  if e["cat"] == "kernel"])
    assert list(r.idle_s) == [""]


def test_no_chunk_range_reads_nothing():
    assert spans.reduce([e for e in EVENTS
                         if e["name"] != trace.CHUNK_RANGE]) is None


# -- the host-sync metric -------------------------------------------------
def _window(chunks):
    return window.Window(seconds=1.0, records=chunks,
                         latencies=[0.01] * chunks, kept=[])


@pytest.fixture
def counter(monkeypatch):
    from cilium_tpu_torch.runtime import metrics

    fresh = metrics.Metrics()
    monkeypatch.setattr(metrics, "METRICS", fresh)
    return fresh


def test_host_syncs_per_chunk_counts_every_call_of_the_run(counter):
    from cilium_tpu_torch.runtime.metrics import ENGINE_HOST_SYNCS

    r = trace.Reading(chunks=12, window_s=0.2, busy_s=0.07, kernel_s=0.02,
                      kernels=4080, copy_s=0.05, device_ops=[], gaps=[])
    # 4 warm-up calls, 100 in the window, the profiler's 1 + 12
    calls = 4 + 100 + 1 + 12
    counter.inc(ENGINE_HOST_SYNCS, calls, labels={"site": "host-lanes"})
    counter.inc(ENGINE_HOST_SYNCS, calls, labels={"site": "replay-upload"})
    counter.inc(ENGINE_HOST_SYNCS, 50, labels={"site": "probe"})
    ctx = {"window": _window(100), "step_bytes": [1, 2, 3, 4], "trace": r}
    assert host_syncs_per_chunk.read(ctx) == pytest.approx(2.0)
    ctx.pop("trace")
    assert host_syncs_per_chunk.read(ctx) == pytest.approx(
        2 * calls / 104)


def test_host_syncs_per_chunk_reads_none_where_nothing_counts(counter):
    from cilium_tpu_torch.runtime.metrics import ENGINE_HOST_SYNCS

    ctx = {"window": _window(10), "step_bytes": [1]}
    assert host_syncs_per_chunk.read(ctx) is None     # a program without
    counter.inc(ENGINE_HOST_SYNCS, 5, labels={"site": "probe"})
    assert host_syncs_per_chunk.read(ctx) is None     # ... the replay's
    assert host_syncs_per_chunk.read({"window": _window(10)}) is None
    assert registry.metric_reader("host_syncs_per_chunk")({}) is None
