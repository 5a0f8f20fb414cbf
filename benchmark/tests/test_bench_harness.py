"""The harness's own checks: files found by name, names and units
refused, the window's arithmetic, the trace's reduction, and a small
run on the CPU that comes out correct, and not correct with the timed
path broken underneath."""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

from benchmark import registry, run, trace, window
from benchmark.tests import small


# -- found by name ---------------------------------------------------------
def test_new_files_are_found_by_name_without_edits(tmp_path, monkeypatch):
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    pkg = tmp_path / "extra_bench"
    (pkg / "metrics").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "metrics" / "__init__.py").write_text("")
    (pkg / "metrics" / "new_metric_ms.py").write_text(
        "def read(ctx):\n    return ctx['x'] * 2\n")
    (tmp_path / "configs" / "new-cfg.json").write_text("{}")
    (tmp_path / "traffic" / "new-mix.json").write_text("{}")
    bench = {"configs": [{"name": "new-cfg",
                          "file": "configs/new-cfg.json"}]}
    assert registry.config_path(bench, "new-cfg", root=str(tmp_path)) \
        == str(tmp_path / "configs" / "new-cfg.json")
    assert registry.traffic_path("new-mix", here=str(tmp_path)) \
        == str(tmp_path / "traffic" / "new-mix.json")
    monkeypatch.syspath_prepend(str(tmp_path))
    read = registry.metric_reader("new_metric.ms",
                                  package="extra_bench.metrics")
    assert read({"x": 21}) == 42


def test_a_new_generator_is_found_by_the_name_its_mix_gives(tmp_path,
                                                           monkeypatch):
    from benchmark import traffic

    pkg = tmp_path / "extra_traffic"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "new_draw.py").write_text(
        "def generate(dep, mix, rng):\n"
        "    return (mix['records'], int(rng.integers(0, 1 << 30)))\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    mix = {"generator": "new-draw", "records": 8}
    a = traffic.generate(None, mix, 5, package="extra_traffic")
    assert a == traffic.generate(None, mix, 5, package="extra_traffic")
    assert a[0] == 8
    with pytest.raises(registry.BenchmarkError):
        traffic.generate(None, dict(mix, generator="none-such"), 5,
                         package="extra_traffic")
    with pytest.raises(registry.BenchmarkError):
        traffic.generate(None, dict(mix, generator="a b"), 5,
                         package="extra_traffic")


def test_every_metric_of_the_benchmark_has_a_reader():
    bench = registry.load_benchmark()
    for m in bench["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))
    for w in bench["workloads"]:
        assert os.path.exists(registry.config_path(bench, w["config"]))
        assert os.path.exists(registry.traffic_path(w["traffic"]))


@pytest.mark.parametrize("name", ["", "a b", "a,b", "a/b", ".x", "x" * 65,
                                  "µs", None, 3])
def test_invalid_names_are_refused(name):
    with pytest.raises(registry.BenchmarkError):
        registry.check_name(name)


@pytest.mark.parametrize("name", ["http-1k", "mesh-10k.replay-unique",
                                  "_a.b-c", "x" * 64])
def test_valid_names_pass(name):
    assert registry.check_name(name) == name


@pytest.mark.parametrize("unit", ["", "tokens per second", "µs", "a" * 17,
                                  "ms,s"])
def test_invalid_units_are_refused(unit):
    with pytest.raises(registry.BenchmarkError):
        registry.check_unit(unit)


@pytest.mark.parametrize("unit", ["verdicts/s", "%", "ms", "kernels",
                                  "s", "B/s", "k.v-1"])
def test_valid_units_pass(unit):
    assert registry.check_unit(unit) == unit


def test_a_bad_name_in_benchmark_json_is_refused(tmp_path):
    bench = json.load(open(os.path.join(registry.ROOT, "BENCHMARK.json")))
    bench["per_layer"][0]["unit"] = "per cent"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(registry.BenchmarkError):
        registry.load_benchmark(str(tmp_path))


# -- the window's arithmetic ----------------------------------------------
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def fake_entry(clock, stall_every, stall_s, normal_s=0.010):
    calls = {"n": 0}

    def entry(start, n):
        calls["n"] += 1
        clock.t += stall_s if calls["n"] % stall_every == 0 else normal_s
        return {"verdict": np.ones(n, dtype=np.int32)}
    return entry


def test_rate_is_all_records_over_all_the_time_and_p95_sees_a_stall():
    """One call in ten stalls for 0.5 s. A median of chunks, or a median
    of sub-windows, would hide it; these must not."""
    clock = FakeClock()
    entry = fake_entry(clock, stall_every=10, stall_s=0.5)
    twins = {0: {"verdict": np.ones(100, dtype=np.int32)}}
    win = window.run_window(entry, [0], 100, 10.0, twins, clock=clock)
    n = win.chunks
    stalls = n // 10
    assert win.seconds == pytest.approx(stalls * 0.5 + (n - stalls) * 0.010)
    assert win.verdicts_per_s() == pytest.approx(n * 100 / win.seconds)
    # the median chunk is 10 ms: a rate from it would be 10000/s
    assert win.verdicts_per_s() < 0.2 * (100 / 0.010)
    assert win.p95_ms() == pytest.approx(500.0)
    assert win.median_ms() == pytest.approx(10.0)


def test_the_call_that_crosses_the_end_counts():
    clock = FakeClock()
    entry = fake_entry(clock, stall_every=10 ** 9, stall_s=0, normal_s=0.3)
    twins = {0: {"verdict": np.ones(10, dtype=np.int32)},
             10: {"verdict": np.ones(10, dtype=np.int32)}}
    win = window.run_window(entry, [0, 10], 10, 1.0, twins, clock=clock)
    assert win.chunks == 4 and win.seconds == pytest.approx(1.2)
    assert [k[0] for k in win.kept] == [0, 10, 0, 10]


def test_percentile_is_nearest_rank():
    assert window.percentile(list(range(1, 101)), 95) == 95
    assert window.percentile([1.0], 95) == 1.0
    assert window.percentile([3, 1, 2, 4], 50) == 2


def test_a_chunk_unlike_its_twin_is_copied_and_judged_on_its_own():
    from benchmark import check

    twin = {"verdict": np.array([1, 2, 5], dtype=np.int32)}
    outs = iter([{"verdict": np.array([1, 2, 5], dtype=np.int32)},
                 {"verdict": np.array([1, 2, 2], dtype=np.int32)}])
    clock = FakeClock()

    def entry(start, n):
        clock.t += 1.0
        return next(outs)
    win = window.run_window(entry, [0], 3, 2.0, {0: twin}, clock=clock)
    assert win.kept[0][2] is twin and win.kept[1][2] is not twin
    got = check.compare(win.kept, {"verdict": np.array([1, 2, 5])})
    assert got["mismatched_records"] == 1 and got["missing_records"] == 0


# -- the trace's reduction ------------------------------------------------
def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_reduction_union_and_labels():
    ev = [
        _x(trace.CHUNK_RANGE, "user_annotation", 0, 100),
        _x("cudaMemcpyAsync", "cuda_runtime", 1, 9),
        _x("Memcpy HtoD", "gpu_memcpy", 5, 10),
        _x("k1", "kernel", 20, 10), _x("k2", "kernel", 25, 10),
        _x("k1", "kernel", 50, 5),
        _x("cudaMemcpyAsync", "cuda_runtime", 60, 30),
        _x("Memcpy DtoH", "gpu_memcpy", 61, 9),
        _x(trace.CHUNK_RANGE, "user_annotation", 120, 30),
        _x("k1", "kernel", 130, 10),
        _x(trace.CHUNK_RANGE, "gpu_user_annotation", 0, 150),
    ]
    r = trace.reduce(ev)
    assert r.chunks == 2 and r.window_s == pytest.approx(150e-6)
    # busy: [5,15] [20,35] [50,55] [61,70] [130,140]
    assert r.busy_s == pytest.approx((10 + 15 + 5 + 9 + 10) * 1e-6)
    assert r.kernels == 4
    assert r.kernel_s == pytest.approx(35e-6)
    assert r.copy_s == pytest.approx(19e-6)
    assert r.device_ops[0] == ("k1", pytest.approx(25e-6))
    gaps = sorted((lab, round(s * 1e6)) for lab, s in r.gaps)
    assert gaps == sorted([
        ("upload", 5),             # [0, 5]: until the first copy returns
        ("step", 5), ("step", 15), ("step", 5),   # [15,20] [35,50] [55,60]
        ("readback", 1),           # [60, 61]: from the last copy call
        ("readback", 30),          # [70, 100]
        ("between chunks", 20),    # [100, 120]
        ("step", 10), ("step", 10),   # chunk 2 made no copy call
    ])
    assert r.gaps[0] == ("readback", pytest.approx(30e-6))
    assert sum(s for _, s in r.gaps) == pytest.approx(r.window_s - r.busy_s)


def test_trace_without_device_events_reads_nothing():
    assert trace.reduce([_x(trace.CHUNK_RANGE, "user_annotation", 0, 1)]) \
        is None
    assert trace.reduce([_x("k", "kernel", 0, 1)]) is None


def test_readers_find_nothing_without_a_trace():
    bench = registry.load_benchmark()
    for m in bench["per_layer"] + bench["end_to_end"]:
        if m["name"] != "setup_s":
            assert registry.metric_reader(m["name"])({"spans": {}}) is None


def test_the_kernel_time_a_million_verdicts_reads_every_traced_chunk():
    read = registry.metric_reader("kernel_ms_per_mverdict")
    r = trace.Reading(chunks=12, window_s=0.2, busy_s=0.07, kernel_s=0.024,
                      kernels=4080, copy_s=0.05, device_ops=[], gaps=[])
    # 24 ms of kernels over 12 chunks of 250000 records: 3 M verdicts
    assert read({"trace": r, "chunk": 250000}) == pytest.approx(8.0)
    assert read({"trace": r}) is None


def test_the_host_metrics_read_the_whole_window():
    w = window.Window(seconds=2.0, records=4000,
                      latencies=[0.001 * i for i in range(1, 101)], kept=[])
    assert registry.metric_reader("host_verdicts_per_s")(
        {"window": w}) == pytest.approx(2000.0)
    assert registry.metric_reader("host_chunk_p95_ms")(
        {"window": w}) == pytest.approx(95.0)


# -- a small run on the CPU, sound and broken ------------------------------
def small_run(cell, wrap=None, seconds=0.3):
    bench = registry.load_benchmark()
    c = registry.workload(bench, cell)
    return run.run_cell(bench, c, 2 ** 31 + 17, seconds, False,
                        device="cpu", config=small.config(c["config"]),
                        traffic_params=small.traffic(), wrap=wrap)


@pytest.mark.parametrize("cell", ["http-1k.replay-unique"])
def test_a_small_run_is_correct(cell):
    res = small_run(cell)
    assert res["correct"] and res["failed"] == 0
    assert res["readings"]["records_compared"] == res["attempted"]
    line = run.result_line(registry.load_benchmark(),
                           {"name": cell}, res)
    assert list(line)[-1] == "checks"
    # no device trace on the CPU: the set-up time alone is reported
    assert set(line["metrics"]) == {"setup_s"}


def altered(entry):
    """An answer altered where it is produced: one verdict a chunk."""
    def call(start, n):
        out = entry(start, n)
        v = out["verdict"].copy()
        v[n // 2] = 1 if v[n // 2] != 1 else 2
        return dict(out, verdict=v)
    return call


def half_left_out(entry):
    """Half of the chunk left out."""
    def call(start, n):
        return {k: v[:n // 2] for k, v in entry(start, n).items()}
    return call


def once_in_the_window(entry):
    """The warm-up's answers right, one window chunk altered."""
    calls = {"n": 0}

    def call(start, n):
        calls["n"] += 1
        out = entry(start, n)
        if calls["n"] == 7:
            out = dict(out, verdict=np.where(out["verdict"] == 2, 5, 2)
                       .astype(out["verdict"].dtype))
        return out
    return call


@pytest.mark.parametrize("fault", [altered, half_left_out,
                                   once_in_the_window])
@pytest.mark.parametrize("cell", ["http-1k.replay-unique"])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    res = small_run(cell, wrap=fault, seconds=0.5)
    assert not res["correct"] and res["failed"] > 0


def test_main_refuses_an_unknown_workload():
    with pytest.raises(registry.BenchmarkError):
        run.main(["--workload", "nope.none", "--seed", "1", "--seconds",
                  "1"])
