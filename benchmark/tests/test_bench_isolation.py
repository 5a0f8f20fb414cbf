"""What the benchmark's processes load, compared by whole top-level
module names, and what it does without a card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

LOADED = "import sys, json; print(json.dumps(sorted({m.split('.')[0] " \
         "for m in sys.modules})))"


def top_level_modules(code: str, cwd: str = ROOT) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\n" + LOADED],
                         cwd=cwd, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    names = top_level_modules(
        "import benchmark.run, benchmark.system, benchmark.trace, "
        "benchmark.control, benchmark.registry\n"
        "from benchmark import system\n"
        "import cilium_tpu_torch.engine.replay, "
        "cilium_tpu_torch.runtime.loader")
    assert "cilium_tpu_torch" in names          # the program is loaded
    assert not names & {"jax", "jaxlib", "flax", "cilium_tpu"}


def test_a_small_run_loads_neither_jax_nor_the_jax_package():
    """A whole small run on the CPU, through the program."""
    names = top_level_modules(
        "from benchmark import registry, run\n"
        "from benchmark.tests import small\n"
        "bench = registry.load_benchmark()\n"
        "cell = registry.workload(bench, 'http-1k.replay-unique')\n"
        "res = run.run_cell(bench, cell, 3, 0.2, False, device='cpu', "
        "config=small.config('http-1k'), "
        "traffic_params=small.traffic(4096, 1024))\n"
        "assert res['correct']")
    assert "cilium_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "cilium_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = top_level_modules(
        "from benchmark import reference, control, check, traffic, "
        "deployment\n"
        "from benchmark.tests import small\n"
        "cfg = small.config('http-1k')\n"
        "r, ok = control.control_readings(cfg, small.traffic(), 1)\n"
        "assert not ok")
    assert not names & {"cilium_tpu_torch", "cilium_tpu", "jax", "torch"}


def test_without_a_card_the_harness_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "http-1k.replay-unique", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_the_harness_alone_fails_and_prints_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    files: the program is missing, so the run fails."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "-c",
         "from benchmark import registry, run\n"
         "from benchmark.tests import small\n"
         "bench = registry.load_benchmark()\n"
         "cell = registry.workload(bench, 'http-1k.replay-unique')\n"
         "res = run.run_cell(bench, cell, 3, 0.2, False, device='cpu', "
         "config=small.config('http-1k'), "
         "traffic_params=small.traffic(4096, 1024))\n"
         "print('result', res['correct'])"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "result" not in out.stdout
    assert "cilium_tpu_torch" in out.stderr


@pytest.mark.parametrize("name", ["jax", "cilium_tpu", "jax.numpy",
                                  "cilium_tpu.engine"])
def test_forbidden_names_are_whole_top_level_names(name, monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, name, sys)
    assert name.split(".")[0] in run.forbidden_modules()


def test_the_port_is_not_a_forbidden_name():
    """``cilium_tpu_torch`` begins with ``cilium_tpu`` and is allowed."""
    from benchmark import run

    import cilium_tpu_torch  # noqa: F401
    assert "cilium_tpu_torch" not in run.forbidden_modules()
    assert run.forbidden_modules() == []
