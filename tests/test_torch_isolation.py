"""The port stands alone and never hides the device.

* importing ``cilium_tpu_torch`` and every submodule pulls in no JAX,
  nothing of ``cilium_tpu`` and no ``yaml`` (the machine with the card
  has neither JAX nor pyyaml), and ``chip_smoke.py`` imports none of
  them either;
* its entry points default to ``cuda`` and raise when CUDA is absent —
  they never drop quietly to the CPU;
* the kernel launchers refuse CPU tensors (only the dispatching
  functions route CPU tensors to the plain versions).
"""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import cilium_tpu_torch
from cilium_tpu_torch.core.config import EngineConfig
from cilium_tpu_torch.engine import (
    dfa_dense_cuda,
    dfa_oblivious_cuda,
    nfa_cuda,
)
from cilium_tpu_torch.engine.compiled import CompiledPolicy
from cilium_tpu_torch.engine.verdict import TorchVerdictEngine
from cilium_tpu_torch.ingest import synth
from cilium_tpu_torch.weights import arrays_from_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        cilium_tpu_torch.__path__, "cilium_tpu_torch."))


#: modules every slice so far added, which the walk must find
_EXPECTED = ("cilium_tpu_torch.engine.megakernel",
             "cilium_tpu_torch.engine.memo",
             "cilium_tpu_torch.engine.replay",
             "cilium_tpu_torch.ingest.binary",
             "cilium_tpu_torch.ingest.columnar",
             "cilium_tpu_torch.runtime.metrics")


def test_every_module_imports_without_jax_cilium_tpu_or_yaml():
    mods = _all_modules()
    assert set(_EXPECTED) <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'yaml', 'cilium_tpu.')) or "
        "m == 'cilium_tpu')\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def _imported_roots(path):
    """Top-level package of every import statement in a file, those
    inside functions included."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_no_jax_cilium_tpu_or_yaml():
    roots = _imported_roots(os.path.join(REPO, "chip_smoke.py"))
    assert "cilium_tpu_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "cilium_tpu", "yaml"}, roots


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_without_device_raises_when_cuda_is_absent(monkeypatch):
    _no_cuda(monkeypatch)
    pi, _ = synth.realize_scenario(synth.scenario_by_name("http", 5, 1))
    pol = CompiledPolicy.build(pi, EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchVerdictEngine(pol)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        arrays_from_reference(pol.arrays)
    # an explicit CPU device is the only way onto the plain versions
    assert TorchVerdictEngine(pol, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("launcher", ["KD", "K1", "K2"])
def test_kernel_launchers_refuse_cpu_tensors(launcher):
    z32 = torch.zeros(1, dtype=torch.int32)
    data = torch.zeros((1, 4), dtype=torch.uint8)
    bc = torch.zeros((1, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if launcher == "KD":
            dfa_dense_cuda.dense_scan_cuda(
                torch.zeros((1, 2, 1), dtype=torch.int32), bc, z32, data,
                z32)
        elif launcher == "K1":
            nfa_cuda.nfa_finals_cuda(
                torch.zeros((1, 1, 1)), torch.zeros((1, 1, 1)), bc,
                torch.zeros((1, 1)), data, z32)
        else:
            dfa_oblivious_cuda.dfa_finals_oblivious_cuda(
                torch.zeros((1, 2, 1), dtype=torch.int32), bc, z32, data,
                z32)


def test_dispatch_routes_cpu_tensors_to_the_plain_versions():
    """No launch happens for CPU tensors: the counts stay at zero."""
    from cilium_tpu_torch.engine import _build

    _build.reset_launches()
    rng = np.random.default_rng(0)
    trans = torch.from_numpy(rng.integers(0, 3, (1, 3, 2)).astype(np.int32))
    bc = torch.zeros((1, 256), dtype=torch.int32)
    start = torch.zeros(1, dtype=torch.int32)
    data = torch.from_numpy(rng.integers(0, 256, (5, 4)).astype(np.uint8))
    lens = torch.full((5,), 4, dtype=torch.int32)
    a = dfa_dense_cuda.dense_scan(trans, bc, start, data, lens)
    b = dfa_oblivious_cuda.dfa_finals_oblivious(trans, bc, start, data, lens)
    assert torch.equal(a, b)
    assert all(k.launches == 0 for k in _build.KERNELS.values())
