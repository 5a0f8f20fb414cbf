"""The port stands alone and never hides the device.

* importing ``cilium_tpu_torch`` and every submodule pulls in no JAX,
  nothing of ``cilium_tpu`` and no ``yaml`` (the machine with the card
  has neither JAX nor pyyaml), and ``chip_smoke.py`` imports none of
  them either;
* its entry points default to ``cuda`` and raise when CUDA is absent —
  they never drop quietly to the CPU;
* the kernel launchers refuse CPU tensors (only the dispatching
  functions route CPU tensors to the plain versions);
* the cluster control services run as processes of their own (the
  kvstore, the apiserver, the operator, the relay): their modules and
  ``main`` functions import nothing of JAX, the JAX package or ``yaml``, and
  importing them starts no CUDA context.
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
_EXPECTED = ("cilium_tpu_torch.clustermesh",
             "cilium_tpu_torch.core.identity_cache",
             "cilium_tpu_torch.identity_kvstore",
             "cilium_tpu_torch.kvstore",
             "cilium_tpu_torch.runtime.dst",
             "cilium_tpu_torch.runtime.tenant",
             "cilium_tpu_torch.engine.longscan",
             "cilium_tpu_torch.engine.megakernel",
             "cilium_tpu_torch.engine.phases",
             "cilium_tpu_torch.fqdn",
             "cilium_tpu_torch.fqdn.cache",
             "cilium_tpu_torch.fqdn.dnsproxy",
             "cilium_tpu_torch.fqdn.namemanager",
             "cilium_tpu_torch.fqdn.server",
             "cilium_tpu_torch.fqdn.wire",
             "cilium_tpu_torch.ipcache",
             "cilium_tpu_torch.loadbalancer",
             "cilium_tpu_torch.loadbalancer.kernel",
             "cilium_tpu_torch.loadbalancer.maglev",
             "cilium_tpu_torch.loadbalancer.service",
             "cilium_tpu_torch.policy.api._yaml",
             "cilium_tpu_torch.policy.api.cnp",
             "cilium_tpu_torch.engine.memo",
             "cilium_tpu_torch.engine.replay",
             "cilium_tpu_torch.ingest.binary",
             "cilium_tpu_torch.ingest.columnar",
             "cilium_tpu_torch.parallel.collectives",
             "cilium_tpu_torch.parallel.cp",
             "cilium_tpu_torch.parallel.mesh",
             "cilium_tpu_torch.parallel.multihost",
             "cilium_tpu_torch.parallel.pipeline",
             "cilium_tpu_torch.parallel.sharding",
             "cilium_tpu_torch.parallel.tp",
             "cilium_tpu_torch.parallel.ulysses",
             "cilium_tpu_torch.tools.parallel_lanes",
             "cilium_tpu_torch.policy.compiler.bankplan",
             "cilium_tpu_torch.policy.compiler.compilequeue",
             "cilium_tpu_torch.policy.oracle",
             "cilium_tpu_torch.proxylib.http",
             "cilium_tpu_torch.proxylib.kafka",
             "cilium_tpu_torch.runtime.canary",
             "cilium_tpu_torch.runtime.checkpoint",
             "cilium_tpu_torch.runtime.fleet",
             "cilium_tpu_torch.runtime.fleetserve",
             "cilium_tpu_torch.runtime.loader",
             "cilium_tpu_torch.runtime.loadmodel",
             "cilium_tpu_torch.runtime.metrics",
             "cilium_tpu_torch.runtime.npds",
             "cilium_tpu_torch.runtime.provenance",
             "cilium_tpu_torch.runtime.service",
             "cilium_tpu_torch.runtime.stream",
             "cilium_tpu_torch.perf_report",
             "cilium_tpu_torch.tools.bench",
             "cilium_tpu_torch.tools.bench_kernel",
             "cilium_tpu_torch.tools.bench_stage",
             "cilium_tpu_torch.tools.bench_service",
             "cilium_tpu_torch.tools.bench_protocols",
             "cilium_tpu_torch.tools.bench_multichip",
             "cilium_tpu_torch.tools.bench_sp",
             "cilium_tpu_torch.tools.churn_lane",
             "cilium_tpu_torch.tools.prov_noise",
             "cilium_tpu_torch.ingest.flowpb",
             "cilium_tpu_torch.ingest.accesslog",
             "cilium_tpu_torch.ingest.cursor",
             "cilium_tpu_torch.ingest.hubble",
             "cilium_tpu_torch.monitor",
             "cilium_tpu_torch.hubble.ring",
             "cilium_tpu_torch.hubble.observer",
             "cilium_tpu_torch.hubble.metrics",
             "cilium_tpu_torch.hubble.exporter",
             "cilium_tpu_torch.hubble.server",
             "cilium_tpu_torch.hubble.accesslog_server",
             "cilium_tpu_torch.runtime.unixsock",
             "cilium_tpu_torch.agent",
             "cilium_tpu_torch.auth",
             "cilium_tpu_torch.cni",
             "cilium_tpu_torch.endpoint",
             "cilium_tpu_torch.health",
             "cilium_tpu_torch.hubble.relay",
             "cilium_tpu_torch.ipam",
             "cilium_tpu_torch.policy.trace",
             "cilium_tpu_torch.proxy_manager",
             "cilium_tpu_torch.runtime.admission",
             "cilium_tpu_torch.runtime.advertise",
             "cilium_tpu_torch.runtime.api",
             "cilium_tpu_torch.runtime.controller",
             "cilium_tpu_torch.runtime.profiling",
             "cilium_tpu_torch.runtime.watcher",
             "cilium_tpu_torch.kvstore_service",
             "cilium_tpu_torch.operator",
             "cilium_tpu_torch.runtime.leader",
             "cilium_tpu_torch.k8s",
             "cilium_tpu_torch.k8s.apiserver",
             "cilium_tpu_torch.k8s.informer",
             "cilium_tpu_torch.k8s.identity_crd",
             "cilium_tpu_torch.k8s.ces",
             "cilium_tpu_torch.k8s.agent_bridge",
             "cilium_tpu_torch.daemon",
             "cilium_tpu_torch.cli",
             "cilium_tpu_torch.bugtool")

#: the observability and ingest plane's modules
_OBSERVE = tuple(m for m in _EXPECTED
                 if m.startswith(("cilium_tpu_torch.ingest.",
                                  "cilium_tpu_torch.hubble.",
                                  "cilium_tpu_torch.monitor",
                                  "cilium_tpu_torch.runtime.unixsock"))
                 and m not in ("cilium_tpu_torch.ingest.binary",
                               "cilium_tpu_torch.ingest.columnar"))

#: the bench plane's modules: their CLIs print to stdout and write a
#: file only where --out names one
_BENCH_TOOLS = ("cilium_tpu_torch.perf_report",
                "cilium_tpu_torch.runtime.canary",
                "cilium_tpu_torch.tools.bench",
                "cilium_tpu_torch.tools.bench_kernel",
                "cilium_tpu_torch.tools.bench_stage",
                "cilium_tpu_torch.tools.bench_service",
                "cilium_tpu_torch.tools.bench_protocols",
                "cilium_tpu_torch.tools.bench_multichip",
                "cilium_tpu_torch.tools.bench_sp",
                "cilium_tpu_torch.tools.churn_lane",
                "cilium_tpu_torch.tools.prov_noise")


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


@pytest.mark.parametrize("module", _BENCH_TOOLS)
def test_bench_tools_import_no_jax_cilium_tpu_or_root_bench(module):
    """No bench tool of the port imports JAX, the JAX package or one of
    the root ``bench*.py`` modules (at any depth of the file)."""
    import importlib

    path = importlib.import_module(module).__file__
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "cilium_tpu", "yaml"}, roots
    assert not {r for r in roots if r.startswith("bench")}, roots


@pytest.mark.parametrize("module", _OBSERVE)
def test_observability_modules_import_no_jax_or_cilium_tpu(module):
    """The observability plane's modules import nothing of JAX, the JAX
    package or ``yaml`` at any depth of the file (their lazy imports
    included)."""
    import importlib

    roots = _imported_roots(importlib.import_module(module).__file__)
    assert not roots & {"jax", "jaxlib", "cilium_tpu", "yaml"}, roots


def _out_defaults(module):
    """The defaults of every ``--out``-like option of a tool's parser,
    read from its ``add_argument`` calls."""
    import ast
    import importlib

    with open(importlib.import_module(module).__file__) as f:
        tree = ast.parse(f.read())
    found = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            continue
        flags = [a.value for a in node.args
                 if isinstance(a, ast.Constant)]
        if not any(str(f) in ("--out", "--capture") for f in flags):
            continue
        for kw in node.keywords:
            if kw.arg == "default":
                found.append(ast.literal_eval(kw.value))
    return found


@pytest.mark.parametrize("module", _BENCH_TOOLS)
def test_bench_tools_write_no_repo_file_by_default(module):
    """No tool's ``--out`` default names a file, let alone one in the
    repo: the reference's defaults name committed artifacts
    (``BENCH_CANARY_r09.jsonl``, ``PERF_TRAJECTORY.json``)."""
    for default in _out_defaults(module):
        assert not (default and os.path.exists(
            os.path.join(REPO, default))), (module, default)
        assert not default, (module, default)


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


def test_parallel_entry_points_raise_when_cuda_is_absent(monkeypatch,
                                                         tmp_path):
    """The parallel layer's entry points default to ``cuda`` like the
    engine's: without CUDA a mesh, the staged lanes, `run_lane`
    and the pipeline raise unless the caller names the CPU; a gloo mesh of CUDA ranks
    stages payloads through host memory, a CPU one never does."""
    import datetime

    import torch.distributed as dist

    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.parallel import collectives, mesh, pipeline
    from cilium_tpu_torch.parallel.sharding import stage_for_lane
    from cilium_tpu_torch.tools.parallel_lanes import mesh_probe, run_lane

    with pytest.raises(RuntimeError, match="initialised"):
        mesh.make_mesh((1,), ("data",), device="cpu")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.run_pipelined(lambda a, b: b, {}, [{}])
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh((1,), ("data",))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stage_for_lane(Config(), {}, {})
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_lane("dp", {})
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_probe((1,), ("data",))
        cpu = mesh.make_mesh((1,), ("data",), device="cpu")
        assert cpu.backend == "gloo" and not collectives._staged(cpu)
        cuda = mesh.Mesh(cpu.devices, ("data",), {}, 0, "gloo",
                         torch.device("cuda"))
        assert collectives._staged(cuda)
    finally:
        dist.destroy_process_group()


def test_dst_entry_points_raise_when_cuda_is_absent(monkeypatch, tmp_path):
    """``DSTWorld`` and ``run_schedule`` (and so ``search`` and
    ``main``) default to ``cuda`` like the engine: without CUDA they
    raise unless the caller names the CPU, and ``run_schedule`` raises
    before it makes its artifact-cache directory."""
    import tempfile

    from cilium_tpu_torch.runtime import dst

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dst.DSTWorld(str(tmp_path))
    made = []
    monkeypatch.setattr(tempfile, "mkdtemp",
                        lambda *a, **k: made.append(1) or str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dst.run_schedule(0, events=[["traffic"]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dst.search(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dst.main(["--replay", "--seed", "0"])
    assert made == []


#: the agent plane's modules (the node-local agent and its services)
_AGENT = tuple(m for m in _EXPECTED if m in (
    "cilium_tpu_torch.agent", "cilium_tpu_torch.auth",
    "cilium_tpu_torch.cni", "cilium_tpu_torch.endpoint",
    "cilium_tpu_torch.health", "cilium_tpu_torch.hubble.relay",
    "cilium_tpu_torch.ipam", "cilium_tpu_torch.policy.trace",
    "cilium_tpu_torch.proxy_manager", "cilium_tpu_torch.runtime.advertise",
    "cilium_tpu_torch.runtime.api", "cilium_tpu_torch.runtime.controller",
    "cilium_tpu_torch.runtime.profiling",
    "cilium_tpu_torch.runtime.watcher", "cilium_tpu_torch.daemon",
    "cilium_tpu_torch.cli", "cilium_tpu_torch.bugtool"))


@pytest.mark.parametrize("module", _AGENT)
def test_agent_modules_import_no_jax_or_cilium_tpu(module):
    """The agent plane's modules import nothing of JAX, the JAX package
    or ``yaml`` at any depth of the file (their lazy imports
    included)."""
    import importlib

    roots = _imported_roots(importlib.import_module(module).__file__)
    assert not roots & {"jax", "jaxlib", "cilium_tpu", "yaml"}, roots


def test_agent_entry_points_raise_when_cuda_is_absent(monkeypatch,
                                                      tmp_path):
    """``Agent()``, its ``Loader`` and ``DNSProxy`` default to ``cuda``
    and raise without it unless the caller names the CPU; the
    profiler's device mode raises rather than trace the CPU."""
    from cilium_tpu_torch.agent import Agent
    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.fqdn import DNSProxy
    from cilium_tpu_torch.runtime.loader import Loader
    from cilium_tpu_torch.runtime.profiling import Profiler

    _no_cuda(monkeypatch)
    cfg = Config()
    cfg.configure_logging = False
    cfg.loader.cache_dir = str(tmp_path)
    for make in (lambda: Agent(cfg), lambda: Loader(cfg),
                 lambda: DNSProxy()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="needs CUDA"):
        Profiler().capture(str(tmp_path), seconds=0.1, mode="device")
    agent = Agent(cfg, device="cpu")
    try:
        assert {agent.loader.device.type, agent.dns_proxy.device.type} == \
            {"cpu"}
    finally:
        agent.stop()


#: the cluster control services' modules (the served kvstore, the k8s
#: layer, the operator with leader election, the relay)
_CLUSTER = tuple(m for m in _EXPECTED if m.startswith((
    "cilium_tpu_torch.kvstore_service", "cilium_tpu_torch.operator",
    "cilium_tpu_torch.runtime.leader", "cilium_tpu_torch.k8s",
    "cilium_tpu_torch.hubble.relay")))

#: the control plane's processes, each started by its module's ``main``
_MAINS = ("cilium_tpu_torch.kvstore_service",
          "cilium_tpu_torch.k8s.apiserver",
          "cilium_tpu_torch.operator",
          "cilium_tpu_torch.hubble.relay")


@pytest.mark.parametrize("module", _CLUSTER)
def test_cluster_modules_import_no_jax_or_cilium_tpu(module):
    """The cluster control services import nothing of JAX, the JAX
    package or ``yaml`` at any depth of the file (their lazy imports,
    the ``main`` functions' included)."""
    import importlib

    roots = _imported_roots(importlib.import_module(module).__file__)
    assert not roots & {"jax", "jaxlib", "cilium_tpu", "yaml"}, roots


@pytest.mark.parametrize("module", _MAINS)
def test_control_plane_mains_start_no_jax_and_no_cuda(module):
    """``python -m <module> --help`` exits 0; the module's import, with
    everything its ``main`` imports, loads no JAX, nothing of the JAX
    package and no ``yaml``, and initialises no CUDA context (the
    control plane shares the card's host and must never hold it)."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m", module, "--help"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and "usage" in r.stdout, r.stderr[-2000:]
    code = (
        "import importlib, sys, torch\n"
        f"importlib.import_module({module!r})\n"
        "import cilium_tpu_torch.kvstore_service, "
        "cilium_tpu_torch.runtime.logging\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'yaml', 'cilium_tpu.')) or "
        "m == 'cilium_tpu')\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("module", ["cilium_tpu_torch.daemon",
                                    "cilium_tpu_torch.cli"])
def test_daemon_and_cli_mains_help_and_import_no_cuda(module):
    """``python -m <module> --help`` exits 0; importing the daemon or
    the CLI, with the service client the CLI uses, loads no JAX, nothing
    of the JAX package and no ``yaml``, and initialises no CUDA context
    (a CLI process beside the daemon never holds the card)."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m", module, "--help"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and "usage" in r.stdout, r.stderr[-2000:]
    code = (
        "import importlib, sys, torch\n"
        f"importlib.import_module({module!r})\n"
        "import cilium_tpu_torch.runtime.service, "
        "cilium_tpu_torch.runtime.api, cilium_tpu_torch.monitor\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'yaml', 'cilium_tpu.')) or "
        "m == 'cilium_tpu')\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
