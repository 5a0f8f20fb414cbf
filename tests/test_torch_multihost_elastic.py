"""Multi-process elasticity of the port (the counterpart of the
reference's ``tests/test_multihost_elastic.py``, which runs here
because ``gloo`` runs on the CPU).

Two OS processes form a ``torch.distributed`` world through
``parallel.multihost.init_multihost`` (a ``FileStore`` in a temporary
directory), run a cross-process collective (a ledger-routed ``psum``
over the global mesh), stage the same content-hashed policy through a
``Loader`` on a SHARED artifact cache and verdict their slice of the
flows (``process_span``). One process is then killed (``os._exit``, no
clean shutdown) and the world re-forms: both processes re-stage the
IDENTICAL cached artifacts (no recompile — mtimes unchanged) and give
the same verdicts. Every launch has its own time limit; a process that
overruns it is killed and the test fails.

This file is also the worker: ``python tests/test_torch_multihost_elastic.py
<store> <world> <rank> <cache> <out> crash|clean``. As a worker it
imports only ``torch`` and ``cilium_tpu_torch``.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_TIMEOUT_S = 120


def worker(store, world, rank, cache_dir, out_path, crash) -> None:
    import torch
    import torch.distributed as dist

    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.ingest import synth
    from cilium_tpu_torch.parallel import collectives
    from cilium_tpu_torch.parallel.multihost import (
        global_mesh,
        init_multihost,
        process_span,
    )
    from cilium_tpu_torch.runtime.loader import Loader

    torch.set_num_threads(1)
    assert init_multihost(f"file://{store}", world, rank, backend="gloo",
                          timeout_s=STEP_TIMEOUT_S)
    assert dist.get_world_size() == world
    # 1. the world is real: a psum across processes (each adds rank + 1)
    mesh = global_mesh(device="cpu")
    total = collectives.psum(torch.tensor([float(rank + 1)]), mesh, "data",
                             site="elastic.psum")
    # 2. identical compile from the shared rule source
    scenario = synth.synth_http_scenario(n_rules=32, n_flows=64)
    per_identity, scenario = synth.realize_scenario(scenario)
    cfg = Config()
    cfg.loader.cache_dir = cache_dir
    engine = Loader(cfg, device="cpu").regenerate(per_identity, revision=1)
    # both processes have staged (and, in a cold round, written) before
    # either reads the cache
    dist.barrier()
    artifacts = sorted(a for a in os.listdir(cache_dir) if a.endswith(".pkl"))
    mtimes = {a: os.stat(os.path.join(cache_dir, a)).st_mtime_ns
              for a in artifacts}
    # 3. verdict MY slice of the stream
    idx, count = process_span()
    verdicts = [int(v) for v in
                engine.verdict_flows(scenario.flows[idx::count])["verdict"]]
    with open(out_path, "w") as fp:
        json.dump({"rank": rank, "psum": float(total[0]),
                   "artifacts": artifacts, "mtimes": mtimes,
                   "slice": [idx, count], "verdicts": verdicts}, fp)
    # a second collective: no process leaves before every one is done
    dist.barrier()
    # both exits skip the process group's shutdown: the crash case dies
    # like a killed agent, and the clean one must not wait on a peer
    # that already died dirty
    os._exit(1 if crash else 0)


def _round(tmp_path, tag, crash_rank=None):
    """One world of 2 processes → their results (each step limited)."""
    store = str(tmp_path / f"{tag}-store")
    cache = str(tmp_path / "artifact-cache")
    outs = [str(tmp_path / f"{tag}-r{i}.json") for i in range(2)]
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), store, "2", str(i),
         cache, outs[i], "crash" if i == crash_rank else "clean"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(2)]
    results = []
    try:
        for i, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=STEP_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"round {tag}: process {i} overran "
                                     f"{STEP_TIMEOUT_S} s")
            want = 1 if i == crash_rank else 0
            assert p.returncode == want, (
                f"round {tag}: process {i} rc={p.returncode} (want {want})\n"
                f"{err.decode()[-2000:]}")
            with open(outs[i]) as fp:
                results.append(json.load(fp))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return results


def test_two_process_world_kill_and_rejoin(tmp_path):
    # round 1: a healthy world; process 1 is killed after staging
    r1 = _round(tmp_path, "r1", crash_rank=1)
    for r in r1:
        assert r["psum"] == 3.0, "the psum must see both processes"
    assert r1[0]["artifacts"] == r1[1]["artifacts"] != []
    assert r1[0]["slice"] == [0, 2] and r1[1]["slice"] == [1, 2]
    # round 2: the world re-forms (the killed process rejoins); the
    # cached artifacts are re-staged, NOT recompiled
    r2 = _round(tmp_path, "r2")
    for r in r2:
        assert r["psum"] == 3.0, "the re-formed world must see both"
    assert r2[0]["artifacts"] == r1[0]["artifacts"]
    assert r2[0]["mtimes"] == r1[0]["mtimes"] == r2[1]["mtimes"], (
        "a restart must reuse the content-hashed artifacts (a recompile "
        "would rewrite them)")
    # same slices → same verdicts as before the kill
    assert r2[0]["verdicts"] == r1[0]["verdicts"]
    assert r2[1]["verdicts"] == r1[1]["verdicts"]
    assert set(r1[0]["verdicts"]) | set(r1[1]["verdicts"]) >= {2, 5}


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           sys.argv[5], sys.argv[6] == "crash")
