"""The port's parallel layer against the JAX package's, on the CPU.

The reference runs on the conftest's 8-device virtual mesh at n
devices; the port runs the same lane on n spawned ``gloo`` ranks
(``parallel.mesh.LocalWorld``, one world of 2 and one of 4 for the
module), each rank given the same numpy arrays and running
``tools/parallel_lanes.run_lane`` (which imports only ``torch`` and
``cilium_tpu_torch``). Integer outputs: tolerance 0.

* ``Config.parallel`` and its two environment knobs;
* a 2×2 ``("data", "expert")`` mesh's coordinates and subgroups in a
  4-rank world, against the reference's device grid;
* ``mesh_from_root_config``, ``global_mesh`` and
  ``data_parallel_mesh`` in a one-rank world;
* ``init_multihost`` without a world, and ``process_span`` on every
  rank;
* the DP step (``stage_for_lane`` ``dp``/``auto`` and the DP step over
  a data × expert mesh with the banks expert-sharded) on all ten lanes,
  against the reference's sharded ``verdict_step``;
* ``run_pipelined`` against the sequential loop and the reference's;
* ``stage_for_lane`` for every lane against the reference's, and
  ``"warp"`` raising in both.

The policy and batch are ``__graft_entry__._small_policy_and_batch(
n_rules=64, n_flows=56, bank_size=8, n_generic=8)``, as
``tests/test_multichip.py`` builds them.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from cilium_tpu_torch.core.config import Config as PortConfig  # noqa: E402
from cilium_tpu_torch.engine.verdict import (  # noqa: E402
    OUTPUT_LANES,
    batch_to_device,
    verdict_step as port_verdict_step,
)
from cilium_tpu_torch.parallel import multihost as port_multihost  # noqa: E402
from cilium_tpu_torch.parallel.mesh import LocalWorld  # noqa: E402
from cilium_tpu_torch.tools.parallel_lanes import (  # noqa: E402
    mesh_probe,
    run_lane,
)
from cilium_tpu_torch.weights import arrays_from_reference  # noqa: E402

NS = (2, 4)
#: the CP lanes' inner block: it divides every sharded field's columns
#: per rank at n = 2 and 4 (16 and 8 of the 32-byte buckets), where the
#: reference's CP is exact; ``test_cp_lane_with_a_block_that_does_not_
#: divide_the_shard`` holds the case where it is not
CP_BLOCK = 8


@pytest.fixture(scope="module")
def worlds():
    """One world of 2 gloo ranks and one of 4 for the module."""
    ws = {n: LocalWorld(n, timeout_s=300.0) for n in NS}
    yield ws
    for w in ws.values():
        w.close()


@pytest.fixture(scope="module")
def small():
    import __graft_entry__ as ge

    policy, batch, _, _ = ge._small_policy_and_batch(
        n_rules=64, n_flows=56, bank_size=8, n_generic=8)
    return policy.arrays, batch


_REF_CACHE = {}


def _ref_lane(lane, n, arrays, batch):
    """The reference's ``stage_for_lane`` on n virtual devices → numpy
    lanes (once per lane and n)."""
    from cilium_tpu.core.config import Config
    from cilium_tpu.parallel.sharding import stage_for_lane

    key = (lane, n)
    if key not in _REF_CACHE:
        cfg = Config()
        cfg.parallel.lane = lane
        cfg.parallel.cp_block = CP_BLOCK
        step, a, b = stage_for_lane(cfg, arrays, batch,
                                    devices=jax.devices()[:n])
        _REF_CACHE[key] = {k: np.asarray(v) for k, v in step(a, b).items()}
    return _REF_CACHE[key]


def _ref_single(arrays, batch):
    from cilium_tpu.engine.verdict import verdict_step

    out = jax.jit(verdict_step)({k: jnp.asarray(v) for k, v in arrays.items()},
                                {k: jnp.asarray(v) for k, v in batch.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_lanes(got, want, what):
    assert set(got) == set(OUTPUT_LANES) == set(want), what
    for lane in OUTPUT_LANES:
        a, b = np.asarray(want[lane]), np.asarray(got[lane])
        assert (a.shape, a.dtype) == (b.shape, b.dtype), (what, lane)
        np.testing.assert_array_equal(b, a, f"{what}: lane {lane!r}")


def test_parallel_lane_env_knobs():
    from cilium_tpu.core.config import Config

    env = {"CILIUM_TPU_PARALLEL_LANE": "cp", "CILIUM_TPU_CP_BLOCK": "128"}
    cfg, ref = PortConfig.from_env(env), Config.from_env(env)
    assert cfg.parallel.lane == ref.parallel.lane == "cp"
    assert cfg.parallel.cp_block == ref.parallel.cp_block == 128
    # unknown lane values are ignored, not crashed on
    env = {"CILIUM_TPU_PARALLEL_LANE": "warp"}
    assert PortConfig.from_env(env).parallel.lane == \
        Config.from_env(env).parallel.lane == "auto"
    # every field and default equal to the reference's
    import dataclasses

    assert dataclasses.asdict(PortConfig().parallel) == \
        dataclasses.asdict(Config().parallel)


def test_mesh_2x2_coordinates_and_subgroups(worlds):
    from cilium_tpu.parallel.mesh import make_mesh

    ref = make_mesh((2, 2), ("data", "expert"), jax.devices()[:4])
    grid = np.vectorize(lambda d: d.id)(ref.devices)
    views = worlds[4].run(mesh_probe, (2, 2), ("data", "expert"),
                          device="cpu")
    for r, v in enumerate(views):
        assert v["rank"] == r
        assert v["shape"] == dict(ref.shape) == {"data": 2, "expert": 2}
        i, j = (int(c) for c in np.argwhere(grid == r)[0])
        assert v["coords"] == {"data": i, "expert": j}
        assert v["axis_ranks"] == {"data": [int(x) for x in grid[:, j]],
                                   "expert": [int(x) for x in grid[i, :]]}
        # the psum over each subgroup sums exactly its members' ranks
        assert v["psum"] == {"data": float(grid[:, j].sum()),
                             "expert": float(grid[i, :].sum())}


def test_init_multihost_single_process_and_process_span(worlds, monkeypatch):
    from cilium_tpu.parallel.multihost import init_multihost, process_span

    for var in ("WORLD_SIZE", "RANK", "JAX_COORDINATOR_ADDRESS",
                "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert port_multihost.init_multihost() is False is init_multihost()
    assert port_multihost.process_span() == (0, 1) == process_span()
    for n, world in worlds.items():
        assert world.run(port_multihost.process_span) == \
            [(r, n) for r in range(n)]


def test_mesh_from_config_and_global_mesh_in_one_rank(tmp_path):
    """The config-driven meshes on a one-rank gloo world in this
    process, against the reference's on one virtual device: axis names
    and shape from ``ParallelConfig``, a ``mesh_shape`` whose axes
    disagree with the names raising in both."""
    import datetime

    import torch.distributed as dist

    from cilium_tpu.core.config import Config
    from cilium_tpu.parallel.mesh import mesh_from_root_config as ref_mesh
    from cilium_tpu_torch.parallel.mesh import (
        data_parallel_mesh,
        mesh_from_root_config,
    )

    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        for use_ep, shape in ((False, None), (True, (1, 1))):
            cfg, rcfg = PortConfig(), Config()
            for c in (cfg, rcfg):
                c.parallel.use_expert_axis = use_ep
                c.parallel.mesh_shape = shape
            got = mesh_from_root_config(cfg, device="cpu")
            want = ref_mesh(rcfg, jax.devices()[:1])
            assert got.axis_names == tuple(want.axis_names)
            assert got.shape == dict(want.shape)
            assert got.axis_ranks(got.axis_names[0]) == [0]
        cfg.parallel.mesh_shape = rcfg.parallel.mesh_shape = (1,)
        with pytest.raises(ValueError, match="mesh_shape"):
            mesh_from_root_config(cfg, device="cpu")
        with pytest.raises(ValueError, match="mesh_shape"):
            ref_mesh(rcfg, jax.devices()[:1])
        assert port_multihost.global_mesh(device="cpu").shape == {"data": 1}
        assert data_parallel_mesh(device="cpu").shape == {"data": 1}
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n", NS)
def test_dp_step_equals_the_reference_sharded_step(worlds, small, n):
    from cilium_tpu.parallel.mesh import make_mesh
    from cilium_tpu.parallel.sharding import (
        make_sharded_step,
        shard_flow_batch,
        shard_policy_arrays,
    )

    arrays, batch = small
    mesh = make_mesh((n,), ("data",), jax.devices()[:n])
    ref = make_sharded_step(mesh, "data")(shard_policy_arrays(arrays, mesh),
                                          shard_flow_batch(batch, mesh))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    res = worlds[n].run(run_lane, "dp", {"arrays": arrays, "batch": batch},
                        device="cpu")
    _assert_lanes(res[0]["out"], ref, f"dp n={n}")
    _assert_lanes(res[0]["out"], _ref_single(arrays, batch), f"dp n={n}")
    # the DP lane issues no collective on any rank
    assert all(r["ledger"] == [] for r in res)


def test_dp_step_over_a_data_expert_mesh(worlds, small):
    """The reference's DP × EP layout: banks sharded on the expert axis,
    flows on the data axis (2 × 2); the port's step gathers the banks
    along the expert axis, one all-gather a banked tensor."""
    from cilium_tpu.parallel.mesh import make_mesh
    from cilium_tpu.parallel.sharding import (
        make_sharded_step,
        shard_flow_batch,
        shard_policy_arrays,
    )
    from cilium_tpu_torch.parallel.sharding import is_banked_key

    arrays, batch = small
    mesh = make_mesh((2, 2), ("data", "expert"), jax.devices()[:4])
    ref = make_sharded_step(mesh, "data")(
        shard_policy_arrays(arrays, mesh, expert_axis="expert"),
        shard_flow_batch(batch, mesh, "data"))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    res = worlds[4].run(run_lane, "dp_ep",
                        {"arrays": arrays, "batch": batch}, device="cpu")
    _assert_lanes(res[0]["out"], ref, "dp x ep")
    rows = res[0]["ledger"]
    assert {r["site"] for r in rows} == {"dp.bank_gather"}
    assert sum(r["count_per_block"] for r in rows) == \
        sum(1 for k in arrays if is_banked_key(k))


def test_run_pipelined_matches_sequential(small):
    from cilium_tpu.engine.verdict import verdict_step
    from cilium_tpu.parallel.pipeline import collect as ref_collect
    from cilium_tpu.parallel.pipeline import run_pipelined as ref_pipelined
    from cilium_tpu_torch.parallel.pipeline import collect, run_pipelined

    arrays, host = small
    perm = np.random.default_rng(3).permutation(len(host["scalars"]))
    batches = [host, {k: v[perm] for k, v in host.items()},
               {k: v[::-1].copy() for k, v in host.items()}]
    staged = arrays_from_reference(arrays, "cpu")
    for depth in (1, 2, 3):
        outs = collect(run_pipelined(port_verdict_step, staged, batches,
                                     device="cpu", depth=depth))
        assert len(outs) == len(batches)
        for b, out in zip(batches, outs):
            seq = port_verdict_step(staged, batch_to_device(b, "cpu"))
            _assert_lanes(out, {k: v.numpy() for k, v in seq.items()},
                          f"pipelined depth {depth}")
    ref = ref_collect(ref_pipelined(
        jax.jit(verdict_step), {k: jax.device_put(v) for k, v in arrays.items()},
        batches))
    for want, got in zip(ref, outs):
        _assert_lanes(got, want, "pipelined against the reference")
    with pytest.raises(ValueError, match="depth"):
        run_pipelined(port_verdict_step, staged, batches, device="cpu",
                      depth=0)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("lane", ["auto", "dp", "ep", "cp"])
def test_stage_for_lane_every_lane_equals_the_reference(worlds, small, n,
                                                        lane):
    arrays, batch = small
    res = worlds[n].run(run_lane, lane, {"arrays": arrays, "batch": batch},
                        cp_block=CP_BLOCK, device="cpu")
    _assert_lanes(res[0]["out"], _ref_lane(lane, n, arrays, batch),
                  f"{lane} n={n}")
    _assert_lanes(res[0]["out"], _ref_single(arrays, batch), f"{lane} n={n}")


def test_cp_lane_with_a_block_that_does_not_divide_the_shard(worlds, small):
    """A difference from the reference, stated: at n = 2 the 32-byte
    buckets shard in 16 columns and a 64-byte inner block does not
    divide them. The reference's CP marks its padding valid by position
    (``cilium_tpu/parallel/cp.py:80-86``), so rank 0 consumes zero bytes
    in place of rank 1's columns and its verdicts differ from its own
    single-device step; the port skips the padding and equals it."""
    arrays, batch = small
    single = _ref_single(arrays, batch)
    res = worlds[2].run(run_lane, "cp", {"arrays": arrays, "batch": batch},
                        cp_block=64, device="cpu")
    _assert_lanes(res[0]["out"], single, "cp n=2, block 64")
    from cilium_tpu.core.config import Config
    from cilium_tpu.parallel.sharding import stage_for_lane

    cfg = Config()
    cfg.parallel.lane = "cp"
    cfg.parallel.cp_block = 64
    step, a, b = stage_for_lane(cfg, arrays, batch, devices=jax.devices()[:2])
    ref = np.asarray(step(a, b)["verdict"])
    assert not np.array_equal(ref, single["verdict"])


def test_stage_for_lane_unknown_lane_raises(small):
    from cilium_tpu.core.config import Config
    from cilium_tpu.parallel.sharding import stage_for_lane as ref_stage
    from cilium_tpu_torch.parallel.sharding import stage_for_lane

    arrays, batch = small
    cfg, rcfg = PortConfig(), Config()
    cfg.parallel.lane = rcfg.parallel.lane = "warp"
    with pytest.raises(ValueError, match="lane"):
        stage_for_lane(cfg, arrays, batch, device="cpu")
    with pytest.raises(ValueError, match="lane"):
        ref_stage(rcfg, arrays, batch)


def test_local_world_fails_a_raising_rank_and_tears_down():
    """A rank's exception reaches the caller with its traceback, and
    the world is torn down: no later call hangs on it."""
    from cilium_tpu_torch.parallel.mesh import WorldError

    world = LocalWorld(2, timeout_s=60.0)
    try:
        with pytest.raises(WorldError, match="unknown lane"):
            world.run(run_lane, "warp", {}, device="cpu")
        with pytest.raises(WorldError, match="torn down"):
            world.run(port_multihost.process_span)
        assert not any(p.is_alive() for p in world._procs)
    finally:
        world.close(kill=True)
