"""The port's DST runner (``runtime/dst.py``) against the JAX package's,
on the CPU, mirroring ``tests/dst/test_dst.py`` and
``tests/dst/test_planted.py``: the schedule generator and its digest
(equal for seeds 0–199), the constants that define the searched space,
``SchedulePlan``'s fire log, the ddmin shrinker, the planted-bug
registry, the regression writer, the ``dst`` provenance rider and the
multichip arm's CP batch.

The schedule traces themselves are held equal to the reference's in
``tests/test_torch_dst_schedules_*.py``. The slow cases (``slow`` and
``dst``, as in the reference) are the port's counterparts of the
reference's: the in-process and three-``PYTHONHASHSEED`` replay pins,
a clean-tree search slice, and the 25-seed planted-bug searches with
their shrink.
"""

import json
import os
import subprocess
import sys

import pytest

from cilium_tpu.runtime import dst as ref_dst
from cilium_tpu.runtime import faults as ref_faults
from cilium_tpu_torch.runtime import dst, faults

REGRESSION_DIR = os.path.join(os.path.dirname(__file__), "dst",
                              "regressions")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the hand-written schedules ``tests/test_torch_dst_schedules_*.py``
#: run in both packages, with the fires each must cause. Between them
#: they reach every event kind, all 14 fault points, the tenant arm's
#: three modes, the fleet arm's four actions, and (every clean run)
#: the liveness epilogue.
SCHEDULES = {
    "serve_and_dispatch_faults": (
        [["fault", "engine.dispatch", 2], ["traffic"],
         ["fault", "serve.lease", 1], ["fault", "serve.ring_slot", 1],
         ["serve", 5], ["advance", 6.0]],
        {"engine.dispatch": 2, "serve.lease": 1, "serve.ring_slot": 1}),
    "loader_and_compile_faults": (
        [["fault", "loader.swap", 1], ["churn", "add", 0],
         ["fault", "loader.bank_compile", 1], ["churn", "add", 1],
         ["fault", "compile.worker", 1], ["churn", "add", 2]],
        {"loader.swap": 1, "loader.bank_compile": 1, "compile.worker": 1}),
    "restore_fetch_and_identity_storm": (
        [["drain-restore"], ["fault", "artifact.fetch", 2],
         ["churn", "add", 2], ["churn", "delete", 2],
         ["fault", "kvstore.churn_storm", 2], ["storm", 8]],
        {"artifact.fetch": 2, "kvstore.churn_storm": 2}),
    "clustermesh_and_fleet_kill_rejoin": (
        [["fault", "clustermesh.session", 1],
         ["fault", "clustermesh.heartbeat", 1], ["clustermesh", 4],
         ["fault", "fleet.heartbeat", 1], ["fleet", 3, "kill"],
         ["fleet", 2, "rejoin"]],
        {"clustermesh.session": 1, "clustermesh.heartbeat": 1,
         "fleet.heartbeat": 1}),
    "fleet_partition_beat_and_multichip": (
        [["fault", "fleet.handoff", 1], ["fleet", 6, "kill"],
         ["fleet", 2, "partition"], ["advance", 2.0],
         ["fleet", 2, "beat"], ["multichip"]],
        {"fleet.handoff": 1}),
    "tenant_arms": (
        [["churn-burst", 2], ["fault", "tenant.quota", 1],
         ["tenant", "quota"], ["tenant", "churn-storm"],
         ["fault", "canary.dispatch", 1], ["tenant", "canary"]],
        {"tenant.quota": 1, "canary.dispatch": 1}),
}

#: the committed regression case both packages replay
REGRESSION_CASE = os.path.join(REGRESSION_DIR,
                               "dst_seed2_e27df4160b0adb25.json")


def _fires(metrics):
    return {p: metrics.METRICS.get(metrics.FAULTS_INJECTED, {"point": p})
            for p in dst.FAULT_POINTS}


def run_both(events, seed=0, mutation="", monkeypatch=None):
    """One schedule in the JAX package and in the port (``device="cpu"``),
    with ``mutation`` armed (empty: none); both results, reference
    first, each with the fires it caused per point (``"fires"``)."""
    from cilium_tpu.runtime import metrics as ref_metrics
    from cilium_tpu_torch.runtime import metrics

    if mutation:
        monkeypatch.setenv(faults.MUTATION_ENV, mutation)
    else:
        monkeypatch.delenv(faults.MUTATION_ENV, raising=False)
    out = []
    for mod, m, kw in ((ref_dst, ref_metrics, {}),
                       (dst, metrics, {"device": "cpu"})):
        before = _fires(m)
        res = mod.run_schedule(seed, events=events, **kw)
        res["fires"] = {p: n - before[p] for p, n in _fires(m).items()
                        if n != before[p]}
        out.append(res)
    return out


def assert_same_trace(ref, port):
    """Field for field: every trace entry, then the digests."""
    assert len(port["trace"]) == len(ref["trace"])
    for want, got in zip(ref["trace"], port["trace"]):
        assert got == want
    assert port["digest"] == ref["digest"]
    assert port["violation"] == ref["violation"]


@pytest.mark.parametrize("block", range(10))
def test_generate_and_digest_equal_the_reference(block):
    """Seeds 0–199, twenty a case: the same event lists, the same
    schedule digests, at the default and at a short length."""
    for seed in range(20 * block, 20 * block + 20):
        for max_events in (12, 5):
            got = dst.generate(seed, max_events=max_events)
            want = ref_dst.generate(seed, max_events=max_events)
            assert got == want, seed
            assert dst.schedule_digest(got) == ref_dst.schedule_digest(want)


def test_generate_is_seeded_and_self_contained():
    a, b, c = dst.generate(11), dst.generate(11), dst.generate(12)
    assert a == b and a != c
    assert all(isinstance(ev, list) and isinstance(ev[0], str) for ev in a)
    assert json.loads(json.dumps(a)) == a
    evs = dst.generate(5)
    assert dst.schedule_digest(evs) == dst.schedule_digest(list(evs))
    assert dst.schedule_digest(evs) != dst.schedule_digest(evs[:-1])


def test_hand_written_schedules_cover_the_searched_space():
    """What the schedule files must reach between them: every event
    kind ``run_schedule`` executes, a fire at each of the 14 points,
    the tenant arm's three modes and the fleet arm's four actions, in
    schedules of 3-6 events."""
    kinds, modes, actions, fired = set(), set(), set(), set()
    for events, fires in SCHEDULES.values():
        assert 3 <= len(events) <= 6
        for ev in events:
            kinds.add(ev[0])
            if ev[0] == "tenant":
                modes.add(ev[1])
            if ev[0] == "fleet":
                actions.add(ev[2])
        fired |= set(fires)
    assert kinds == {"fault", "churn", "churn-burst", "traffic", "serve",
                     "fleet", "multichip", "clustermesh", "advance",
                     "tenant", "storm", "drain-restore"}
    assert modes == {"churn-storm", "quota", "canary"}
    assert actions == {"kill", "partition", "beat", "rejoin"}
    assert fired == set(dst.FAULT_POINTS)


def _claim_orders(root):
    """One compile worker, three queued compiles of tenants a, b and
    default after a history of claims (a, a, b): the order they run in
    when each is claimed before the next is submitted (``idle``), and
    when all three wait behind a busy worker (``busy``)."""
    import importlib
    import threading

    cq = importlib.import_module(f"{root}.policy.compiler.compilequeue")
    out = {}
    for mode in ("idle", "busy"):
        q = cq.CompileQueue(workers=1)
        ran = []
        for i, t in enumerate(("a", "a", "b")):
            q.wait(q.submit(f"h{i}", lambda: None, tenant=t), timeout=10)
        gate = threading.Event()
        if mode == "busy":
            q.submit("blocker", lambda: gate.wait(10), tenant="a")
        tasks = []
        for t in ("a", "b", "default"):
            tasks.append(q.submit(f"k{t}", lambda t=t: ran.append(t),
                                  tenant=t))
            if mode == "idle":
                q.wait(tasks[-1], timeout=10)
        gate.set()
        for task in tasks:
            q.wait(task, timeout=10)
        q.close()
        out[mode] = ran
    return out


def test_one_worker_runs_queued_compiles_in_an_order_set_by_timing():
    """A determinism hole of the reference that the port inherits
    (ROADMAP queue 3): with one compile worker, the compiles one
    regeneration submits run in submit order when the worker claims
    each before the next submit, and in weighted-fair order when they
    queue behind a busy worker. Which bank an armed
    ``loader.bank_compile`` or ``compile.worker`` fault lands on then
    depends on thread timing wherever a regeneration submits several
    compiles of different tenants — both packages alike."""
    want = {"idle": ["a", "b", "default"], "busy": ["default", "a", "b"]}
    assert _claim_orders("cilium_tpu") == want
    assert _claim_orders("cilium_tpu_torch") == want


def test_the_searched_space_is_the_reference_s():
    """The constants and the world's settings define the searched
    space and the trace: none is cut or widened."""
    for name in ("FAULT_POINTS", "PROBE_INTERVAL_S", "QUARANTINE_TTL_S",
                 "ADVANCES", "COMPILES_PER_CHANGE_BOUND", "SCHEDULE_FORMAT"):
        assert getattr(dst, name) == getattr(ref_dst, name), name
    assert len(dst.FAULT_POINTS) == 14
    assert (dst.DSTWorld.N_IDS, dst.DSTWorld.BASE_PATHS) == (3, 4)
    assert (ref_dst.DSTWorld.N_IDS, ref_dst.DSTWorld.BASE_PATHS) == (3, 4)
    # every armable point is registered once the world's modules load
    import cilium_tpu_torch.clustermesh  # noqa: F401
    import cilium_tpu_torch.identity_kvstore  # noqa: F401
    import cilium_tpu_torch.policy.compiler.bankplan  # noqa: F401
    import cilium_tpu_torch.policy.compiler.compilequeue  # noqa: F401
    import cilium_tpu_torch.runtime.canary  # noqa: F401
    import cilium_tpu_torch.runtime.fleetserve  # noqa: F401
    import cilium_tpu_torch.runtime.loader  # noqa: F401
    import cilium_tpu_torch.runtime.tenant  # noqa: F401

    assert set(dst.FAULT_POINTS) <= set(faults.registered_points())


def test_schedule_plan_fires_as_the_reference_s():
    """Arms grant one-shot fires consumed by the next hits, logged by
    (point, hit ordinal) — the same log and exceptions in both."""
    def drive(mod, flt):
        plan = mod.SchedulePlan()
        plan.arm("loader.swap", 2)
        out = [type(plan.check("loader.swap")).__name__,
               plan.check("engine.dispatch"),
               type(plan.check("loader.swap")).__name__,
               plan.check("loader.swap")]
        plan.arm("engine.dispatch")
        plan.disarm_all()
        out.append(plan.check("engine.dispatch"))
        assert isinstance(mod.SchedulePlan().check("x") or
                          flt.FaultInjected("x"), flt.FaultInjected)
        return out, plan.fires

    assert drive(dst, faults) == drive(ref_dst, ref_faults)


def test_digest_and_violation_match_the_reference():
    verdicts = [5, 5, 2, 1, 2, 255, 5]
    assert dst._digest(verdicts) == ref_dst._digest(verdicts)
    v = dst.InvariantViolation(4, "oracle-agreement", "served x")
    r = ref_dst.InvariantViolation(4, "oracle-agreement", "served x")
    assert (str(v), v.index, v.invariant, v.detail) == \
        (str(r), r.index, r.invariant, r.detail)
    assert isinstance(v, AssertionError)


def test_shrink_is_ddmin_minimal_on_a_synthetic_predicate(monkeypatch):
    """The shrinker contract, isolated from the world: ddmin over
    run_schedule keeps any subset that still violates and stops at
    1-minimality — the same minimal schedule as the reference's."""
    def fake(mod):
        def run(seed, events=None, cache_dir=None, max_events=12,
                device=None):
            events = events if events is not None else mod.generate(seed)
            bad = (["fault", "loader.swap", 1] in events
                   and ["drain-restore"] in events)
            return {"seed": seed, "events": events, "trace": [],
                    "digest": "x", "schedule_digest": "y",
                    "violation": ({"index": 0, "invariant": "synthetic",
                                   "detail": ""} if bad else None)}
        return run

    monkeypatch.setattr(dst, "run_schedule", fake(dst))
    monkeypatch.setattr(ref_dst, "run_schedule", fake(ref_dst))
    events = [["traffic"], ["fault", "loader.swap", 1], ["advance", 2.0],
              ["storm", 8], ["drain-restore"], ["traffic"],
              ["churn", "add", 0]]
    best = dst.shrink(0, events)
    assert best["violation"] is not None
    assert sorted(map(str, best["events"])) == sorted(map(str, [
        ["fault", "loader.swap", 1], ["drain-restore"]]))
    assert best == ref_dst.shrink(0, events)


def test_mutations_are_the_reference_s(monkeypatch):
    """The same planted bugs, each described in the reference's words
    (the port leaves out the reference's history note at the end)."""
    assert set(faults.MUTATIONS) == set(ref_faults.MUTATIONS)
    for name, where in faults.MUTATIONS.items():
        assert ref_faults.MUTATIONS[name].startswith(where + " ("), name
    assert faults.MUTATION_ENV == ref_faults.MUTATION_ENV
    monkeypatch.delenv(faults.MUTATION_ENV, raising=False)
    assert not faults.mutation_active("rollback-artifact-key")
    monkeypatch.setenv(faults.MUTATION_ENV, "positional-banks")
    assert faults.mutation_active("positional-banks")


def test_emit_regression_writes_the_reference_s_case(tmp_path, monkeypatch):
    monkeypatch.setenv(faults.MUTATION_ENV, "rollback-artifact-key")
    result = {"seed": 2, "events": [["drain-restore"]],
              "schedule_digest": "abc",
              "violation": {"index": 1, "invariant": "oracle-agreement",
                            "detail": "d"}}
    got = dst.emit_regression(result, str(tmp_path / "port"))
    want = ref_dst.emit_regression(result, str(tmp_path / "ref"))
    assert os.path.basename(got) == os.path.basename(want)
    assert open(got).read() == open(want).read()


def test_dst_stamp_rides_bench_lines(monkeypatch):
    """CILIUM_TPU_DST_SEED/_DIGEST on the environment land as the
    ``dst`` rider on every stamped line, as in the reference."""
    from cilium_tpu.runtime.provenance import stamp as ref_stamp
    from cilium_tpu_torch.runtime.provenance import stamp

    monkeypatch.setenv("CILIUM_TPU_DST_SEED", "41")
    monkeypatch.setenv("CILIUM_TPU_DST_DIGEST", "abc123")
    monkeypatch.delenv(faults.MUTATION_ENV, raising=False)
    line = stamp({"metric": "x", "value": 1}, rtt=False)
    assert line["dst"] == {"dst_seed": 41, "schedule_digest": "abc123"}
    assert line["dst"] == ref_stamp({"metric": "x"}, rtt=False)["dst"]
    monkeypatch.delenv("CILIUM_TPU_DST_SEED")
    assert "dst" not in stamp({"metric": "x", "value": 1}, rtt=False)


def test_main_sweeps_and_writes_a_stamped_line(tmp_path, monkeypatch,
                                               capsys):
    """``python -m cilium_tpu_torch.runtime.dst`` on the CPU: the lane's
    line (the reference's keys plus the device) lands in ``--out``;
    ``run_schedule`` is stubbed, the lane's bookkeeping is what is
    tested here."""
    def run(seed, events=None, cache_dir=None, max_events=12, device=None):
        assert str(device) == "cpu"
        evs = dst.generate(seed, max_events=max_events)
        return {"seed": seed, "events": evs,
                "trace": [{"t": 5.1}], "digest": "d",
                "schedule_digest": dst.schedule_digest(evs),
                "violation": None}

    monkeypatch.setattr(dst, "run_schedule", run)
    monkeypatch.delenv(faults.MUTATION_ENV, raising=False)
    # main stamps its line through these two; set here, monkeypatch
    # restores them after main overwrites them
    monkeypatch.setenv("CILIUM_TPU_DST_SEED", "0")
    monkeypatch.setenv("CILIUM_TPU_DST_DIGEST", "")
    out = tmp_path / "dst.jsonl"
    rc = dst.main(["--schedules", "3", "--seed", "4", "--device", "cpu",
                   "--out", str(out)])
    assert rc == 0
    line = json.loads(out.read_text().splitlines()[-1])
    assert {k: line[k] for k in ("metric", "value", "lane", "violations",
                                 "distinct_schedules", "seed0", "device",
                                 "simulated_s")} == {
        "metric": "dst_schedules_explored", "value": 3, "lane": "dst",
        "violations": 0, "distinct_schedules": 3, "seed0": 4,
        "device": "cpu", "simulated_s": 15.3}
    assert line["dst"]["dst_seed"] == 4
    assert "[dst] 3 schedules" in capsys.readouterr().out


def test_multichip_cp_batch_reaches_the_block_departure_without_a_crossing():
    """The CP lane skips the reference's inner-block padding of a
    rank's payload shard (a departure ``parallel/cp.py`` documents).
    It shows only where the block does not divide the shard AND a row
    runs past its shard's end into the padding. The multichip arm's
    batch (the world's probe corpus over 2 ranks at the default
    ``cp_block`` 256) reaches the first condition on every sharded
    field — each rank's shard is narrower than the block — but no row
    crosses its first shard's end, so the reference's padded bytes are
    never consumed: the CP outputs equal the single-device step in
    both packages, and the multichip traces stay equal."""
    import tempfile

    import torch

    from cilium_tpu_torch.core.config import ParallelConfig
    from cilium_tpu_torch.engine.compiled import (
        encode_flows,
        flowbatch_to_host_dict,
    )
    from cilium_tpu_torch.engine.megakernel import SCAN_FIELDS
    from cilium_tpu_torch.engine.verdict import batch_field, unpack_batch
    from cilium_tpu_torch.parallel.cp import MIN_SHARD_COLS
    from cilium_tpu_torch.runtime import simclock

    with simclock.use(simclock.VirtualClock()):
        world = dst.DSTWorld(tempfile.mkdtemp(), device="cpu")
        try:
            # the storm of a churn-storm arm: the longest paths a
            # schedule makes ("/churnt<i>k<k>/x")
            world.rules_of[0] += [("http", f"/churnt11k{k}/.*")
                                  for k in range(6)]
            world.committed = {i: list(v)
                               for i, v in world.rules_of.items()}
            flows = world.corpus()
            flows += flows[:len(flows) % 2]
            host = flowbatch_to_host_dict(encode_flows(
                flows, world.loader.engine.policy.kafka_interns,
                world.cfg.engine))
        finally:
            world.close()
    block = ParallelConfig().cp_block
    assert block == 256
    b = unpack_batch({k: torch.from_numpy(v) for k, v in host.items()})
    sharded = 0
    for _prefix, field in SCAN_FIELDS:
        width = host[f"{field}_data"].shape[1]
        if width % 2 or width // 2 < MIN_SHARD_COLS:
            continue
        sharded += 1
        shard = width // 2
        _data, lengths, _valid = batch_field(b, field)
        assert shard % block != 0, field          # the departure is reached
        assert int(lengths.max()) <= shard, field  # and never crossed
    assert sharded == len(SCAN_FIELDS)


def _pin(seed, hashseed):
    env = dict(os.environ, PYTHONHASHSEED=hashseed)
    env.pop(faults.MUTATION_ENV, None)
    out = subprocess.run(
        [sys.executable, "-c",
         "from cilium_tpu_torch.runtime import dst; "
         f"print(dst.run_schedule({seed}, device='cpu')['digest'])"],
        capture_output=True, text=True, timeout=480, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.slow
@pytest.mark.dst
def test_trace_byte_identical_across_three_hashseeds():
    """The acceptance pin: the same seed produces a byte-identical
    trace across 3 PYTHONHASHSEEDs, and it is the reference's."""
    digests = {_pin(7, h) for h in ("0", "1", "42")}
    assert len(digests) == 1, digests
    assert digests == {ref_dst.run_schedule(7)["digest"]}


@pytest.mark.slow
@pytest.mark.dst
def test_same_seed_replays_byte_identical_in_process():
    r1 = dst.run_schedule(3, device="cpu")
    r2 = dst.run_schedule(3, device="cpu")
    assert r1["digest"] == r2["digest"] and r1["trace"] == r2["trace"]
    assert r1["violation"] is None


@pytest.mark.slow
@pytest.mark.dst
def test_clean_tree_slice_has_zero_violations():
    ran, failing = dst.search(6, seed0=100, device="cpu")
    assert ran == 6
    assert failing is None, failing and failing["violation"]


@pytest.mark.slow
@pytest.mark.dst
@pytest.mark.parametrize("mutation,invariants", [
    ("rollback-artifact-key", {"oracle-agreement", "session-stale"}),
    ("positional-banks", {"o-delta-compile"}),
])
def test_planted_bug_is_caught_and_shrunk(mutation, invariants,
                                          monkeypatch):
    """tests/dst/test_planted.py on the port: caught within 25 seeds,
    at the reference's first catching seed, shrunk to ≤ 5 events that
    are clean without the mutation."""
    monkeypatch.setenv(faults.MUTATION_ENV, mutation)
    ran, failing = dst.search(25, device="cpu")
    assert failing is not None, f"{mutation} not caught within 25 seeds"
    assert failing["violation"]["invariant"] in invariants
    _, ref_failing = ref_dst.search(25)
    assert failing["seed"] == ref_failing["seed"]
    small = dst.shrink(failing["seed"], failing["events"], device="cpu")
    assert small["violation"] is not None
    assert len(small["events"]) <= 5, small["events"]
    monkeypatch.delenv(faults.MUTATION_ENV)
    clean = dst.run_schedule(small["seed"], events=small["events"],
                             device="cpu")
    assert clean["violation"] is None, clean["violation"]


@pytest.mark.slow
@pytest.mark.dst
@pytest.mark.parametrize("case", sorted(os.listdir(REGRESSION_DIR)))
def test_regression_corpus_replays(case, monkeypatch):
    """Every committed case keeps reproducing its violation on the
    port, with its recorded mutation armed."""
    with open(os.path.join(REGRESSION_DIR, case)) as fp:
        data = json.load(fp)
    assert data["format"] == dst.SCHEDULE_FORMAT
    monkeypatch.setenv(faults.MUTATION_ENV, data.get("mutation", ""))
    res = dst.run_schedule(data["seed"], events=data["events"],
                           device="cpu")
    assert res["violation"] is not None, \
        f"{case} no longer reproduces its violation"
    assert res["violation"]["invariant"] == data["violation"]["invariant"]
