"""The port's churn storm (``runtime/fleet.py``) against the JAX
package's, on the CPU.

Both packages drive the same storm at the reference's smoke size
(``tests/test_fleet.py``: 400 identities x 200 CNPs, 8 updates, two
compile workers) through their own ``Loader`` (the port's with
``device="cpu"``) and must agree exactly: the compiled arrays after the
cold build and after every update, byte for byte; the result's
classes, banks, bank compiles, compiles per update, memo hit ratio and
schedule digest; and the capture-replay session's verdicts after every
update. Times (update→enforcement, cold build, wall) and RSS differ by
package and are not compared.

Also: the storm's corpus is the same capture in both packages, the p99
gate needs a denominator from the caller, the world stages on ``cuda``
by default (raises without it), and ``main`` prints one stamped line.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from cilium_tpu.engine import verdict as jax_verdict
from cilium_tpu.ingest import binary as jax_binary
from cilium_tpu.runtime import fleet as jax_fleet

from cilium_tpu_torch.engine import replay as port_replay
from cilium_tpu_torch.ingest import binary as port_binary
from cilium_tpu_torch.runtime import fleet as port_fleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(identities=400, cnps=200, updates=8)
COMPARED = ("identities", "cnps", "classes", "updates", "banks_t0",
            "bank_compiles", "compiles_per_update", "odelta_bound",
            "memo_hit_ratio", "registry_evictions", "schedule_digest",
            "metric", "unit", "lane", "p99_gated", "rss_bound_mb")


def _digest(arrays):
    return {k: (np.asarray(v).dtype.str, np.asarray(v).shape,
                hashlib.sha256(np.ascontiguousarray(v).tobytes())
                .hexdigest())
            for k, v in arrays.items()}


def _storm(monkeypatch, tmp_path, mod, replay_cls, **kw):
    """Run one package's storm; record, at every session verdict (after
    the cold build and after each update), the verdicts and the digest
    of the serving engine's arrays."""
    seen = []
    inner = replay_cls.verdict_chunk

    def recording(self, *a, **k):
        out = inner(self, *a, **k)
        seen.append((np.asarray(out["verdict"]).tolist(),
                     _digest(self.loader.engine.policy.arrays)))
        return out

    with monkeypatch.context() as m:
        m.setattr(replay_cls, "verdict_chunk", recording)
        result = mod.run(cache_dir=str(tmp_path / mod.__name__),
                         workers=2, gate_p99=False,
                         progress=lambda *_: None, **SIZE, **kw)
    return result, seen


@pytest.fixture(scope="module")
def storms(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("storm")
    try:
        jax = _storm(mp, tmp, jax_fleet, jax_verdict.CaptureReplay)
        port = _storm(mp, tmp, port_fleet, port_replay.CaptureReplay,
                      device="cpu")
    finally:
        mp.undo()
    return jax, port


@pytest.mark.parametrize("key", COMPARED)
def test_storm_result_equals_reference(storms, key):
    (jr, _), (pr, _) = storms
    assert pr[key] == jr[key]


def test_storm_passes_its_gates(storms):
    _, (pr, _) = storms
    assert pr["classes"] == 8
    assert pr["compiles_per_update"] <= pr["odelta_bound"] == 1.022
    assert pr["memo_hit_ratio"] >= 0.98
    assert pr["rss_peak_mb"] <= pr["rss_bound_mb"]
    assert pr["compile_queue"]["completed"] > 0
    assert pr["p99_bound_ms"] is None and pr["baseline_p99_ms"] is None


def test_session_verdicts_equal_after_every_update(storms):
    (_, js), (_, ps) = storms
    assert len(js) == len(ps) == SIZE["updates"] + 1
    for step, ((jv, _), (pv, _)) in enumerate(zip(js, ps)):
        assert pv == jv, f"verdicts differ after update {step}"
    assert 5 in ps[-1][0] and 2 in ps[-1][0]     # allowed and dropped


def test_compiled_arrays_equal_after_every_update(storms):
    (_, js), (_, ps) = storms
    for step, ((_, ja), (_, pa)) in enumerate(zip(js, ps)):
        assert pa == ja, f"arrays differ after update {step}"
    # the policy moved: an add recompiles a path bank
    assert ps[0][1]["path_trans"] != ps[1][1]["path_trans"]


def test_corpus_is_the_same_capture(tmp_path):
    worlds = [mod.FleetWorld(120, 60, str(tmp_path / mod.__name__),
                             workers=0, **kw)
              for mod, kw in ((jax_fleet, {}),
                              (port_fleet, {"device": "cpu"}))]
    (jf, jn), (pf, pn) = (w.corpus(sample_ids=16, repeat=2)
                          for w in worlds)
    assert pn == jn and len(pf) == len(jf) == 2 * jn
    assert port_binary.capture_to_bytes(pf) == \
        jax_binary.capture_to_bytes(jf)
    assert worlds[1].n_classes == worlds[0].n_classes == 3
    assert worlds[1].rules_of == worlds[0].rules_of


def test_peak_rss_is_the_processs_own():
    """A spawned child's ``ru_maxrss`` starts at its parent's peak; the
    storm's RSS gate reads the child's own high-water mark."""
    import multiprocessing
    import resource

    parent = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    assert port_fleet._peak_rss_mb() >= 0.9 * parent
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(1) as pool:
        child = pool.apply(port_fleet._peak_rss_mb)
    assert child < parent / 2


def test_p99_gate_needs_the_callers_denominator(tmp_path):
    with pytest.raises(ValueError, match="base_p99_ms"):
        port_fleet.run(10, 5, 1, str(tmp_path), device="cpu")


def test_world_stages_on_cuda_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_fleet.FleetWorld(10, 5, str(tmp_path), workers=0)


def test_compile_ratio_is_the_27_bank_lanes():
    with open(os.path.join(REPO, "BENCH_CHURN_r06.jsonl")) as fp:
        rows = [json.loads(line) for line in fp if line.strip()]
    assert {r["compiles_per_update"] for r in rows} == \
        {port_fleet.BASELINE_COMPILES_PER_UPDATE}


def test_main_prints_one_stamped_line(capsys, monkeypatch):
    monkeypatch.setenv("CILIUM_TPU_HOST_ID", "host-test")
    for var in ("CILIUM_TPU_DST_SEED", "CILIUM_TPU_DST_DIGEST"):
        monkeypatch.delenv(var, raising=False)      # main sets them
    assert port_fleet.main(["--identities", "60", "--cnps", "30",
                            "--updates", "2", "--workers", "0",
                            "--no-p99-gate", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert len(lines) == 1
    line = lines[0]
    assert line["lane"] == "churn-fleet" and line["updates"] == 2
    assert line["host_id"] == "host-test"
    prov = line["provenance"]
    assert prov["torch_version"] == torch.__version__
    assert prov["backend"] == "cpu" and prov["card"] is None
    assert line["dst"]["schedule_digest"] == line["schedule_digest"]
