"""The port's phase probes against the JAX package's, on the CPU.

* the live sub-steps (``_live_mapstate`` → ``_live_scan`` →
  ``_live_resolve``) give the ten lanes of the port's fused step, under
  ``auto`` and ``nfa-bitset``, and of the reference's own sub-steps on
  the same policy and flows;
* the capture sub-steps (``_cap_gather``, ``_cap_mapstate``,
  ``_cap_resolve``) give the lanes of ``verdict_step_capture`` on the
  row stream and on the dedup id stream, and of the reference's
  sub-steps on the same capture;
* ``EnginePhaseProbe`` and ``CapturePhaseProbe`` reports carry the
  reference's keys and phase labels, and feed
  ``cilium_tpu_engine_phase_seconds`` and
  ``cilium_tpu_engine_host_syncs_total``.

The reference's sub-steps are jitted as its probe jits them. The probes'
wall-clock coverage is not asserted here: it is a ratio of host times,
held on the card by ``chip_smoke.py``.

Inputs: the http scenario at 12 rules × 128 flows, realized in both
packages from one seed; one capture written by the port's writer (the
two writers' files are byte-identical, ``tests/test_torch_capture.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.core.config import EngineConfig as JaxEngineConfig
from cilium_tpu.engine import phases as jph
from cilium_tpu.engine import verdict as jv
from cilium_tpu.ingest import synth as jax_synth

from cilium_tpu_torch.core.config import EngineConfig
from cilium_tpu_torch.engine import phases
from cilium_tpu_torch.engine.compiled import (
    CompiledPolicy,
    encode_flows,
    flowbatch_to_host_dict,
)
from cilium_tpu_torch.engine.replay import CaptureReplay, _ids_to_device
from cilium_tpu_torch.engine.verdict import (
    OUTPUT_LANES,
    TorchVerdictEngine,
    batch_to_device,
    verdict_step_capture,
)
from cilium_tpu_torch.ingest import binary, synth
from cilium_tpu_torch.runtime.metrics import (
    ENGINE_HOST_SYNCS,
    ENGINE_PHASE_SECONDS,
    METRICS,
)

N_RULES, N_FLOWS = 12, 128


class _World:
    def __init__(self, tmpdir):
        jpi, jsc = jax_synth.realize_scenario(
            jax_synth.scenario_by_name("http", N_RULES, N_FLOWS))
        pi, sc = synth.realize_scenario(
            synth.scenario_by_name("http", N_RULES, N_FLOWS))
        self.flows, self.jflows = sc.flows, jsc.flows
        self.jeng = jv.VerdictEngine(
            jv.CompiledPolicy.build(jpi, JaxEngineConfig()))
        pol = CompiledPolicy.build(pi, EngineConfig())
        nfa_cfg = EngineConfig()
        nfa_cfg.kernel_impl = "nfa-bitset"
        self.engines = {
            "auto": TorchVerdictEngine(pol, device="cpu"),
            "nfa-bitset": TorchVerdictEngine(
                CompiledPolicy.build(pi, nfa_cfg), device="cpu",
                cfg=nfa_cfg)}
        self.host = flowbatch_to_host_dict(encode_flows(
            self.flows, pol.kafka_interns, EngineConfig()))
        self.jhost = jv.flowbatch_to_host_dict(jv.encode_flows(
            self.jflows, self.jeng.policy.kafka_interns,
            JaxEngineConfig()))
        path = os.path.join(tmpdir, "cap.bin")
        binary.write_capture_l7(path, (self.flows * 3)[:3 * N_FLOWS])
        self.rec = np.asarray(binary.map_capture(path))
        self.sections = binary.read_l7_sidecar(path)

    def replays(self, stream):
        """(reference replay, port replay) over the capture, staged for
        the ``row`` or ``id`` stream."""
        l7, offsets, blob = self.sections
        out = []
        for rp, eng in ((jv.CaptureReplay, self.jeng),
                        (CaptureReplay, self.engines["auto"])):
            r = rp(eng, l7, offsets, blob, None)
            r.stage_rows(self.rec, l7)
            if stream == "id":
                r.stage_unique()
                assert r.row_idx is not None
            out.append(r)
        return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _World(str(tmp_path_factory.mktemp("phases")))


def _lanes_equal(got, want):
    assert set(got) == set(want) == set(OUTPUT_LANES)
    for lane in OUTPUT_LANES:
        a, b = np.asarray(got[lane]), np.asarray(want[lane])
        assert a.shape == b.shape, lane
        np.testing.assert_array_equal(a, b, lane)


def _np(out):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


_REF_LIVE = (jax.jit(jph._live_mapstate), jax.jit(jph._live_scan),
             jax.jit(jph._live_resolve))
_REF_CAP = (jax.jit(jph._cap_gather), jax.jit(jph._cap_mapstate),
            jax.jit(jph._cap_resolve))


@pytest.mark.parametrize("arm", ["auto", "nfa-bitset"])
def test_live_substeps_equal_the_fused_step(world, arm):
    engine = world.engines[arm]
    arrays = engine._arrays
    if arm == "nfa-bitset":
        assert "nfa-bitset" in engine.impl_plan.values()
    batch = batch_to_device(world.host, "cpu")
    ms = phases._live_mapstate(arrays, batch)
    words = phases._live_scan(arrays, batch)
    via = phases._live_resolve(arrays, ms, words, batch)
    _lanes_equal(_np(via), _np(engine._step(arrays, batch)))
    # the verdict mix holds both sides
    assert {2, 5} <= set(np.unique(via["verdict"].numpy()).tolist())


def test_live_substeps_equal_the_reference(world):
    for k in world.host:
        np.testing.assert_array_equal(world.host[k], world.jhost[k], k)
    arrays = world.engines["auto"]._arrays
    batch = batch_to_device(world.host, "cpu")
    ms = phases._live_mapstate(arrays, batch)
    words = phases._live_scan(arrays, batch)
    via = phases._live_resolve(arrays, ms, words, batch)
    jms_f, jscan_f, jres_f = _REF_LIVE
    jarr, jb = world.jeng._arrays, {k: jnp.asarray(v)
                                    for k, v in world.jhost.items()}
    jms = jms_f(jarr, jb)
    jwords = jscan_f(jarr, jb)
    for k in jms:
        np.testing.assert_array_equal(ms[k].numpy(), np.asarray(jms[k]), k)
    for w, jw in zip(words, jwords):
        np.testing.assert_array_equal(w.numpy().view(np.uint32),
                                      np.asarray(jw))
    _lanes_equal(_np(via), _np(jres_f(jarr, jms, jwords, jb)))


@pytest.mark.parametrize("stream", ["row", "id"])
def test_capture_substeps_equal_the_capture_step_and_the_reference(
        world, stream):
    jrep, rep = world.replays(stream)
    arrays = rep.engine._arrays
    if stream == "id":
        np.testing.assert_array_equal(rep.row_idx, jrep.row_idx)
        batch = {"rows": rep.stage_unique_device(),
                 "idx": _ids_to_device(rep.row_idx, rep.engine.device)}
        jbatch = {"rows": jrep.stage_unique_device(),
                  "idx": jnp.asarray(jrep.row_idx)}
    else:
        batch = {"rows": torch.from_numpy(rep.rows_all)}
        jbatch = {"rows": jnp.asarray(jrep.rows_all)}
    rows, words = phases._cap_gather(rep.table_words, batch)
    ms = phases._cap_mapstate(arrays, batch)
    via = phases._cap_resolve(arrays, ms, rows, words, batch)
    _lanes_equal(_np(via), _np(verdict_step_capture(
        arrays, rep.table_words, batch)))
    jg, jm, jr = _REF_CAP
    jrows, jwords = jg(jrep.table_words, jbatch)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    jout = jr(jrep.engine._arrays, jm(jrep.engine._arrays, jbatch), jrows,
              jwords, jbatch)
    _lanes_equal(_np(via), _np(jout))
    assert len(via["verdict"]) == 3 * N_FLOWS


def _marks(phase_names, sites):
    return ({p: METRICS.histo_count(ENGINE_PHASE_SECONDS, {"phase": p})
             for p in phase_names},
            {s: METRICS.get(ENGINE_HOST_SYNCS, {"site": s}) for s in sites})


def _rose(before, after):
    return all(after[k] > v for k, v in before.items())


def test_engine_probe_report_has_the_reference_keys(world):
    sites = ("engine-h2d", "engine-mapstate", "engine-dfa-scan",
             "engine-resolve", "engine-fused-verdict", "engine-three-op",
             "engine-impl-scan")
    labels = ("featurize", "h2d", "mapstate", "dfa-scan", "resolve",
              "fused-verdict", "dfa-dense", "compile", "execute")
    h0, s0 = _marks(labels, sites)
    report = phases.EnginePhaseProbe(world.engines["auto"]).measure_flows(
        world.flows, EngineConfig(), reps=2)
    h1, s1 = _marks(labels, sites)
    assert _rose(h0, h1) and _rose(s0, s1)
    want = jph.EnginePhaseProbe(world.jeng).measure_flows(
        world.jflows, JaxEngineConfig(), reps=1)
    assert set(report) == set(want)
    assert set(report["phases_ms"]) == set(want["phases_ms"])
    assert report["impl_plan"] == want["impl_plan"]
    assert set(report["phases_ms"]) <= set(phases.ENGINE_PHASES)
    assert report["batch"] == want["batch"] == N_FLOWS
    assert (report["fused_dispatches"], report["three_op_dispatches"]) \
        == (want["fused_dispatches"], want["three_op_dispatches"]) == (1, 3)
    assert phases.ENGINE_PHASES == jph.ENGINE_PHASES
    assert phases.CAPTURE_PHASES == jph.CAPTURE_PHASES
    # the bitset-NFA arm reports its own lane (K1's, on the card)
    nfa = phases.EnginePhaseProbe(world.engines["nfa-bitset"]).measure(
        world.host, reps=1)
    assert "nfa-bitset" in nfa["phases_ms"] and nfa["batch"] == N_FLOWS
    assert nfa["impl_plan"] == world.engines["nfa-bitset"].impl_plan


@pytest.mark.parametrize("stream", ["row", "id"])
def test_capture_probe_report_has_the_reference_keys(world, stream):
    jrep, rep = world.replays(stream)
    sites = ("capture-h2d", "capture-chunk", "capture-gather",
             "capture-mapstate", "capture-resolve", "capture-step")
    h0, s0 = _marks(("h2d",) + phases.CAPTURE_PHASES, sites)
    report = phases.CapturePhaseProbe(rep).measure(0, 64, reps=2)
    h1, s1 = _marks(("h2d",) + phases.CAPTURE_PHASES, sites)
    assert _rose(h0, h1) and _rose(s0, s1)
    want = jph.CapturePhaseProbe(jrep).measure(0, 64, reps=1)
    assert set(report) == set(want)
    assert set(report["phases_ms"]) == set(want["phases_ms"])
    assert report["stream"] == want["stream"] == stream
    assert report["batch"] == 64
    with pytest.raises(ValueError, match="stage_rows"):
        phases.CapturePhaseProbe(CaptureReplay(
            rep.engine, *world.sections, None)).measure()
