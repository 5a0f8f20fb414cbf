"""The port's capture format and capture featurizers against the JAX
package's, exact on every byte, row, id and lane.

* the writer gives byte-identical files to the reference's
  ``write_capture_l7`` for the same flows (http, fqdn, kafka, and a v3
  capture with generic records); the reader returns the reference's
  ``rec``, ``l7``, ``offsets``, ``blob`` and GENERIC section; and
  ``capture_field_widths`` and the columnar encoder agree (mirrors
  ``tests/test_ingest_columnar.py``'s encoder and writer checks);
* ``CaptureFeaturizer`` tables, LUTs and ``encode_rows``, and the
  ``FlowBatch`` of ``encode_records`` and ``encode_l7_records``, equal
  the reference's;
* a v3 capture with generic records raises ``NotImplementedError``
  naming Q5 on every replay path of the port.

Inputs: the synth scenarios at 12 rules × 240 flows (http), 6 × 180
(fqdn) and 12 × 200 (kafka), realized in both packages from the same
seed, with some http flows mutated alike in both (empty and overlong
paths, upper-cased hosts, long header blocks).
"""

import numpy as np
import pytest

from cilium_tpu.core.config import EngineConfig as JaxEngineConfig
from cilium_tpu.engine import verdict as jax_verdict
from cilium_tpu.ingest import binary as jax_binary
from cilium_tpu.ingest import columnar as jax_columnar
from cilium_tpu.ingest import synth as jax_synth

from cilium_tpu_torch.core.config import EngineConfig
from cilium_tpu_torch.engine import compiled
from cilium_tpu_torch.engine.compiled import CompiledPolicy
from cilium_tpu_torch.engine.replay import CaptureReplay
from cilium_tpu_torch.engine.verdict import TorchVerdictEngine
from cilium_tpu_torch.ingest import binary, columnar, synth

#: scenario → (rules, flows)
SIZES = {"http": (12, 240), "fqdn": (6, 180), "kafka": (12, 200)}


def _mutate_http(flows):
    """Edge cases of the string tables, alike in both packages."""
    for i, f in enumerate(flows):
        if f.http is None:
            continue
        if i % 17 == 0:
            f.http.path = ""
        if i % 19 == 0:
            f.http.path = "/" + "a" * 300          # past the 256 cap
        if i % 13 == 0:
            f.http.host = f.http.host.upper()
        if i % 11 == 0:
            f.http.headers = (("X-Long", "v" * 40),) * 3
    return flows


def _realize(pkg_synth, name):
    n_rules, n_flows = SIZES[name]
    pi, sc = pkg_synth.realize_scenario(
        pkg_synth.scenario_by_name(name, n_rules, n_flows))
    if name == "http":
        _mutate_http(sc.flows)
    return pi, sc


@pytest.fixture(scope="module")
def both():
    """name → ((JAX per-identity, scenario, policy), (port ...))."""
    out = {}
    for name in SIZES:
        jpi, jsc = _realize(jax_synth, name)
        pi, sc = _realize(synth, name)
        out[name] = (
            (jpi, jsc, jax_verdict.CompiledPolicy.build(
                jpi, JaxEngineConfig())),
            (pi, sc, CompiledPolicy.build(pi, EngineConfig())))
    return out


def _write_both(tmp_path, jflows, flows):
    a, b = str(tmp_path / "ref.bin"), str(tmp_path / "port.bin")
    n_ref = jax_binary.write_capture_l7(a, jflows)
    n_port = binary.write_capture_l7(b, flows)
    assert n_ref == n_port == len(flows)
    return a, b


def _port_generic_flows(jflows):
    """The reference's flows, rebuilt as the port's Flow objects."""
    from cilium_tpu_torch.core import flow as pf

    out = []
    for f in jflows:
        out.append(pf.Flow(
            src_identity=f.src_identity, dst_identity=f.dst_identity,
            dport=f.dport, protocol=pf.Protocol(int(f.protocol)),
            direction=pf.TrafficDirection(int(f.direction)),
            l7=pf.L7Type(int(f.l7)),
            generic=(pf.GenericL7Info(proto=f.generic.proto,
                                      fields=dict(f.generic.fields))
                     if f.generic is not None else None)))
    return out


def _assert_arrays_equal(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape
    assert want.tobytes() == got.tobytes()


@pytest.mark.parametrize("name", list(SIZES))
def test_writer_is_byte_identical_and_reader_agrees(both, name,
                                                    tmp_path):
    (_, jsc, _), (_, sc, _) = both[name]
    a, b = _write_both(tmp_path, jsc.flows, sc.flows)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert binary.capture_version(b) == jax_binary.capture_version(a) == 2
    assert binary.capture_count(b) == jax_binary.capture_count(a)
    _assert_arrays_equal(jax_binary.map_capture(a), binary.map_capture(b))
    for want, got in zip(jax_binary.read_l7_sidecar(a),
                         binary.read_l7_sidecar(b)):
        _assert_arrays_equal(want, got)
    assert binary.read_gen_sidecar(b) is None
    l7, offsets, _ = binary.read_l7_sidecar(b)
    assert binary.capture_field_widths(l7, offsets) == \
        jax_binary.capture_field_widths(l7, offsets)


@pytest.mark.parametrize("name", list(SIZES))
def test_columnar_encoder_equals_reference(both, name):
    (_, jsc, _), (_, sc, _) = both[name]
    want = jax_columnar.flows_to_columns(jsc.flows)
    got = columnar.flows_to_columns(sc.flows)
    for k in ("rec", "l7", "offsets", "blob"):
        _assert_arrays_equal(getattr(want, k), getattr(got, k))
    assert (got.gen, got.fmax, got.gen_dropped) == \
        (None, want.fmax, want.gen_dropped)
    _assert_arrays_equal(jax_binary.flows_to_records(jsc.flows),
                         binary.flows_to_records(sc.flows))


def _v3_flows():
    _, jsc = jax_synth.realize_scenario(
        jax_synth.scenario_by_name("generic", 6, 40))
    return jsc.flows, _port_generic_flows(jsc.flows)


def test_v3_capture_bytes_and_generic_section(tmp_path):
    jflows, flows = _v3_flows()
    a, b = _write_both(tmp_path, jflows, flows)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert binary.capture_version(b) == binary.VERSION_L7G
    _assert_arrays_equal(jax_binary.read_gen_sidecar(a),
                         binary.read_gen_sidecar(b))


def test_v3_generic_replay_raises_naming_q5(both, tmp_path):
    """The GENERIC section's l7g columns need the protocol frontends:
    every replay path refuses a v3 capture, naming queue 1's Q5."""
    _, flows = _v3_flows()
    path = str(tmp_path / "v3.bin")
    binary.write_capture_l7(path, flows)
    rec = binary.map_capture(path)
    l7, offsets, blob = binary.read_l7_sidecar(path)
    gen = binary.read_gen_sidecar(path)
    pol = both["http"][1][2]
    engine = TorchVerdictEngine(pol, device="cpu")
    with pytest.raises(NotImplementedError, match="Q5"):
        CaptureReplay(engine, l7, offsets, blob, gen=gen)
    with pytest.raises(NotImplementedError, match="Q5"):
        engine.verdict_l7_records(rec, l7, offsets, blob, gen=gen)
    with pytest.raises(NotImplementedError, match="Q5"):
        compiled.CaptureFeaturizer(l7, offsets, blob, pol.kafka_interns,
                                   gen=gen)


def _sections(tmp_path, flows):
    path = str(tmp_path / "c.bin")
    binary.write_capture_l7(path, flows)
    rec = np.asarray(binary.map_capture(path))
    return (rec, *binary.read_l7_sidecar(path))


@pytest.mark.parametrize("name", list(SIZES))
def test_capture_featurizer_equals_reference(both, name, tmp_path):
    (_, _, jpol), (_, sc, pol) = both[name]
    assert jpol.kafka_interns == pol.kafka_interns
    rec, l7, offsets, blob = _sections(tmp_path, sc.flows)
    want = jax_verdict.CaptureFeaturizer(l7, offsets, blob,
                                         jpol.kafka_interns)
    got = compiled.CaptureFeaturizer(l7, offsets, blob, pol.kafka_interns)
    assert got.widths == want.widths
    assert sorted(got.tables) == sorted(want.tables)
    for field in want.tables:
        for w, g in zip(want.tables[field], got.tables[field]):
            _assert_arrays_equal(w, g)
    assert sorted(got.luts) == sorted(want.luts)
    for k in want.luts:
        _assert_arrays_equal(want.luts[k], got.luts[k])
    _assert_arrays_equal(want.encode_rows(rec, l7),
                         got.encode_rows(rec, l7))
    assert compiled._ROW_COLS == jax_verdict._ROW_COLS


def _assert_host_dicts_equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        _assert_arrays_equal(want[k], got[k])


@pytest.mark.parametrize("name", list(SIZES))
def test_record_encoders_equal_reference(both, name, tmp_path):
    (_, _, jpol), (_, sc, pol) = both[name]
    rec, l7, offsets, blob = _sections(tmp_path, sc.flows)
    widths = binary.capture_field_widths(l7, offsets)
    for w in (None, widths):
        _assert_host_dicts_equal(
            jax_verdict.flowbatch_to_host_dict(
                jax_verdict.encode_l7_records(
                    rec, l7, offsets, blob, jpol.kafka_interns,
                    widths=w)),
            compiled.flowbatch_to_host_dict(
                compiled.encode_l7_records(
                    rec, l7, offsets, blob, pol.kafka_interns,
                    widths=w)))
    _assert_host_dicts_equal(
        jax_verdict.flowbatch_to_host_dict(
            jax_verdict.encode_records(rec)),
        compiled.flowbatch_to_host_dict(compiled.encode_records(rec)))


def test_blob_layout_equals_reference(both):
    (_, jsc, jpol), (_, sc, pol) = both["http"]
    want_blob, want_layout = jax_verdict.pack_blob_host(
        jax_verdict.flowbatch_to_host_dict(jax_verdict.encode_flows(
            jsc.flows, jpol.kafka_interns)))
    got_blob, got_layout = compiled.pack_blob_host(
        compiled.flowbatch_to_host_dict(compiled.encode_flows(
            sc.flows, pol.kafka_interns)))
    assert got_layout == want_layout
    _assert_arrays_equal(want_blob, got_blob)


def test_pad_rows_pow2_equals_reference():
    rng = np.random.default_rng(3)
    for n in (1, 2, 3, 5, 8, 100):
        a = rng.integers(0, 9, (n, 4)).astype(np.int32)
        b = rng.integers(0, 2, (n,)).astype(bool)
        for w, g in zip(jax_verdict._pad_rows_pow2(a, b),
                        compiled._pad_rows_pow2(a, b)):
            _assert_arrays_equal(w, g)
