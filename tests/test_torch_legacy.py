"""The port's legacy (unfused) verdict step and the entry points over
it against the JAX package's, exact on all ten lanes, on the CPU.

* ``verdict_step`` (and through it ``_verdict_core``, the per-rule
  resolve) equals the reference's ``verdict_step`` on a mutated http
  batch (empty and overlong paths, unmatched ports, egress, missing L7
  records — the edge cases of ``tests/test_torch_slice.py``), fed the
  reference's compiled arrays and the port's own;
* ``kernel_impl="legacy"`` and a policy whose resolve plan degenerated
  (``GROUP_CAP`` set to 1 around ``CompiledPolicy.build``) give the
  fused step's lanes (mirrors ``tests/test_megakernel.py``'s
  ``test_fused_legacy_knob_reverts_wholesale`` and
  ``test_plan_degenerate_falls_back_to_legacy_resolve``);
* ``verdict_flows_blob`` equals ``verdict_flows`` for http, fqdn and
  kafka, and enforces drop-until-authed through a padded batch
  (mirrors ``tests/test_blob_transport.py``);
* ``verdict_records`` and ``verdict_l7_records`` equal the reference's.

Inputs: synth http at 12 rules × 240 flows, fqdn at 6 × 180, kafka at
12 × 200, realized in both packages from one seed.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cilium_tpu.core.config import EngineConfig as JaxEngineConfig
from cilium_tpu.engine import megakernel as jax_mk
from cilium_tpu.engine import verdict as jax_verdict

from cilium_tpu_torch.core.config import EngineConfig
from cilium_tpu_torch.engine import megakernel as mk
from cilium_tpu_torch.engine.compiled import (
    CompiledPolicy,
    encode_flows,
    flowbatch_to_host_dict,
)
from cilium_tpu_torch.engine.verdict import (
    OUTPUT_LANES,
    TorchVerdictEngine,
    batch_to_device,
    verdict_step,
)
from cilium_tpu_torch.ingest import binary
from cilium_tpu_torch.weights import arrays_from_reference

SIZES = {"http": (12, 240), "fqdn": (6, 180), "kafka": (12, 200)}


def _mutate(flows, flow_mod):
    """Deterministic edge cases, applied alike to both packages' flows."""
    for i, f in enumerate(flows):
        if i % 17 == 0:
            f.http.path = ""
        if i % 19 == 0:
            f.http.path = "/" + "a" * 300          # past the 256 bucket
        if i % 23 == 0:
            f.dport = 8080                         # no L4 entry
        if i % 29 == 0:
            f.l7 = flow_mod.L7Type.NONE
        if i % 31 == 0:
            f.direction = flow_mod.TrafficDirection.EGRESS
        if i % 37 == 0:
            f.http.method = ""
        if i % 13 == 0:
            f.http.host = f.http.host.upper()
    return flows


def _realize(pkg, name):
    root = "cilium_tpu" if pkg == "jax" else "cilium_tpu_torch"
    pkg_synth = importlib.import_module(f"{root}.ingest.synth")
    flow_mod = importlib.import_module(f"{root}.core.flow")
    n_rules, n_flows = SIZES[name]
    pi, sc = pkg_synth.realize_scenario(
        pkg_synth.scenario_by_name(name, n_rules, n_flows))
    if name == "http":
        _mutate(sc.flows, flow_mod)
    return pi, sc


@pytest.fixture(scope="module")
def both():
    """name → (JAX policy, JAX flows, port policy, port flows)."""
    out = {}
    for name in SIZES:
        jpi, jsc = _realize("jax", name)
        pi, sc = _realize("port", name)
        out[name] = (jax_verdict.CompiledPolicy.build(jpi, JaxEngineConfig()),
                     jsc.flows, CompiledPolicy.build(pi, EngineConfig()),
                     sc.flows)
    return out


def _assert_lanes_equal(want, got, lanes=OUTPUT_LANES):
    for lane in lanes:
        a, b = np.asarray(want[lane]), np.asarray(got[lane])
        assert (a.shape, a.dtype) == (b.shape, b.dtype), lane
        np.testing.assert_array_equal(b, a, lane)


def _reference_legacy(jpol, jflows):
    host = jax_verdict.flowbatch_to_host_dict(
        jax_verdict.encode_flows(jflows, jpol.kafka_interns))
    out = jax.jit(jax_verdict.verdict_step)(
        {k: jnp.asarray(v) for k, v in jpol.arrays.items()},
        {k: jnp.asarray(v) for k, v in host.items()})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("arrays_from", ["reference", "port"])
def test_verdict_step_equals_reference(both, arrays_from):
    jpol, jflows, pol, flows = both["http"]
    want = _reference_legacy(jpol, jflows)
    arrays = arrays_from_reference(
        (jpol if arrays_from == "reference" else pol).arrays, "cpu")
    host = flowbatch_to_host_dict(encode_flows(flows, pol.kafka_interns))
    got = verdict_step(arrays, batch_to_device(host, "cpu"))
    assert set(got) == set(OUTPUT_LANES)
    _assert_lanes_equal(want, {k: v.numpy() for k, v in got.items()})
    assert {2, 5} <= set(want["verdict"].tolist())


@pytest.mark.parametrize("name", list(SIZES))
def test_legacy_knob_reverts_wholesale(both, name):
    jpol, jflows, pol, flows = both[name]
    cfg = EngineConfig()
    cfg.kernel_impl = "legacy"
    legacy = TorchVerdictEngine(pol, device="cpu", cfg=cfg)
    assert legacy.impl_plan == {} and legacy.kernel_report == {}
    fused = TorchVerdictEngine(pol, device="cpu")
    assert fused.impl_plan
    got = legacy.verdict_flows(flows)
    _assert_lanes_equal(fused.verdict_flows(flows), got)
    _assert_lanes_equal(_reference_legacy(jpol, jflows), got)


def _degenerate(pkg_mk, build, pi, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(pkg_mk, "GROUP_CAP", 1)
        return build(pi)


def test_degenerate_plan_falls_back_to_the_per_rule_resolve(monkeypatch):
    jpi, jsc = _realize("jax", "http")
    pi, sc = _realize("port", "http")
    jpol = _degenerate(jax_mk, lambda p: jax_verdict.CompiledPolicy.build(
        p, JaxEngineConfig()), jpi, monkeypatch)
    pol = _degenerate(mk, lambda p: CompiledPolicy.build(
        p, EngineConfig()), pi, monkeypatch)
    assert pol.resolve_meta is None
    assert not any(k.startswith("rp_") for k in pol.arrays)
    assert sorted(pol.arrays) == sorted(jpol.arrays)
    engine = TorchVerdictEngine(pol, device="cpu")
    got = engine.verdict_flows(sc.flows)
    # the reference's engine on its degenerate policy (fused step,
    # per-rule resolve) and its legacy step agree with the port's
    want = {k: np.asarray(v) for k, v in
            jax_verdict.VerdictEngine(jpol).verdict_flows(jsc.flows).items()}
    _assert_lanes_equal(want, got)
    _assert_lanes_equal(_reference_legacy(jpol, jsc.flows), got)
    # the reference's arrays without rp_* stage and run on the port too
    host = flowbatch_to_host_dict(encode_flows(sc.flows, pol.kafka_interns))
    direct = mk.fused_verdict_step(arrays_from_reference(jpol.arrays, "cpu"),
                                   batch_to_device(host, "cpu"),
                                   impl_plan=tuple(engine.impl_plan.items()))
    _assert_lanes_equal(want, {k: v.numpy() for k, v in direct.items()})
    # the attribution lane is in rule space here, the rest equals the
    # planned policy's fused step
    planned = TorchVerdictEngine(CompiledPolicy.build(pi, EngineConfig()),
                                 device="cpu").verdict_flows(sc.flows)
    _assert_lanes_equal(planned, got,
                        [lane for lane in OUTPUT_LANES if lane != "l7_match"])


@pytest.mark.parametrize("name", list(SIZES))
def test_blob_equals_multiarray(both, name):
    jpol, jflows, pol, flows = both[name]
    engine = TorchVerdictEngine(pol, device="cpu")
    got = engine.verdict_flows_blob(flows)
    _assert_lanes_equal(engine.verdict_flows(flows), got)
    _assert_lanes_equal(jax_verdict.VerdictEngine(jpol)
                        .verdict_flows_blob(jflows), got)


def test_blob_enforces_auth_and_padded_path():
    from cilium_tpu_torch.core.flow import Flow, Protocol
    from cilium_tpu_torch.core.identity import IdentityAllocator
    from cilium_tpu_torch.core.labels import LabelSet
    from cilium_tpu_torch.policy.api import (
        EndpointSelector,
        IngressRule,
        PortProtocol,
        PortRule,
        Rule,
    )
    from cilium_tpu_torch.policy.mapstate import PolicyResolver
    from cilium_tpu_torch.policy.repository import Repository
    from cilium_tpu_torch.policy.selectorcache import SelectorCache

    rules = [Rule(
        endpoint_selector=EndpointSelector.from_labels(app="pay"),
        ingress=(IngressRule(
            from_endpoints=(EndpointSelector.from_labels(app="cart"),),
            auth_mode="required",
            to_ports=(PortRule(
                ports=(PortProtocol(8443, Protocol.TCP),)),)),),
    )]
    alloc = IdentityAllocator()
    pay = alloc.allocate(LabelSet.from_dict({"app": "pay"}))
    cart = alloc.allocate(LabelSet.from_dict({"app": "cart"}))
    repo = Repository()
    repo.add(rules, sanitize=False)
    per_identity = {pay: PolicyResolver(repo, SelectorCache(alloc)).resolve(
        alloc.lookup(pay))}
    engine = TorchVerdictEngine(CompiledPolicy.build(per_identity),
                                device="cpu")
    flows = [Flow(src_identity=cart, dst_identity=pay, dport=8443)] * 3
    # the padded entry: a non-pow2 batch padded with identity-0 flows
    padded = flows + [Flow()]
    for pairs, want in (
            (None, 2),                                     # fail closed
            (np.array([[cart, pay]], dtype=np.int32), 1)):  # authed
        got = engine.verdict_flows_blob(flows, authed_pairs=pairs)
        assert got["verdict"].tolist() == [want] * 3
        got_padded = engine.verdict_flows_blob(padded, authed_pairs=pairs)
        assert got_padded["verdict"][:3].tolist() == [want] * 3


@pytest.mark.parametrize("name", list(SIZES))
def test_record_entry_points_equal_reference(both, name, tmp_path):
    jpol, _, pol, flows = both[name]
    path = str(tmp_path / "c.bin")
    binary.write_capture_l7(path, flows)
    rec = np.asarray(binary.map_capture(path))
    l7, offsets, blob = binary.read_l7_sidecar(path)
    widths = binary.capture_field_widths(l7, offsets)
    jeng = jax_verdict.VerdictEngine(jpol)
    engine = TorchVerdictEngine(pol, device="cpu")
    _assert_lanes_equal(jeng.verdict_records(rec),
                        engine.verdict_records(rec))
    got = engine.verdict_l7_records(rec, l7, offsets, blob, widths=widths)
    _assert_lanes_equal(jeng.verdict_l7_records(rec, l7, offsets, blob,
                                                widths=widths), got)
    # the capture replays as the flows it was written from
    _assert_lanes_equal(engine.verdict_flows(flows), got)
