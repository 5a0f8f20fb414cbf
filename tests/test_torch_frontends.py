"""The port's protocol frontends and ``l7proto`` rules against the JAX
package's, exact (every lane is an integer), on the CPU.

* the frontend registry: the ``l7proto`` universe, the family table,
  each frontend's lowering and scan value, ``UnknownL7ProtoError`` for a
  typo and ``SanitizeError`` for a rule no record could satisfy;
* ``CompiledPolicy.build``: every array byte-equal (``l7g_*``, ``fe_*``,
  ``gen_*``, ``rp_fe_*``, ``rp_gen_*`` included), the interns, the rule
  tables and the arm extras of ``plan_for_engine``, for the ``generic``
  and ``protocols`` scenarios, each frontend alone, a ``test.lineparser``
  policy (proxy-only: the generic pair path, no ``l7g``), http and
  frontend rules on one endpoint, and a policy with no frontend rules;
* ``encode_flows``, byte-equal;
* the fused step under ``auto``, ``nfa-bitset`` and the oblivious DFA
  arm (the JAX side runs its Pallas kernels in interpret mode) and the
  legacy step, all ten lanes (``MEMO_COLS``), on the reference's
  arrays and on the port's own engine;
* the attribution lane's decode (``flow_family`` and the shared ``fe``
  table);
* a hypothesis-random frontend bank, in the style of
  ``tests/test_megakernel.py``.

Inputs: the synth scenarios at 12–24 rules × 160–300 flows, realized in
both packages from one seed, with edge cases applied alike (a record on
another protocol's port, an absent scan field, an over-long scan value,
an unknown proto, a frontend record without its L7 type).
"""

import dataclasses
import enum
import importlib
import random
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import cilium_tpu.core.flow as jax_flow
import cilium_tpu.policy.api as jax_api
from cilium_tpu.core.config import EngineConfig as JaxEngineConfig
from cilium_tpu.engine import attribution as jax_attribution
from cilium_tpu.engine import megakernel as jax_mk
from cilium_tpu.engine import verdict as jax_verdict
from cilium_tpu.ingest import synth as jax_synth
from cilium_tpu.policy.compiler import frontends as jax_fe
from cilium_tpu.runtime import loadmodel as jax_loadmodel

import cilium_tpu_torch.core.flow as port_flow
import cilium_tpu_torch.policy.api as port_api
from cilium_tpu_torch.core.config import EngineConfig
from cilium_tpu_torch.engine import attribution
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
from cilium_tpu_torch.ingest import synth
from cilium_tpu_torch.policy.api.l7 import SanitizeError
from cilium_tpu_torch.policy.compiler import frontends
from cilium_tpu_torch.runtime import loadmodel
from cilium_tpu_torch.weights import arrays_from_reference

#: the two packages, by the modules a scenario builder needs
PKGS = {"jax": (jax_flow, jax_api, jax_synth),
        "port": (port_flow, port_api, synth)}

def to_reference(obj):
    """The JAX package's twin of a port policy-API or flow object: each
    dataclass rebuilt as the class of the same name in the reference's
    module of the same path, enums by value."""
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_reference(o) for o in obj)
    if isinstance(obj, dict):
        return {k: to_reference(v) for k, v in obj.items()}
    cls = type(obj)
    if not cls.__module__.startswith("cilium_tpu_torch."):
        return obj
    ref = getattr(importlib.import_module(
        cls.__module__.replace("cilium_tpu_torch.", "cilium_tpu.", 1)),
        cls.__qualname__)
    if isinstance(obj, enum.Enum):
        return ref(obj.value)
    return ref(**{f.name: to_reference(getattr(obj, f.name))
                  for f in dataclasses.fields(obj) if f.init})


def lineparser_scenario(pkg, n_rules: int = 12, n_flows: int = 200):
    """The port's ``synth_lineparser_scenario`` (a proxy-only proto: its
    records stay on the generic pair path); the reference has no such
    scenario, so its side realizes the twin of the port's rules and
    flows."""
    _, _, syn = pkg
    sc = synth.synth_lineparser_scenario(n_rules, n_flows)
    if syn is synth:
        return synth.realize_scenario(sc)
    per_identity, jsc = syn.realize_scenario(syn.SynthScenario(
        name=sc.name, rules=to_reference(sc.rules),
        endpoints=sc.endpoints, flows=to_reference(sc.flows)))
    for f in jsc.flows:
        f.src_identity, f.dst_identity = jsc.ids["client"], jsc.ids["liner"]
    return per_identity, jsc


def mixed_scenario(pkg, n_rules: int = 12, n_flows: int = 160):
    """http and frontend rule sets on one policy, as each package's
    serve soak builds it at a protocol mix (``loadmodel._build_policy``),
    the first ``n_flows`` of its two pools interleaved."""
    lm = loadmodel if pkg is PKGS["port"] else jax_loadmodel
    per_identity, http_flows, proto_flows = lm._build_policy(
        n_rules, 1, protocol_mix=0.2)
    flows = [f for pair in zip(http_flows, proto_flows) for f in pair]
    return per_identity, types.SimpleNamespace(flows=flows[:n_flows])


def single_frontend(proto):
    def build(pkg, n_rules=12, n_flows=200):
        _, _, syn = pkg
        return syn.realize_scenario(syn.synth_protocols_scenario(
            n_rules=n_rules, n_flows=n_flows, mix=((proto, 1.0),)))
    return build


def named(name):
    def build(pkg, n_rules, n_flows):
        _, _, syn = pkg
        return syn.realize_scenario(syn.scenario_by_name(name, n_rules,
                                                         n_flows))
    return build


#: scenario → (builder, n_rules, n_flows)
SCENARIOS = {
    "generic": (named("generic"), 12, 200),
    "protocols": (named("protocols"), 24, 300),
    "cassandra": (single_frontend("cassandra"), 12, 160),
    "memcache": (single_frontend("memcache"), 12, 160),
    "r2d2": (single_frontend("r2d2"), 12, 160),
    "lineparser": (lineparser_scenario, 12, 200),
    "mixed": (mixed_scenario, 12, 160),
    "http": (named("http"), 12, 160),
}


def mutate(flows, flow):
    """Deterministic edge cases, applied alike to both packages'
    flows."""
    for i, f in enumerate(flows):
        g = f.generic
        if g is None:
            continue
        if i % 11 == 0 and "query_table" in g.fields:
            g.fields["query_table"] = "ks." + "x" * 300   # past l7g_len
        if i % 13 == 0:
            g.fields.pop("key", None)                     # absent scan
            g.fields.pop("file", None)
        if i % 17 == 0:
            f.dport = 9042 if f.dport != 9042 else 11211  # wrong port
        if i % 19 == 0:
            g.proto = "nosuchproto"
        if i % 23 == 0:
            f.l7 = flow.L7Type.NONE
        if i % 29 == 0:
            f.generic = None
    return flows


def build_both(name):
    builder, n_rules, n_flows = SCENARIOS[name]
    (jpi, jsc), (pi, sc) = (builder(PKGS[p], n_rules, n_flows)
                            for p in ("jax", "port"))
    mutate(jsc.flows, jax_flow)
    mutate(sc.flows, port_flow)
    return (jpi, jsc), (pi, sc)


@pytest.fixture(scope="module")
def worlds():
    return {}


def world(worlds, name):
    if name not in worlds:
        worlds[name] = build_both(name)
    return worlds[name]


def assert_same_arrays(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), k


def assert_lanes_equal(want, got):
    assert set(got) == set(OUTPUT_LANES)
    for lane in OUTPUT_LANES:
        a, b = np.asarray(want[lane]), np.asarray(got[lane])
        assert (a.shape, a.dtype) == (b.shape, b.dtype), lane
        np.testing.assert_array_equal(b, a, lane)


def cfgs(mode="auto", bank_size=128):
    jcfg, cfg = JaxEngineConfig(), EngineConfig()
    for c in (jcfg, cfg):
        c.kernel_impl = mode
        c.bank_size = bank_size
    return jcfg, cfg


# ------------------------------------------------------------- registry --
def test_registry_equals_reference():
    assert frontends.known_l7protos() == jax_fe.known_l7protos()
    assert frontends.family_names() == jax_fe.family_names()
    assert frontends.PROTOS == tuple(jax_fe.frontends())
    assert frontends.MAX_FAMILY == jax_fe.MAX_FAMILY
    for proto in sorted(jax_fe.known_l7protos()) + ["nosuch"]:
        assert frontends.family_of(proto) == jax_fe.family_of(proto)
        assert frontends.family_name_of(proto) == \
            jax_fe.family_name_of(proto)
        want, got = jax_fe.get(proto), frontends.get(proto)
        assert (want is None) == (got is None)
        if got is not None:
            assert dataclasses_tuple(got.spec) == \
                dataclasses_tuple(want.spec)


def dataclasses_tuple(spec):
    return (spec.name, spec.family, spec.family_name, spec.fields,
            spec.scan_field)


#: (proto, rule pairs) → lowering cases: exact, presence-only scan
#: field, enum only, two exact scan values (dead), empty
LOWERINGS = [
    ("cassandra", (("query_action", "select"), ("query_table", "ks.t1"))),
    ("cassandra", (("query_table", ""),)),
    ("cassandra", (("query_action", "op0x0a"),)),
    ("cassandra", (("query_table", "a.b"), ("query_table", "c.d"))),
    ("memcache", (("cmd", "get"), ("key", "k+1*"))),
    ("memcache", (("cmd", ""), ("key", ""))),
    ("r2d2", (("cmd", "READ"), ("file", "f.dat"))),
    ("r2d2", ()),
]


@pytest.mark.parametrize("proto,pairs", LOWERINGS)
def test_lowering_and_scan_value_equal_reference(proto, pairs):
    assert frontends.get(proto).lower_rule(pairs) == \
        tuple_lowered(jax_fe.get(proto).lower_rule(pairs))
    fields = dict(pairs)
    assert frontends.scan_value(proto, fields) == \
        jax_fe.scan_value(proto, fields)


def tuple_lowered(lo):
    return frontends.LoweredRule(lo.pattern, lo.pairs, lo.dead)


#: l7proto rules a compile must refuse, and with what
BAD_RULES = [
    ("r2d2x", {"cmd": "READ"}, "UnknownL7ProtoError"),
    ("r2d2", {"flie": "a"}, "SanitizeError"),
    ("r2d2", {"cmd": "RAED"}, "SanitizeError"),
    ("memcache", {"cmd": "getx"}, "SanitizeError"),
    ("cassandra", {"query_action": "SELECT"}, "SanitizeError"),
    ("cassandra", {"query_table": "KS.T"}, "SanitizeError"),
]


def _policy_with(pkg, proto, rule):
    flow, api, _ = pkg
    mod = jax_mapstate if pkg is PKGS["jax"] else port_mapstate
    ms = mod.MapState()
    ms.insert(mod.MapStateKey(0, 4040, 6, 0), mod.MapStateEntry(
        l7_rules=(api.L7Rules(l7proto=proto,
                              l7=(api.PortRuleL7.from_dict(rule),)),)))
    return {1: ms}


import cilium_tpu.policy.mapstate as jax_mapstate  # noqa: E402
import cilium_tpu_torch.policy.mapstate as port_mapstate  # noqa: E402


@pytest.mark.parametrize("proto,rule,err", BAD_RULES)
def test_bad_rules_raise_as_in_reference(proto, rule, err):
    with pytest.raises(Exception) as want:
        jax_verdict.CompiledPolicy.build(
            _policy_with(PKGS["jax"], proto, rule))
    with pytest.raises(SanitizeError) as got:
        CompiledPolicy.build(_policy_with(PKGS["port"], proto, rule))
    assert type(want.value).__name__ == type(got.value).__name__ == err
    assert str(got.value) == str(want.value)
    if err == "UnknownL7ProtoError":
        assert isinstance(got.value, frontends.UnknownL7ProtoError)


# -------------------------------------------------------------- compile --
@pytest.mark.parametrize("mode,bank_size", [("auto", 128),
                                            ("nfa-bitset", 4)])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_compiled_arrays_byte_equal(worlds, name, mode, bank_size):
    (jpi, _), (pi, _) = world(worlds, name)
    jcfg, cfg = cfgs(mode, bank_size)
    jpol = jax_verdict.CompiledPolicy.build(jpi, jcfg)
    pol = CompiledPolicy.build(pi, cfg)
    assert_same_arrays(jpol.arrays, pol.arrays)
    assert jpol.kafka_interns == pol.kafka_interns
    assert jpol.gen_rules == pol.gen_rules
    assert jpol.fe_rules == pol.fe_rules
    assert (jpol.l7g_matcher is None) == (pol.l7g_matcher is None)
    for k in ("groups", "kafka_groups", "gen_groups", "fe_groups",
              "fe_group_rules", "gen_group_rules"):
        assert jpol.resolve_meta[k] == pol.resolve_meta[k], k
    jplan, jextra, _ = jax_mk.plan_for_engine(jpol, jcfg, True)
    plan, extra, _ = mk.plan_for_engine(pol, cfg, "cpu")
    assert jplan == plan
    assert_same_arrays(jextra, extra)
    has_l7g = name not in ("lineparser", "http")
    assert ("l7g_trans" in pol.arrays) == has_l7g
    assert ("l7g" in plan) == has_l7g
    if mode == "nfa-bitset" and has_l7g:
        assert plan["l7g"] == "nfa-bitset"
    if name == "lineparser":
        assert pol.gen_rules and not pol.fe_rules


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_encoded_flows_byte_equal(worlds, name):
    (jpi, jsc), (pi, sc) = world(worlds, name)
    jcfg, cfg = cfgs()
    jpol = jax_verdict.CompiledPolicy.build(jpi, jcfg)
    pol = CompiledPolicy.build(pi, cfg)
    assert_same_arrays(
        jax_verdict.flowbatch_to_host_dict(
            jax_verdict.encode_flows(jsc.flows, jpol.kafka_interns, jcfg)),
        flowbatch_to_host_dict(encode_flows(sc.flows, pol.kafka_interns,
                                            cfg)))


# ----------------------------------------------------------- fused step --
#: name → (kernel_impl, bank_size, JAX dfa_impl, port dfa_impl)
ARMS = {
    "auto": ("auto", 128, "gather", "gather"),
    "nfa-bitset": ("nfa-bitset", 4, "gather", "gather"),
    "oblivious": ("auto", 8, "pallas", "oblivious"),
    "legacy": ("legacy", 128, "gather", "gather"),
}
#: scenarios held on every arm (the others on auto)
ALL_ARMS = ("protocols", "lineparser", "mixed")


def _jax_step(jpol, jcfg, jax_dfa, host):
    if jcfg.kernel_impl == "legacy":
        step = jax.jit(jax_verdict.verdict_step)
        arrays, plan = jpol.arrays, {}
    else:
        plan, extra, _ = jax_mk.plan_for_engine(jpol, jcfg, True)
        arrays = {**jpol.arrays, **extra}
        step = jax.jit(lambda a, b, p=tuple(sorted(plan.items())):
                       jax_mk.fused_verdict_step(
                           a, b, impl_plan=p, dfa_impl=jax_dfa,
                           interpret=True, use_pallas_nfa=True))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out = step({k: jnp.asarray(v) for k, v in arrays.items()},
                   {k: jnp.asarray(v) for k, v in host.items()})
    return {k: np.asarray(v) for k, v in out.items()}, arrays, plan


@pytest.mark.parametrize("name,arm", [
    (n, a) for n in SCENARIOS for a in ARMS
    if a == "auto" or n in ALL_ARMS])
def test_fused_step_equals_reference(worlds, name, arm, monkeypatch):
    (jpi, jsc), (pi, sc) = world(worlds, name)
    mode, bank, jax_dfa, port_dfa = ARMS[arm]
    jcfg, cfg = cfgs(mode, bank)
    jpol = jax_verdict.CompiledPolicy.build(jpi, jcfg)
    host = jax_verdict.flowbatch_to_host_dict(
        jax_verdict.encode_flows(jsc.flows, jpol.kafka_interns, jcfg))
    want, arrays, plan = _jax_step(jpol, jcfg, jax_dfa, host)
    # the port's step on the reference's arrays
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        if arm == "legacy":
            got = verdict_step(arrays_from_reference(arrays, "cpu"),
                               batch_to_device(host, "cpu"))
        else:
            got = mk.fused_verdict_step(
                arrays_from_reference(arrays, "cpu"),
                batch_to_device(host, "cpu"),
                impl_plan=tuple(sorted(plan.items())), dfa_impl=port_dfa)
    assert_lanes_equal(want, {k: v.numpy() for k, v in got.items()})
    # the port's own engine over its own compiled policy
    monkeypatch.setenv("CILIUM_TPU_DFA_IMPL", jax_dfa)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        engine = TorchVerdictEngine(CompiledPolicy.build(pi, cfg),
                                    device="cpu", cfg=cfg)
        assert engine.impl_plan == plan
        assert_lanes_equal(want, engine.verdict_flows(sc.flows))
        assert_lanes_equal(want, engine.verdict_flows_blob(sc.flows))
    # both sides of the verdict, and the frontend lane really decides
    assert {2, 5} <= set(np.unique(want["verdict"]).tolist())
    if name != "http":
        gen = np.array([f.generic is not None for f in sc.flows])
        assert (want["l7_match"][gen] >= 0).any()


def test_no_frontend_rules_stage_no_l7g_arrays(worlds):
    """A policy without frontend rules stages no ``l7g`` array and
    scans five fields; frontend records against it match nothing."""
    (_, _), (pi, sc) = world(worlds, "http")
    pol = CompiledPolicy.build(pi, EngineConfig())
    assert not any(k.startswith(("l7g_", "fe_", "rp_fe_"))
                   for k in pol.arrays)
    assert mk.scan_fields(pol.arrays) == mk.SCAN_FIELDS
    (_, _), (_, psc) = world(worlds, "protocols")
    out = TorchVerdictEngine(pol, device="cpu").verdict_flows(
        psc.flows[:32])
    assert (out["l7_match"] == -1).all()


# ---------------------------------------------------------- attribution --
def _port_flow_of(f):
    return port_flow.Flow(
        l7=port_flow.L7Type(int(f.l7)),
        generic=(port_flow.GenericL7Info(proto=f.generic.proto,
                                         fields=dict(f.generic.fields))
                 if f.generic is not None else None))


@pytest.mark.parametrize("proto", ["cassandra", "memcache", "r2d2",
                                   "test.lineparser", "nosuchproto"])
def test_flow_family_equals_reference(proto):
    for l7 in (jax_flow.L7Type.GENERIC, jax_flow.L7Type.HTTP):
        f = jax_flow.Flow(l7=l7, generic=jax_flow.GenericL7Info(
            proto=proto, fields={}))
        assert attribution.flow_family(_port_flow_of(f)) == \
            jax_attribution.flow_family(f)


@pytest.mark.parametrize("name", ["protocols", "mixed", "lineparser"])
def test_fe_decode_equals_reference(worlds, name):
    """Every code of the attribution lane decodes to the reference's
    rule ids and bank keys, the ``fe`` table included."""
    (jpi, jsc), (pi, sc) = world(worlds, name)
    jpol = jax_verdict.CompiledPolicy.build(jpi, JaxEngineConfig())
    pol = CompiledPolicy.build(pi, EngineConfig())
    jmap = jax_attribution.AttributionMap.from_policy(jpol)
    pmap = attribution.AttributionMap.from_policy(pol)
    assert pmap.space == jmap.space
    assert pmap._members == jmap._members
    assert pmap._bank_of == jmap._bank_of
    out = TorchVerdictEngine(pol, device="cpu").verdict_flows(sc.flows)
    resolved = 0
    for f, jf, code in zip(sc.flows, jsc.flows, out["l7_match"].tolist()):
        fam = attribution.flow_family(f)
        assert fam == jax_attribution.flow_family(jf)
        assert pmap.resolve(fam, code) == jmap.resolve(fam, code)
        assert pmap.rule_label(fam, code) == jmap.rule_label(fam, code)
        resolved += pmap.resolve(fam, code) is not None
    assert resolved


# ------------------------------------------------------- random banks --
_SCAN = {"cassandra": "query_table", "memcache": "key", "r2d2": "file"}
_ENUM = {"cassandra": ("query_action", ("select", "insert", "drop")),
         "memcache": ("cmd", ("get", "set", "delete")),
         "r2d2": ("cmd", ("READ", "WRITE", "HALT"))}


def _random_world(pkg, seed, n_rules, n_flows):
    """One endpoint, the three frontends' ports, random rules and
    records over a small value alphabet (so rules and records collide)."""
    flow, api, syn = pkg
    rng = random.Random(seed)
    vals = ["a", "b", "ab", "a.b", ""]
    ports = []
    rules_of = {}
    for proto, port in syn.PROTOCOL_PORTS.items():
        rr = []
        for _ in range(rng.randrange(0, n_rules + 1)):
            r = {}
            if rng.random() < 0.7:
                r[_SCAN[proto]] = rng.choice(vals)
            if rng.random() < 0.6:
                key, enum = _ENUM[proto]
                r[key] = rng.choice(enum + ("",))
            rr.append(r)
        rules_of[proto] = rr
        ports.append(api.PortRule(
            ports=(api.PortProtocol(port, flow.Protocol.TCP),),
            rules=api.L7Rules(l7proto=proto, l7=tuple(
                api.PortRuleL7.from_dict(r) for r in rr))))
    rule = api.Rule(endpoint_selector=syn._sel(app="polysvc"),
                    ingress=(api.IngressRule(
                        from_endpoints=(syn._sel(app="client"),),
                        to_ports=tuple(ports)),),
                    labels=("synth=random",))
    flows = []
    for _ in range(n_flows):
        proto = rng.choice(sorted(syn.PROTOCOL_PORTS))
        fields = {}
        if rng.random() < 0.8:
            fields[_SCAN[proto]] = rng.choice(vals)
        if rng.random() < 0.8:
            key, enum = _ENUM[proto]
            fields[key] = rng.choice(enum)
        flows.append(flow.Flow(
            dport=syn.PROTOCOL_PORTS[rng.choice(sorted(syn.PROTOCOL_PORTS))
                                     if rng.random() < 0.2 else proto],
            protocol=flow.Protocol.TCP,
            direction=flow.TrafficDirection.INGRESS,
            l7=flow.L7Type.GENERIC,
            generic=flow.GenericL7Info(proto=proto, fields=fields)))
    sc = syn.SynthScenario(name="protocols", rules=[rule],
                           endpoints={"polysvc": {"app": "polysvc"},
                                      "client": {"app": "client"}},
                           flows=flows)
    return syn.realize_scenario(sc)


@settings(max_examples=6, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2 ** 16), n_rules=st.integers(0, 6))
def test_random_frontend_banks_equal_reference(seed, n_rules):
    (jpi, jsc), (pi, sc) = (_random_world(PKGS[p], seed, n_rules, 64)
                            for p in ("jax", "port"))
    jcfg, cfg = cfgs()
    jpol = jax_verdict.CompiledPolicy.build(jpi, jcfg)
    pol = CompiledPolicy.build(pi, cfg)
    assert_same_arrays(jpol.arrays, pol.arrays)
    host = jax_verdict.flowbatch_to_host_dict(
        jax_verdict.encode_flows(jsc.flows, jpol.kafka_interns, jcfg))
    want, _, _ = _jax_step(jpol, jcfg, "gather", host)
    got = TorchVerdictEngine(pol, device="cpu", cfg=cfg) \
        .verdict_flows(sc.flows)
    assert_lanes_equal(want, got)
