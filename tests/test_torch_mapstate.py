"""The port's L3/L4 mapstate lookup against the JAX package's, on
hypothesis-random tables with deny/allow precedence, wildcards, port
RANGES (prefix-length keys) and ICMP types (mirrors
``tests/test_mapstate.py``). Every output lane must be equal, and the
two packages must pack the same tables byte for byte."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cilium_tpu.engine import mapstate_kernel as jax_ms_kernel
from cilium_tpu.policy import mapstate as jax_ms

from cilium_tpu_torch.engine import mapstate_kernel as ms_kernel
from cilium_tpu_torch.policy import mapstate as tms
from cilium_tpu_torch.weights import stage_array

TCP, UDP, ICMP, ICMP6 = 6, 17, 1, 58
LANES = ("allowed", "denied", "redirect", "ruleset", "match_spec",
         "auth_required", "audit")
PEERS = [0, 100, 200, 300]
#: (port, prefix length) of table entries: wildcard, exact ports, ICMP
#: types 8 and 0, and two port ranges
ENTRY_PORTS = [(0, 0), (53, 16), (80, 16), (443, 16), (8, 16), (0, 16),
               (8080, 13), (1024, 6)]

entry_st = st.tuples(
    st.sampled_from(PEERS),                          # peer identity
    st.sampled_from(ENTRY_PORTS),
    st.sampled_from([0, TCP, UDP, ICMP]),
    st.sampled_from([0, 1]),                         # direction
    st.booleans(),                                   # deny
    st.booleans(),                                   # auth
    st.booleans(),                                   # L7 redirect
)
identity_st = st.tuples(
    st.lists(entry_st, max_size=20),
    st.booleans(), st.booleans(), st.booleans())     # enforced in/eg, audit


def _mapstate(pkg, entries, ing, eg, audit):
    from cilium_tpu.policy.api.l7 import L7Rules as JL7, PortRuleHTTP as JH
    from cilium_tpu_torch.policy.api.l7 import L7Rules as TL7
    from cilium_tpu_torch.policy.api.l7 import PortRuleHTTP as TH

    L7, H = (JL7, JH) if pkg is jax_ms else (TL7, TH)
    ms = pkg.MapState()
    ms.ingress_enforced, ms.egress_enforced, ms.audit = ing, eg, audit
    for peer, (port, plen), proto, d, deny, auth, l7 in entries:
        if plen == 16:
            # ICMP types key with the marker bit, as the resolver does
            port = pkg.effective_dport(port, proto)
        key = pkg.MapStateKey(peer, port, proto, d, port_plen=plen)
        ms.insert(key, pkg.MapStateEntry(
            is_deny=deny, auth_required=auth, auth_explicit=auth,
            l7_rules=((L7(http=(H(path=f"/p{port}"),)),) if l7 else ())))
    return ms


_jax_lookup = jax.jit(jax_ms_kernel.mapstate_lookup)


PROBE_EPS = [1000, 2000, 3000, 4000]        # 4000: no policy
PROBE_PEERS = PEERS + [999]
PROBE_PORTS = [0, 8, 53, 80, 443, 8080, 8087, 1030, 5000]
PROBE_PROTOS = [TCP, UDP, ICMP, ICMP6]


@settings(max_examples=25, deadline=None)
@given(st.lists(identity_st, min_size=1, max_size=3),
       st.lists(st.tuples(st.sampled_from(PROBE_EPS),
                          st.sampled_from(PROBE_PEERS),
                          st.sampled_from(PROBE_PORTS),
                          st.sampled_from(PROBE_PROTOS),
                          st.sampled_from([0, 1])),
                min_size=1, max_size=40))
def test_lookup_equals_reference(idents, probes):
    _check_lookup(idents, probes)


@pytest.mark.parametrize("seed", range(5))
def test_seeded_tables_equal_reference(seed):
    """Seeded counterpart of the hypothesis test (the reference suite's
    ``test_kernel_matches_golden_model`` shape): three identities with
    up to 30 random entries each, 40 random probes."""
    rng = random.Random(seed)
    idents = [([(rng.choice(PEERS), rng.choice(ENTRY_PORTS),
                 rng.choice([0, TCP, UDP, ICMP]), rng.choice([0, 1]),
                 rng.random() < 0.3, rng.random() < 0.2,
                 rng.random() < 0.3) for _ in range(rng.randint(0, 30))],
               rng.random() < 0.7, rng.random() < 0.5, rng.random() < 0.2)
              for _ in range(3)]
    probes = [(rng.choice(PROBE_EPS), rng.choice(PROBE_PEERS),
               rng.choice(PROBE_PORTS), rng.choice(PROBE_PROTOS),
               rng.choice([0, 1])) for _ in range(40)]
    _check_lookup(idents, probes)


def _check_lookup(idents, probes):
    eps = (1000, 2000, 3000)
    jtables = {ep: _mapstate(jax_ms, *spec)
               for ep, spec in zip(eps, idents)}
    ttables = {ep: _mapstate(tms, *spec)
               for ep, spec in zip(eps, idents)}

    def ruleset_of(ep, key, entry):
        return key.dport % 7
    jp = jax_ms_kernel.pack_mapstate(jtables, ruleset_of_entry=ruleset_of)
    tp = ms_kernel.pack_mapstate(ttables, ruleset_of_entry=ruleset_of)
    for f in ("key_w0", "key_w1", "key_w2", "is_deny", "ruleset_id",
              "auth", "enf_ids", "enf_flags", "tmpl_ids", "port_plens"):
        np.testing.assert_array_equal(getattr(jp, f), getattr(tp, f))

    # a fixed probe count keeps the jitted reference at one compile per
    # table shape
    probes = (probes * 40)[:40]
    cols = [np.array(c, dtype=np.int32) for c in zip(*probes)]
    tables = (tp.key_w0, tp.key_w1, tp.key_w2, tp.is_deny, tp.ruleset_id,
              tp.enf_ids, tp.enf_flags)
    want = _jax_lookup(
        *(jnp.asarray(a) for a in tables), *(jnp.asarray(c) for c in cols),
        auth=jnp.asarray(tp.auth), port_plens=jnp.asarray(tp.port_plens),
        tmpl_ids=jnp.asarray(tp.tmpl_ids))
    cpu = torch.device("cpu")
    got = ms_kernel.mapstate_lookup(
        *(stage_array(a, cpu) for a in tables),
        *(stage_array(c, cpu) for c in cols),
        auth=stage_array(tp.auth, cpu),
        port_plens=stage_array(tp.port_plens, cpu),
        tmpl_ids=stage_array(tp.tmpl_ids, cpu))
    for lane in LANES:
        np.testing.assert_array_equal(got[lane].numpy(),
                                      np.asarray(want[lane]), lane)


def test_empty_table_and_unknown_identity():
    """No identities at all: the sentinel row and sentinel enforcement
    row must not be matched, and an unknown endpoint defaults to
    allow."""
    tp = ms_kernel.pack_mapstate({})
    cpu = torch.device("cpu")
    cols = [np.array(v, dtype=np.int32)
            for v in ([5, 6], [0, 7], [80, 0], [TCP, ICMP], [0, 1])]
    tables = (tp.key_w0, tp.key_w1, tp.key_w2, tp.is_deny, tp.ruleset_id,
              tp.enf_ids, tp.enf_flags)
    got = ms_kernel.mapstate_lookup(
        *(stage_array(a, cpu) for a in tables),
        *(stage_array(c, cpu) for c in cols),
        tmpl_ids=stage_array(tp.tmpl_ids, cpu))
    want = jax_ms_kernel.mapstate_lookup(
        *(jnp.asarray(a) for a in tables), *(jnp.asarray(c) for c in cols),
        tmpl_ids=jnp.asarray(tp.tmpl_ids))
    for lane in LANES:
        np.testing.assert_array_equal(got[lane].numpy(),
                                      np.asarray(want[lane]), lane)
    assert got["allowed"].all()
