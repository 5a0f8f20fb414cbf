"""The port's load balancer against the JAX package's, exact, on the CPU.

* ``maglev_table`` over random backend sets and weights (zero weights
  included): identical tables;
* ``ServiceManager.pack()`` field by field after the same upserts,
  deletes, ``set_remote_backends`` and ``remove_remote_cluster``, and
  for the empty manager; ``select()`` on the same flows;
* ``lb_lookup`` on 2000 seeded flows through ``weights.
  lb_arrays_from_reference`` against the reference's kernel: VIPs above
  2**31 (LoadBalancer addresses), ClientIP-affinity services, a
  zero-weight service and unmatched flows; the empty manager's pack
  gives -1;
* ``toServices``: the port's ``PolicyResolver`` with the port's
  ``ServiceManager`` gives the reference's MapState entries for
  ``tests/test_to_services.py``'s ``CNP`` and ``CNP_BY_LABELS``.

Integer functions: the tolerance is 0.
"""

import dataclasses
import enum
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu import loadbalancer as jlb
from cilium_tpu.loadbalancer.service import _ip_u32

from cilium_tpu_torch import loadbalancer as plb
from cilium_tpu_torch.weights import LB_FIELDS, lb_arrays_from_reference

M = 1021  # a small prime keeps the tables quick; 16381 in production

PKGS = {"ref": jlb, "port": plb}


def _build(lb, seed=0, n_services=24, remote=True):
    """One seeded service world, built alike in either package: ClusterIP
    VIPs and LoadBalancer VIPs above 2**31, weights 0-3, terminating
    backends, ClientIP affinity on every fourth service, shared services
    with remote clusters' backends, then deletes and a cluster's
    removal."""
    rng = random.Random(seed)
    mgr = lb.ServiceManager(table_size=M)
    fes = []
    for i in range(n_services):
        if i % 3 == 0:
            vip = f"192.168.{i}.{rng.randrange(1, 255)}"
        elif i % 3 == 1:
            vip = f"203.0.113.{i}"
        else:
            vip = f"10.96.{i}.{rng.randrange(1, 255)}"
        fe = lb.Frontend(vip, rng.choice([53, 80, 443, 8080]),
                         rng.choice([6, 17]))
        n_b = rng.randrange(1, 9)
        backends = [lb.Backend(
            f"10.{i}.{j}.{rng.randrange(1, 255)}", 8000 + j,
            weight=rng.choice([1, 1, 2, 3, 0]) if i != 5 else 0,
            state=(lb.BackendState.TERMINATING if rng.random() < 0.1
                   else lb.BackendState.ACTIVE))
            for j in range(n_b)]
        mgr.upsert(lb.Service(
            fe, backends, svc_type=lb.ServiceType(i % 3),
            affinity=i % 4 == 0, name=f"svc{i}", namespace="default",
            labels={"team": f"t{i % 2}"}, shared=i % 5 == 0))
        fes.append(fe)
    if remote:
        for i in range(0, n_services, 5):
            for cluster in ("east", "west"):
                mgr.set_remote_backends(cluster, "default", f"svc{i}", [
                    lb.Backend(f"172.16.{i}.{k}", 9000 + k)
                    for k in range(rng.randrange(1, 4))])
        mgr.remove_remote_cluster("west")
        mgr.delete(fes[3])
        mgr.delete(lb.Frontend("1.2.3.4", 1))   # absent: a no-op
    return mgr, fes


def _flows(fes, n, seed=7):
    """(src ip, sport, dst ip, dport, proto): 80 % to frontends (some
    deleted), the rest to random addresses and ports."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        if rng.random() < 0.8:
            fe = rng.choice(fes)
            dst = (fe.ip, fe.port, fe.proto)
        else:
            dst = (f"{rng.randrange(256)}.{rng.randrange(256)}.0.9",
                   rng.randrange(1, 65536), rng.choice([6, 17]))
        out.append((f"{rng.randrange(256)}.{rng.randrange(256)}."
                    f"{rng.randrange(256)}.{rng.randrange(256)}",
                    rng.randrange(1024, 65536), *dst))
    return out


def _flow_columns(flows):
    return (np.array([_ip_u32(f[0]) for f in flows], np.uint32),
            np.array([f[1] for f in flows], np.int32),
            np.array([_ip_u32(f[2]) for f in flows], np.uint32),
            np.array([f[3] for f in flows], np.int32),
            np.array([f[4] for f in flows], np.int32))


def _ref_lookup(packed, cols):
    out = jlb.lb_lookup(*(jnp.asarray(getattr(packed, f))
                          for f in LB_FIELDS),
                        *(jnp.asarray(c) for c in cols))
    return {k: np.asarray(v).astype(np.int64) for k, v in out.items()}


def _port_lookup(packed, cols):
    arrays = lb_arrays_from_reference(packed, "cpu")
    flows = [torch.from_numpy(c.astype(np.int64) if c.dtype == np.uint32
                              else c) for c in cols]
    out = plb.lb_lookup(*arrays, *flows)
    return {k: v.numpy().astype(np.int64) for k, v in out.items()}


def _assert_same(got, want):
    assert set(got) == set(want) == {"backend", "ip", "port"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)


@pytest.fixture(scope="module")
def worlds():
    return {name: _build(lb) for name, lb in PKGS.items()}


def test_maglev_table_equal_on_random_backend_sets():
    rng = np.random.default_rng(3)
    for case in range(40):
        n = int(rng.integers(0, 12))
        names = [f"10.0.{case}.{i}:{int(rng.integers(1, 65536))}"
                 for i in range(n)]
        weights = [int(w) for w in rng.integers(0, 4, n)]
        if case % 4 == 0:
            weights = None
        m = int(rng.choice([7, 101, M]))
        want = jlb.maglev_table(list(range(n)), names, m=m, weights=weights)
        got = plb.maglev_table(list(range(n)), names, m=m, weights=weights)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert plb.DEFAULT_TABLE_SIZE == jlb.DEFAULT_TABLE_SIZE
    assert plb.fnv1a(b"10.0.0.1:80") == jlb.fnv1a(b"10.0.0.1:80")
    words = rng.integers(0, 2 ** 32, (50, 5), dtype=np.uint64) \
        .astype(np.uint32)
    np.testing.assert_array_equal(plb.fnv1a_words(words),
                                  jlb.fnv1a_words(words))
    a = plb.maglev_table([0, 1, 2], ["a", "b", "c"], m=101)
    b = plb.maglev_table([0, 1], ["a", "c"], m=101)
    assert plb.disruption(a, b) == jlb.disruption(a, b)


def test_pack_equal_field_by_field(worlds):
    (jmgr, _), (mgr, _) = worlds["ref"], worlds["port"]
    want, got = jmgr.pack(), mgr.pack()
    assert got.revision == want.revision and jmgr.revision == mgr.revision
    assert got.n_services == want.n_services
    for f in LB_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
    # the world holds VIPs above 2**31 and affinity services
    assert (want.svc_ip >= 2 ** 31).any() and want.svc_affinity.any()


def test_empty_manager_pack_equal_and_misses():
    want = jlb.ServiceManager(table_size=M).pack()
    got = plb.ServiceManager(table_size=M).pack()
    for f in LB_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.svc_ip[0] == 0xFFFFFFFF   # the sentinel, unsigned
    cols = _flow_columns([("1.0.0.1", 2, "255.255.255.255", 65535, 255),
                          ("0.0.0.3", 4, "0.0.0.0", 0, 0)])
    out = _port_lookup(got, cols)
    assert out["backend"].tolist() == [-1, -1]
    _assert_same(out, _ref_lookup(want, cols))


def test_lb_lookup_equal_to_the_reference_and_select(worlds):
    """2000 seeded flows through both packages' lookups on the same
    pack: the three outputs equal; and each equal to ``select()``."""
    (jmgr, fes), (mgr, _) = worlds["ref"], worlds["port"]
    flows = _flows(fes, 2000)
    cols = _flow_columns(flows)
    packed = mgr.pack()
    got = _port_lookup(packed, cols)
    want = _ref_lookup(jmgr.pack(), cols)
    _assert_same(got, want)
    # the reference's pack gives the same through the port's lookup
    _assert_same(_port_lookup(jmgr.pack(), cols), got)
    hits = 0
    for i, f in enumerate(flows):
        w = jmgr.select(*f)
        p = mgr.select(*f)
        assert (p is None) == (w is None), f
        if w is None:
            assert got["backend"][i] == -1, f
            continue
        hits += 1
        assert (p.ip, p.port) == (w.ip, w.port)
        assert (got["ip"][i], got["port"][i]) == (_ip_u32(w.ip), w.port)
    assert 1000 < hits < 2000
    high = cols[2] >= 2 ** 31
    assert (got["backend"][high] >= 0).sum() > 100


def test_lb_lookup_takes_int32_bit_patterns():
    """Addresses given as int32 bit patterns (negative above 2**31) are
    read as unsigned, as the reference's uint32 columns are."""
    mgr, fes = _build(plb, seed=2, n_services=9, remote=False)
    flows = _flows(fes, 300, seed=3)
    cols = _flow_columns(flows)
    packed = mgr.pack()
    arrays = lb_arrays_from_reference(packed, "cpu")
    as_i32 = [torch.from_numpy(c.view(np.int32) if c.dtype == np.uint32
                               else c) for c in cols]
    out = plb.lb_lookup(*arrays, *as_i32)
    _assert_same({k: v.numpy().astype(np.int64) for k, v in out.items()},
                 _port_lookup(packed, cols))


def test_lb_arrays_widen_the_uint32_columns():
    packed = plb.ServiceManager(table_size=M).pack()
    arrays = lb_arrays_from_reference(packed, "cpu")
    assert [a.dtype for a in arrays] == [torch.int64, torch.int64,
                                         torch.bool, torch.int32,
                                         torch.int64, torch.int32]
    assert int(arrays[0][0]) == 0xFFFFFFFF
    # the reference's pack stages to the same tensors
    ref = lb_arrays_from_reference(jlb.ServiceManager(table_size=M).pack(),
                                   "cpu")
    assert all(torch.equal(a, b) for a, b in zip(arrays, ref))


def test_select_affinity_and_zero_weight_equal():
    for lb in PKGS.values():
        mgr = lb.ServiceManager(table_size=M)
        mgr.upsert(lb.Service(lb.Frontend("10.96.0.30", 53, 17), [
            lb.Backend("10.0.3.1", 53), lb.Backend("10.0.3.2", 53)],
            affinity=True))
        mgr.upsert(lb.Service(lb.Frontend("10.96.0.9", 80), [
            lb.Backend("10.0.1.1", 80, weight=0)]))
        picks = {mgr.select("192.168.7.7", s, "10.96.0.30", 53, 17).ip
                 for s in range(1000, 1100)}
        assert len(picks) == 1
        assert mgr.select("192.168.0.1", 1234, "10.96.0.9", 80) is None
    j = jlb.ServiceManager(table_size=M)
    p = plb.ServiceManager(table_size=M)
    for mgr, lb in ((j, jlb), (p, plb)):
        mgr.upsert(lb.Service(lb.Frontend("10.96.0.30", 53, 17), [
            lb.Backend(f"10.0.3.{i}", 53) for i in range(7)],
            affinity=True))
    for s in range(200):
        src = f"192.168.{s}.{s % 7}"
        w = j.select(src, s, "10.96.0.30", 53, 17)
        g = p.select(src, s, "10.96.0.30", 53, 17)
        assert (g.ip, g.port) == (w.ip, w.port)


# -- toServices -------------------------------------------------------------

def _plain(x):
    """Dataclasses, enums and sets as plain comparable data."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            _plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return int(x.value)
    if isinstance(x, (set, frozenset)):
        return frozenset(_plain(v) for v in x)
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    return x


def _to_services_entries(pkg, cnp_text, services, remote=()):
    """The client's MapState entries in package ``pkg`` ("cilium_tpu" or
    "cilium_tpu_torch") for one CNP, over a fixed set of endpoints with
    IPs and ``services`` (name, labels, backend IPs, shared)."""
    import importlib

    mod = {m: importlib.import_module(f"{pkg}.{m}") for m in (
        "core.identity", "core.labels", "loadbalancer", "policy.api.cnp",
        "policy.mapstate", "policy.repository", "policy.selectorcache")}
    lb = mod["loadbalancer"]
    alloc = mod["core.identity"].IdentityAllocator()
    LabelSet = mod["core.labels"].LabelSet
    eps = {"client": ({"app": "client"}, None),
           "orders": ({"app": "orders-pod"}, "10.0.0.7"),
           "pay": ({"app": "pay"}, "10.0.0.9"),
           "other": ({"app": "other"}, "10.0.0.8"),
           "remote": ({"app": "remote"}, "172.16.0.5")}
    ip_to_id = {}
    for name, (labels, ip) in eps.items():
        nid = alloc.allocate(LabelSet.from_dict(labels))
        if ip is not None:
            ip_to_id[ip] = nid
    mgr = lb.ServiceManager(table_size=101)
    for i, (name, labels, ips, shared) in enumerate(services):
        mgr.upsert(lb.Service(
            lb.Frontend(f"10.96.0.{10 + i}", 8080),
            [lb.Backend(ip, 8080) for ip in ips], name=name,
            namespace="default", labels=labels, shared=shared))
    for cluster, name, ips in remote:
        mgr.set_remote_backends(cluster, "default", name,
                                [lb.Backend(ip, 8080) for ip in ips])
    repo = mod["policy.repository"].Repository()
    repo.add(mod["policy.api.cnp"].load_cnp_yaml_text(cnp_text)[0].rules)
    resolver = mod["policy.mapstate"].PolicyResolver(
        repo, mod["policy.selectorcache"].SelectorCache(alloc),
        services=mgr, backend_identity=ip_to_id.get)
    ms = resolver.resolve(LabelSet.from_dict({"app": "client"}))
    return _plain(ms.entries)


@pytest.mark.parametrize("case", ["by-name", "by-labels", "absent",
                                  "shared-remote"])
def test_to_services_resolves_as_the_reference(case):
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_to_services import CNP, CNP_BY_LABELS

    cnp, services, remote = {
        "by-name": (CNP, [("orders", {}, ["10.0.0.7"], False),
                          ("ads", {}, ["10.0.0.8"], False)], ()),
        "by-labels": (CNP_BY_LABELS, [
            ("payments", {"team": "payments"}, ["10.0.0.9"], False),
            ("ads", {"team": "ads"}, ["10.0.0.8"], False)], ()),
        "absent": (CNP, [("ads", {}, ["10.0.0.8"], False)], ()),
        "shared-remote": (CNP, [("orders", {}, ["10.0.0.7"], True)],
                          (("east", "orders", ["172.16.0.5"]),)),
    }[case]
    want = _to_services_entries("cilium_tpu", cnp, services, remote)
    got = _to_services_entries("cilium_tpu_torch", cnp, services, remote)
    assert got == want
    if case != "absent":
        assert want, "the rule must select the backends"
