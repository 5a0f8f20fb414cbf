"""The port's kvstore, cluster identity allocator and regeneration
debouncer (``kvstore.py``, ``core/identity_cache.py``,
``identity_kvstore.py``) against the JAX package's, on the CPU,
mirroring ``tests/test_identity_kvstore.py``, ``tests/dst/test_debounce.py``
and the kvstore half of ``tests/test_clustermesh.py``.

Every case runs one scenario in both packages, each under its own
``VirtualClock`` (the id claims carry a wall timestamp), and holds what
comes out equal: the numeric identities, the store's contents, the
watch events, the ``on_change`` notifications and the debouncer's fire
counts. The scenario also makes the reference test's own assertions.

``test_cross_node_policy_enforcement`` (two live agents over a served
kvstore, with the operator) is held in ``tests/test_torch_k8s_agent.py``.
"""

import importlib
import json
import threading
import types

import pytest

PKG_MODULES = (("labels", "core.labels"), ("identity", "core.identity"),
               ("kv", "kvstore"), ("ik", "identity_kvstore"),
               ("simclock", "runtime.simclock"), ("faults", "runtime.faults"),
               ("metrics", "runtime.metrics"))


def _pkg(root):
    ns = types.SimpleNamespace(root=root)
    for attr, mod in PKG_MODULES:
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX, PORT = _pkg("cilium_tpu"), _pkg("cilium_tpu_torch")


def _fmt(lbls):
    return None if lbls is None else tuple(sorted(lbls.format()))


def _both(scenario):
    """``scenario(p)`` in each package under its own virtual clock;
    both records, reference first."""
    out = []
    for p in (JAX, PORT):
        with p.simclock.use(p.simclock.VirtualClock(start=1000.0)):
            out.append(scenario(p))
    return out


def _labels(p, **kw):
    return p.labels.LabelSet.from_dict(kw)


# -- scenarios of tests/test_identity_kvstore.py ---------------------------


def _two_nodes_agree(p):
    store = p.kv.KVStore()
    a = p.ik.ClusterIdentityAllocator(store).start()
    b = p.ik.ClusterIdentityAllocator(store).start()
    try:
        nid_a = a.allocate(_labels(p, app="db"))
        nid_b = b.allocate(_labels(p, app="db"))
        assert nid_a == nid_b
        web = b.allocate(_labels(p, app="web"))
        assert web != nid_a
        assert a.lookup(web) == _labels(p, app="web")
        return {"ids": (nid_a, web), "store": store.list_prefix("")}
    finally:
        a.close()
        b.close()


def _remote_allocation_triggers_on_change(p):
    store = p.kv.KVStore()
    seen = []
    a = p.ik.ClusterIdentityAllocator(store).start()
    b = p.ik.ClusterIdentityAllocator(
        store, on_change=lambda nid, lbls: seen.append((nid, _fmt(lbls))))
    b.start()
    try:
        nid = a.allocate(_labels(p, app="remote"))
        assert (nid, _fmt(_labels(p, app="remote"))) in seen
        c = p.ik.ClusterIdentityAllocator(store).start()
        try:
            assert c.lookup_by_labels(_labels(p, app="remote")) == nid
        finally:
            c.close()
        return {"seen": seen, "store": store.list_prefix("")}
    finally:
        a.close()
        b.close()


def _readthrough_lookup_fires_on_change(p):
    store = p.kv.KVStore()
    a = p.ik.ClusterIdentityAllocator(store).start()
    seen = []
    b = p.ik.ClusterIdentityAllocator(
        store, on_change=lambda nid, lbls: seen.append((nid, _fmt(lbls))))
    try:
        nid = a.allocate(_labels(p, app="raced"))
        assert b.lookup_by_labels(_labels(p, app="raced")) == nid
        before = len(seen)
        b._on_event(p.kv.Event(
            p.kv.EVENT_CREATE, p.ik.VALUE_PREFIX + p.ik._encode_labels(
                _labels(p, app="raced")), str(int(nid))))
        assert len(seen) == before
        nid2 = a.allocate(_labels(p, app="raced2"))
        assert b.lookup(nid2) == _labels(p, app="raced2")
        return {"seen": seen}
    finally:
        a.close()
        b.close()


def _adoption_racing_delete_ends_removed(p):
    store = p.kv.KVStore()
    a = p.ik.ClusterIdentityAllocator(store).start()
    b = p.ik.ClusterIdentityAllocator(store)
    events = []

    def on_change(nid, lbls):
        events.append((nid, _fmt(lbls)))
        if lbls is not None and len(events) == 1:
            key = p.ik.VALUE_PREFIX + p.ik._encode_labels(lbls)
            store.delete(key)
            b._on_event(p.kv.Event(p.kv.EVENT_DELETE, key, str(int(nid))))

    b.on_change = on_change
    try:
        nid = a.allocate(_labels(p, app="ghost"))
        assert b.lookup_by_labels(_labels(p, app="ghost")) == nid
        assert events[-1] == (nid, None), events
        assert b.lookup_by_labels(_labels(p, app="ghost")) is None
        return {"events": events}
    finally:
        a.close()
        b.close()


def _stale_readthrough_never_clobbers(p):
    store = p.kv.KVStore()
    a = p.ik.ClusterIdentityAllocator(store).start()
    events = []
    b = p.ik.ClusterIdentityAllocator(
        store, on_change=lambda nid, lbls: events.append((nid, _fmt(lbls))))
    b.start()
    try:
        lbls = _labels(p, app="churny")
        old = a.allocate(lbls)
        key = p.ik.VALUE_PREFIX + p.ik._encode_labels(lbls)
        store.delete(key)
        store.delete(p.ik.ID_PREFIX + str(int(old)))
        new = int(old) + 100
        store.set(p.ik.ID_PREFIX + str(new), json.dumps(
            {"labels": sorted(lbls.format()), "ts": p.simclock.wall()}))
        store.set(key, str(new))
        assert b.lookup_by_labels(lbls) == new
        history = list(events)
        events.clear()
        b._adopt(int(old), lbls, 0)
        assert b.lookup_by_labels(lbls) == new
        assert events == []
        return {"history": history, "store": store.list_prefix("")}
    finally:
        a.close()
        b.close()


def _delete_mid_readthrough_stays_silent(p, on_change=True):
    store = p.kv.KVStore()
    events = []
    b = p.ik.ClusterIdentityAllocator(
        store, on_change=(lambda nid, lbls: events.append((nid, _fmt(lbls))))
        if on_change else None)
    lbls = _labels(p, app="gone")
    key = p.ik.VALUE_PREFIX + p.ik._encode_labels(lbls)
    try:
        store.set(key, "5000")
        gen = b._gen_of(lbls)
        raw = store.get(key)
        store.delete(key)
        b._on_event(p.kv.Event(p.kv.EVENT_DELETE, key, "5000"))
        b._adopt(int(raw), lbls, gen)
        assert events == []
        assert b.lookup_by_labels(lbls) is None
        assert b.lookup(5000) is None
        return {"gen_after": b._gen_of(lbls), "len": len(b)}
    finally:
        b.close()


def _create_after_adoption_residue(p):
    store = p.kv.KVStore()
    events = []
    b = p.ik.ClusterIdentityAllocator(
        store, on_change=lambda nid, lbls: events.append((nid, _fmt(lbls))))
    L = _labels(p, app="lag")
    key = p.ik.VALUE_PREFIX + p.ik._encode_labels(L)
    try:
        assert b._insert(1001, L, clobber=False) is False
        b._on_event(p.kv.Event(p.kv.EVENT_CREATE, key, "1000"))
        b._on_event(p.kv.Event(p.kv.EVENT_DELETE, key, "1000"))
        b._on_event(p.kv.Event(p.kv.EVENT_CREATE, key, "1001"))
        assert events[-1] == (1001, _fmt(L)), events
        assert b.lookup_by_labels(L) == 1001
        return {"events": events}
    finally:
        b.close()


def _concurrent_allocation_converges(p):
    store = p.kv.KVStore()
    allocators = [p.ik.ClusterIdentityAllocator(store).start()
                  for _ in range(4)]
    results = []
    barrier = threading.Barrier(4)

    def run(alloc):
        barrier.wait()
        results.append(alloc.allocate(_labels(p, app="contended")))

    threads = [threading.Thread(target=run, args=(a,)) for a in allocators]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads), "allocator hung"
        assert len(results) == 4 and len(set(results)) == 1, results
        return {"id": results[0],
                "values": store.list_prefix(p.ik.VALUE_PREFIX)}
    finally:
        for a in allocators:
            a.close()


def _losing_claim_never_poisons(p):
    store = p.kv.KVStore()
    a = p.ik.ClusterIdentityAllocator(store).start()
    try:
        lbls = _labels(p, app="contested")
        store.set(p.ik.ID_PREFIX + "777", json.dumps(
            {"labels": sorted(lbls.format()), "ts": p.simclock.wall()}))
        assert a.lookup_by_labels(lbls) is None
        nid = a.allocate(lbls)
        assert nid != 777
        a.lookup(777)
        assert a.lookup_by_labels(lbls) == nid
        return {"id": nid, "store": store.list_prefix("")}
    finally:
        a.close()


def _cidr_and_reserved_stay_off_the_store(p):
    store = p.kv.KVStore()
    a = p.ik.ClusterIdentityAllocator(store).start()
    try:
        nid = a.allocate(p.labels.LabelSet.parse(["cidr:10.0.0.0/8"]))
        assert nid >= 1 << 24
        reserved = {int(rid): a.allocate(lbls)
                    for rid, lbls in p.identity.RESERVED_LABELS.items()}
        assert all(k == v for k, v in reserved.items())
        assert not store.list_prefix(p.ik.ID_PREFIX)
        return {"cidr": nid, "reserved": sorted(reserved)}
    finally:
        a.close()


def _gc_reaps_orphans(p):
    store = p.kv.KVStore()
    a = p.ik.ClusterIdentityAllocator(store).start()
    gc0 = p.metrics.METRICS.get("cilium_tpu_operator_identities_gc_total")
    try:
        live = a.allocate(_labels(p, app="live"))
        store.set(p.ik.ID_PREFIX + "9999", json.dumps(
            {"labels": ["k8s:app=orphan"], "ts": p.simclock.wall() - 3600}))
        store.set(p.ik.ID_PREFIX + "9998", json.dumps(
            {"labels": ["k8s:app=inflight"], "ts": p.simclock.wall()}))
        store.set(p.ik.ID_PREFIX + "9997", "not json")
        reaped = p.ik.gc_orphan_identities(store)
        assert reaped == 2
        assert store.get(p.ik.ID_PREFIX + "9999") is None
        assert store.get(p.ik.ID_PREFIX + "9998") is not None
        assert store.get(p.ik.ID_PREFIX + str(int(live))) is not None
        return {"reaped": reaped, "store": store.list_prefix(""),
                "counted": p.metrics.METRICS.get(
                    "cilium_tpu_operator_identities_gc_total") - gc0}
    finally:
        a.close()


def _churn_sequence(p):
    """Allocate, delete straight in the store, re-allocate and replay:
    the store's contents, every notification and a fresh replaying
    allocator's view."""
    store = p.kv.KVStore()
    seen = []
    watcher = p.ik.ClusterIdentityAllocator(
        store, on_change=lambda nid, lbls: seen.append((nid, _fmt(lbls))))
    watcher.start()
    a = p.ik.ClusterIdentityAllocator(store).start()
    try:
        pool = [_labels(p, app=f"s{i}", tier=str(i % 3)) for i in range(12)]
        ids = [a.allocate(lbls) for lbls in pool]
        for lbls in pool[::3]:
            store.delete(p.ik.VALUE_PREFIX + p.ik._encode_labels(lbls))
        ids += [a.allocate(lbls) for lbls in pool]
        fresh = p.ik.ClusterIdentityAllocator(store).start()
        try:
            replay = [fresh.lookup_by_labels(lbls) for lbls in pool]
        finally:
            fresh.close()
        return {"ids": ids, "replay": replay, "seen": seen,
                "store": store.list_prefix(""), "revision": store.revision}
    finally:
        a.close()
        watcher.close()


def _max_id_retired_then_claimed_again(p):
    """The next id to claim after the largest cached id is retired
    (the port reads it off a heap, the reference scans the cache): the
    retired id's claim key still stands, so the claim moves past it."""
    store = p.kv.KVStore()
    seen = []
    a = p.ik.ClusterIdentityAllocator(store).start()
    b = p.ik.ClusterIdentityAllocator(
        store, on_change=lambda nid, lbls: seen.append((nid, _fmt(lbls))))
    b.start()
    try:
        ids = [a.allocate(_labels(p, app=f"m{i}")) for i in range(6)]
        for i in (5, 4):
            store.delete(p.ik.VALUE_PREFIX + p.ik._encode_labels(
                _labels(p, app=f"m{i}")))
        store.delete(p.ik.ID_PREFIX + str(ids[4]))
        ids += [b.allocate(_labels(p, app=f"n{i}")) for i in range(3)]
        ids += [a.allocate(_labels(p, app=f"m{i}")) for i in (4, 5)]
        return {"ids": ids, "seen": seen, "store": store.list_prefix("")}
    finally:
        a.close()
        b.close()


SCENARIOS = {
    "two_nodes_agree_on_identity": _two_nodes_agree,
    "max_id_retired_then_claimed_again": _max_id_retired_then_claimed_again,
    "remote_allocation_triggers_on_change":
        _remote_allocation_triggers_on_change,
    "readthrough_lookup_fires_on_change": _readthrough_lookup_fires_on_change,
    "readthrough_adoption_racing_delete_ends_removed":
        _adoption_racing_delete_ends_removed,
    "stale_readthrough_never_clobbers_newer_mapping":
        _stale_readthrough_never_clobbers,
    "delete_fully_processed_mid_readthrough_stays_silent":
        _delete_mid_readthrough_stays_silent,
    "stale_adoption_retracts_even_without_on_change":
        lambda p: _delete_mid_readthrough_stays_silent(p, on_change=False),
    "create_after_adoption_residue_still_announces":
        _create_after_adoption_residue,
    "concurrent_allocation_converges": _concurrent_allocation_converges,
    "losing_claim_never_poisons_label_resolution":
        _losing_claim_never_poisons,
    "cidr_and_reserved_identities_stay_off_the_store":
        _cidr_and_reserved_stay_off_the_store,
    "gc_reaps_orphans_respects_grace_and_references": _gc_reaps_orphans,
    "churn_sequence_store_and_notifications": _churn_sequence,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_allocator_scenario_equals_the_reference(name):
    ref, port = _both(SCENARIOS[name])
    assert port == ref


def test_ten_thousand_label_sets_agree_with_the_reference():
    """Two allocators over one store in each package (the mesh-scale
    shape of chip_smoke's phase 15d, cut to 2000 label sets): every
    identity equal across the allocators and across the packages."""
    def scenario(p):
        store = p.kv.KVStore()
        a = p.ik.ClusterIdentityAllocator(store).start()
        b = p.ik.ClusterIdentityAllocator(store).start()
        try:
            pool = [_labels(p, app=f"a{i % 97}", ns=f"n{i // 97}")
                    for i in range(2000)]
            got_a = [a.allocate(lbls) for lbls in pool]
            got_b = [b.allocate(lbls) for lbls in pool[::-1]][::-1]
            assert got_a == got_b
            return got_a
        finally:
            a.close()
            b.close()

    ref, port = _both(scenario)
    assert port == ref and len(set(port)) == 2000


def test_store_from_reference_carries_every_identity():
    """The state carried across: a port allocator started over
    ``weights.store_from_reference`` of a store the reference filled
    maps every label set to the reference's identity, and its next
    allocation takes the id the reference's would."""
    from cilium_tpu_torch.weights import store_from_reference

    pool = [{"app": f"w{i}", "team": f"t{i % 5}"} for i in range(300)]
    with JAX.simclock.use(JAX.simclock.VirtualClock(start=1000.0)):
        ref_store = JAX.kv.KVStore()
        ref = JAX.ik.ClusterIdentityAllocator(ref_store).start()
        want = [ref.allocate(JAX.labels.LabelSet.from_dict(d)) for d in pool]
        ref_next = ref.allocate(JAX.labels.LabelSet.from_dict({"app": "new"}))
        ref.close()
    items = ref_store.list_prefix("")
    store = store_from_reference(items)
    assert store.list_prefix("") == items
    port = PORT.ik.ClusterIdentityAllocator(store).start()
    try:
        got = [port.lookup_by_labels(PORT.labels.LabelSet.from_dict(d))
               for d in pool]
        assert got == want
        assert port.allocate(
            PORT.labels.LabelSet.from_dict({"app": "new"})) == ref_next
    finally:
        port.close()


# -- the kvstore (tests/test_clustermesh.py's kvstore half) ----------------


def _kvstore_basics(p):
    kv = p.kv.KVStore()
    kv.set("a/1", "x")
    kv.set("a/2", "y")
    kv.set("b/1", "z")
    assert kv.get("a/1") == "x"
    assert kv.list_prefix("a/") == {"a/1": "x", "a/2": "y"}
    out = [kv.delete("a/1"), kv.delete("a/1"), kv.get("a/1"),
           kv.delete_prefix("a/"), len(kv), kv.create("b/1", "w"),
           kv.create("c/1", "v"), sorted(kv), kv.revision]
    assert out[:5] == [True, False, None, 1, 1]
    return out


def _watch_replay_then_follow(p):
    kv = p.kv.KVStore()
    kv.set("pfx/old", "1")
    events = []
    w = kv.watch_prefix("pfx/", events.append, replay=True)
    kv.set("pfx/new", "2")
    kv.set("pfx/new", "3")
    kv.set("other/x", "ignored")
    kv.delete("pfx/old")
    w.stop()
    kv.set("pfx/after", "4")
    return [(e.typ, e.key, e.value) for e in events]


def _lease_expiry(p):
    kv = p.kv.KVStore()
    lease = kv.lease(ttl=60.0)
    kv.set("leased/k", "v", lease=lease)
    kv.set("plain/k", "v")
    out = [kv.get("leased/k")]
    p.simclock.get().advance(60.5)
    out += [kv.get("leased/k"), kv.get("plain/k"), kv.list_prefix("leased/")]
    assert out == ["v", None, "v", {}]
    # replay skips an expired key; a key re-set without its lease survives
    lease2 = kv.lease(ttl=5.0)
    kv.set("pfx/dead", "v", lease=lease2)
    kv.set("pfx/live", "v")
    kv.set("k", "old", lease=lease2)
    kv.set("k", "new")
    p.simclock.get().advance(6.0)
    events = []
    kv.watch_prefix("pfx/", events.append, replay=True)
    out += [[(e.typ, e.key) for e in events], "pfx/dead" in list(kv),
            kv.expire_leases(), kv.get("k")]
    kv.revoke(lease)
    return out


def _watch_fault_isolated(p):
    """A raising callback and an injected ``kvstore.watch`` fault each
    cost one watcher one event — counted, never raised at the writer."""
    kv = p.kv.KVStore()
    good, bad = [], []

    def raising(ev):
        bad.append(ev.key)
        raise ValueError("watcher bug")

    kv.watch_prefix("k/", raising)
    kv.watch_prefix("k/", good.append)
    errs0 = p.metrics.METRICS.get(p.metrics.KVSTORE_WATCH_ERRORS)
    kv.set("k/1", "a")
    plan = p.faults.FaultPlan([p.faults.FaultRule("kvstore.watch", times=1)])
    with p.faults.inject(plan):
        kv.set("k/2", "b")
    return {"good": [e.key for e in good], "bad": bad,
            "errors": p.metrics.METRICS.get(p.metrics.KVSTORE_WATCH_ERRORS)
            - errs0}


def _lease_expiry_order(p):
    """Expired keys go in the store's insertion order, whatever order
    they took their leases in (the port indexes the leased keys)."""
    kv = p.kv.KVStore()
    events = []
    kv.watch_prefix("e/", events.append)
    short, long_ = kv.lease(ttl=5.0), kv.lease(ttl=50.0)
    for i in range(6):
        kv.set(f"e/{i}", "plain")
    for i in (4, 1, 5, 0):
        kv.set(f"e/{i}", "leased", lease=short)
    kv.set("e/2", "long", lease=long_)
    kv.set("e/1", "unleased again")
    p.simclock.get().advance(6.0)
    removed = kv.expire_leases()
    p.simclock.get().advance(50.0)
    removed += kv.expire_leases()
    return {"removed": removed, "events": [(e.typ, e.key, e.value)
                                           for e in events],
            "left": kv.list_prefix("")}


@pytest.mark.parametrize("scenario", [_kvstore_basics,
                                      _watch_replay_then_follow,
                                      _lease_expiry, _lease_expiry_order,
                                      _watch_fault_isolated],
                         ids=lambda f: f.__name__.strip("_"))
def test_kvstore_scenario_equals_the_reference(scenario):
    ref, port = _both(scenario)
    assert port == ref


def test_churn_storm_fault_loses_one_delivery_and_a_replay_converges():
    """The ``kvstore.churn_storm`` point: an armed fault loses one
    remote delivery to the watching allocator (isolated by the watch),
    and a fresh replay-then-follow allocator still sees every mapping."""
    def scenario(p):
        store = p.kv.KVStore()
        seen = []
        b = p.ik.ClusterIdentityAllocator(
            store, on_change=lambda nid, lbls: seen.append(nid)).start()
        a = p.ik.ClusterIdentityAllocator(store).start()
        plan = p.faults.FaultPlan([p.faults.FaultRule(
            "kvstore.churn_storm", times=1)])
        try:
            with p.faults.inject(plan):
                ids = [a.allocate(_labels(p, storm=f"s{i}")) for i in range(4)]
            fresh = p.ik.ClusterIdentityAllocator(store).start()
            replay = [fresh.lookup_by_labels(_labels(p, storm=f"s{i}"))
                      for i in range(4)]
            fresh.close()
            assert replay == ids
            return {"ids": ids, "seen": seen}
        finally:
            a.close()
            b.close()

    ref, port = _both(scenario)
    assert port == ref
    assert len(port["seen"]) == 3


# -- the regeneration debouncer (tests/dst/test_debounce.py) ---------------


def _wait_for(pred, rounds=2000):
    ev = threading.Event()
    for _ in range(rounds):
        if pred():
            return True
        ev.wait(0.005)
    return pred()


def _storm_of_100_fires_once(p):
    clk = p.simclock.VirtualClock(autojump=0.003)
    with p.simclock.use(clk):
        fires = []
        deb = p.ik.RegenDebouncer(lambda: fires.append(1), window_s=0.05)
        before = p.metrics.METRICS.get(
            "cilium_tpu_identity_regen_coalesced_total")
        for _ in range(100):
            deb.note()
        _wait_for(lambda: deb.fires)
        deb.close()
        return {"fires": deb.fires, "called": len(fires),
                "coalesced": p.metrics.METRICS.get(
                    "cilium_tpu_identity_regen_coalesced_total") - before}


def _window_zero_is_synchronous(p):
    fires = []
    deb = p.ik.RegenDebouncer(lambda: fires.append(1), window_s=0.0)
    for _ in range(5):
        deb.note()
    deb.close()
    return {"fires": deb.fires, "called": len(fires)}


def _flush_then_close_is_idempotent(p):
    with p.simclock.use(p.simclock.VirtualClock()):
        fires = []
        deb = p.ik.RegenDebouncer(lambda: fires.append(1), window_s=10.0)
        deb.note()
        deb.note()
        out = [len(fires)]
        deb.flush()
        out.append(len(fires))
        deb.close()
        deb.close()
        deb.note()
        out += [len(fires), deb.fires]
        return out


def _fire_exception_keeps_serving(p):
    clk = p.simclock.VirtualClock(autojump=0.003)
    with p.simclock.use(clk):
        calls = []

        def boom():
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("regen failed")

        deb = p.ik.RegenDebouncer(boom, window_s=0.02)
        deb.note()
        assert _wait_for(lambda: calls, 1000)
        deb.note()
        assert _wait_for(lambda: len(calls) >= 2, 1000)
        deb.close()
        return {"calls": len(calls), "fires": deb.fires}


@pytest.mark.parametrize("scenario", [_storm_of_100_fires_once,
                                      _window_zero_is_synchronous,
                                      _flush_then_close_is_idempotent,
                                      _fire_exception_keeps_serving],
                         ids=lambda f: f.__name__.strip("_"))
def test_debouncer_scenario_equals_the_reference(scenario):
    ref, port = scenario(JAX), scenario(PORT)
    assert port == ref


def test_debouncer_storm_coalesces_into_one_fire():
    got = _storm_of_100_fires_once(PORT)
    assert got == {"fires": 1, "called": 1, "coalesced": 99}


def test_sustained_storm_fires_at_the_max_delay_cadence():
    """Events spaced inside the window keep re-arming it; max_delay
    bounds the staleness: O(duration / max_delay) fires, never one per
    event (the bound of ``tests/dst/test_debounce.py``)."""
    clk = PORT.simclock.VirtualClock(autojump=0.003)
    with PORT.simclock.use(clk):
        deb = PORT.ik.RegenDebouncer(lambda: None, window_s=0.05,
                                     max_delay_s=0.2)
        stop = threading.Event()

        def stormer():
            for _ in range(20):
                deb.note()
                PORT.simclock.sleep(0.03)
            stop.set()

        t = threading.Thread(target=stormer)
        t.start()
        t.join(timeout=30.0)
        assert stop.is_set()
        deb.close(flush=True)
        assert 1 <= deb.fires <= 6


def test_new_families_carry_the_reference_help_text():
    """The families these modules write, by the reference's names, with
    its ``# HELP`` text in the port's exposition."""
    m = PORT.metrics
    names = {m.KVSTORE_WATCH_ERRORS: JAX.metrics.KVSTORE_WATCH_ERRORS,
             m.TENANT_QUOTA_READS: JAX.metrics.TENANT_QUOTA_READS,
             m.CLUSTERMESH_DECODE_ERRORS:
                 "cilium_tpu_clustermesh_decode_errors_total",
             m.CLUSTERMESH_READY: "cilium_tpu_clustermesh_ready",
             m.IDENTITIES_CLUSTER: "cilium_tpu_identities_cluster",
             m.IDENTITY_GC: "cilium_tpu_operator_identities_gc_total",
             m.IDENTITY_REGEN_COALESCED:
                 "cilium_tpu_identity_regen_coalesced_total"}
    assert all(k == v for k, v in names.items())
    for name in names:
        assert m.HELP[name] == JAX.metrics.METRICS._help[name]
    reg = m.Metrics()
    reg.inc(m.KVSTORE_WATCH_ERRORS)
    text = reg.expose()
    assert (f"# HELP {m.KVSTORE_WATCH_ERRORS} "
            f"{m.HELP[m.KVSTORE_WATCH_ERRORS]}\n# TYPE "
            f"{m.KVSTORE_WATCH_ERRORS} counter") in text
