"""The port's operator and leader election (``operator.py``,
``runtime/leader.py``) against the JAX package's, on the CPU, mirroring
``tests/test_operator.py``, ``tests/test_leader_election.py`` and
``tests/test_advice_r4.py::test_leader_stop_releases_via_lease_revocation``.

Every case runs one scenario in each package and holds what comes out
equal: the CIDR assignments, the ``on_cidr_change`` notifications, the
store's node and CIDR keys, the leader key and the ``is_leader``
transitions (as the ordered started/stopped callbacks). The scenario
also makes the reference test's own assertions.

Time: each package runs under its own ``VirtualClock``, kept flowing at
the wall rate by a ticker thread. Registration leases and election TTLs
are at least 2 s; a lease lapses, or a standby's campaign tick comes
round, only when the scenario jumps the clock, so no case rests on a
short wall-clock lease. The agents run with the gate off (the oracle),
the port's on ``device="cpu"``.
"""

import contextlib
import importlib
import json
import os
import shutil
import tempfile
import threading
import time
import types

import pytest

PKG_MODULES = (("kv", "kvstore"), ("operator", "operator"),
               ("leader", "runtime.leader"), ("ipam", "ipam"),
               ("simclock", "runtime.simclock"), ("agent", "agent"),
               ("config", "core.config"), ("metrics", "runtime.metrics"))


def _pkg(root):
    ns = types.SimpleNamespace(root=root, jax=root == "cilium_tpu")
    for attr, mod in PKG_MODULES:
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX, PORT = _pkg("cilium_tpu"), _pkg("cilium_tpu_torch")


@contextlib.contextmanager
def short_dir():
    d = tempfile.mkdtemp(prefix="opr")
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


@contextlib.contextmanager
def flowing(p, tick=0.002):
    """``p``'s simclock set to a VirtualClock that a ticker thread
    advances at the wall rate; the scenario jumps it with
    ``clock.advance``."""
    with p.simclock.use(p.simclock.VirtualClock(start=1000.0)) as clock:
        stop = threading.Event()

        def run():
            last = time.monotonic()
            while not stop.wait(tick):
                now = time.monotonic()
                clock.advance(now - last)
                last = now

        t = threading.Thread(target=run, daemon=True, name="clock-flow")
        t.start()
        try:
            yield clock
        finally:
            stop.set()
            t.join()


def _both(scenario):
    out = []
    for p in (JAX, PORT):
        with short_dir() as tmp, flowing(p) as clock:
            out.append(scenario(p, tmp, clock))
    assert out[0] == out[1], out
    return out[1]


def wait_until(pred, timeout=10.0, clock=None, jump=0.0):
    """Poll ``pred``; with ``clock``, jump it ``jump`` s a poll so a
    campaign tick comes round without waiting out its wall time."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        if clock is not None:
            clock.advance(jump)
        time.sleep(0.01)
    return False


def _store_view(p, store):
    return {k: v for k, v in store.list_prefix("cilium/").items()
            if k.startswith((p.operator.NODES_PREFIX,
                             p.operator.CIDRS_PREFIX,
                             p.leader.LEADER_PREFIX))}


# ================================================= tests/test_operator.py
def _register_assigns_cidr(p, tmp, clock):
    store = p.kv.KVStore()
    op = p.operator.Operator(store, pool_cidr="10.0.0.0/16",
                             node_mask_size=24).start()
    try:
        reg = p.operator.NodeRegistration(store, "node-a")
        cidr = reg.wait_for_cidr()
        assert cidr == "10.0.0.0/24"
        again = op.reconcile()
        assert again == {"node-a": "10.0.0.0/24"}
        return cidr, again, _store_view(p, store)
    finally:
        op.stop()


def test_register_assigns_cidr():
    _both(_register_assigns_cidr)


def _distinct_nodes_get_distinct_cidrs(p, tmp, clock):
    store = p.kv.KVStore()
    op = p.operator.Operator(store, pool_cidr="10.0.0.0/16",
                             node_mask_size=24).start()
    try:
        cidrs = [p.operator.NodeRegistration(store, n).wait_for_cidr()
                 for n in ("a", "b", "c")]
        assert len(set(cidrs)) == 3
        return cidrs
    finally:
        op.stop()


def test_distinct_nodes_get_distinct_cidrs():
    _both(_distinct_nodes_get_distinct_cidrs)


def _deregister_reclaims_cidr(p, tmp, clock):
    store = p.kv.KVStore()
    op = p.operator.Operator(store, pool_cidr="10.0.0.0/24",
                             node_mask_size=26).start()
    try:
        regs = [p.operator.NodeRegistration(store, f"n{i}")
                for i in range(4)]
        cidrs = [r.wait_for_cidr() for r in regs]
        waiter = p.operator.NodeRegistration(store, "n4")
        op.reconcile()
        assert store.get(p.operator.CIDRS_PREFIX + "n4") is None
        freed = regs[1].pod_cidr()
        regs[1].deregister()
        got = waiter.wait_for_cidr()
        assert got == freed
        assert store.get(p.operator.CIDRS_PREFIX + "n1") is None
        return cidrs, got, _store_view(p, store)
    finally:
        op.stop()


def test_deregister_reclaims_cidr():
    _both(_deregister_reclaims_cidr)


def _reconcile_with_expired_lease_does_not_deadlock(p, tmp, clock):
    store = p.kv.KVStore()
    op = p.operator.Operator(store, pool_cidr="10.0.0.0/16",
                             node_mask_size=24).start()
    try:
        p.operator.NodeRegistration(store, "ghost", lease_ttl=2.0)
        clock.advance(3.0)
        done = threading.Event()
        result = {}

        def run():
            result["assigned"] = op.reconcile()
            done.set()

        threading.Thread(target=run, daemon=True).start()
        assert done.wait(timeout=5.0), "reconcile deadlocked"
        assert result["assigned"] == {}
        return result["assigned"], _store_view(p, store)
    finally:
        op.stop()


def test_reconcile_with_expired_lease_does_not_deadlock():
    _both(_reconcile_with_expired_lease_does_not_deadlock)


def _heartbeat_after_lapse_reregisters(p, tmp, clock):
    store = p.kv.KVStore()
    op = p.operator.Operator(store, pool_cidr="10.0.0.0/16",
                             node_mask_size=24).start()
    try:
        reg = p.operator.NodeRegistration(store, "stall", lease_ttl=2.0)
        first = reg.wait_for_cidr()
        clock.advance(3.0)  # the lease lapses; GC reclaims on next touch
        store.expire_leases()
        op.reconcile()
        assert store.get(p.operator.CIDRS_PREFIX + "stall") is None
        reg.heartbeat()  # re-registers, does not resurrect
        assert store.get(p.operator.NODES_PREFIX + "stall") is not None
        assert not reg.lease.expired()
        second = reg.wait_for_cidr()
        assert second.endswith("/24")
        return first, second
    finally:
        op.stop()


def test_heartbeat_after_lapse_reregisters():
    _both(_heartbeat_after_lapse_reregisters)


def _start_quarantines_corrupt_assignment(p, tmp, clock):
    store = p.kv.KVStore()
    store.set(p.operator.CIDRS_PREFIX + "legacy",
              json.dumps({"cidr": "10.0.0.0/24"}))
    store.set(p.operator.NODES_PREFIX + "legacy",
              json.dumps({"name": "legacy"}))
    op = p.operator.Operator(store, pool_cidr="10.0.0.0/16",
                             node_mask_size=25).start()
    try:
        raw = store.get(p.operator.CIDRS_PREFIX + "legacy")
        assert raw is not None
        assert json.loads(raw)["cidr"].endswith("/25")
        return raw
    finally:
        op.stop()


def test_start_quarantines_corrupt_assignment():
    _both(_start_quarantines_corrupt_assignment)


def _lease_expiry_triggers_gc(p, tmp, clock):
    store = p.kv.KVStore()
    op = p.operator.Operator(store, pool_cidr="10.0.0.0/16",
                             node_mask_size=24)
    p.operator.NodeRegistration(store, "ghost", lease_ttl=2.0)
    op.start()
    try:
        assigned = store.get(p.operator.CIDRS_PREFIX + "ghost")
        clock.advance(3.0)
        store.expire_leases()
        op.reconcile()
        assert store.get(p.operator.CIDRS_PREFIX + "ghost") is None
        assert store.get(p.operator.NODES_PREFIX + "ghost") is None
        return assigned, _store_view(p, store)
    finally:
        op.stop()


def test_lease_expiry_triggers_gc():
    _both(_lease_expiry_triggers_gc)


def _operator_restart_adopts_existing_assignments(p, tmp, clock):
    store = p.kv.KVStore()
    op1 = p.operator.Operator(store, pool_cidr="10.0.0.0/16",
                              node_mask_size=24).start()
    reg = p.operator.NodeRegistration(store, "survivor")
    before = reg.wait_for_cidr()
    op1.stop()
    op2 = p.operator.Operator(store, pool_cidr="10.0.0.0/16",
                              node_mask_size=24).start()
    try:
        assert reg.pod_cidr() == before
        newcomer = p.operator.NodeRegistration(
            store, "newcomer").wait_for_cidr()
        assert newcomer != before
        return before, newcomer
    finally:
        op2.stop()


def test_operator_restart_adopts_existing_assignments():
    _both(_operator_restart_adopts_existing_assignments)


def _adopt_rejects_foreign_or_conflicting_cidrs(p, tmp, clock):
    pool = p.ipam.ClusterPool("10.0.0.0/16", node_mask_size=24)
    with pytest.raises(ValueError):
        pool.adopt_node_cidr("a", "192.168.0.0/24")  # outside the pool
    with pytest.raises(ValueError):
        pool.adopt_node_cidr("a", "10.0.0.0/26")  # wrong mask
    pool.adopt_node_cidr("a", "10.0.5.0/24")
    pool.adopt_node_cidr("a", "10.0.5.0/24")  # idempotent
    with pytest.raises(ValueError):
        pool.adopt_node_cidr("b", "10.0.5.0/24")  # held by a
    got = pool.allocate_node_cidr("c")
    assert got != "10.0.5.0/24"
    return got


def test_adopt_rejects_foreign_or_conflicting_cidrs():
    _both(_adopt_rejects_foreign_or_conflicting_cidrs)


def _on_cidr_change_fires_on_recarve(p, tmp, clock):
    store = p.kv.KVStore()
    op1 = p.operator.Operator(store, pool_cidr="10.0.0.0/16",
                              node_mask_size=24).start()
    changes = []
    got_new = threading.Event()

    def on_change(old, new):
        changes.append((old, new))
        if new is not None and new.endswith("/25"):
            got_new.set()

    reg = p.operator.NodeRegistration(store, "live",
                                      on_cidr_change=on_change)
    first = reg.wait_for_cidr()
    op1.stop()
    # a restart with another mask: the /24 is quarantined and re-carved
    op2 = p.operator.Operator(store, pool_cidr="10.0.0.0/16",
                              node_mask_size=25).start()
    try:
        assert got_new.wait(timeout=5.0), "never notified of re-carve"
        second = reg.pod_cidr()
        assert second != first and second.endswith("/25")
        assert changes[0] == (None, first)
        assert (first, None) in changes  # the quarantine delete
        assert changes[-1][1] == second
        return changes
    finally:
        reg.close()
        op2.stop()


def test_on_cidr_change_fires_on_recarve():
    _both(_on_cidr_change_fires_on_recarve)


def _reconcile_quarantines_corrupt_assignment(p, tmp, clock):
    store = p.kv.KVStore()
    op = p.operator.Operator(store, pool_cidr="10.0.0.0/16",
                             node_mask_size=24).start()
    try:
        reg_a = p.operator.NodeRegistration(store, "a")
        reg_b = p.operator.NodeRegistration(store, "b")
        cidr_b = reg_b.wait_for_cidr()
        reg_a.wait_for_cidr()
        store.set(p.operator.CIDRS_PREFIX + "a", "{not json")
        assigned = op.reconcile()  # must not raise
        assert assigned["b"] == cidr_b
        assert assigned["a"].endswith("/24")
        assert json.loads(store.get(p.operator.CIDRS_PREFIX + "a"))[
            "cidr"] == assigned["a"]
        return assigned
    finally:
        op.stop()


def test_reconcile_quarantines_corrupt_assignment():
    _both(_reconcile_quarantines_corrupt_assignment)


def _pool_exhaustion_is_metered_not_fatal(p, tmp, clock):
    store = p.kv.KVStore()
    name = "cilium_tpu_operator_pool_exhausted_total"
    before = p.metrics.METRICS.get(name) or 0
    op = p.operator.Operator(store, pool_cidr="10.0.0.0/24",
                             node_mask_size=25).start()
    try:
        p.operator.NodeRegistration(store, "a").wait_for_cidr()
        p.operator.NodeRegistration(store, "b").wait_for_cidr()
        p.operator.NodeRegistration(store, "c")
        assigned = op.reconcile()
        assert set(assigned) == {"a", "b"}
        after = p.metrics.METRICS.get(name) or 0
        assert after > before
        return assigned
    finally:
        op.stop()


def test_pool_exhaustion_is_metered_not_fatal():
    _both(_pool_exhaustion_is_metered_not_fatal)


def _cluster_pool_config(p, tmp, node):
    cfg = p.config.Config()
    cfg.ipam_mode = "cluster-pool"
    cfg.node_name = node
    cfg.configure_logging = False
    cfg.enable_tpu_offload = False
    cfg.loader.cache_dir = os.path.join(tmp, "cache")
    return cfg


def _agent(p, cfg, store):
    extra = {} if p.jax else {"device": "cpu"}
    return p.agent.Agent(config=cfg, kvstore=store, **extra).start()


def _agent_cluster_pool_ipam_end_to_end(p, tmp, clock):
    store = p.kv.KVStore()
    op = p.operator.Operator(store, pool_cidr="10.200.0.0/16",
                             node_mask_size=26)
    op.start()
    cfg = _cluster_pool_config(p, tmp, "worker-1")
    agent = _agent(p, cfg, store)
    try:
        cidr = str(agent.ipam.cidr)
        assert cidr.startswith("10.200.") and cidr.endswith("/26")
        ep = agent.endpoint_add(7, {"app": "web"})
        assert ep.ipv4.startswith("10.200.")
        ipam = agent.status()["ipam"]
        assert ipam["mode"] == "cluster-pool"
    finally:
        agent.stop()
    agent2 = _agent(p, cfg, store)  # same node name → same CIDR
    try:
        assert str(agent2.ipam.cidr) == cidr
        return cidr, ep.ipv4, ipam, str(agent2.ipam.cidr)
    finally:
        agent2.stop()
        op.stop()


def test_agent_cluster_pool_ipam_end_to_end():
    _both(_agent_cluster_pool_ipam_end_to_end)


def _agent_rebuilds_allocator_on_recarve(p, tmp, clock):
    import ipaddress

    store = p.kv.KVStore()
    op = p.operator.Operator(store, pool_cidr="10.201.0.0/16",
                             node_mask_size=24)
    op.start()
    agent = _agent(p, _cluster_pool_config(p, tmp, "worker-r"), store)
    try:
        old_cidr = str(agent.ipam.cidr)
        first = agent.endpoint_add(1, {"app": "a"})
        op.stop()
        op2 = p.operator.Operator(store, pool_cidr="10.201.0.0/16",
                                  node_mask_size=25).start()
        try:
            assert wait_until(lambda: str(agent.ipam.cidr) != old_cidr)
            new_cidr = str(agent.ipam.cidr)
            assert new_cidr != old_cidr and new_cidr.endswith("/25")
            ep = agent.endpoint_add(2, {"app": "b"})
            assert (ipaddress.ip_address(ep.ipv4)
                    in ipaddress.ip_network(new_cidr))
            outside = p.metrics.METRICS.get(
                "cilium_tpu_ipam_endpoints_outside_cidr")
            return old_cidr, first.ipv4, new_cidr, ep.ipv4, outside
        finally:
            op2.stop()
    finally:
        agent.stop()


def test_agent_rebuilds_allocator_on_recarve():
    _both(_agent_rebuilds_allocator_on_recarve)


def _cidr_watch_ignores_other_nodes(p, tmp, clock):
    store = p.kv.KVStore()
    op = p.operator.Operator(store, pool_cidr="10.0.0.0/16",
                             node_mask_size=24).start()
    seen = []
    try:
        reg1 = p.operator.NodeRegistration(
            store, "worker-1", on_cidr_change=lambda o, n: seen.append(n))
        cidr1 = reg1.wait_for_cidr()
        reg10 = p.operator.NodeRegistration(store, "worker-10")
        cidr10 = reg10.wait_for_cidr()
        assert cidr10 != cidr1
        assert seen == [cidr1]  # never worker-10's assignment
        return seen, cidr10
    finally:
        reg1.close()
        op.stop()


def test_cidr_watch_ignores_other_nodes_with_same_name_prefix():
    _both(_cidr_watch_ignores_other_nodes)


def _wait_for_cidr_times_out_without_operator(p, tmp, clock):
    store = p.kv.KVStore()
    reg = p.operator.NodeRegistration(store, "alone")
    with pytest.raises(TimeoutError):
        reg.wait_for_cidr(timeout=0.1)
    return _store_view(p, store)


def test_wait_for_cidr_times_out_without_operator():
    assert list(_both(_wait_for_cidr_times_out_without_operator)) == [
        "cilium/nodes/alone"]


# ========================================== tests/test_leader_election.py
TTL = 3.0  # election TTL; the campaign ticks every TTL / 3


def _single_winner_and_clean_handover(p, tmp, clock):
    store = p.kv.KVStore()
    events = []

    def mk(name):
        return p.leader.LeaderElector(
            store, "op", name,
            on_started_leading=lambda: events.append(("lead", name)),
            on_stopped_leading=lambda: events.append(("stop", name)),
            ttl=TTL).start()

    a = mk("a")
    assert wait_until(lambda: a.is_leader)
    b = mk("b")
    clock.advance(TTL / 2)  # b campaigns at least once and loses
    time.sleep(0.1)
    assert not b.is_leader
    key = p.leader.LEADER_PREFIX + "op"
    assert store.get(key) == "a"
    a.stop()  # a clean resign hands over without waiting out the TTL
    assert ("stop", "a") in events
    assert wait_until(lambda: b.is_leader, clock=clock, jump=0.1)
    assert store.get(key) == "b"
    b.stop()
    assert events[-1] == ("stop", "b")
    return events, store.get(key)


def test_single_winner_and_clean_handover():
    assert _both(_single_winner_and_clean_handover) == (
        [("lead", "a"), ("stop", "a"), ("lead", "b"), ("stop", "b")], None)


def _crash_failover_after_ttl(p, tmp, clock):
    store = p.kv.KVStore()
    a = p.leader.LeaderElector(store, "op", "a", lambda: None,
                               lambda: None, ttl=TTL).start()
    assert wait_until(lambda: a.is_leader)
    b = p.leader.LeaderElector(store, "op", "b", lambda: None,
                               lambda: None, ttl=TTL).start()
    a._stop.set()  # a's campaign thread ends without a stop()
    a._thread.join(timeout=5)
    assert wait_until(lambda: b.is_leader, clock=clock, jump=0.25)
    holder = store.get(p.leader.LEADER_PREFIX + "op")
    b.stop()
    return holder, a.is_leader


def test_crash_failover_after_ttl():
    assert _both(_crash_failover_after_ttl) == ("b", False)


def _operator_ha_failover_reassigns_nodes(p, tmp, clock):
    store = p.kv.KVStore()
    op1 = p.operator.Operator(store, pool_cidr="10.77.0.0/16",
                              leader_election=True, instance="op1",
                              election_ttl=TTL).start()
    op2 = p.operator.Operator(store, pool_cidr="10.77.0.0/16",
                              leader_election=True, instance="op2",
                              election_ttl=TTL).start()
    try:
        assert wait_until(lambda: op1.is_leader or op2.is_leader)
        leader, standby = (op1, op2) if op1.is_leader else (op2, op1)
        assert not standby.is_leader
        reg1 = p.operator.NodeRegistration(store, "node-1")
        assert reg1.wait_for_cidr(timeout=10)
        cidr1 = reg1.pod_cidr()
        leader.stop()
        assert wait_until(lambda: standby.is_leader, clock=clock,
                          jump=0.1)
        assert reg1.pod_cidr() == cidr1  # survives the failover
        reg2 = p.operator.NodeRegistration(store, "node-2")
        assert reg2.wait_for_cidr(timeout=10)
        assert reg2.pod_cidr() != cidr1
        reg1.close()
        reg2.close()
        view = _store_view(p, store)
        # which replica won the first campaign is a race: compare the
        # assignments and that the lock moved to the other one
        holder = view.pop(p.leader.LEADER_PREFIX + "cilium-operator")
        assert holder == standby._instance != leader._instance
        return cidr1, reg2.pod_cidr(), view
    finally:
        op1.stop()
        op2.stop()


def test_operator_ha_failover_reassigns_nodes():
    _both(_operator_ha_failover_reassigns_nodes)


# ============================================= tests/test_advice_r4.py:152
def _leader_stop_releases_via_lease_revocation(p, tmp, clock):
    prefix = p.leader.LEADER_PREFIX

    class NoDeleteStore(p.kv.KVStore):
        """Counts raw deletes of the leader key: resign must revoke
        its own lease instead."""

        def __init__(self):
            super().__init__()
            self.leader_key_deletes = 0

        def delete(self, key):
            if key.startswith(prefix):
                self.leader_key_deletes += 1
            return super().delete(key)

    store = NoDeleteStore()
    a = p.leader.LeaderElector(store, "op", "a", lambda: None,
                               lambda: None, ttl=TTL).start()
    assert wait_until(lambda: a.is_leader)
    b = p.leader.LeaderElector(store, "op", "b", lambda: None,
                               lambda: None, ttl=TTL).start()
    a.stop()
    assert wait_until(lambda: store.get(prefix + "op") == "b",
                      clock=clock, jump=0.1)
    clock.advance(TTL / 3)
    time.sleep(0.2)
    assert store.get(prefix + "op") == "b"
    assert store.leader_key_deletes == 0
    b.stop()
    return store.leader_key_deletes, store.get(prefix + "op")


def test_leader_stop_releases_via_lease_revocation():
    assert _both(_leader_stop_releases_via_lease_revocation) == (0, None)


def test_operator_keys_match_reference():
    assert (PORT.operator.NODES_PREFIX, PORT.operator.CIDRS_PREFIX,
            PORT.leader.LEADER_PREFIX) == (
        JAX.operator.NODES_PREFIX, JAX.operator.CIDRS_PREFIX,
        JAX.leader.LEADER_PREFIX)
