"""The port's Hubble relay (``hubble/relay.py``: ``Relay``,
``RemoteObserver``, ``RelayObserver``, ``FollowingRelay``,
``PeerDirectory``) against the JAX package's, on the CPU, mirroring
``tests/test_relay_remote.py``, ``tests/test_hubble_server.py::
test_relay_peers_op`` and the relay and health cases of
``tests/test_observability.py``.

Every case runs one scenario in each package and holds what comes out
equal: the merged streams (peer, and each flow as ``flow_to_dict``
gives it, in order), the flows served on the relay socket, the peer
sets, the relay's status and the health checker's states. The scenario
also makes the reference test's own assertions.

Time: each package runs under its own ``VirtualClock``, kept flowing at
the wall rate by a ticker thread (the followers back off on it).
Agents run with the gate off (the oracle), the port's on
``device="cpu"``; every socket lives in a short ``tempfile.mkdtemp()``
directory.
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

PKG_MODULES = (("flow", "core.flow"), ("hubble", "hubble"),
               ("observer", "hubble.observer"), ("relay", "hubble.relay"),
               ("server", "hubble.server"), ("ingest", "ingest.hubble"),
               ("kv", "kvstore"), ("health", "health"),
               ("simclock", "runtime.simclock"), ("agent", "agent"),
               ("config", "core.config"))


def _pkg(root):
    ns = types.SimpleNamespace(root=root, jax=root == "cilium_tpu")
    for attr, mod in PKG_MODULES:
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX, PORT = _pkg("cilium_tpu"), _pkg("cilium_tpu_torch")


@contextlib.contextmanager
def short_dir():
    d = tempfile.mkdtemp(prefix="rly")
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


@contextlib.contextmanager
def flowing(p, tick=0.002):
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
        with short_dir() as tmp, flowing(p):
            out.append(scenario(p, tmp))
    assert out[0] == out[1], out
    return out[1]


def wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _flow(p, t, src=1, dst=2, verdict=None):
    F = p.flow
    return F.Flow(time=t, src_identity=src, dst_identity=dst, dport=80,
                  verdict=verdict or F.Verdict.FORWARDED)


def _merged(p, merged):
    return [(name, p.ingest.flow_to_dict(f)) for name, f in merged]


class Nodes:
    """Two nodes' observers, each served on its own hubble socket."""

    def __init__(self, p, tmp):
        self.p, self.tmp = p, tmp
        self.observers = [p.hubble.Observer(), p.hubble.Observer()]
        self.observers[0].observe([_flow(p, 1.0, src=10),
                                   _flow(p, 3.0, src=10)])
        self.observers[1].observe([_flow(p, 2.0, src=20),
                                   _flow(p, 4.0, src=20)])
        self.servers = [
            p.server.HubbleServer(obs, self.path(name)).start()
            for obs, name in zip(self.observers, ("a", "b"))]

    def path(self, name):
        return os.path.join(self.tmp, f"{name}.sock")

    def stop(self):
        for srv in self.servers:
            srv.stop()


@contextlib.contextmanager
def two_nodes(p, tmp):
    nodes = Nodes(p, tmp)
    try:
        yield nodes
    finally:
        nodes.stop()


# ====================================== tests/test_relay_remote.py
def _remote_peers_merge_time_ordered(p, tmp):
    with two_nodes(p, tmp) as nodes:
        relay = p.relay.Relay()
        relay.add_remote_peer("node-a", nodes.path("a"))
        relay.add_remote_peer("node-b", nodes.path("b"))
        merged = relay.get_flows()
        assert [(n, f.time) for n, f in merged] == [
            ("node-a", 1.0), ("node-b", 2.0), ("node-a", 3.0),
            ("node-b", 4.0)]
        only_b = relay.get_flows(p.observer.FlowFilter(src_identity=20))
        assert {n for n, _ in only_b} == {"node-b"}
        return _merged(p, merged), _merged(p, only_b)


def test_remote_peers_merge_time_ordered():
    _both(_remote_peers_merge_time_ordered)


def _relay_socket_serves_merged_stream(p, tmp):
    with two_nodes(p, tmp) as nodes:
        relay = p.relay.Relay()
        relay.add_remote_peer("node-a", nodes.path("a"))
        relay.add_remote_peer("node-b", nodes.path("b"))
        server = p.server.HubbleServer(p.relay.RelayObserver(relay),
                                       nodes.path("relay"),
                                       relay=relay).start()
        try:
            client = p.server.HubbleClient(nodes.path("relay"))
            flows = list(client.get_flows())
            assert [f["node_name"] for f in flows] == [
                "node-a", "node-b", "node-a", "node-b"]
            peers = client.peers()["peers"]
            assert peers == ["node-a", "node-b"]
            return flows, peers
        finally:
            server.stop()


def test_relay_socket_serves_merged_stream():
    _both(_relay_socket_serves_merged_stream)


def _unreachable_peer_degrades_not_fatal(p, tmp):
    with two_nodes(p, tmp) as nodes:
        relay = p.relay.Relay()
        relay.add_remote_peer("node-a", nodes.path("a"))
        relay.add_remote_peer("ghost", nodes.path("nope"))
        merged = relay.get_flows()
        assert {n for n, _ in merged} == {"node-a"}
        status = relay.status()
        assert status["ghost"]["available"] is False
        return _merged(p, merged), status


def test_unreachable_peer_degrades_not_fatal():
    _both(_unreachable_peer_degrades_not_fatal)


def _peer_directory_tracks_membership(p, tmp):
    with two_nodes(p, tmp) as nodes:
        store = p.kv.KVStore()
        relay = p.relay.Relay()
        directory = p.relay.PeerDirectory(store, relay).start()
        prefix = p.relay.PeerDirectory.PREFIX
        try:
            store.set(prefix + "node-a",
                      json.dumps({"socket": nodes.path("a")}))
            steps = [relay.peers()]
            assert steps[-1] == ["node-a"]
            assert len(relay.get_flows()) == 2
            store.set(prefix + "node-b",
                      json.dumps({"socket": nodes.path("b")}))
            merged = relay.get_flows()
            assert len(merged) == 4
            store.delete(prefix + "node-b")
            steps.append(relay.peers())
            assert steps[-1] == ["node-a"]
            return steps, _merged(p, merged)
        finally:
            directory.stop()


def test_peer_directory_tracks_membership():
    _both(_peer_directory_tracks_membership)


def _relay_rejects_follow_and_resume(p, tmp):
    with two_nodes(p, tmp) as nodes:
        relay = p.relay.Relay()
        relay.add_remote_peer("node-a", nodes.path("a"))
        server = p.server.HubbleServer(p.relay.RelayObserver(relay),
                                       nodes.path("relay"),
                                       relay=relay).start()
        try:
            client = p.server.HubbleClient(nodes.path("relay"))
            errors = []
            for kw in ({"follow": True, "timeout": 0.2},
                       {"since_seq": 3}):
                with pytest.raises(RuntimeError) as exc:
                    list(client.get_flows(**kw))
                errors.append(str(exc.value))
            return errors
        finally:
            server.stop()


def test_relay_rejects_follow_and_resume():
    _both(_relay_rejects_follow_and_resume)


def _limit_pushes_down_to_peers(p, tmp):
    with two_nodes(p, tmp) as nodes:
        relay = p.relay.Relay()
        relay.add_remote_peer("node-a", nodes.path("a"))
        relay.add_remote_peer("node-b", nodes.path("b"))
        merged = relay.get_flows(limit=2)
        assert [(n, f.time) for n, f in merged] == [
            ("node-a", 3.0), ("node-b", 4.0)]  # the global newest two
        return _merged(p, merged)


def test_limit_pushes_down_to_peers():
    _both(_limit_pushes_down_to_peers)


def _agent(p, tmp, name, store, **kw):
    cfg = p.config.Config()
    cfg.node_name = name
    cfg.configure_logging = False
    cfg.enable_tpu_offload = False
    cfg.loader.cache_dir = os.path.join(tmp, f"cache-{name}")
    extra = {} if p.jax else {"device": "cpu"}
    return p.agent.Agent(cfg, kvstore=store, **kw, **extra).start()


def _hubble_peer_readvertises_after_lapse(p, tmp):
    store = p.kv.KVStore()
    agent = _agent(p, tmp, "lapse", store,
                   hubble_socket_path=os.path.join(tmp, "h.sock"))
    try:
        key = p.relay.PeerDirectory.PREFIX + "lapse"
        steps = [store.get(key) is not None]
        # a stall past the TTL: the advertisement's lease is forced out
        agent._hubble_ad._lease.deadline = 0.0
        store.expire_leases()
        steps.append(store.get(key) is not None)
        agent._hubble_ad.heartbeat()
        steps.append(store.get(key) is not None)  # re-advertised
        assert steps == [True, False, True]
        return steps
    finally:
        agent.stop()


def test_hubble_peer_readvertises_after_lapse():
    _both(_hubble_peer_readvertises_after_lapse)


def _following_relay_streams_live(p, tmp):
    with two_nodes(p, tmp) as nodes:
        relay = p.relay.FollowingRelay()
        relay.add_remote_peer("node-a", nodes.path("a"))
        relay.add_remote_peer("node-b", nodes.path("b"))
        server = p.server.HubbleServer(relay.observer, nodes.path("relay"),
                                       relay=relay).start()
        try:
            assert wait_until(lambda: relay.observer.seen >= 4)
            assert relay.observer.seen == 4
            client = p.server.HubbleClient(nodes.path("relay"))
            got = list(client.get_flows())
            assert {f["node_name"] for f in got} == {"node-a", "node-b"}
            collected = []
            done = threading.Event()

            def follow():
                fc = p.server.HubbleClient(nodes.path("relay"))
                for f in fc.get_flows(follow=True, timeout=5.0):
                    collected.append(f)
                    if f.get("source", {}).get("identity") == 999:
                        done.set()
                        return

            t = threading.Thread(target=follow, daemon=True)
            t.start()
            time.sleep(0.3)
            nodes.observers[0].observe([_flow(p, 9.0, src=999)])
            assert done.wait(10.0), "live flow never reached the follower"
            assert relay.status()["node-a"]["available"]
            # arrival order across the two followers is a race: the
            # relay's ring is compared as a sorted set of flows
            return (sorted(json.dumps(f, sort_keys=True) for f in got),
                    collected[-1])
        finally:
            server.stop()
            relay.stop()


def test_following_relay_streams_live():
    _both(_following_relay_streams_live)


def _following_relay_readd_is_duplicate_free(p, tmp):
    with two_nodes(p, tmp) as nodes:
        relay = p.relay.FollowingRelay()
        try:
            relay.add_remote_peer("node-a", nodes.path("a"))
            assert wait_until(lambda: relay.observer.seen >= 2)
            assert relay.observer.seen == 2
            relay.add_remote_peer("node-a", nodes.path("a"))  # re-ad
            time.sleep(0.5)
            assert relay.observer.seen == 2  # no replayed duplicates
            return [p.ingest.flow_to_dict(f)
                    for f in relay.observer.get_flows()]
        finally:
            relay.stop()


def test_following_relay_readd_is_duplicate_free():
    _both(_following_relay_readd_is_duplicate_free)


def _following_relay_survives_peer_restart(p, tmp):
    with two_nodes(p, tmp) as nodes:
        relay = p.relay.FollowingRelay()
        try:
            relay.add_remote_peer("node-a", nodes.path("a"))
            assert wait_until(lambda: relay.observer.seen >= 2)
            # the node restarts: a NEW observer (seqs from 0), same path
            nodes.servers[0].stop()
            fresh = p.hubble.Observer()
            nodes.servers[0] = p.server.HubbleServer(
                fresh, nodes.path("a")).start()
            fresh.observe([_flow(p, 9.0, src=999)])
            assert wait_until(lambda: relay.observer.seen >= 3,
                              timeout=30), "post-restart flow never came"
            return [p.ingest.flow_to_dict(f)
                    for f in relay.observer.get_flows()]
        finally:
            relay.stop()


def test_following_relay_survives_peer_restart():
    _both(_following_relay_survives_peer_restart)


def _following_relay_peer_removal_stops_stream(p, tmp):
    with two_nodes(p, tmp) as nodes:
        relay = p.relay.FollowingRelay()
        try:
            relay.add_remote_peer("node-a", nodes.path("a"))
            assert wait_until(lambda: relay.observer.seen >= 2)
            relay.remove_peer("node-a")
            seen = relay.observer.seen
            nodes.observers[0].observe([_flow(p, 9.0, src=999)])
            time.sleep(0.5)
            assert relay.observer.seen == seen  # the follower stopped
            assert relay.peers() == []
            return seen, relay.peers()
        finally:
            relay.stop()


def test_following_relay_peer_removal_stops_stream():
    _both(_following_relay_peer_removal_stops_stream)


def _agents_publish_peers_and_relay_sees_their_flows(p, tmp):
    store = p.kv.KVStore()
    agent_a = _agent(p, tmp, "na", store,
                     hubble_socket_path=os.path.join(tmp, "na.sock"))
    agent_b = _agent(p, tmp, "nb", store,
                     hubble_socket_path=os.path.join(tmp, "nb.sock"))
    relay = p.relay.Relay()
    directory = p.relay.PeerDirectory(store, relay).start()
    stopped_b = False
    try:
        peers = [sorted(relay.peers())]
        assert peers[0] == ["na", "nb"]
        for agent, ident in ((agent_a, 100), (agent_b, 200)):
            agent.endpoint_add(1, {"app": f"x{ident}"})
            agent.observer.observe([_flow(p, float(ident), src=ident)])
        merged = relay.get_flows()
        assert {f.src_identity for _, f in merged} >= {100, 200}
        agent_b.stop()  # a clean departure drops the peer
        stopped_b = True
        peers.append(relay.peers())
        assert peers[-1] == ["na"]
        return peers, _merged(p, merged)
    finally:
        directory.stop()
        agent_a.stop()
        if not stopped_b:
            agent_b.stop()


def test_agents_publish_peers_and_relay_sees_their_flows():
    _both(_agents_publish_peers_and_relay_sees_their_flows)


# ======================== tests/test_hubble_server.py::test_relay_peers_op
def _relay_peers_op(p, tmp):
    relay = p.relay.Relay()
    obs_a, obs_b = p.hubble.Observer(), p.hubble.Observer()
    relay.add_peer("node-a", obs_a)
    relay.add_peer("node-b", obs_b)
    srv = p.server.HubbleServer(obs_a, os.path.join(tmp, "relay.sock"),
                                relay=relay).start()
    try:
        peers = sorted(p.server.HubbleClient(srv.socket_path).peers()[
            "peers"])
        assert peers == ["node-a", "node-b"]
        return peers
    finally:
        srv.stop()


def test_relay_peers_op():
    _both(_relay_peers_op)


# ==================================== tests/test_observability.py cases
def _obs_flows(p, n):
    F = p.flow
    return [F.Flow(src_identity=100 + i, dst_identity=200, dport=80,
                   protocol=F.Protocol.TCP,
                   direction=F.TrafficDirection.INGRESS) for i in range(n)]


def _relay_merge_sorts_across_peers(p, tmp):
    V = p.flow.Verdict
    obs_a, obs_b = p.hubble.Observer(), p.hubble.Observer()
    fa, fb = _obs_flows(p, 2), _obs_flows(p, 2)
    for i, f in enumerate(fa):
        f.time = 10.0 + 2 * i
        f.verdict = V.FORWARDED
    for i, f in enumerate(fb):
        f.time = 11.0 + 2 * i
        f.verdict = V.DROPPED
    obs_a.observe(fa)
    obs_b.observe(fb)
    relay = p.hubble.Relay()
    relay.add_peer("node-a", obs_a)
    relay.add_peer("node-b", obs_b)
    got = relay.get_flows()
    assert [n for n, _ in got] == ["node-a", "node-b", "node-a", "node-b"]
    assert [f.time for _, f in got] == [10.0, 11.0, 12.0, 13.0]
    dropped = relay.get_flows(p.hubble.FlowFilter(verdict=V.DROPPED))
    assert {n for n, _ in dropped} == {"node-b"}
    relay.remove_peer("node-b")
    assert relay.peers() == ["node-a"]
    after = relay.get_flows()
    assert len(after) == 2
    return _merged(p, got), _merged(p, dropped), _merged(p, after)


def test_relay_merge_sorts_across_peers():
    _both(_relay_merge_sorts_across_peers)


def _relay_unreachable_peer_degrades(p, tmp):
    class Broken:
        def get_flows(self, flt=None):
            raise ConnectionError("node down")

    relay = p.hubble.Relay()
    obs = p.hubble.Observer()
    f = _obs_flows(p, 1)[0]
    f.time = 1.0
    obs.observe([f])
    relay.add_peer("good", obs)
    relay.add_peer("bad", Broken())
    got = relay.get_flows()
    assert len(got) == 1
    status = relay.status()
    assert status["bad"]["available"] is False
    assert status["good"]["available"] is True
    return _merged(p, got), status


def test_relay_unreachable_peer_degrades():
    _both(_relay_unreachable_peer_degrades)


def _health_failure_detection_and_recovery(p, tmp):
    hc = p.health.HealthChecker(failure_threshold=2)
    state = {"healthy": True}

    def probe():
        if not state["healthy"]:
            raise ConnectionError("unreachable")

    def snap():
        st = hc.status()["peer-1"]
        return (st.reachable, st.consecutive_failures, hc.unreachable())

    hc.add_node("peer-1", probe)
    steps = []
    hc.probe_all()
    steps.append(snap())
    assert hc.status()["peer-1"].reachable
    state["healthy"] = False
    hc.probe_all()
    steps.append(snap())
    assert hc.status()["peer-1"].reachable  # below the threshold
    hc.probe_all()
    steps.append(snap())
    st = hc.status()["peer-1"]
    assert not st.reachable and st.consecutive_failures == 2
    assert hc.unreachable() == ["peer-1"]
    state["healthy"] = True
    hc.probe_all()
    steps.append(snap())
    assert hc.status()["peer-1"].reachable
    assert hc.unreachable() == []
    return steps


def test_health_failure_detection_and_recovery():
    assert _both(_health_failure_detection_and_recovery) == [
        (True, 0, []), (True, 1, []), (False, 2, ["peer-1"]),
        (True, 0, [])]


# ============================================== the port's own guards
def test_relay_exports_and_prefix_match_reference():
    assert PORT.relay.PeerDirectory.PREFIX == JAX.relay.PeerDirectory.PREFIX
    assert PORT.hubble.Relay is PORT.relay.Relay
    assert PORT.hubble.Peer is PORT.relay.Peer
    assert sorted(PORT.hubble.__all__) == sorted(JAX.hubble.__all__)


def test_port_relay_reads_reference_nodes():
    """One wire protocol: a port relay merges the streams of reference
    Hubble sockets exactly as a reference relay does."""
    with short_dir() as tmp:
        nodes = Nodes(JAX, tmp)
        try:
            got = []
            for p in (JAX, PORT):
                relay = p.relay.Relay()
                relay.add_remote_peer("node-a", nodes.path("a"))
                relay.add_remote_peer("node-b", nodes.path("b"))
                got.append(_merged(p, relay.get_flows()))
            assert got[0] == got[1] and len(got[1]) == 4
        finally:
            nodes.stop()
