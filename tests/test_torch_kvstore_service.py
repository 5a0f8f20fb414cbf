"""The port's socket-served kvstore (``kvstore_service.py``) against the
JAX package's, on the CPU, mirroring ``tests/test_kvstore_service.py``.

Every case runs one scenario in each package and holds what comes out
equal: values read back, store contents and revisions, the watch
events (type, key, value, in order), the ambiguous-create outcome, the
operator's CIDR assignment and the clustermesh keys. The scenario also
makes the reference test's own assertions.

Time: each package runs under its own ``VirtualClock``, kept flowing
at the wall rate by a ticker thread (``flowing``). Leases are at least
2 s long and lapse only when the scenario jumps the clock past them,
so no case depends on how fast a loaded CPU runs. Sockets live in a
short ``tempfile.mkdtemp()`` directory per package.
"""

import contextlib
import importlib
import os
import shutil
import socket
import tempfile
import threading
import time
import types

import pytest

PKG_MODULES = (("kv", "kvstore"), ("svc", "kvstore_service"),
               ("simclock", "runtime.simclock"), ("agent", "agent"),
               ("config", "core.config"), ("operator", "operator"),
               ("clustermesh", "clustermesh"),
               ("identity", "core.identity"), ("labels", "core.labels"),
               ("ipcache", "ipcache"),
               ("selectorcache", "policy.selectorcache"))


def _pkg(root):
    ns = types.SimpleNamespace(root=root, jax=root == "cilium_tpu")
    for attr, mod in PKG_MODULES:
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX, PORT = _pkg("cilium_tpu"), _pkg("cilium_tpu_torch")


@contextlib.contextmanager
def short_dir():
    d = tempfile.mkdtemp(prefix="kvs")
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
    """``scenario(p, tmp, clock)`` in each package; the two results
    must be equal. Returns the port's."""
    out = []
    for p in (JAX, PORT):
        with short_dir() as tmp, flowing(p) as clock:
            out.append(scenario(p, tmp, clock))
    assert out[0] == out[1], out
    return out[1]


def wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _ev(ev):
    return (ev.typ, ev.key, ev.value)


@contextlib.contextmanager
def served(p, tmp):
    path = os.path.join(tmp, "kv.sock")
    server = p.svc.KVStoreServer(path).start()
    client = p.svc.RemoteKVStore(path)
    try:
        yield server, client, path
    finally:
        client.close()
        server.stop()


# ---------------------------------------------------------------- cases
def _basic_kv_roundtrip(p, tmp, clock):
    with served(p, tmp) as (_, kv, _path):
        kv.set("a/1", "x")
        kv.set("a/2", "y")
        kv.set("b/1", "z")
        out = {"get": kv.get("a/1"), "missing": kv.get("missing"),
               "list": kv.list_prefix("a/")}
        assert out == {"get": "x", "missing": None,
                       "list": {"a/1": "x", "a/2": "y"}}
        out["del"] = [kv.delete("a/1"), kv.delete("a/1")]
        out["del_prefix"] = kv.delete_prefix("a/")
        out["rev"] = kv.revision
        out["created"] = [kv.create("c/1", "v"), kv.create("c/1", "w")]
        out["all"] = kv.list_prefix("")
        assert out["del"] == [True, False] and out["del_prefix"] == 1
        assert out["rev"] > 0 and out["created"] == [True, False]
        return out


def test_basic_kv_roundtrip():
    _both(_basic_kv_roundtrip)


def _watch_replay_then_follow(p, tmp, clock):
    with served(p, tmp) as (_, kv, path):
        kv.set("w/1", "old")
        events = []
        got_live = threading.Event()

        def cb(ev):
            events.append(_ev(ev))
            if ev.key == "w/2":
                got_live.set()

        watcher = p.svc.RemoteKVStore(path)
        w = watcher.watch_prefix("w/", cb)
        try:
            assert wait_until(lambda: events)
            assert events[0] == (p.kv.EVENT_CREATE, "w/1", "old")
            kv.set("w/2", "live")
            assert got_live.wait(5.0)
        finally:
            w.stop()
            watcher.close()
        n = len(events)
        kv.set("w/3", "ignored")
        time.sleep(0.1)
        assert len(events) == n
        return events


def test_watch_replay_then_follow():
    assert _both(_watch_replay_then_follow) == [
        ("create", "w/1", "old"), ("create", "w/2", "live")]


def _lease_expiry_server_side(p, tmp, clock):
    with served(p, tmp) as (_, kv, _path):
        lease = kv.lease(2.0)
        kv.set("ephemeral", "v", lease=lease)
        before = kv.get("ephemeral")
        assert before == "v"
        # no client activity at all: the server's sweeper expires it
        # once the clock is past the TTL
        clock.advance(2.5)
        assert wait_until(lambda: kv.get("ephemeral") is None)
        return before, kv.get("ephemeral"), kv.list_prefix("")


def test_lease_expiry_server_side():
    _both(_lease_expiry_server_side)


def _keepalive_on_expired_lease_errors(p, tmp, clock):
    with served(p, tmp) as (_, kv, _path):
        lease = kv.lease(2.0)
        kv.set("gone", "v", lease=lease)
        clock.advance(3.0)
        with pytest.raises(KeyError):
            lease.keepalive()
        return True


def test_keepalive_on_expired_lease_errors():
    _both(_keepalive_on_expired_lease_errors)


def _lease_keepalive_keeps_key(p, tmp, clock):
    with served(p, tmp) as (_, kv, _path):
        lease = kv.lease(2.0)
        kv.set("alive", "v", lease=lease)
        for _ in range(4):
            clock.advance(1.0)
            lease.keepalive()
        # four TTL halves later the key lives on
        assert kv.get("alive") == "v"
        return kv.list_prefix("")


def test_lease_keepalive_keeps_key():
    assert _both(_lease_keepalive_keeps_key) == {"alive": "v"}


def _expired_lease_delete_fires_watch(p, tmp, clock):
    with served(p, tmp) as (_, kv, path):
        seen = []
        deleted = threading.Event()

        def cb(ev):
            seen.append(_ev(ev))
            if ev.typ == p.kv.EVENT_DELETE:
                deleted.set()

        watcher = p.svc.RemoteKVStore(path)
        w = watcher.watch_prefix("eph/", cb)
        try:
            kv.set("eph/1", "v", lease=kv.lease(2.0))
            assert wait_until(lambda: seen)
            clock.advance(2.5)
            assert deleted.wait(5.0), "sweeper never fired the DELETE"
        finally:
            w.stop()
            watcher.close()
        return seen


def test_expired_lease_delete_fires_watch():
    assert _both(_expired_lease_delete_fires_watch) == [
        ("create", "eph/1", "v"), ("delete", "eph/1", "v")]


def _watch_resubscribes_after_server_restart(p, tmp, clock):
    path = os.path.join(tmp, "kv.sock")
    server = p.svc.KVStoreServer(path).start()
    kv = p.svc.RemoteKVStore(path)
    watcher = p.svc.RemoteKVStore(path)
    seen = []
    got_post_restart = threading.Event()

    def cb(ev):
        seen.append(_ev(ev))
        if ev.key == "r/after":
            got_post_restart.set()

    w = watcher.watch_prefix("r/", cb)
    try:
        kv.set("r/before", "1")
        assert wait_until(lambda: seen)
        server.stop()
        server = p.svc.KVStoreServer(path, store=server.store).start()
        kv.set("r/after", "2")
        assert got_post_restart.wait(10.0), "watch never resubscribed"
    finally:
        w.stop()
        watcher.close()
        kv.close()
        server.stop()
    # the resubscription replays: r/before surfaces again as a CREATE
    return sorted(set(seen))


def test_watch_resubscribes_after_server_restart():
    assert _both(_watch_resubscribes_after_server_restart) == [
        ("create", "r/after", "2"), ("create", "r/before", "1")]


def _revoke_unknown_lease_is_not_an_error(p, tmp, clock):
    path = os.path.join(tmp, "kv.sock")
    server = p.svc.KVStoreServer(path).start()
    kv = p.svc.RemoteKVStore(path)
    lease = kv.lease(60.0)
    kv.set("node/x", "v", lease=lease)
    server.stop()
    server = p.svc.KVStoreServer(path, store=server.store).start()
    try:
        kv.revoke(lease)  # unknown to the new server: must not raise
        deleted = kv.delete("node/x")
        assert deleted in (True, False)
        return deleted, kv.list_prefix("")
    finally:
        kv.close()
        server.stop()


def test_revoke_unknown_lease_is_not_an_error():
    _both(_revoke_unknown_lease_is_not_an_error)


def _client_reconnects_after_server_restart(p, tmp, clock):
    path = os.path.join(tmp, "kv.sock")
    server = p.svc.KVStoreServer(path).start()
    kv = p.svc.RemoteKVStore(path)
    kv.set("k", "v")
    server.stop()
    server2 = p.svc.KVStoreServer(path, store=server.store).start()
    try:
        got = kv.get("k")  # transparent reconnect, same data
        assert got == "v"
        return got, kv.revision
    finally:
        kv.close()
        server2.stop()


def test_client_reconnects_after_server_restart():
    _both(_client_reconnects_after_server_restart)


def _operator_and_agent_over_served_store(p, tmp, clock):
    path = os.path.join(tmp, "kv.sock")
    server = p.svc.KVStoreServer(path).start()
    op_kv = p.svc.RemoteKVStore(path)
    agent_kv = p.svc.RemoteKVStore(path)
    op = p.operator.Operator(op_kv, pool_cidr="10.220.0.0/16",
                             node_mask_size=24)
    op.start()
    cfg = p.config.Config()
    cfg.ipam_mode = "cluster-pool"
    cfg.node_name = "remote-node"
    cfg.configure_logging = False
    cfg.enable_tpu_offload = False
    cfg.loader.cache_dir = os.path.join(tmp, "cache")
    extra = {} if p.jax else {"device": "cpu"}
    agent = p.agent.Agent(config=cfg, kvstore=agent_kv, **extra).start()
    try:
        cidr = str(agent.ipam.cidr)
        assert cidr.startswith("10.220.")
        ep = agent.endpoint_add(4, {"app": "x"})
        assert ep.ipv4.startswith("10.220.")
        return {"cidr": cidr, "ip": ep.ipv4,
                "assigned": op_kv.list_prefix(p.operator.CIDRS_PREFIX),
                "nodes": sorted(op_kv.list_prefix(
                    p.operator.NODES_PREFIX))}
    finally:
        agent.stop()
        op.stop()
        op_kv.close()
        agent_kv.close()
        server.stop()


def test_operator_and_agent_over_served_store():
    out = _both(_operator_and_agent_over_served_store)
    assert out["cidr"] == "10.220.0.0/24"


def _clustermesh_over_served_store(p, tmp, clock):
    path = os.path.join(tmp, "kv.sock")
    server = p.svc.KVStoreServer(path).start()
    kv = p.svc.RemoteKVStore(path)
    allocator = p.identity.IdentityAllocator()
    sc = p.selectorcache.SelectorCache(allocator)
    ipcache = p.ipcache.IPCache(allocator, sc)
    pub = p.clustermesh.LocalStatePublisher(kv, "cluster-a", allocator,
                                            ipcache)
    try:
        ident = allocator.allocate(
            p.labels.LabelSet.from_dict({"app": "remote"}))
        ipcache.upsert("10.9.9.9/32", ident)
        pub.heartbeat()
        keys = kv.list_prefix("cilium/")
        assert any("10.9.9.9" in k for k in keys), keys
        return keys
    finally:
        kv.close()
        server.stop()


def test_clustermesh_over_served_store():
    _both(_clustermesh_over_served_store)


def _create_not_resent_after_ambiguous_connection_loss(p, tmp, clock):
    path = os.path.join(tmp, "kv.sock")
    server = p.svc.KVStoreServer(socket_path=path).start()
    try:
        client = p.svc.RemoteKVStore(path)
        assert client.create("claim/1", "a") is True
        # the next create goes through a decoy that swallows the
        # request and closes without replying: "the connection died
        # after the send, the outcome is unknown"
        decoy_path = os.path.join(tmp, "decoy.sock")
        decoy = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        decoy.bind(decoy_path)
        decoy.listen(1)

        def swallow():
            conn, _ = decoy.accept()
            conn.recv(1 << 16)
            conn.close()

        t = threading.Thread(target=swallow, daemon=True)
        t.start()
        sabotage = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sabotage.connect(decoy_path)
        real = client._sock
        client._sock = sabotage
        raised = None
        try:
            with pytest.raises((OSError, ConnectionError)) as exc:
                client.create("claim/2", "b")
            raised = issubclass(exc.type, (OSError, ConnectionError))
        finally:
            if real is not None:
                real.close()
            t.join(timeout=2)
            decoy.close()
        # a resend would have landed claim/2 on the real server
        fresh = p.svc.RemoteKVStore(path)
        try:
            got = fresh.get("claim/2")
            assert got is None, "create was resent after ambiguous loss"
            assert fresh.get("claim/1") == "a"
            out = {"raised": raised, "claim2": got,
                   "all": fresh.list_prefix("")}
        finally:
            fresh.close()
        client.close()
        return out
    finally:
        server.stop()


def test_create_not_resent_after_ambiguous_connection_loss():
    out = _both(_create_not_resent_after_ambiguous_connection_loss)
    assert out["all"] == {"claim/1": "a"} and out["raised"] is True


# ------------------------------------------------- the port's own guards
def test_frame_protocol_is_shared():
    """The two packages speak one frame protocol: a port client reads
    and writes a reference server, and the reverse."""
    with short_dir() as tmp:
        for srv_pkg, cli_pkg in ((JAX, PORT), (PORT, JAX)):
            path = os.path.join(tmp, f"{srv_pkg.root}.sock")
            server = srv_pkg.svc.KVStoreServer(path).start()
            client = cli_pkg.svc.RemoteKVStore(path)
            try:
                client.set("x/1", "a")
                assert client.get("x/1") == "a"
                assert client.create("x/1", "b") is False
                assert server.store.list_prefix("") == {"x/1": "a"}
            finally:
                client.close()
                server.stop()


def test_sweep_interval_matches_reference():
    assert PORT.svc.EXPIRY_SWEEP_S == JAX.svc.EXPIRY_SWEEP_S
    assert PORT.svc.RemoteKVStore._NO_RESEND == \
        JAX.svc.RemoteKVStore._NO_RESEND
