"""The port's k8s layer (``k8s/apiserver.py``, ``informer.py``,
``identity_crd.py``, ``ces.py``, ``agent_bridge._provenance``) against
the JAX package's, on the CPU, mirroring ``tests/test_k8s_apiserver.py``,
``tests/test_k8s_identity_crd.py``, ``tests/test_cidrgroup_ces.py`` and
the k8s cases of ``tests/test_advice_r4.py``; and the state carried
across, ``weights.resources_from_reference``.

Every case runs one scenario in each package and holds what comes out
equal: store contents and listings, watch events, resourceVersions
(both stores start at 0, so they are compared as they stand),
identities, informer caches and callbacks, slices and verdicts. Where
the scenario races threads on purpose (concurrent writers, concurrent
allocators) only what the race cannot change is compared: convergence
and the invariants the reference asserts. ``created-at`` stamps are
taken out before comparing. The scenario also makes the reference
test's own assertions.

Time: each package runs under its own ``VirtualClock``, kept flowing at
the wall rate by a ticker thread; the GC case stamps its old identities
an hour behind the clock's wall. Agents run with the gate off (the
oracle), the port's on ``device="cpu"``.
"""

import collections
import contextlib
import importlib
import os
import random
import shutil
import tempfile
import threading
import time
import types

import pytest

PKG_MODULES = (("apiserver", "k8s.apiserver"), ("informer", "k8s.informer"),
               ("crd", "k8s.identity_crd"), ("ces", "k8s.ces"),
               ("bridge", "k8s.agent_bridge"), ("k8s", "k8s"),
               ("labels", "core.labels"), ("flow", "core.flow"),
               ("cnp", "policy.api.cnp"), ("rule", "policy.api.rule"),
               ("simclock", "runtime.simclock"), ("agent", "agent"),
               ("config", "core.config"), ("kv", "kvstore"))


def _pkg(root):
    ns = types.SimpleNamespace(root=root, jax=root == "cilium_tpu")
    for attr, mod in PKG_MODULES:
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX, PORT = _pkg("cilium_tpu"), _pkg("cilium_tpu_torch")
CNP = "ciliumnetworkpolicies"


@contextlib.contextmanager
def short_dir():
    d = tempfile.mkdtemp(prefix="k8s")
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
        with short_dir() as tmp, flowing(p) as clock:
            out.append(scenario(p, tmp, clock))
    assert out[0] == out[1], out
    return out[1]


def wait_until(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _strip(obj):
    """An object without the stamps that are not data."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k != "created-at"}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


@contextlib.contextmanager
def apiserver(p, tmp):
    """``p``'s apiserver and a client. A scenario stops the server
    before its informers: a dead server breaks their watch streams, so
    each stops at once instead of waiting out its join."""
    server = p.apiserver.APIServer(os.path.join(tmp, "k8s.sock")).start()
    try:
        yield server, p.apiserver.K8sClient(server.socket_path)
    finally:
        server.stop()


def cnp(name, ns="default", port="80"):
    return {
        "apiVersion": "cilium.io/v2",
        "kind": "CiliumNetworkPolicy",
        "metadata": {"name": name, "namespace": ns},
        "spec": {
            "endpointSelector": {"matchLabels": {"app": "db"}},
            "ingress": [{
                "fromEndpoints": [{"matchLabels": {"app": "web"}}],
                "toPorts": [{"ports": [
                    {"port": port, "protocol": "TCP"}]}],
            }],
        },
    }


def _make_agent(p, tmp, socket_path, name="node-0", **fields):
    cfg = p.config.Config()
    cfg.node_name = name
    cfg.k8s_api_socket = socket_path
    cfg.configure_logging = False
    cfg.enable_tpu_offload = False
    cfg.loader.cache_dir = os.path.join(tmp, f"cache-{name}")
    for k, v in fields.items():
        setattr(cfg, k, v)
    extra = {} if p.jax else {"device": "cpu"}
    kv = {} if fields.get("identity_allocation_mode") == "crd" else {
        "kvstore": p.kv.KVStore()}
    return p.agent.Agent(config=cfg, **kv, **extra).start()


# ======================================== tests/test_k8s_apiserver.py
def _crud_and_resource_versions(p, tmp, clock):
    s = p.apiserver.ResourceStore()
    a = s.create(CNP, cnp("a"))
    b = s.create(CNP, cnp("b"))
    assert int(b["metadata"]["resourceVersion"]) > \
        int(a["metadata"]["resourceVersion"])
    assert a["metadata"]["uid"] != b["metadata"]["uid"]
    got = s.get(CNP, "default", "a")
    assert got["spec"] == cnp("a")["spec"]
    listing = s.list(CNP)
    assert {o["metadata"]["name"] for o in listing["items"]} == {"a", "b"}
    assert listing["resource_version"] == b["metadata"]["resourceVersion"]
    gone = s.delete(CNP, "default", "a")
    assert gone["metadata"]["name"] == "a"
    with pytest.raises(p.apiserver.NotFound):
        s.get(CNP, "default", "a")
    listing.pop("instance")
    return a, b, listing, gone, s.list(CNP)["items"]


def test_crud_and_resource_versions():
    _both(_crud_and_resource_versions)


def _create_conflict_and_unknown_resource(p, tmp, clock):
    s = p.apiserver.ResourceStore()
    s.create(CNP, cnp("a"))
    with pytest.raises(p.apiserver.Conflict):
        s.create(CNP, cnp("a"))
    with pytest.raises(p.apiserver.NotFound):
        s.list("widgets")
    return s.list(CNP)["resource_version"]


def test_create_conflict_and_unknown_resource():
    _both(_create_conflict_and_unknown_resource)


def _update_optimistic_concurrency_and_generation(p, tmp, clock):
    s = p.apiserver.ResourceStore()
    a = s.create(CNP, cnp("a"))
    fresh = cnp("a", port="443")
    fresh["metadata"]["resourceVersion"] = a["metadata"]["resourceVersion"]
    a2 = s.update(CNP, fresh)
    assert a2["metadata"]["generation"] == 2
    assert a2["metadata"]["uid"] == a["metadata"]["uid"]
    stale = cnp("a", port="8080")
    stale["metadata"]["resourceVersion"] = a["metadata"]["resourceVersion"]
    with pytest.raises(p.apiserver.Conflict):
        s.update(CNP, stale)
    a3 = s.update(CNP, cnp("a", port="9090"))  # rv-less: forced write
    assert a3["metadata"]["generation"] == 3
    return a2, a3


def test_update_optimistic_concurrency_and_generation():
    _both(_update_optimistic_concurrency_and_generation)


def _cluster_scoped_resources_drop_namespace(p, tmp, clock):
    s = p.apiserver.ResourceStore()
    node = s.create("ciliumnodes", {
        "metadata": {"name": "n1", "namespace": "ignored"},
        "spec": {"podCIDR": "10.0.0.0/24"}})
    assert "namespace" not in node["metadata"]
    got = s.get("ciliumnodes", "", "n1")
    assert got["spec"]["podCIDR"] == "10.0.0.0/24"
    return node, got


def test_cluster_scoped_resources_drop_namespace():
    _both(_cluster_scoped_resources_drop_namespace)


def _watch_replays_strictly_after_rv_and_follows(p, tmp, clock):
    s = p.apiserver.ResourceStore()
    a = s.create(CNP, cnp("a"))
    s.create(CNP, cnp("b"))
    seen = []
    w = s.watch(CNP, a["metadata"]["resourceVersion"], seen.append)
    try:
        assert [e["object"]["metadata"]["name"] for e in seen] == ["b"]
        assert seen[0]["type"] == "ADDED"
        s.delete(CNP, "default", "b")
        assert seen[-1]["type"] == "DELETED"
        s.create("ciliumnodes", {"metadata": {"name": "n1"}})
        assert all(e["object"]["kind"] == "CiliumNetworkPolicy"
                   for e in seen)
        return seen
    finally:
        w.stop()


def test_watch_replays_strictly_after_rv_and_follows():
    _both(_watch_replays_strictly_after_rv_and_follows)


def _watch_gone_on_instance_change_or_future_rv(p, tmp, clock):
    s = p.apiserver.ResourceStore()
    s.create(CNP, cnp("a"))
    rv = s.list(CNP)["resource_version"]
    s.watch(CNP, rv, lambda e: None, instance=s.instance).stop()
    gone = []
    for kw in ({"since_rv": rv, "instance": "someone-elses-history"},
               {"since_rv": str(int(rv) + 50), "instance": s.instance}):
        with pytest.raises(p.apiserver.WatchGone) as exc:
            s.watch(CNP, kw["since_rv"], lambda e: None,
                    instance=kw["instance"])
        gone.append(str(exc.value))
    return rv, gone


def test_watch_gone_on_instance_change_or_future_rv():
    _both(_watch_gone_on_instance_change_or_future_rv)


def _watch_gone_when_history_compacted(p, tmp, clock):
    s = p.apiserver.ResourceStore()
    s._events = collections.deque(maxlen=4)  # tiny retention
    first = s.create(CNP, cnp("a"))
    for i in range(6):
        s.create(CNP, cnp(f"x{i}"))
    with pytest.raises(p.apiserver.WatchGone) as exc:
        s.watch(CNP, first["metadata"]["resourceVersion"], lambda e: None)
    rv = s.list(CNP)["resource_version"]
    s.watch(CNP, rv, lambda e: None).stop()
    return str(exc.value), rv


def test_watch_gone_when_history_compacted():
    _both(_watch_gone_when_history_compacted)


def _client_crud_apply_and_errors(p, tmp, clock):
    with apiserver(p, tmp) as (_, c):
        made = c.create(CNP, cnp("a"))
        assert made["metadata"]["uid"]
        with pytest.raises(p.apiserver.Conflict):
            c.create(CNP, cnp("a"))
        with pytest.raises(p.apiserver.NotFound):
            c.get(CNP, "nope")
        applied = c.apply(CNP, cnp("a", port="443"))
        assert applied["metadata"]["generation"] == 2
        c.apply(CNP, cnp("b"))
        names = {o["metadata"]["name"] for o in c.list(CNP)["items"]}
        assert names == {"a", "b"}
        c.delete(CNP, "b")
        items = c.list(CNP)["items"]
        assert len(items) == 1
        return made, applied, items


def test_client_crud_apply_and_errors():
    _both(_client_crud_apply_and_errors)


def _informer_converges_under_concurrent_churn(p, tmp, clock):
    with apiserver(p, tmp) as (server, c):
        inf = p.informer.Informer(
            p.apiserver.K8sClient(server.socket_path), CNP).start()
        names = [f"obj-{i}" for i in range(6)]

        def writer(seed):
            rng = random.Random(seed)
            cli = p.apiserver.K8sClient(server.socket_path)
            for i in range(40):
                name = rng.choice(names)
                op = rng.random()
                try:
                    if op < 0.5:
                        cli.apply(CNP, cnp(name,
                                           port=str(1000 + seed * 100 + i)))
                    elif op < 0.75:
                        cli.create(CNP, cnp(name))
                    else:
                        cli.delete(CNP, name)
                except (p.apiserver.Conflict, p.apiserver.NotFound):
                    pass  # racing writers: both outcomes are expected

        threads = [threading.Thread(target=writer, args=(s,))
                   for s in range(4)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
            final = {o["metadata"]["name"]: o["metadata"]["resourceVersion"]
                     for o in c.list(CNP)["items"]}

            def synced():
                with inf._lock:
                    mine = {n: o["metadata"]["resourceVersion"]
                            for (_, n), o in inf.store.items()}
                return mine == final

            assert wait_until(synced, timeout=30)
            for o in c.list(CNP)["items"]:
                key = (o["metadata"].get("namespace", ""),
                       o["metadata"]["name"])
                assert inf.store[key]["spec"] == o["spec"]
            # the writers race: what they leave differs run to run, so
            # only convergence is held across the packages
            return True
        finally:
            server.stop()
            inf.stop()


def test_informer_converges_under_concurrent_churn():
    _both(_informer_converges_under_concurrent_churn)


def _informer_sync_follow_update_delete(p, tmp, clock):
    with apiserver(p, tmp) as (server, c):
        events = []
        lock = threading.Lock()

        def rec(kind):
            def h(*objs):
                with lock:
                    events.append((kind, objs[-1]["metadata"]["name"]))
            return h

        c.create(CNP, cnp("pre"))
        inf = p.informer.Informer(c, CNP, on_add=rec("add"),
                                  on_update=rec("update"),
                                  on_delete=rec("del")).start()
        try:
            assert ("add", "pre") in events  # the first list is sync
            c.create(CNP, cnp("live"))
            assert wait_until(lambda: ("add", "live") in events)
            c.apply(CNP, cnp("live", port="443"))
            assert wait_until(lambda: ("update", "live") in events)
            c.delete(CNP, "live")
            assert wait_until(lambda: ("del", "live") in events)
            assert ("live",) not in inf.store
            return events, sorted(inf.store)
        finally:
            server.stop()
            inf.stop()


def test_informer_sync_follow_update_delete():
    _both(_informer_sync_follow_update_delete)


def _informer_relists_across_server_restart(p, tmp, clock):
    path = os.path.join(tmp, "k8s.sock")
    server = p.apiserver.APIServer(path).start()
    events = []

    def rec(kind):
        return lambda *objs: events.append(
            (kind, objs[-1]["metadata"]["name"]))

    c = p.apiserver.K8sClient(path)
    c.create(CNP, cnp("keep"))
    c.create(CNP, cnp("drop"))
    inf = p.informer.Informer(c, CNP, on_add=rec("add"),
                              on_update=rec("update"),
                              on_delete=rec("del")).start()
    try:
        assert {("add", "keep"), ("add", "drop")} <= set(events)
        lists_before = inf.list_count
        server.stop()
        # a NEW apiserver (fresh store, rv restarts): while the
        # informer was blind, drop went and new came
        server = p.apiserver.APIServer(path).start()
        c2 = p.apiserver.K8sClient(path)
        c2.create(CNP, cnp("keep"))
        c2.create(CNP, cnp("new"))
        assert wait_until(lambda: inf.list_count > lists_before
                          and ("add", "new") in events
                          and ("del", "drop") in events, timeout=30)
        assert ("default", "drop") not in inf.store
        assert ("default", "new") in inf.store
        return sorted(set(events)), sorted(inf.store)
    finally:
        server.stop()
        inf.stop()


def test_informer_relists_across_server_restart():
    _both(_informer_relists_across_server_restart)


# ===================================== tests/test_k8s_identity_crd.py
def _labels(p, **kw):
    return p.labels.LabelSet.from_dict(kw)


def _fmt(lbls):
    return None if lbls is None else tuple(sorted(lbls.format()))


def _two_nodes_agree_and_remote_announces(p, tmp, clock):
    with apiserver(p, tmp) as (server, c):
        seen = []
        a = p.crd.CRDIdentityAllocator(
            p.apiserver.K8sClient(server.socket_path)).start()
        b = p.crd.CRDIdentityAllocator(
            c, on_change=lambda nid, lbls: seen.append(
                (int(nid), _fmt(lbls)))).start()
        try:
            nid = a.allocate(_labels(p, app="db"))
            assert wait_until(
                lambda: b.lookup_by_labels(_labels(p, app="db")) == nid)
            assert b.lookup(nid) == _labels(p, app="db")
            assert (int(nid), _fmt(_labels(p, app="db"))) in seen
            assert b.allocate(_labels(p, app="db")) == nid
            items = c.list(p.crd.PLURAL)["items"]
            assert len(items) == 1
            d = p.crd.CRDIdentityAllocator(
                p.apiserver.K8sClient(server.socket_path)).start()
            try:
                assert d.lookup_by_labels(_labels(p, app="db")) == nid
            finally:
                d.close()
            return int(nid), seen, _strip(items)
        finally:
            server.stop()
            a.close()
            b.close()


def test_two_nodes_agree_and_remote_announces():
    _both(_two_nodes_agree_and_remote_announces)


def _cidr_identities_stay_node_local(p, tmp, clock):
    with apiserver(p, tmp) as (server, c):
        a = p.crd.CRDIdentityAllocator(
            p.apiserver.K8sClient(server.socket_path)).start()
        try:
            nid = a.allocate(p.labels.LabelSet.parse(["cidr:10.0.0.0/8"]))
            assert nid >= 1 << 24
            assert not c.list(p.crd.PLURAL)["items"]
            return int(nid)
        finally:
            server.stop()
            a.close()


def test_cidr_identities_stay_node_local():
    _both(_cidr_identities_stay_node_local)


def _duplicate_identities_tolerated_lowest_wins(p, tmp, clock):
    with apiserver(p, tmp) as (server, c):
        seen = []
        a = p.crd.CRDIdentityAllocator(
            c, on_change=lambda nid, lbls: seen.append(
                (int(nid), _fmt(lbls)))).start()
        dup = _labels(p, app="dup")
        try:
            c.create(p.crd.PLURAL, p.crd.identity_object(300, dup))
            assert wait_until(lambda: a.lookup_by_labels(dup) == 300)
            c.create(p.crd.PLURAL, p.crd.identity_object(290, dup))
            assert wait_until(lambda: a.lookup_by_labels(dup) == 290)
            assert a.lookup(300) == dup and a.lookup(290) == dup
            assert (300, _fmt(dup)) in seen and (290, _fmt(dup)) in seen
            c.delete(p.crd.PLURAL, "290")  # the winner reaped
            assert wait_until(lambda: a.lookup_by_labels(dup) == 300)
            assert (290, None) in seen
            return seen
        finally:
            server.stop()
            a.close()


def test_duplicate_identities_tolerated_lowest_wins():
    _both(_duplicate_identities_tolerated_lowest_wins)


def _concurrent_allocation_converges(p, tmp, clock):
    with apiserver(p, tmp) as (server, c):
        allocators = [p.crd.CRDIdentityAllocator(
            p.apiserver.K8sClient(server.socket_path)).start()
            for _ in range(4)]
        results = []
        barrier = threading.Barrier(4)

        def run(alloc):
            barrier.wait()
            results.append(alloc.allocate(_labels(p, app="contended")))

        threads = [threading.Thread(target=run, args=(a,))
                   for a in allocators]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(15)
            assert not any(t.is_alive() for t in threads), "hung"
            assert len(results) == 4
            want = min(results)
            for a in allocators:
                assert wait_until(lambda: a.lookup_by_labels(
                    _labels(p, app="contended")) == want)
            # how many duplicates the race made varies run to run; the
            # id every allocator settles on is the first one handed out
            return int(want)
        finally:
            server.stop()
            for a in allocators:
                a.close()


def test_concurrent_allocation_converges_or_duplicates_safely():
    _both(_concurrent_allocation_converges)


def _gc_reaps_unreferenced_after_grace(p, tmp, clock):
    with apiserver(p, tmp) as (_, c):
        old = p.simclock.wall() - 3600
        c.create(p.crd.PLURAL, dict(
            p.crd.identity_object(256, _labels(p, app="live")),
            **{"created-at": old}))
        c.create("ciliumendpoints", {
            "metadata": {"name": "n1-ep-1", "namespace": "default"},
            "status": {"id": 1, "identity": {"id": 256},
                       "networking": {"node": "n1"}}})
        c.create(p.crd.PLURAL, dict(
            p.crd.identity_object(300, _labels(p, app="old")),
            **{"created-at": old}))
        c.create(p.crd.PLURAL, p.crd.identity_object(
            301, _labels(p, app="fresh")))
        reaped = p.crd.gc_crd_identities(c)
        assert reaped == 1
        names = {o["metadata"]["name"] for o in c.list(p.crd.PLURAL)["items"]}
        assert names == {"256", "301"}
        return reaped, sorted(names)


def test_gc_reaps_unreferenced_after_grace():
    _both(_gc_reaps_unreferenced_after_grace)


CNP_YAML = """
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata: {name: allow-web}
spec:
  endpointSelector: {matchLabels: {app: db}}
  ingress:
  - fromEndpoints: [{matchLabels: {app: web}}]
    toPorts: [{ports: [{port: "5432", protocol: TCP}]}]
"""


def _agent_crd_mode_cross_node_enforcement(p, tmp, clock):
    with apiserver(p, tmp) as (server, c):
        agent_a = _make_agent(p, tmp, server.socket_path, "node-a",
                              identity_allocation_mode="crd",
                              k8s_api_socket=server.socket_path)
        agent_b = _make_agent(p, tmp, server.socket_path, "node-b",
                              identity_allocation_mode="crd",
                              k8s_api_socket=server.socket_path)
        try:
            db = agent_a.endpoint_add(1, {"app": "db"})
            web_remote = agent_b.endpoint_add(2, {"app": "web"})
            agent_a.policy_add(p.cnp.load_cnp_yaml_text(CNP_YAML)[0])
            F = p.flow.Flow

            def verdicts():
                out = agent_a.process_flows([
                    F(src_identity=web_remote.identity,
                      dst_identity=db.identity, dport=5432),
                    F(src_identity=db.identity, dst_identity=db.identity,
                      dport=5432)])
                return [int(v) for v in out["verdict"]]

            assert wait_until(lambda: verdicts() == [1, 2], timeout=30)
            web_a = agent_a.endpoint_add(3, {"app": "web"})
            assert web_a.identity == web_remote.identity
            ids = sorted(o["metadata"]["name"]
                         for o in c.list(p.crd.PLURAL)["items"])
            return (verdicts(), [int(db.identity), int(web_remote.identity)],
                    ids)
        finally:
            server.stop()
            agent_a.stop()
            agent_b.stop()


def test_agent_crd_mode_cross_node_enforcement():
    _both(_agent_crd_mode_cross_node_enforcement)


def _agent_crd_mode_requires_socket(p, tmp, clock):
    cfg = p.config.Config()
    cfg.identity_allocation_mode = "crd"
    cfg.configure_logging = False
    cfg.loader.cache_dir = os.path.join(tmp, "cache")
    extra = {} if p.jax else {"device": "cpu"}
    with pytest.raises(ValueError) as exc:
        p.agent.Agent(config=cfg, **extra)
    return str(exc.value)


def test_agent_crd_mode_requires_socket():
    _both(_agent_crd_mode_requires_socket)


# ========================================== tests/test_cidrgroup_ces.py
def _group(name, cidrs):
    return {"apiVersion": "cilium.io/v2alpha1", "kind": "CiliumCIDRGroup",
            "metadata": {"name": name},
            "spec": {"externalCIDRs": list(cidrs)}}


def _cnp_groupref(name, group):
    return {"apiVersion": "cilium.io/v2", "kind": "CiliumNetworkPolicy",
            "metadata": {"name": name},
            "spec": {"endpointSelector": {"matchLabels": {"app": "db"}},
                     "ingress": [{"fromCIDRSet": [{"cidrGroupRef": group}]}]}}


def _cidr_group_ref_and_cidr_are_exclusive(p, tmp, clock):
    doc = _cnp_groupref("bad", "g")
    doc["spec"]["ingress"][0]["fromCIDRSet"] = [
        {"cidrGroupRef": "g", "cidr": "10.0.0.0/8"}]
    with pytest.raises(p.rule.SanitizeError) as exc:
        p.cnp.parse_cnp(doc)
    return str(exc.value)


def test_cidr_group_ref_and_cidr_are_exclusive():
    _both(_cidr_group_ref_and_cidr_are_exclusive)


def _cidr_group_drives_enforcement(p, tmp, clock):
    with apiserver(p, tmp) as (server, c):
        c.create("ciliumcidrgroups", _group("partners", ["198.51.0.0/16"]))
        c.create(CNP, _cnp_groupref("allow-partners", "partners"))
        agent = _make_agent(p, tmp, server.socket_path)
        try:
            db = agent.endpoint_add(1, {"app": "db"})
            inside = agent.ipcache.upsert("198.51.100.7/32", None)
            outside = agent.ipcache.upsert("203.0.113.9/32", None)
            agent.endpoint_manager.regenerate_all(wait=True)
            F = p.flow.Flow

            def verdicts():
                out = agent.process_flows([
                    F(src_identity=inside, dst_identity=db.identity,
                      dport=443),
                    F(src_identity=outside, dst_identity=db.identity,
                      dport=443)])
                return [int(v) for v in out["verdict"]]

            seen = []
            for step, want in ((None, [1, 2]),
                               ("edit", [2, 1]), ("delete", [2, 2])):
                if step == "edit":
                    c.apply("ciliumcidrgroups",
                            _group("partners", ["203.0.113.0/24"]))
                elif step == "delete":
                    c.delete("ciliumcidrgroups", "partners")
                assert wait_until(lambda: verdicts() == want), verdicts()
                seen.append(verdicts())
            return seen, [int(inside), int(outside)]
        finally:
            server.stop()
            agent.stop()


def test_cidr_group_drives_enforcement():
    _both(_cidr_group_drives_enforcement)


def _cep(name, ep_id, identity=1000, namespace="default"):
    return {"apiVersion": "cilium.io/v2", "kind": "CiliumEndpoint",
            "metadata": {"name": name, "namespace": namespace},
            "status": {"id": ep_id, "identity": {"id": identity},
                       "networking": {"node": "n1"}}}


def _slice_members(client):
    slices = client.list("ciliumendpointslices")["items"]
    members = {}
    for s in slices:
        for ep in s.get("endpoints", ()):
            members.setdefault(ep["name"], []).append(
                s["metadata"]["name"])
    return slices, members


def _placement(client):
    """(namespace, name) → sorted member ids, slice by slice: what the
    batcher decided, without its resourceVersions."""
    slices, _ = _slice_members(client)
    return sorted(sorted((e["namespace"], e["name"]) for e in
                         s.get("endpoints", ())) for s in slices)


def _ces_batching_churn(p, tmp, clock):
    with apiserver(p, tmp) as (server, c):
        batcher = p.ces.CESBatcher(p.apiserver.K8sClient(server.socket_path),
                                   max_per_slice=4).start()
        try:
            for i in range(10):
                c.apply("ciliumendpoints", _cep(f"pod-{i}", i))

            def converged():
                slices, members = _slice_members(c)
                names = {f"pod-{i}" for i in range(10)}
                return (set(members) == names
                        and all(len(v) == 1 for v in members.values())
                        and all(len(s.get("endpoints", ())) <= 4
                                for s in slices))

            assert wait_until(converged)
            placed = _placement(c)
            c.apply("ciliumendpoints", _cep("pod-3", 3, identity=2222))

            def updated():
                _, members = _slice_members(c)
                if "pod-3" not in members:
                    return False
                s = c.get("ciliumendpointslices", members["pod-3"][0])
                return any(ep["name"] == "pod-3"
                           and ep["identity"].get("id") == 2222
                           for ep in s["endpoints"])

            assert wait_until(updated)
            for i in range(10):
                c.delete("ciliumendpoints", f"pod-{i}", "default")
            assert wait_until(lambda: _slice_members(c) == ([], {}))
            return len(placed), sorted(len(s) for s in placed)
        finally:
            server.stop()
            batcher.stop()


def test_ces_batching_churn():
    assert _both(_ces_batching_churn) == (3, [2, 4, 4])


def _ces_same_name_across_namespaces(p, tmp, clock):
    with apiserver(p, tmp) as (server, c):
        batcher = p.ces.CESBatcher(p.apiserver.K8sClient(server.socket_path),
                                   max_per_slice=10).start()
        try:
            c.apply("ciliumendpoints", _cep("web-0", 1, namespace="a"))
            c.apply("ciliumendpoints", _cep("web-0", 2, namespace="b"))

            def members():
                slices, _ = _slice_members(c)
                return sorted((e["namespace"], e["name"], e["id"])
                              for s in slices for e in s["endpoints"])

            assert wait_until(lambda: members() == [("a", "web-0", 1),
                                                    ("b", "web-0", 2)])
            c.delete("ciliumendpoints", "web-0", "a")
            assert wait_until(lambda: members() == [("b", "web-0", 2)])
            return members()
        finally:
            server.stop()
            batcher.stop()


def test_ces_same_name_across_namespaces():
    _both(_ces_same_name_across_namespaces)


def _ces_refills_partial_slices(p, tmp, clock):
    with apiserver(p, tmp) as (server, c):
        batcher = p.ces.CESBatcher(p.apiserver.K8sClient(server.socket_path),
                                   max_per_slice=3).start()
        try:
            for i in range(6):
                c.apply("ciliumendpoints", _cep(f"pod-{i}", i))
            assert wait_until(lambda: len(_slice_members(c)[1]) == 6)
            c.delete("ciliumendpoints", "pod-1", "default")
            assert wait_until(lambda: len(_slice_members(c)[1]) == 5)
            c.apply("ciliumendpoints", _cep("pod-new", 77))
            assert wait_until(lambda: len(_slice_members(c)[1]) == 6)
            slices, members = _slice_members(c)
            assert len(slices) == 2  # refilled, not a third slice
            assert all(len(v) == 1 for v in members.values())
            return len(slices), sorted(members)
        finally:
            server.stop()
            batcher.stop()


def test_ces_refills_partial_slices():
    _both(_ces_refills_partial_slices)


# ================================ the k8s cases of tests/test_advice_r4.py
def _cnp_doc(name, kind="CiliumNetworkPolicy", namespace=None, app="web"):
    doc = {"apiVersion": "cilium.io/v2", "kind": kind,
           "metadata": {"name": name},
           "spec": {"endpointSelector": {"matchLabels": {"app": "db"}},
                    "ingress": [{
                        "fromEndpoints": [{"matchLabels": {"app": app}}],
                        "toPorts": [{"ports": [
                            {"port": "80", "protocol": "TCP"}]}]}]}}
    if namespace is not None:
        doc["metadata"]["namespace"] = namespace
    return doc


def _app_of(obj):
    return obj["spec"]["ingress"][0]["fromEndpoints"][0]["matchLabels"][
        "app"]


def _store_update_defaults_namespace(p, tmp, clock):
    s = p.apiserver.ResourceStore()
    s.create(CNP, _cnp_doc("a"))
    out = s.update(CNP, _cnp_doc("a", app="api"))
    assert out["metadata"]["namespace"] == "default"
    got = s.get(CNP, "default", "a")
    assert _app_of(got) == "api"
    return out, got


def test_store_update_defaults_namespace():
    _both(_store_update_defaults_namespace)


def _update_strips_namespace_from_clusterwide_kinds(p, tmp, clock):
    s = p.apiserver.ResourceStore()
    ccnp = "ciliumclusterwidenetworkpolicies"
    kind = "CiliumClusterwideNetworkPolicy"
    s.create(ccnp, _cnp_doc("cw", kind=kind))
    out = s.update(ccnp, _cnp_doc("cw", kind=kind, namespace="kube-system",
                                  app="api"))
    assert "namespace" not in out["metadata"]
    got = s.get(ccnp, "", "cw")
    assert _app_of(got) == "api"
    return out, got


def test_update_strips_namespace_from_clusterwide_kinds():
    _both(_update_strips_namespace_from_clusterwide_kinds)


def _client_reapply_namespaceless_cnp(p, tmp, clock):
    with apiserver(p, tmp) as (_, c):
        first = c.apply(CNP, _cnp_doc("np"))
        second = c.apply(CNP, _cnp_doc("np", app="api"))
        assert first["metadata"]["namespace"] == "default"
        assert second["metadata"]["namespace"] == "default"
        assert int(second["metadata"]["generation"]) == 2
        return first, second


def test_client_reapply_namespaceless_cnp():
    _both(_client_reapply_namespaceless_cnp)


def _cnp_ccnp_labels_disjoint(p, tmp, clock):
    kind = "CiliumClusterwideNetworkPolicy"
    cnp_ = p.cnp.parse_cnp(_cnp_doc("x"))
    ccnp = p.cnp.parse_cnp(_cnp_doc("x", kind=kind))
    assert set(cnp_.labels) != set(ccnp.labels)
    assert any("derived-from=CiliumNetworkPolicy" in l for l in cnp_.labels)
    assert any(f"derived-from={kind}" in l for l in ccnp.labels)
    assert set(p.bridge._provenance(_cnp_doc("x"))) == set(cnp_.labels)
    assert set(p.bridge._provenance(_cnp_doc("x", kind=kind))) == \
        set(ccnp.labels)
    return sorted(cnp_.labels), sorted(ccnp.labels)


def test_cnp_ccnp_labels_disjoint():
    _both(_cnp_ccnp_labels_disjoint)


def _deleting_ccnp_keeps_same_named_cnp_rules(p, tmp, clock):
    kind = "CiliumClusterwideNetworkPolicy"
    cfg = p.config.Config()
    cfg.configure_logging = False
    cfg.enable_tpu_offload = False
    cfg.loader.cache_dir = os.path.join(tmp, "cache")
    extra = {} if p.jax else {"device": "cpu"}
    agent = p.agent.Agent(config=cfg, kvstore=p.kv.KVStore(),
                          **extra).start()
    try:
        agent.policy_add(p.cnp.parse_cnp(_cnp_doc("x")), wait=False)
        agent.policy_add(p.cnp.parse_cnp(_cnp_doc("x", kind=kind,
                                                  app="api")), wait=False)
        assert len(agent.repo.rules()) == 2
        n = agent.policy_delete(list(p.bridge._provenance(
            _cnp_doc("x", kind=kind))), wait=False)
        assert n == 1
        remaining = agent.repo.rules()
        assert len(remaining) == 1
        assert any("derived-from=CiliumNetworkPolicy" in l
                   for l in remaining[0].labels)
        return n, sorted(remaining[0].labels)
    finally:
        agent.stop()


def test_deleting_ccnp_keeps_same_named_cnp_rules():
    _both(_deleting_ccnp_keeps_same_named_cnp_rules)


# ============================================== the port's own guards
def test_resources_and_exports_match_reference():
    assert PORT.apiserver.RESOURCES == JAX.apiserver.RESOURCES
    assert PORT.apiserver.EVENT_RING == JAX.apiserver.EVENT_RING
    assert PORT.crd.GC_GRACE_S == JAX.crd.GC_GRACE_S
    assert sorted(PORT.k8s.__all__) == sorted(JAX.k8s.__all__)


def test_resources_from_reference_starts_informers_equal():
    """The state carried across: a port ``ResourceStore`` built by
    ``weights.resources_from_reference`` from a reference store holds
    its objects at their versions; a port informer over it lists what
    a reference informer lists, and the next write continues the
    reference's resourceVersion sequence."""
    from cilium_tpu_torch.weights import resources_from_reference

    ref = JAX.apiserver.ResourceStore()
    for i in range(5):
        ref.create(CNP, cnp(f"p{i}", port=str(80 + i)))
    ref.create("ciliumnodes", {"metadata": {"name": "n1"}})
    ref.create(JAX.crd.PLURAL, JAX.crd.identity_object(
        256, JAX.labels.LabelSet.from_dict({"app": "db"})))
    ref.update(CNP, cnp("p1", port="443"))
    ref.delete(CNP, "default", "p3")
    rv = ref.list(CNP)["resource_version"]
    objects = {plural: ref.list(plural)["items"]
               for plural in JAX.apiserver.RESOURCES}
    store = resources_from_reference(objects, rv)
    for plural in JAX.apiserver.RESOURCES:
        want, got = ref.list(plural), store.list(plural)
        assert got["items"] == want["items"]
        assert got["resource_version"] == want["resource_version"]
    # a watch from the carried version goes live; one from before it
    # is told to relist
    seen = []
    w = store.watch(CNP, rv, seen.append)
    with pytest.raises(PORT.apiserver.WatchGone):
        store.watch(CNP, str(int(rv) - 1), lambda e: None)
    # the same next write on both sides
    a = ref.create(CNP, cnp("p9"))
    b = store.create(CNP, cnp("p9"))
    w.stop()
    assert a == b and [e["object"] for e in seen] == [b]
    with short_dir() as tmp:
        servers = []
        try:
            for p, st in ((JAX, ref), (PORT, store)):
                server = p.apiserver.APIServer(
                    os.path.join(tmp, f"{p.root}.sock"), store=st).start()
                servers.append(server)
            lists = []
            for p, server in zip((JAX, PORT), servers):
                inf = p.informer.Informer(
                    p.apiserver.K8sClient(server.socket_path), CNP).start()
                try:
                    lists.append(sorted(inf.store.items()))
                finally:
                    inf.stop()
            assert lists[0] == lists[1] and len(lists[1]) == 5
        finally:
            for server in servers:
                server.stop()
    with pytest.raises(ValueError):
        resources_from_reference(objects, int(rv) - 2)
