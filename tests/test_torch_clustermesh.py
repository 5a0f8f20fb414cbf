"""The port's clustermesh (``clustermesh.py``) against the JAX
package's, on the CPU, mirroring ``tests/test_clustermesh.py``.

The reference drives clustermesh through two live ``Agent``\\ s; each
case here wires the parts an agent wires —
an ``IdentityAllocator``, an ``IPCache``, a ``KVStore``, a
``LocalStatePublisher`` and a ``ClusterMesh`` per cluster, and a
``ServiceManager`` where services take part — in both packages, drives
the same calls through each, and holds what comes out equal: the store
keys and values, ``IPCache.dump()`` on both sides, the remote identities'
labels, ``ClusterMesh.status()``, the merged service backends and the
counters. Each case also makes the reference test's own assertions.

The controller-manager cases
(``test_controller_manager_restartable_after_stop_all``,
``test_update_racing_stop_all_does_not_leak_controller``) and
``test_global_services_across_processes`` (over the served kvstore) are
held in ``tests/test_torch_k8s_agent.py``, and
``test_to_services_sees_remote_backends`` (the agent's ``toServices``
regeneration, both gates) in ``tests/test_torch_agent.py``.
"""

import importlib
import types

import pytest

PKG_MODULES = (("cm", "clustermesh"), ("kv", "kvstore"),
               ("identity", "core.identity"), ("labels", "core.labels"),
               ("ipcache", "ipcache"), ("lb", "loadbalancer.service"),
               ("simclock", "runtime.simclock"), ("faults", "runtime.faults"),
               ("metrics", "runtime.metrics"))


def _pkg(root):
    ns = types.SimpleNamespace(root=root)
    for attr, mod in PKG_MODULES:
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX, PORT = _pkg("cilium_tpu"), _pkg("cilium_tpu_torch")


class _Cluster:
    """What an agent wires for clustermesh: allocator, ipcache, its own
    store with a publisher on it, the mesh of remote clusters."""

    def __init__(self, p, name, services=None, lease_ttl=60.0):
        self.p = p
        self.name = name
        self.alloc = p.identity.IdentityAllocator()
        self.ipcache = p.ipcache.IPCache(self.alloc)
        self.store = p.kv.KVStore()
        self.services = services
        self.publisher = p.cm.LocalStatePublisher(
            self.store, name, self.alloc, self.ipcache,
            lease_ttl=lease_ttl, services=services)
        self.changes = []
        self.mesh = p.cm.ClusterMesh(self.alloc, self.ipcache,
                                     on_change=lambda: self.changes.append(1),
                                     services=services)

    def endpoint_add(self, labels, ip):
        nid = self.alloc.allocate(self.p.labels.LabelSet.from_dict(labels))
        self.ipcache.upsert(f"{ip}/32", nid)
        return nid

    def endpoint_remove(self, ip):
        self.ipcache.delete(f"{ip}/32")

    def remote_view(self, ip):
        nid = self.ipcache.lookup(ip)
        if nid is None:
            return None
        lbls = self.alloc.lookup(nid)
        return None if lbls is None else tuple(sorted(lbls.format()))

    def state(self):
        return {"store": self.store.list_prefix(""),
                "ipcache": self.ipcache.dump(),
                "mesh": self.mesh.status()}


def _both(scenario):
    out = []
    for p in (JAX, PORT):
        with p.simclock.use(p.simclock.VirtualClock(start=1000.0)):
            out.append(scenario(p))
    return out


def _remote_endpoints_become_matchable(p):
    a, b = _Cluster(p, "alpha"), _Cluster(p, "beta")
    a.endpoint_add({"app": "db"}, "10.1.0.5")
    b.mesh.connect("alpha", a.store)
    view = [b.remote_view("10.1.0.5")]
    lbls = b.alloc.lookup(b.ipcache.lookup("10.1.0.5"))
    assert lbls.get("app", p.labels.SOURCE_K8S).value == "db"
    assert lbls.get(p.cm.CLUSTER_LABEL_KEY,
                    p.labels.SOURCE_K8S).value == "alpha"
    a.endpoint_add({"app": "cache"}, "10.1.0.6")
    view.append(b.remote_view("10.1.0.6"))
    a.endpoint_remove("10.1.0.5")
    assert b.ipcache.lookup("10.1.0.5") is None
    assert b.mesh.status()["alpha"]["num-entries"] == 1
    return {"view": view, "a": a.state(), "b": b.state()}


def _policy_selects_remote_cluster_identity(p):
    """A rule on beta's api pods allowing ingress from ``app=db`` on
    5432: the remote identity learned over clustermesh satisfies it
    (the CPU oracle of each package resolves it)."""
    api = importlib.import_module(f"{p.root}.policy.api")
    flow = importlib.import_module(f"{p.root}.core.flow")
    mapstate = importlib.import_module(f"{p.root}.policy.mapstate")
    repository = importlib.import_module(f"{p.root}.policy.repository")
    selectorcache = importlib.import_module(f"{p.root}.policy.selectorcache")
    oracle = importlib.import_module(f"{p.root}.policy.oracle")

    a, b = _Cluster(p, "alpha"), _Cluster(p, "beta")
    a.endpoint_add({"app": "db"}, "10.1.0.5")
    local = b.endpoint_add({"app": "api"}, "10.2.0.9")
    b.mesh.connect("alpha", a.store)
    repo = repository.Repository()
    repo.add([api.Rule(
        endpoint_selector=api.EndpointSelector.from_labels(app="api"),
        ingress=(api.IngressRule(
            from_endpoints=(api.EndpointSelector.from_labels(app="db"),),
            to_ports=(api.PortRule(ports=(api.PortProtocol(
                5432, flow.Protocol.TCP),)),)),))], sanitize=False)
    resolver = mapstate.PolicyResolver(repo,
                                       selectorcache.SelectorCache(b.alloc))
    engine = oracle.OracleVerdictEngine(
        {local: resolver.resolve(b.alloc.lookup(local))})
    remote = b.ipcache.lookup("10.1.0.5")
    flows = [flow.Flow(src_identity=remote, dst_identity=local, dport=port,
                       protocol=flow.Protocol.TCP,
                       direction=flow.TrafficDirection.INGRESS)
             for port in (5432, 80)]
    out = [int(v) for v in engine.verdict_flows(flows)["verdict"]]
    assert out == [int(flow.Verdict.FORWARDED), int(flow.Verdict.DROPPED)]
    return {"verdicts": out, "remote": remote}


def _full_mesh_no_echo(p):
    a, b = _Cluster(p, "alpha"), _Cluster(p, "beta")
    a.endpoint_add({"app": "db"}, "10.1.0.5")
    b.endpoint_add({"app": "api"}, "10.2.0.9")
    a.mesh.connect("beta", b.store)
    b.mesh.connect("alpha", a.store)
    assert set(a.store.list_prefix(p.cm.IP_PREFIX)) == {
        f"{p.cm.IP_PREFIX}alpha/10.1.0.5/32"}
    assert set(b.store.list_prefix(p.cm.IP_PREFIX)) == {
        f"{p.cm.IP_PREFIX}beta/10.2.0.9/32"}
    assert a.ipcache.lookup("10.2.0.9") is not None
    assert b.ipcache.lookup("10.1.0.5") is not None
    return {"a": a.state(), "b": b.state()}


def _disconnect_removes_remote_state(p):
    a, b = _Cluster(p, "alpha"), _Cluster(p, "beta")
    a.endpoint_add({"app": "db"}, "10.1.0.5")
    b.mesh.connect("alpha", a.store)
    nid = b.ipcache.lookup("10.1.0.5")
    assert nid is not None
    ready = p.metrics.METRICS.get("cilium_tpu_clustermesh_ready",
                                  {"cluster": "alpha"})
    b.mesh.disconnect("alpha")
    assert b.ipcache.lookup("10.1.0.5") is None
    assert b.mesh.status() == {}
    assert b.alloc.lookup(nid) is None
    return {"nid": nid, "ready": (ready, p.metrics.METRICS.get(
        "cilium_tpu_clustermesh_ready", {"cluster": "alpha"})),
        "b": b.state(), "changes": b.changes}


def _publisher_lease_expiry(p):
    a = _Cluster(p, "alpha", lease_ttl=30.0)
    a.endpoint_add({"app": "db"}, "10.1.0.5")
    key = f"{p.cm.IP_PREFIX}alpha/10.1.0.5/32"
    out = [a.store.get(key) is not None]
    p.simclock.get().advance(20.0)
    a.publisher.heartbeat()           # keepalive: the lease lives on
    p.simclock.get().advance(20.0)
    out.append(a.store.get(key) is not None)
    p.simclock.get().advance(31.0)    # no beat: the dead agent ages out
    a.store.expire_leases()
    out.append(a.store.get(key))
    assert out == [True, True, None]
    return out


def _reconnect_fires_on_change_once(p):
    b = _Cluster(p, "beta")
    kv = p.kv.KVStore()
    b.mesh.connect("alpha", kv)
    counts = [len(b.changes)]
    b.mesh.connect("alpha", kv)
    counts.append(len(b.changes))
    b.mesh.disconnect("alpha")
    counts.append(len(b.changes))
    b.mesh.close()
    assert counts == [1, 2, 3]
    return counts


def _session_and_heartbeat_faults_then_repair(p):
    """The two clustermesh fault points: a session fault costs the
    remote one event (isolated by the kvstore watch, counted), a
    heartbeat fault raises at the publisher; the next announcement of
    the key repairs the remote entry."""
    a, b = _Cluster(p, "alpha"), _Cluster(p, "beta")
    b.mesh.connect("alpha", a.store)
    errs0 = p.metrics.METRICS.get(p.metrics.KVSTORE_WATCH_ERRORS)
    plan = p.faults.FaultPlan([
        p.faults.FaultRule("clustermesh.session", times=1),
        p.faults.FaultRule("clustermesh.heartbeat", times=1)])
    raised = []
    with p.faults.inject(plan):
        nid = a.endpoint_add({"app": "db"}, "10.1.0.5")
        missing = b.ipcache.lookup("10.1.0.5")
        try:
            a.publisher.heartbeat()
        except p.faults.FaultInjected as e:
            raised.append(type(e).__name__)
        a.ipcache.upsert("10.1.0.5/32", nid)     # unchanged: no event
        a.ipcache.delete("10.1.0.5/32")
        a.ipcache.upsert("10.1.0.5/32", nid)     # the re-announce
        a.publisher.heartbeat()
    return {"missing": missing, "raised": raised,
            "watch_errors": p.metrics.METRICS.get(
                p.metrics.KVSTORE_WATCH_ERRORS) - errs0,
            "view": b.remote_view("10.1.0.5"), "b": b.state()}


def _decode_errors_are_counted(p):
    b = _Cluster(p, "beta")
    kv = p.kv.KVStore()
    b.mesh.connect("alpha", kv)
    labels = {"cluster": "alpha"}
    before = p.metrics.METRICS.get(
        "cilium_tpu_clustermesh_decode_errors_total", labels)
    kv.set(f"{p.cm.IP_PREFIX}alpha/garbage", "{not json")
    kv.set(f"{p.cm.IP_PREFIX}alpha/nokey", "{}")
    return {"decode_errors": p.metrics.METRICS.get(
        "cilium_tpu_clustermesh_decode_errors_total", labels) - before,
        "b": b.state()}


def _global_service_merges_remote_backends(p):
    Backend, Frontend, Service = p.lb.Backend, p.lb.Frontend, p.lb.Service
    a = _Cluster(p, "alpha", services=p.lb.ServiceManager())
    b = _Cluster(p, "beta", services=p.lb.ServiceManager())
    a.endpoint_add({"app": "orders"}, "10.1.0.7")
    a.services.upsert(Service(frontend=Frontend("10.96.1.1", 8080),
                              backends=[Backend(ip="10.1.0.7", port=8080)],
                              name="orders", namespace="default",
                              shared=True))
    a.publisher.publish_services()
    b.endpoint_add({"app": "client"}, "10.2.0.9")
    b.endpoint_add({"app": "orders"}, "10.2.0.7")
    b.services.upsert(Service(frontend=Frontend("10.97.1.1", 8080),
                              backends=[Backend(ip="10.2.0.7", port=8080)],
                              name="orders", namespace="default",
                              shared=True))
    b.mesh.connect("alpha", a.store)
    svc = b.services.get(Frontend("10.97.1.1", 8080))
    steps = [[bk.ip for bk in b.services.active_backends(svc)]]
    assert steps[0] == ["10.2.0.7", "10.1.0.7"]
    picked = sorted({b.services.select("10.2.0.9", sport, "10.97.1.1",
                                       8080).ip
                     for sport in range(1000, 1200)})
    assert picked == ["10.1.0.7", "10.2.0.7"]
    a.services.upsert(Service(frontend=Frontend("10.96.1.1", 8080),
                              backends=[Backend(ip="10.1.0.7", port=8080)],
                              name="orders", namespace="default",
                              shared=False))
    a.publisher.publish_services()
    steps.append([bk.ip for bk in b.services.active_backends(svc)])
    a.services.upsert(Service(frontend=Frontend("10.96.1.1", 8080),
                              backends=[Backend(ip="10.1.0.7", port=8080)],
                              name="orders", namespace="default",
                              shared=True))
    a.publisher.publish_services()
    steps.append([bk.ip for bk in b.services.active_backends(svc)])
    b.mesh.disconnect("alpha")
    steps.append([bk.ip for bk in b.services.active_backends(svc)])
    assert steps[1:] == [["10.2.0.7"], ["10.2.0.7", "10.1.0.7"],
                         ["10.2.0.7"]]
    return {"steps": steps, "picked": picked,
            "a": a.store.list_prefix(p.cm.SERVICES_PREFIX)}


SCENARIOS = {
    "remote_endpoints_become_matchable": _remote_endpoints_become_matchable,
    "policy_selects_remote_cluster_identity":
        _policy_selects_remote_cluster_identity,
    "full_mesh_no_echo": _full_mesh_no_echo,
    "disconnect_removes_remote_state": _disconnect_removes_remote_state,
    "publisher_lease_expiry_ages_out_dead_agent": _publisher_lease_expiry,
    "reconnect_fires_on_change_once": _reconnect_fires_on_change_once,
    "session_and_heartbeat_faults_then_repair":
        _session_and_heartbeat_faults_then_repair,
    "decode_errors_are_counted": _decode_errors_are_counted,
    "global_service_merges_remote_backends":
        _global_service_merges_remote_backends,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_clustermesh_scenario_equals_the_reference(name):
    ref, port = _both(SCENARIOS[name])
    assert port == ref


def test_mesh_scale_announcements_resolve_with_the_cluster_tag():
    """The shape of chip_smoke's phase 15d, cut to 2000 endpoints:
    announcements through publisher → kvstore → remote cluster into a
    local ipcache, each resolving to an identity tagged with the remote
    cluster — ``IPCache.dump()`` equal to the reference's."""
    def scenario(p):
        a, b = _Cluster(p, "alpha"), _Cluster(p, "beta")
        rc = b.mesh.connect("alpha", a.store)
        for i in range(2000):
            a.endpoint_add({"app": f"m{i % 40}"},
                           f"10.{8 + i // 60000}.{(i // 250) % 240}."
                           f"{i % 250 + 1}")
        assert rc.num_entries() == 2000
        for e in b.ipcache.dump():
            lbls = b.alloc.lookup(e["identity"])
            assert lbls.get(p.cm.CLUSTER_LABEL_KEY,
                            p.labels.SOURCE_K8S).value == "alpha"
        return b.ipcache.dump()

    ref, port = _both(scenario)
    assert port == ref and len(port) == 2000


def test_clustermesh_state_carried_from_a_reference_store():
    """A port ``RemoteCluster`` watching ``store_from_reference`` of the
    store a reference publisher filled resolves every announced prefix
    with the reference's labels and the remote tag."""
    from cilium_tpu_torch.weights import store_from_reference

    with JAX.simclock.use(JAX.simclock.VirtualClock(start=1000.0)):
        ref = _Cluster(JAX, "alpha")
        for i in range(200):
            ref.endpoint_add({"app": f"w{i % 7}"}, f"10.5.0.{i + 1}")
        items = ref.store.list_prefix("")
    port = _Cluster(PORT, "beta")
    port.mesh.connect("alpha", store_from_reference(items))
    for i in range(200):
        view = port.remote_view(f"10.5.0.{i + 1}")
        assert view == tuple(sorted(
            (f"k8s:app=w{i % 7}",
             f"k8s:{PORT.cm.CLUSTER_LABEL_KEY}=alpha")))
