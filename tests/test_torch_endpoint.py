"""The port's endpoint plane against the JAX package's, on the CPU:
endpoints and their regeneration, IPAM, mutual auth, proxy ports and
the health mesh.

Mirrors ``tests/test_ipam.py``, ``tests/test_proxy_manager.py``,
``tests/test_auth_mode.py`` (the CLI case over REST, as the CLI calls
it; the CLI itself is held in ``tests/test_torch_cli.py``) and
``tests/test_health_mesh.py`` (two agents over one kvstore), each case
run through both packages and compared: endpoint JSON, IPAM state,
redirect tables, ``pairs_array`` tables, verdict lanes on both engines
(the gate off and on), health status. Also the endpoint manager's own
faces: ``with_cluster_label``, checkpoint and restore, regeneration
coalescing (``_gen_target`` / ``_gen_done``), the DNS proxy's
allow-sets and ``update_named_ports``.
"""

import json
import os
import time

import pytest

from test_torch_agent import (
    svc_client,
    PKGS,
    both,
    flow,
    lanes,
    make_agent,
    running,
    short_dir,
)

AUTH_CNP = """
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata: {name: mtls}
spec:
  endpointSelector: {matchLabels: {app: svc}}
  ingress:
  - fromEndpoints: [{matchLabels: {app: peer}}]
    authentication: {mode: required}
    toPorts: [{ports: [{port: "443", protocol: TCP}]}]
  - fromEndpoints: [{matchLabels: {app: open}}]
    toPorts: [{ports: [{port: "80", protocol: TCP}]}]
"""

HTTP_CNP = """
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata: {name: http-api}
spec:
  endpointSelector: {matchLabels: {app: svc}}
  ingress:
  - fromEndpoints: [{matchLabels: {app: peer}}]
    toPorts:
    - ports: [{port: "80", protocol: TCP}]
      rules:
        http: [{method: GET, path: "/.*"}]
"""

KAFKA_CNP = """
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata: {name: kafka-acl}
spec:
  endpointSelector: {matchLabels: {app: svc}}
  ingress:
  - fromEndpoints: [{matchLabels: {app: peer}}]
    toPorts:
    - ports: [{port: "9092", protocol: TCP}]
      rules:
        kafka: [{role: produce, topic: t}]
"""

DNS_CNP = """
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata: {name: dns-egress}
spec:
  endpointSelector: {matchLabels: {app: crawler}}
  egress:
  - toEndpoints: [{matchLabels: {app: kube-dns}}]
    toPorts:
    - ports: [{port: "53", protocol: UDP}]
      rules:
        dns: [{matchPattern: "*.cilium.io"}]
"""


def cnp(P, text):
    return P.cnp.load_cnp_yaml_text(text)[0]


# ================================================================ test_ipam
def test_cluster_pool_and_node_allocator():
    def run(P, tmp):
        I = P.ipam
        out = {}
        pool = I.ClusterPool("10.128.0.0/16", node_mask_size=24)
        out["cidrs"] = [pool.allocate_node_cidr(f"node{i}")
                        for i in range(10)]
        out["again"] = pool.allocate_node_cidr("node0")
        pool.release_node_cidr("node0")
        out["fresh"] = pool.allocate_node_cidr("node-new")
        pool.adopt_node_cidr("adopted", "10.128.200.0/24")
        pool.adopt_node_cidr("adopted", "10.128.200.0/24")
        for bad in ("10.128.200.0/24", "10.129.0.0/24", "10.128.0.0/25"):
            try:
                pool.adopt_node_cidr("other", bad)
                out.setdefault("adopt", []).append("ok")
            except ValueError as e:
                out.setdefault("adopt", []).append(str(e))
        small = I.ClusterPool("10.0.0.0/30", node_mask_size=31)
        small.allocate_node_cidr("a")
        small.allocate_node_cidr("b")
        with pytest.raises(I.PoolExhausted):
            small.allocate_node_cidr("c")
        with pytest.raises(ValueError):
            I.ClusterPool("10.0.0.0/16", node_mask_size=8)
        alloc = I.NodeAllocator("10.0.0.0/29")
        out["six"] = [alloc.allocate() for _ in range(6)]
        with pytest.raises(I.PoolExhausted):
            alloc.allocate()
        out["rel"] = [alloc.release("10.0.0.3"), alloc.release("10.0.0.3"),
                      alloc.allocate(), alloc.available, alloc.dump()]
        a2 = I.NodeAllocator("10.0.0.0/24")
        out["readopt"] = a2.allocate_ip("10.0.0.9")
        with pytest.raises(I.PoolExhausted):
            a2.allocate_ip("10.0.0.9")
        with pytest.raises(ValueError):
            a2.allocate_ip("192.168.0.1")
        out["next"] = [a2.allocate() for _ in range(12)]
        return out

    got = both(run)
    assert len(set(got["cidrs"])) == 10 and "10.0.0.0" not in got["six"]


def test_agent_ipam_endpoint_lifecycle():
    def run(P, tmp):
        with running(P, tmp, cfg_fields={"pod_cidr": "10.7.0.0/24"}) as a:
            out = []
            ep = a.endpoint_add(1, {"app": "web"})
            out.append([ep.ipv4, a.ipcache.lookup(ep.ipv4) == ep.identity])
            ep2 = a.endpoint_add(2, {"app": "db"})
            out.append(ep2.ipv4)
            a.endpoint_remove(1)
            out.append([a.ipcache.lookup(ep.ipv4), a.status()["ipam"]])
            again = a.endpoint_add(2, {"app": "db"})  # CNI ADD retry
            out.append([again.ipv4, a.ipam.dump()])
            a.endpoint_add(3, {"app": "web"}, ipv4="10.7.0.5")
            with pytest.raises(P.ipam.PoolExhausted):
                a.endpoint_add(4, {"app": "db"}, ipv4="10.7.0.5")
            moved = a.endpoint_add(3, {"app": "web"}, ipv4="10.7.0.6")
            out.append([moved.ipv4, a.ipcache.lookup("10.7.0.5")])
            out.append(a.endpoint_add(5, {"app": "x"},
                                      ipv4="10.7.0.5").ipv4)
            out.append(a.endpoint_add(6, {"app": "y"},
                                      ipv4="192.168.1.1").ipv4)
            a.endpoint_remove(99)
            out.append([a.status()["ipam"], a.ipam.dump(),
                        sorted(e.endpoint_id for e in
                               a.endpoint_manager.endpoints())])
            return out

    got = both(run)
    assert got[0][0].startswith("10.7.0.")


def test_host_endpoint_and_kube_apiserver_ips():
    def run(P, tmp):
        with running(P, tmp, cfg_fields={
                "kube_apiserver_ips": ("10.96.0.1", "fd00::1")}) as a:
            host = a.host_endpoint_add({"node": "n1"}, ipv4="10.0.0.250")
            return [host.to_json(), a.ipcache.lookup("10.96.0.1"),
                    sorted(str(x) for x in a.ipcache.dump())]

    got = both(run)
    assert got[0]["identity"] == 1 and got[1] == 7


# ======================================================== test_proxy_manager
def test_proxy_manager_acquire_release_reuse():
    def run(P, tmp):
        PM = P.proxy_manager
        pm = PM.ProxyManager(port_min=100, port_max=101)
        out = [pm.acquire("http", True, (1, 80)).proxy_port,
               pm.acquire("http", True, (2, 80)).proxy_port,
               pm.acquire("kafka", True, (1, 9092)).proxy_port]
        with pytest.raises(PM.ProxyPortExhausted):
            pm.acquire("dns", False, (1, 53))
        pm.release("http", True, (1, 80))
        out.append(pm.lookup("http", True))
        pm.release("http", True, (2, 80))
        pm.release("nope", True, (2, 80))
        out += [pm.lookup("http", True),
                pm.acquire("dns", False, (1, 53)).proxy_port, pm.dump()]
        return out

    assert both(run)[:3] == [100, 100, 101]


def test_agent_reconciles_redirect_lifecycle():
    def run(P, tmp):
        with running(P, tmp) as agent:
            agent.endpoint_add(1, {"app": "svc"})
            agent.endpoint_add(2, {"app": "peer"})
            out = [agent.proxy_manager.dump()]
            agent.policy_add(cnp(P, HTTP_CNP))
            out.append(agent.proxy_manager.dump())
            agent.policy_add(cnp(P, KAFKA_CNP))
            out.append(agent.proxy_manager.dump())
            agent.policy_delete(
                ["k8s:io.cilium.k8s.policy.name=http-api",
                 "k8s:io.cilium.k8s.policy.namespace=default"])
            out.append(agent.proxy_manager.dump())
            out.append(agent.proxy_manager.lookup("kafka", True))
            return out

    got = both(run)
    assert got[0] == [] and [d["l7proto"] for d in got[3]] == ["kafka"]


# ============================================================ test_auth_mode
@pytest.mark.parametrize("offload", [False, True])
def test_auth_required_lane_and_enforcement(offload):
    def run(P, tmp):
        with running(P, tmp, offload=offload) as agent:
            svc = agent.endpoint_add(1, {"app": "svc"})
            peer = agent.endpoint_add(2, {"app": "peer"})
            open_ep = agent.endpoint_add(3, {"app": "open"})
            agent.policy_add(cnp(P, AUTH_CNP))
            fl = [flow(P, peer.identity, svc.identity, 443),
                  flow(P, open_ep.identity, svc.identity, 80),
                  flow(P, peer.identity, svc.identity, 80)]
            out = {"lane_only": lanes(agent.loader.engine.verdict_flows(
                fl, authed_pairs=P.auth.AUTH_UNENFORCED))}
            out["closed"] = lanes(agent.loader.engine.verdict_flows(fl))
            out["pre"] = lanes(agent.process_flows(fl))
            agent.auth.authenticate(peer.identity, svc.identity)
            out["authed"] = lanes(agent.process_flows(fl))
            out["pairs"] = agent.auth.pairs_array().tolist()
            agent.auth.revoke(peer.identity, svc.identity)
            out["revoked"] = lanes(agent.process_flows(fl))
            mgr = P.auth.AuthManager()
            mgr.authenticate(peer.identity, svc.identity)
            out["other_mgr"] = lanes(agent.loader.engine.verdict_flows(
                fl, authed_pairs=mgr.pairs_array()))
            return out

    got = both(run)
    assert got["lane_only"]["verdict"] == [1, 1, 2]
    assert got["lane_only"]["auth_required"] == [True, False, False]
    assert got["pre"]["verdict"][0] == 2
    assert got["authed"]["verdict"][0] == 1
    assert got["revoked"]["verdict"][0] == 2


def test_auth_ttl_expiry_and_manager():
    def run(P, tmp):
        A = P.auth
        mgr = A.AuthManager()
        out = []
        for bad in (2**31, -1, A.PAIR_SENTINEL):
            for args in ((bad, 5), (5, bad)):
                with pytest.raises(ValueError):
                    mgr.authenticate(*args)
        for i in range(10):
            mgr.authenticate(100 - i, i)
        arr = mgr.pairs_array()
        out.append(arr.tolist())
        out.append([arr.dtype.name, mgr.is_authed(91, 9),
                    mgr.is_authed(9, 91), mgr.revoke(91, 9),
                    mgr.revoke(91, 9), len(mgr.pairs())])
        mgr.authenticate(1, 2, ttl=0.05)
        cached = mgr.pairs_array()
        out.append(int((cached[:, 0] == 1).sum()))
        time.sleep(0.1)
        out.append(int((mgr.pairs_array()[:, 0] == 1).sum()))
        out.append([mgr.expire(), mgr.expire(), mgr.is_authed(1, 2)])
        return out

    got = both(run)
    assert got[2] == 1 and got[3] == 0 and got[4][0] == 1


def test_auth_survives_entry_merge():
    merged = """
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata: {name: merged}
spec:
  endpointSelector: {matchLabels: {app: svc}}
  ingress:
  - fromEndpoints: [{matchLabels: {app: peer}}]
    toPorts: [{ports: [{port: "443", protocol: TCP}]}]
  - fromEndpoints: [{matchLabels: {app: peer}}]
    authentication: {mode: required}
    toPorts: [{ports: [{port: "443", protocol: TCP}]}]
"""

    def run(P, tmp):
        with running(P, tmp, offload=True) as agent:
            svc = agent.endpoint_add(1, {"app": "svc"})
            peer = agent.endpoint_add(2, {"app": "peer"})
            agent.policy_add(cnp(P, merged))
            return lanes(agent.loader.engine.verdict_flows(
                [flow(P, peer.identity, svc.identity, 443)]))

    assert both(run)["auth_required"] == [True]


def test_verdict_service_enforces_auth():
    def run(P, tmp):
        sock = os.path.join(tmp, "svc.sock")
        with running(P, tmp, socket_path=sock) as agent:
            svc = agent.endpoint_add(1, {"app": "svc"})
            peer = agent.endpoint_add(2, {"app": "peer"})
            agent.policy_add(cnp(P, AUTH_CNP))
            f = P.ingest.flow_to_dict(flow(P, peer.identity,
                                           svc.identity, 443))
            client = svc_client(P, sock)
            try:
                out = [client.call({"op": "verdict", "flows": [f]})]
                agent.auth.authenticate(peer.identity, svc.identity)
                out.append(client.call({"op": "verdict", "flows": [f]}))
                out.append(client.call({"op": "check", "flow": f}))
            finally:
                client.close()
            return [{k: v for k, v in r.items() if k != "trace_id"}
                    for r in out]

    got = both(run)
    assert got[0]["verdicts"] == [2] and got[1]["verdicts"] == [1]


# ========================================================= test_health_mesh
def mesh_agent(P, store, name, tmp):
    return make_agent(P, os.path.join(tmp, name),
                      cfg_fields={"node_name": name}, kvstore=store,
                      api_socket_path=os.path.join(tmp, f"{name}.sock"))


def test_agents_probe_each_other():
    def run(P, tmp):
        store = P.kvstore.KVStore()
        a = mesh_agent(P, store, "na", tmp)
        b = mesh_agent(P, store, "nb", tmp)
        try:
            out = [sorted(a.health.status()), sorted(b.health.status())]
            a.health.probe_all()
            st = a.health.status()["nb"]
            out.append([st.reachable, st.last_latency_s > 0,
                        st.consecutive_failures, st.last_error])
            out.append(sorted(store.list_prefix("cilium/")))
        finally:
            b.stop()
            out.append(sorted(a.health.status()))
            a.stop()
        out.append(sorted(store.list_prefix("cilium/")))
        return out

    got = both(run)
    assert got[0] == ["nb"] and got[1] == ["na"] and got[2][0] is True


def test_dead_peer_becomes_unreachable():
    def run(P, tmp):
        H = P.health
        store = P.kvstore.KVStore()
        a = mesh_agent(P, store, "na", tmp)
        checker = H.HealthChecker(node_name="observer",
                                  failure_threshold=2)
        watcher = H.HealthPeerWatcher(store, checker).start()
        try:
            out = [sorted(checker.status())]
            checker.probe_all()
            out.append(checker.status()["na"].reachable)
            a.api_server.stop()
            checker.probe_all()
            out.append(checker.status()["na"].reachable)
            checker.probe_all()
            st = checker.status()["na"]
            out.append([st.reachable, st.consecutive_failures,
                        checker.unreachable()])
            return out
        finally:
            watcher.stop()
            a.stop()

    assert both(run)[-1][:2] == [False, 2]


def test_lease_lapse_ages_peer_out():
    def run(P, tmp):
        H = P.health
        store = P.kvstore.KVStore()
        checker = H.HealthChecker(node_name="observer")
        watcher = H.HealthPeerWatcher(store, checker).start()
        try:
            ad = P.advertise.Advertisement(
                store, H.PEERS_PREFIX + "ghost",
                '{"socket": "/nonexistent"}', ttl=0.05)
            out = [sorted(checker.status())]
            time.sleep(0.1)
            store.expire_leases()
            out.append(sorted(checker.status()))
            ad.heartbeat()
            out.append(sorted(checker.status()))
            ad.heartbeat()
            ad.withdraw()
            ad.withdraw()
            out.append(sorted(checker.status()))
            store.set(H.PEERS_PREFIX + "junk", "not json")
            out.append(sorted(checker.status()))
            checker.add_node("manual", lambda: None)
            checker.remove_node("manual")
            return out
        finally:
            watcher.stop()

    assert both(run) == [["ghost"], [], ["ghost"], [], []]


def test_socket_probe_raises_on_dead_socket():
    for P in PKGS:
        with short_dir() as tmp:
            with pytest.raises(Exception):
                P.health.socket_probe(os.path.join(tmp, "nope.sock"))()


# ======================================================= endpoint manager
def test_with_cluster_label():
    def run(P, tmp):
        L = P.labels
        out = []
        for labels in (L.LabelSet.from_dict({"app": "web"}),
                       L.LabelSet.parse(["reserved:world"]),
                       L.LabelSet.parse(["cidr:10.0.0.0/8"]),
                       L.LabelSet.parse([
                           "k8s:io.cilium.k8s.policy.cluster=other",
                           "k8s:app=x"])):
            out.append(sorted(P.endpoint.with_cluster_label(
                labels, "c1").format()))
        return out

    got = both(run)
    assert "k8s:io.cilium.k8s.policy.cluster=c1" in got[0]


def test_endpoint_checkpoint_restore_and_named_ports():
    def run(P, tmp):
        state = os.path.join(tmp, "state")
        agent = make_agent(P, tmp, start=False, state_dir=state)
        agent.endpoint_add(1, {"app": "svc"}, ipv4="10.0.0.5",
                           named_ports={"web": 8080})
        agent.endpoint_add(2, {"app": "peer"}, ipv4="10.0.0.6")
        agent.endpoint_config(1, policy_audit_mode=True)
        agent.endpoint_manager.update_named_ports(1, {"web": 9090})
        agent.stop()
        with open(os.path.join(state, "endpoints.json")) as fp:
            saved = sorted(json.load(fp), key=lambda d: d["id"])
        with running(P, tmp, state_dir=state) as a2:
            a2.endpoint_manager.regenerate_all(wait=True)
            eps = sorted((e.to_json() for e in
                          a2.endpoint_manager.endpoints()),
                         key=lambda d: d["id"])
            states = sorted(e.state.value for e in
                            a2.endpoint_manager.endpoints())
            return [saved, eps, states, a2.ipam.dump(),
                    a2.ipcache.lookup("10.0.0.5") == eps[0]["identity"]]

    got = both(run)
    assert got[1][0]["named_ports"] == {"web": 9090}
    assert got[1][0]["policy_audit_mode"] is True


def test_regeneration_coalesces_and_counts():
    """Many queued triggers coalesce: the manager's generation counters
    and the loader's revision end equal in both packages, and a
    regeneration covers every endpoint."""

    def run(P, tmp):
        with running(P, tmp) as agent:
            em = agent.endpoint_manager
            for i in range(6):
                agent.endpoint_add(i + 1, {"app": f"a{i % 3}"})
            futs = [em.regenerate_all() for _ in range(8)]
            for f in futs:
                f.result()
            em.regenerate_all(wait=True)
            m = P.metrics.METRICS
            return {"target": em._gen_target,
                    "covered": em._gen_done == em._gen_target,
                    "states": sorted({e.state.value
                                      for e in em.endpoints()}),
                    "revs": sorted({e.policy_revision
                                    for e in em.endpoints()}),
                    "regens": m.get(
                        "cilium_tpu_endpoint_regenerations_total") > 0}

    got = both(run)
    assert got["covered"] is True and got["states"] == ["ready"]


def test_dns_proxy_allow_sets_follow_policy():
    def run(P, tmp):
        with running(P, tmp) as agent:
            c = agent.endpoint_add(1, {"app": "crawler"})
            agent.endpoint_add(2, {"app": "kube-dns"})
            agent.policy_add(cnp(P, DNS_CNP))
            em = agent.endpoint_manager
            out = [{k: sorted(v) for k, v in em._dns_ports.items()}]
            out.append([agent.dns_proxy.check_allowed(1, 53, n) for n in
                        ("www.cilium.io", "evil.com")])
            agent.policy_delete(["k8s:io.cilium.k8s.policy.name=dns-egress"])
            out.append({k: sorted(v) for k, v in em._dns_ports.items()})
            out.append([agent.dns_proxy.check_allowed(1, 53, n) for n in
                        ("www.cilium.io", "evil.com")])
            agent.endpoint_remove(1)
            out.append(c.state.value)
            return out

    got = both(run)
    assert got[0][1] == [53] and got[1] == [True, False]


@pytest.mark.parametrize("offload", [False, True])
def test_to_groups_provider_and_secret_hooks(offload):
    groups = """
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata: {name: to-groups}
spec:
  endpointSelector: {matchLabels: {app: client}}
  egress:
  - toGroups:
    - aws: {securityGroupsIds: [sg-1234]}
"""

    def run(P, tmp):
        with running(P, tmp, offload=offload) as agent:
            client = agent.endpoint_add(1, {"app": "client"})
            in_grp = agent.ipcache.upsert("198.18.0.5/32", None)
            out_grp = agent.ipcache.upsert("198.19.0.5/32", None)
            group_cidrs = ["198.18.0.0/16"]
            agent.register_group_provider("aws", lambda spec: group_cidrs)
            agent.policy_add(cnp(P, groups))
            eg = P.flow.TrafficDirection.EGRESS
            fl = [P.flow.Flow(src_identity=client.identity,
                              dst_identity=int(d), dport=443,
                              direction=eg) for d in (in_grp, out_grp)]
            out = [lanes(agent.process_flows(fl))]
            group_cidrs[:] = ["198.19.0.0/16"]
            agent.endpoint_manager.regenerate_all(wait=True)
            out.append(lanes(agent.process_flows(fl)))
            agent.register_group_provider("aws", lambda spec: 1 / 0)
            out.append(lanes(agent.process_flows(fl)))
            agent.secret_set("default", "tok", "s3cret")
            out.append(agent.secrets.lookup("default", "tok"))
            agent.secret_delete("default", "tok")
            out.append(agent.secrets.lookup("default", "tok"))
            return out

    got = both(run)
    assert got[0]["verdict"] == [1, 2] and got[1]["verdict"] == [2, 1]
    assert got[2]["verdict"] == [2, 2]
