"""The port's agent on the cluster control services, against the JAX
package's, on the CPU: the slice as a whole at a small size.

* the non-CLI cases of ``tests/test_k8s_agent.py`` (the watcher bridge:
  CNP and CCNP in, an unparseable CNP keeping the previous state,
  CEP and CiliumNode status out, orphan CEPs pruned);
* ``tests/test_k8s_replay_golden.py`` in both its ``oracle`` and
  ``tpu-engine`` modes against ``tests/golden/k8s_replay.jsonl``: every
  checkpoint's verdicts equal the golden ones in both packages, and the
  lanes each engine returns are equal across the packages;
* ``tests/test_identity_kvstore.py::test_cross_node_policy_enforcement``
  (two cluster-pool agents over a served kvstore, with the operator);
* ``tests/test_clustermesh.py::test_global_services_across_processes``
  and the two controller-manager cases of ``tests/test_clustermesh.py``;
* the slice's own path, phase 19 of ``chip_smoke.py`` at 8 rules and 64
  flows: the port's control plane as OS processes (each by its
  ``main``), the reference's in threads, two agents each in
  ``cluster-pool`` IPAM with ``crd`` identities, a CNP applied through
  the apiserver, the relay's merged stream, the leader's failover and
  the CNP's deletion.

Tolerance: exact, on every lane. Each package runs under its own
``VirtualClock`` kept flowing at the wall rate; the agents' gate is set
alike in both packages, and the port's agents run with
``device="cpu"`` (the plain versions). A scenario stops its servers
before its agents, so the informers stop at once.
"""

import contextlib
import dataclasses
import importlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "k8s_replay.jsonl")
LANES = ("verdict", "match_spec", "ruleset", "allowed", "l3l4_allowed",
         "redirect", "l7_ok", "l7_log", "auth_required", "l7_match")
CNP = "ciliumnetworkpolicies"

PKG_MODULES = (("agent", "agent"), ("config", "core.config"),
               ("flow", "core.flow"), ("labels", "core.labels"),
               ("apiserver", "k8s.apiserver"), ("kv", "kvstore"),
               ("svc", "kvstore_service"), ("operator", "operator"),
               ("endpoint", "endpoint"), ("cnp", "policy.api.cnp"),
               ("controller", "runtime.controller"),
               ("lb", "loadbalancer"), ("synth", "ingest.synth"),
               ("ingest", "ingest.hubble"), ("relay", "hubble.relay"),
               ("server", "hubble.server"), ("leader", "runtime.leader"),
               ("simclock", "runtime.simclock"))


def _pkg(root):
    ns = types.SimpleNamespace(root=root, jax=root == "cilium_tpu")
    for attr, mod in PKG_MODULES:
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX, PORT = _pkg("cilium_tpu"), _pkg("cilium_tpu_torch")


@contextlib.contextmanager
def short_dir():
    d = tempfile.mkdtemp(prefix="k8a")
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


def _both(scenario, *args):
    out = []
    for p in (JAX, PORT):
        with short_dir() as tmp, flowing(p) as clock:
            out.append(scenario(p, tmp, clock, *args))
    assert out[0] == out[1], out
    return out[1]


def wait_until(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def lanes(out):
    return {k: np.asarray(out[k]).tolist() for k in LANES if k in out}


def config(p, tmp, name="node-0", offload=False, **fields):
    cfg = p.config.Config()
    cfg.node_name = name
    cfg.configure_logging = False
    cfg.enable_tpu_offload = offload
    cfg.loader.cache_dir = os.path.join(tmp, f"cache-{name}")
    cfg.compile.deadline_s = 600.0
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


def make_agent(p, cfg, **kw):
    extra = {} if p.jax else {"device": "cpu"}
    return p.agent.Agent(config=cfg, **kw, **extra).start()


def cnp_obj(name, port="5432", ns="default", app="web"):
    return {"apiVersion": "cilium.io/v2", "kind": "CiliumNetworkPolicy",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"endpointSelector": {"matchLabels": {"app": "db"}},
                     "ingress": [{
                         "fromEndpoints": [{"matchLabels": {"app": app}}],
                         "toPorts": [{"ports": [
                             {"port": port, "protocol": "TCP"}]}]}]}}


@contextlib.contextmanager
def k8s_agent(p, tmp, **fields):
    """An apiserver and an agent bridged to it (its own in-process
    kvstore); the server stops first."""
    server = p.apiserver.APIServer(os.path.join(tmp, "k8s.sock")).start()
    agent = None
    try:
        agent = make_agent(p, config(p, tmp, k8s_api_socket=server.socket_path,
                                     **fields), kvstore=p.kv.KVStore())
        yield server, p.apiserver.K8sClient(server.socket_path), agent
    finally:
        server.stop()
        if agent is not None:
            agent.stop()


def verdicts(p, agent, db, web, dport=5432):
    F = p.flow.Flow
    out = agent.process_flows([
        F(src_identity=web.identity, dst_identity=db.identity, dport=dport),
        F(src_identity=db.identity, dst_identity=db.identity, dport=dport)])
    return [int(v) for v in out["verdict"]]


# ========================================= tests/test_k8s_agent.py
def _cnp_lifecycle_drives_enforcement(p, tmp, clock):
    server = p.apiserver.APIServer(os.path.join(tmp, "k8s.sock")).start()
    c = p.apiserver.K8sClient(server.socket_path)
    # applied BEFORE the agent starts: enforced at start (the first
    # informer list is synchronous)
    c.create(CNP, cnp_obj("allow-web"))
    agent = make_agent(p, config(p, tmp, k8s_api_socket=server.socket_path),
                       kvstore=p.kv.KVStore())
    try:
        db = agent.endpoint_add(1, {"app": "db"})
        web = agent.endpoint_add(2, {"app": "web"})
        agent.endpoint_manager.regenerate_all(wait=True)
        steps = [verdicts(p, agent, db, web)]
        assert steps[-1] == [1, 2]
        c.apply(CNP, cnp_obj("allow-web", app="api"))
        assert wait_until(lambda: verdicts(p, agent, db, web) == [2, 2])
        steps.append(verdicts(p, agent, db, web))
        c.apply(CNP, cnp_obj("allow-web", port="6000"))
        assert wait_until(
            lambda: verdicts(p, agent, db, web, dport=6000) == [1, 2])
        steps.append(verdicts(p, agent, db, web, dport=5432))
        assert steps[-1] == [2, 2]  # the upsert replaced the old port
        c.delete(CNP, "allow-web")
        assert wait_until(lambda: verdicts(p, agent, db, web) == [1, 1])
        steps.append(verdicts(p, agent, db, web))
        return steps, [int(db.identity), int(web.identity)]
    finally:
        server.stop()
        agent.stop()


def test_cnp_lifecycle_drives_enforcement():
    _both(_cnp_lifecycle_drives_enforcement)


def _unparseable_cnp_keeps_previous_state(p, tmp, clock):
    with k8s_agent(p, tmp) as (_, c, agent):
        db = agent.endpoint_add(1, {"app": "db"})
        web = agent.endpoint_add(2, {"app": "web"})
        c.create(CNP, cnp_obj("allow-web"))
        assert wait_until(lambda: verdicts(p, agent, db, web) == [1, 2])
        bad = cnp_obj("allow-web")
        bad["spec"]["ingress"][0]["toPorts"][0]["ports"][0][
            "protocol"] = "BOGUS"  # SanitizeError in parse_cnp
        rules = len(agent.repo.rules())
        c.apply(CNP, bad)
        time.sleep(0.5)
        got = verdicts(p, agent, db, web)
        assert got == [1, 2]
        assert len(agent.repo.rules()) == rules
        return got, rules


def test_unparseable_cnp_keeps_previous_state():
    _both(_unparseable_cnp_keeps_previous_state)


def _ccnp_ingest(p, tmp, clock):
    with k8s_agent(p, tmp) as (_, c, agent):
        db = agent.endpoint_add(1, {"app": "db"})
        web = agent.endpoint_add(2, {"app": "web"})
        ccnp = cnp_obj("cluster-allow")
        ccnp["kind"] = "CiliumClusterwideNetworkPolicy"
        del ccnp["metadata"]["namespace"]
        c.create("ciliumclusterwidenetworkpolicies", ccnp)
        assert wait_until(lambda: verdicts(p, agent, db, web) == [1, 2])
        labels = sorted(agent.repo.rules()[0].labels)
        c.delete("ciliumclusterwidenetworkpolicies", "cluster-allow")
        assert wait_until(lambda: verdicts(p, agent, db, web) == [1, 1])
        return labels


def test_ccnp_ingest():
    _both(_ccnp_ingest)


def _publish_node_conflict_is_best_effort(p, tmp, clock):
    with k8s_agent(p, tmp) as (_, c, agent):
        bridge = agent.k8s_bridge

        def conflicting_apply(plural, obj):
            raise p.apiserver.Conflict("stale resourceVersion 1 (current 3)")

        original = bridge.client.apply
        bridge.client.apply = conflicting_apply
        try:
            bridge.publish_node()  # must not raise
        finally:
            bridge.client.apply = original
        bridge.publish_node()  # and the real path still works
        node = c.get("ciliumnodes", agent.config.node_name)
        return node["spec"], node["metadata"]["generation"]


def test_publish_node_conflict_is_best_effort():
    _both(_publish_node_conflict_is_best_effort)


def _cep_and_node_status_published(p, tmp, clock):
    with k8s_agent(p, tmp) as (_, c, agent):
        ep = agent.endpoint_add(7, {"app": "db"}, named_ports={"pg": 5432})
        st = c.get("ciliumendpoints", "node-0-ep-7")["status"]
        assert st["id"] == 7
        assert st["identity"]["id"] == int(ep.identity)
        assert "k8s:app=db" in st["identity"]["labels"]
        assert st["networking"]["addressing"][0]["ipv4"] == ep.ipv4
        assert st["named-ports"] == [{"name": "pg", "port": 5432}]
        # How far the first regeneration has got when the CEP is read is
        # thread timing, so each package holds the state to the states a
        # freshly added endpoint can be in, and the packages compare the
        # rest; the synced snapshot below is compared whole.
        assert st["state"] in ("waiting-to-regenerate", "regenerating",
                               "ready")
        st = {k: v for k, v in st.items() if k != "state"}
        agent.endpoint_manager.regenerate_all(wait=True)
        agent.k8s_bridge.sync_endpoint_status()
        synced = c.get("ciliumendpoints", "node-0-ep-7")["status"]
        assert synced["state"] == "ready"
        assert synced["policy"]["revision"] == ep.policy_revision
        node = c.get("ciliumnodes", agent.config.node_name)
        assert node["kind"] == "CiliumNode"
        agent.endpoint_remove(7)
        with pytest.raises(p.apiserver.NotFound):
            c.get("ciliumendpoints", "node-0-ep-7")
        return st, synced, node["spec"]


def test_cep_and_node_status_published():
    _both(_cep_and_node_status_published)


def _cep_sync_prunes_orphans(p, tmp, clock):
    with k8s_agent(p, tmp) as (_, c, agent):
        agent.endpoint_add(9, {"app": "db"})
        c.apply("ciliumendpoints", {
            "metadata": {"name": "node-0-ep-99", "namespace": "default"},
            "status": {"id": 99, "networking":
                       {"node": agent.config.node_name}}})
        c.apply("ciliumendpoints", {
            "metadata": {"name": "other-ep-50", "namespace": "default"},
            "status": {"id": 50, "networking": {"node": "other-node"}}})
        agent.k8s_bridge.sync_endpoint_status()
        names = {o["metadata"]["name"]
                 for o in c.list("ciliumendpoints")["items"]}
        assert names == {"node-0-ep-9", "other-ep-50"}
        return sorted(names)


def test_cep_sync_prunes_orphans():
    _both(_cep_sync_prunes_orphans)


# ================================== tests/test_k8s_replay_golden.py
ENDPOINTS = [(1, "db", {"app": "db"}), (2, "web", {"app": "web"}),
             (3, "crawler", {"app": "crawler"})]


def _golden_replay(p, tmp, clock, offload):
    with open(GOLDEN) as f:
        steps = [json.loads(line) for line in f if line.strip()]
    with k8s_agent(p, tmp, offload=offload) as (_, client, agent):
        eps = {name: agent.endpoint_add(eid, labels)
               for eid, name, labels in ENDPOINTS}
        agent.endpoint_manager.regenerate_all(wait=True)
        F = p.flow.Flow

        def run(chk):
            return agent.process_flows([
                F(src_identity=eps[c["src"]].identity,
                  dst_identity=eps[c["dst"]].identity, dport=c["dport"])
                for c in chk])

        seen = []
        for i, step in enumerate(steps):
            if "checkpoint" in step:
                chk = step["checkpoint"]
                want = [c["want"] for c in chk]
                assert wait_until(lambda: [int(v) for v in run(chk)[
                    "verdict"]] == want), f"step {i}: {want}"
                seen.append(lanes(run(chk)))
            elif step["op"] == "apply":
                client.apply(step["plural"], step["object"])
            elif step["op"] == "delete":
                client.delete(step["plural"], step["name"])
            else:
                raise AssertionError(f"unknown step {step}")
        return seen


@pytest.mark.parametrize("offload", [False, True],
                         ids=["oracle", "tpu-engine"])
def test_recorded_k8s_objects_drive_golden_verdicts(offload):
    seen = _both(_golden_replay, offload)
    assert len(seen) == sum(1 for line in open(GOLDEN)
                            if '"checkpoint"' in line)
    if offload:  # the engine returns every lane
        assert all(set(s) == set(LANES) for s in seen)


# ================================ the cross-process cases of the reference
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


def _cross_node_policy_enforcement(p, tmp, clock):
    path = os.path.join(tmp, "kv.sock")
    server = p.svc.KVStoreServer(path).start()
    op_kv = p.svc.RemoteKVStore(path)
    op = p.operator.Operator(op_kv, pool_cidr="10.60.0.0/16").start()
    agents = []
    try:
        for name in ("node-a", "node-b"):
            agents.append(make_agent(
                p, config(p, tmp, name, ipam_mode="cluster-pool",
                          identity_allocation_mode="kvstore"),
                kvstore=p.svc.RemoteKVStore(path)))
        agent_a, agent_b = agents
        db = agent_a.endpoint_add(1, {"app": "db"})
        web_remote = agent_b.endpoint_add(2, {"app": "web"})
        want_labels = p.endpoint.with_cluster_label(
            p.labels.LabelSet.from_dict({"app": "web"}), "default")
        assert wait_until(lambda: agent_a.allocator.lookup_by_labels(
            want_labels) == web_remote.identity, timeout=30)
        agent_a.policy_add(p.cnp.load_cnp_yaml_text(CNP_YAML)[0])
        assert wait_until(
            lambda: verdicts(p, agent_a, db, web_remote) == [1, 2],
            timeout=30)
        return (verdicts(p, agent_a, db, web_remote),
                [str(a.ipam.cidr) for a in agents],
                [int(db.identity), int(web_remote.identity)])
    finally:
        for a in agents:
            a.stop()
        op.stop()
        op_kv.close()
        server.stop()


def test_cross_node_policy_enforcement():
    _both(_cross_node_policy_enforcement)


def _global_services_across_processes(p, tmp, clock):
    Backend, Frontend, Service = p.lb.Backend, p.lb.Frontend, p.lb.Service
    srv_a = p.svc.KVStoreServer(os.path.join(tmp, "a.sock")).start()
    srv_b = p.svc.KVStoreServer(os.path.join(tmp, "b.sock")).start()
    a = b = None
    try:
        a = make_agent(p, config(p, tmp, "na", cluster_name="alpha"),
                       kvstore=p.svc.RemoteKVStore(srv_a.socket_path))
        b = make_agent(p, config(p, tmp, "nb", cluster_name="beta"),
                       kvstore=p.svc.RemoteKVStore(srv_b.socket_path))
        a.endpoint_add(1, {"app": "orders"}, ipv4="10.1.0.7")
        a.services.upsert(Service(
            frontend=Frontend("10.96.1.1", 8080),
            backends=[Backend(ip="10.1.0.7", port=8080)],
            name="orders", namespace="default", shared=True))
        a.publisher.publish_services()
        b.endpoint_add(10, {"app": "orders"}, ipv4="10.2.0.7")
        b.services.upsert(Service(
            frontend=Frontend("10.97.1.1", 8080),
            backends=[Backend(ip="10.2.0.7", port=8080)],
            name="orders", namespace="default", shared=True))
        # beta watches ALPHA's server over its socket
        b.clustermesh.connect("alpha",
                              p.svc.RemoteKVStore(srv_a.socket_path))
        svc = b.services.get(Frontend("10.97.1.1", 8080))

        def merged():
            return [bk.ip for bk in b.services.active_backends(svc)]

        assert wait_until(lambda: merged() == ["10.2.0.7", "10.1.0.7"],
                          timeout=30)
        assert wait_until(lambda: b.ipcache.lookup("10.1.0.7") is not None,
                          timeout=30)
        return merged(), int(b.ipcache.lookup("10.1.0.7"))
    finally:
        for agent in (a, b):
            if agent is not None:
                agent.stop()
        srv_a.stop()
        srv_b.stop()


def test_global_services_across_processes():
    _both(_global_services_across_processes)


def _controller_manager_restartable_after_stop_all(p, tmp, clock):
    mgr = p.controller.ControllerManager()
    ran = []
    mgr.update("t", lambda: ran.append(1), interval=3600.0)
    mgr.stop_all()
    assert mgr.status() == {}
    before = len(ran)
    mgr.update("t", lambda: ran.append(2), interval=3600.0)
    assert wait_until(lambda: len(ran) > before, timeout=5)
    mgr.stop_all()
    return ran


def test_controller_manager_restartable_after_stop_all():
    assert _both(_controller_manager_restartable_after_stop_all) == [1, 2]


def _update_racing_stop_all(p, tmp, clock):
    mgr = p.controller.ControllerManager()
    release_old = threading.Event()
    old_running = threading.Event()

    def old_fn():
        old_running.set()
        release_old.wait(timeout=10.0)

    mgr.update("x", old_fn, interval=3600.0)
    assert old_running.wait(timeout=5.0)
    new_controller = []
    t = threading.Thread(target=lambda: new_controller.append(
        mgr.update("x", lambda: None, interval=3600.0)))
    t.start()
    # the update thread popped "x" and is joining old_fn
    assert wait_until(lambda: "x" not in mgr.status(), timeout=5)
    mgr.stop_all()  # its snapshot misses "x"
    release_old.set()
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert mgr.status() == {}
    assert new_controller[0]._stop.is_set()
    return mgr.status(), new_controller[0]._stop.is_set()


def test_update_racing_stop_all_does_not_leak_controller():
    _both(_update_racing_stop_all)


# =========================== the slice's own path (chip_smoke phase 19)
def _wait_socket(path, proc=None, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            return
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"{proc.args} exited {proc.returncode}")
        time.sleep(0.05)
    raise AssertionError(f"{path} never appeared")


POOL, TTL = "10.240.0.0/16", 2.0


class ControlPlane:
    """The kvstore, the apiserver, two operators under leader election
    and the live relay: the port's as OS processes started by their
    ``main``s, the reference's as threads in this process."""

    def __init__(self, p, tmp):
        self.p, self.tmp = p, tmp
        self.sock = {k: os.path.join(tmp, f"{k}.sock")
                     for k in ("kv", "k8s", "relay")}
        self.procs, self.threads = {}, {}

    def start(self):
        p, s = self.p, self.sock
        if p.jax:
            self.threads["kv"] = p.svc.KVStoreServer(s["kv"]).start()
            self.threads["k8s"] = p.apiserver.APIServer(s["k8s"]).start()
            self.kvs = []
            for i in (1, 2):
                kv = p.svc.RemoteKVStore(s["kv"])
                self.kvs.append(kv)
                self.threads[f"op{i}"] = p.operator.Operator(
                    kv, pool_cidr=POOL, k8s_api_socket=s["k8s"],
                    leader_election=True, instance=f"op{i}",
                    election_ttl=TTL).start()
            relay = p.relay.FollowingRelay()
            kv = p.svc.RemoteKVStore(s["kv"])
            self.kvs.append(kv)
            self.directory = p.relay.PeerDirectory(kv, relay).start()
            self.relay = relay
            self.threads["relay"] = p.server.HubbleServer(
                relay.observer, s["relay"], relay=relay).start()
            return self
        env = dict(os.environ)
        env.pop("CILIUM_TPU_DEVICE", None)

        def spawn(name, *args):
            self.procs[name] = subprocess.Popen(
                [sys.executable, "-m", *args], cwd=REPO, env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)

        spawn("kv", "cilium_tpu_torch.kvstore_service", s["kv"])
        spawn("k8s", "cilium_tpu_torch.k8s.apiserver", s["k8s"])
        _wait_socket(s["kv"], self.procs["kv"])
        _wait_socket(s["k8s"], self.procs["k8s"])
        for i in (1, 2):
            spawn(f"op{i}", "cilium_tpu_torch.operator", "--kvstore",
                  s["kv"], "--pool-cidr", POOL, "--leader-election",
                  "--election-ttl", str(TTL), "--k8s-api-socket", s["k8s"])
        spawn("relay", "cilium_tpu_torch.hubble.relay", "--kvstore",
              s["kv"], "--socket", s["relay"], "--mode", "live")
        _wait_socket(s["relay"], self.procs["relay"])
        return self

    def leader(self):
        kv = self.p.svc.RemoteKVStore(self.sock["kv"])
        try:
            return kv.get(self.p.leader.LEADER_PREFIX + "cilium-operator")
        finally:
            kv.close()

    def kill_leader(self):
        """SIGTERM (or stop) the leading operator → its name."""
        holder = self.leader()
        if self.p.jax:
            name = holder  # the instance names are op1 / op2
            self.threads.pop(name).stop()
            return name
        for name in ("op1", "op2"):
            proc = self.procs[name]
            if holder == f"operator-{proc.pid}":
                proc.send_signal(signal.SIGTERM)
                assert proc.wait(timeout=30) == 0
                self.procs.pop(name)
                return name
        raise AssertionError(f"no operator holds the lock ({holder})")

    def stop(self):
        """Stop everything; the processes' exit codes by name."""
        rcs = {}
        if self.p.jax:
            for name in ("relay", "op1", "op2", "k8s", "kv"):
                obj = self.threads.pop(name, None)
                if obj is not None:
                    obj.stop()
                    rcs[name] = 0
            self.directory.stop()
            self.relay.stop()
            for kv in self.kvs:
                kv.close()
            return rcs
        for name in ("relay", "op1", "op2", "k8s", "kv"):
            proc = self.procs.pop(name, None)
            if proc is None:
                continue
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
            try:
                rcs[name] = proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                rcs[name] = proc.wait()
        return rcs


def _cluster_slice(p, tmp, clock):
    sc = p.synth.synth_http_scenario(8, 64)
    plane = ControlPlane(p, tmp).start()
    agents = {}
    out = {}
    try:
        assert wait_until(lambda: plane.leader() is not None, timeout=60)
        for name, impl in (("node-a", "auto"), ("node-b", "nfa-bitset")):
            cfg = config(p, tmp, name, offload=True, ipam_mode="cluster-pool",
                         identity_allocation_mode="crd",
                         k8s_api_socket=plane.sock["k8s"])
            cfg.engine.kernel_impl = impl
            agents[name] = make_agent(
                p, cfg, kvstore=p.svc.RemoteKVStore(plane.sock["kv"]),
                hubble_socket_path=os.path.join(tmp, f"{name}.sock"))
        a, b = agents["node-a"], agents["node-b"]
        out["cidrs"] = sorted(str(x.ipam.cidr) for x in (a, b))
        assert len(set(out["cidrs"])) == 2
        assert all(c.endswith("/24") for c in out["cidrs"])
        # server on node-a, client on node-b, and a second server on
        # node-b: equal labels, one identity through CiliumIdentity
        srv = a.endpoint_add(1, sc.endpoints["server"])
        cli = b.endpoint_add(2, sc.endpoints["client"])
        want = p.endpoint.with_cluster_label(
            p.labels.LabelSet.from_dict(sc.endpoints["server"]), "default")
        assert wait_until(
            lambda: b.allocator.lookup_by_labels(want) == srv.identity)
        srv_b = b.endpoint_add(3, sc.endpoints["server"])
        assert srv_b.identity == srv.identity
        out["ids"] = [int(srv.identity), int(cli.identity)]
        # the rule in through the apiserver
        doc = PORT.synth.http_rule_cnp(sc.rules[0], "synth-http")
        parsed = p.cnp.parse_cnp(doc).rules[0]
        assert dataclasses.replace(parsed, labels=sc.rules[0].labels) == \
            sc.rules[0]
        flows = sc.flows
        for f in flows:
            f.src_identity, f.dst_identity = cli.identity, srv.identity
        for x in (a, b):  # settle the endpoints' regenerations
            x.endpoint_manager.regenerate_all(wait=True)

        def probe(x):  # the served engine's verdicts, no fan-out
            out = x.loader.engine.verdict_flows(flows[:16])
            return set(np.asarray(out["verdict"]).tolist())

        revs = {n: x.loader.revision for n, x in agents.items()}
        client = p.apiserver.K8sClient(plane.sock["k8s"])
        client.apply(CNP, doc)
        for n, x in agents.items():
            assert wait_until(lambda: x.loader.revision != revs[n]
                              and 2 in probe(x), timeout=60)
        got = {n: lanes(x.process_flows(flows)) for n, x in agents.items()}
        assert got["node-a"] == got["node-b"]
        mix = np.bincount(got["node-a"]["verdict"], minlength=6).tolist()
        assert mix[2] > 0 and mix[5] > 0
        out["lanes"] = got["node-a"]
        # status published, and the relay's merged stream
        ceps = client.list("ciliumendpoints")["items"]
        out["ceps"] = sorted(o["metadata"]["name"] for o in ceps)
        out["nodes"] = sorted(
            (o["metadata"]["name"], tuple(o["spec"]["ipam"]["podCIDRs"]))
            for o in client.list("ciliumnodes")["items"])
        def stampless(d):
            d.pop("node_name", None)
            return json.dumps(d, sort_keys=True)

        union = sorted(stampless(p.ingest.flow_to_dict(f))
                       for x in (a, b) for f in x.observer.get_flows())
        relay = p.server.HubbleClient(plane.sock["relay"])
        assert wait_until(lambda: len(list(relay.get_flows())) == len(union),
                          timeout=60)
        merged = list(relay.get_flows())
        assert sorted(stampless(d) for d in merged) == union
        out["relay"] = len(merged)
        # the leader's failover: a third node gets its CIDR from the
        # standby
        out["killed"] = plane.kill_leader() in ("op1", "op2")
        assert wait_until(lambda: plane.leader() is not None, timeout=30)
        agents["node-c"] = make_agent(
            p, config(p, tmp, "node-c", ipam_mode="cluster-pool",
                      identity_allocation_mode="crd",
                      k8s_api_socket=plane.sock["k8s"]),
            kvstore=p.svc.RemoteKVStore(plane.sock["kv"]))
        out["cidr_c"] = str(agents["node-c"].ipam.cidr)
        assert out["cidr_c"] not in out["cidrs"]
        # the CNP deleted: both nodes drop its enforcement
        revs = {n: agents[n].loader.revision for n in ("node-a", "node-b")}
        client.delete(CNP, "synth-http")
        for n in ("node-a", "node-b"):
            x = agents[n]
            assert wait_until(lambda: x.loader.revision != revs[n]
                              and not x.repo.rules() and probe(x) == {1},
                              timeout=60)
        after = {n: lanes(agents[n].process_flows(flows))
                 for n in ("node-a", "node-b")}
        assert after["node-a"] == after["node-b"]
        assert set(after["node-a"]["verdict"]) == {1}
        out["after"] = after["node-a"]["verdict"][:4]
    finally:
        rcs = plane.stop()
        for x in agents.values():
            x.stop()
    assert all(rc == 0 for rc in rcs.values()), rcs
    out["rcs"] = len(rcs)
    return out


def test_cluster_slice_over_control_plane_processes():
    out = _both(_cluster_slice)
    assert out["relay"] == 128 and out["rcs"] == 4


def test_http_rule_cnp_round_trips_and_refuses_the_rest():
    """``synth.http_rule_cnp`` renders the http scenario's rule as the
    object ``parse_cnp`` (of either package) reads back into it, and
    raises on what it does not render rather than drop it."""
    for n in (5, 40):
        for p in (JAX, PORT):
            sc = p.synth.synth_http_scenario(n, 8)
            doc = PORT.synth.http_rule_cnp(sc.rules[0], "r")
            got = p.cnp.parse_cnp(doc).rules[0]
            assert dataclasses.replace(got, labels=sc.rules[0].labels) == \
                sc.rules[0]
    from cilium_tpu_torch.policy.api import EgressRule

    rule = PORT.synth.synth_http_scenario(5, 8).rules[0]
    ing = rule.ingress[0]
    for bad in (dataclasses.replace(rule, egress=(EgressRule(),)),
                dataclasses.replace(rule, ingress=(dataclasses.replace(
                    ing, from_entities=("world",)),)),
                dataclasses.replace(rule, ingress=(dataclasses.replace(
                    ing, deny=True),))):
        with pytest.raises(ValueError):
            PORT.synth.http_rule_cnp(bad, "r")
