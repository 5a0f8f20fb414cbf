"""The port's node-local agent against the JAX package's, on the CPU.

Both packages' ``Agent`` are built from one configuration (the port's
with ``device="cpu"``, the plain versions), driven by the same script,
and what each returns is compared field for field:

* ``tests/test_agent.py``: the policy lifecycle, restore, the FQDN
  answer → regeneration path, the controller manager's backoff and the
  observer ring (``test_cli_over_socket_and_replay`` is held in
  ``tests/test_torch_cli.py``);
* ``Agent.process_flows`` at the http scenario (40 rules, 256 flows)
  with the gate on in both packages: the ten lanes bit for bit, before
  and after an auth put, the monitor's events and the annotated flows
  in the Hubble ring (``tests/test_observability.py::
  test_agent_process_flows_feeds_monitor_and_hubble`` with its bugtool
  bundle); the regeneration count and ``engine_revision``;
* the ``kvstore`` identity mode; the configurations that default to
  ``cuda`` and raise without it unless ``device="cpu"``: the cluster
  ones (``crd``, ``k8s_api_socket``, ``cluster-pool``), which build and
  start, an agent from ``Config.from_toml`` (equal to the reference's
  reading of the same file) and one whose service answers the
  ``bugtool`` op with a bundle; the auth module's ``AUTH_UNENFORCED``
  is the engine's own object;
* the service's agent ops (``VerdictService(agent=...)``): ``status``,
  ``policy_get``, ``verdict`` with the monitor fan-out, ``profile`` in
  host mode, ``bugtool`` (the bundle's path) and the LOG sink on
  ``PolicyBridge.accesslog_fn``;
* the three reference tests that need nothing of the daemon or the CLI:
  ``tests/test_accesslog_server.py``, ``tests/test_clustermesh.py::
  test_to_services_sees_remote_backends`` (both gates) and
  ``tests/dst/test_debounce.py::test_agent_identity_hook_is_debounced``.

Stamps that are not data (socket paths, times, trace spans' times) are
taken out before comparing. Every agent is stopped in a ``finally``;
sockets live in short ``tempfile.mkdtemp()`` directories.
"""

import contextlib
import dataclasses
import importlib
import os
import shutil
import tempfile
import threading
import time
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "examples", "policies")
LANES = ("verdict", "match_spec", "ruleset", "allowed", "l3l4_allowed",
         "redirect", "l7_ok", "l7_log", "auth_required", "l7_match")


def _pkg(root):
    ns = types.SimpleNamespace(root=root, jax=root == "cilium_tpu")
    for attr, mod in (("agent", "agent"),
                      ("config", "core.config"),
                      ("flow", "core.flow"),
                      ("labels", "core.labels"),
                      ("cnp", "policy.api.cnp"),
                      ("rule", "policy.api.rule"),
                      ("endpoint", "endpoint"),
                      ("auth", "auth"),
                      ("ipam", "ipam"),
                      ("proxy_manager", "proxy_manager"),
                      ("health", "health"),
                      ("kvstore", "kvstore"),
                      ("advertise", "runtime.advertise"),
                      ("api", "runtime.api"),
                      ("watcher", "runtime.watcher"),
                      ("controller", "runtime.controller"),
                      ("profiling", "runtime.profiling"),
                      ("admission", "runtime.admission"),
                      ("metrics", "runtime.metrics"),
                      ("service", "runtime.service"),
                      ("tracing", "runtime.tracing"),
                      ("hubble", "hubble"),
                      ("ingest", "ingest.hubble"),
                      ("synth", "ingest.synth"),
                      ("trace", "policy.trace"),
                      ("monitor", "monitor"),
                      ("cni", "cni")):
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX, PORT = _pkg("cilium_tpu"), _pkg("cilium_tpu_torch")
PKGS = (JAX, PORT)
k8s = importlib.import_module("cilium_tpu_torch.k8s.apiserver")
operator = importlib.import_module("cilium_tpu_torch.operator")
IDS = ("jax", "port")


def config(P, cache_dir, offload=False, **fields):
    """One configuration for both packages: the gate set alike (the
    packages' defaults differ), logging left to the test runner, a
    cache directory of each package's own and a compile deadline no
    loaded CPU reaches."""
    cfg = P.config.Config()
    cfg.enable_tpu_offload = offload
    cfg.configure_logging = False
    cfg.loader.cache_dir = cache_dir
    cfg.compile.deadline_s = 600.0
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


def make_agent(P, tmp, offload=False, start=True, cfg_fields=None,
               **kw):
    """``P``'s agent on its configuration; the port's on the CPU."""
    cfg = config(P, os.path.join(tmp, "cache"), offload=offload,
                 **(cfg_fields or {}))
    extra = {} if P.jax else {"device": "cpu"}
    agent = P.agent.Agent(cfg, **kw, **extra)
    return agent.start() if start else agent


@contextlib.contextmanager
def running(P, tmp, **kw):
    agent = make_agent(P, tmp, **kw)
    try:
        yield agent
    finally:
        agent.stop()


@contextlib.contextmanager
def short_dir():
    """A short directory for unix sockets (paths stay under 108
    bytes), removed afterwards."""
    d = tempfile.mkdtemp(prefix="ag")
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


def both(fn, *args):
    """Run ``fn(P, tmp, *args)`` for each package in a directory of its
    own; the two results must be equal. Returns the port's."""
    res = []
    for P in PKGS:
        with short_dir() as tmp:
            res.append(fn(P, tmp, *args))
    diff = differing(*res)
    assert not diff, diff[:20]
    return res[1]


def _leaves(obj, pre=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, f"{pre}.{k}")
    elif isinstance(obj, (list, tuple)):
        yield f"{pre}#len", len(obj)
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{pre}[{i}]")
    else:
        yield pre, obj


def differing(a, b):
    """The leaves (path, reference's, port's) where two results
    differ; empty when they are equal."""
    if a == b:
        return []
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    miss = "<missing>"
    return [(k, la.get(k, miss), lb.get(k, miss))
            for k in sorted(set(la) | set(lb))
            if la.get(k, miss) != lb.get(k, miss)] or [("", a, b)]


def svc_client(P, sock, timeout=60.0):
    """``P``'s ``VerdictClient`` with a timeout on every read."""
    client = P.service.VerdictClient(sock)
    client.sock.settimeout(timeout)
    return client


def threads_settle(before, timeout=10.0):
    """Threads the test started are gone (the agent joins its own)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        extra = [t for t in threading.enumerate()
                 if t not in before and t.is_alive()]
        if not extra:
            return []
        time.sleep(0.05)
    return [t.name for t in extra]


def flow(P, src, dst, port, path=None, method="GET", direction=None,
         **kw):
    F = P.flow
    f = F.Flow(src_identity=src, dst_identity=dst, dport=port,
               protocol=F.Protocol.TCP,
               direction=direction or F.TrafficDirection.INGRESS, **kw)
    if path is not None:
        f.l7 = F.L7Type.HTTP
        f.http = F.HTTPInfo(method=method, path=path, host="h")
    return f


def lanes(out):
    return {k: np.asarray(out[k]).tolist() for k in LANES if k in out}


# ============================================================ test_agent.py
def test_agent_policy_lifecycle():
    def run(P, tmp):
        agent = make_agent(P, tmp, start=False)
        try:
            agent.endpoint_add(1, {"app": "service"}, ipv4="10.0.0.1")
            agent.endpoint_add(2, {"app": "frontend"}, ipv4="10.0.0.2")
            agent.policy_add_file(
                os.path.join(FIXTURES, "l7", "http-api.yaml"))
            svc = agent.endpoint_manager.get(1)
            out = {"state": svc.state.value,
                   "rev": [svc.policy_revision, agent.repo.revision]}
            sid, fid = svc.identity, agent.endpoint_manager.get(2).identity
            out["v1"] = lanes(agent.loader.engine.verdict_flows([
                flow(P, fid, sid, 80, "/api/v1/x"),
                flow(P, fid, sid, 80, "/api/v1/x", method="DELETE")]))
            out["n"] = agent.policy_delete(
                ["k8s:io.cilium.k8s.policy.name=l7-http-api"])
            out["v2"] = lanes(agent.loader.engine.verdict_flows([
                flow(P, fid, sid, 80, "/x", method="DELETE")]))
            out["eps"] = sorted(
                (e.to_json()["id"], e.to_json()["identity"],
                 e.to_json()["ipv4"], e.to_json()["labels"])
                for e in agent.endpoint_manager.endpoints())
            return out
        finally:
            agent.stop()

    got = both(run)
    assert got["v1"]["verdict"] == [5, 2] and got["v2"]["verdict"] == [1]


def test_agent_restore_roundtrip():
    def run(P, tmp):
        state = os.path.join(tmp, "state")
        agent = make_agent(P, tmp, start=False, state_dir=state)
        agent.endpoint_add(7, {"app": "web"})
        agent.endpoint_manager.regenerate_all(wait=True)
        agent.stop()  # checkpoints
        with running(P, tmp, state_dir=state) as agent2:
            agent2.endpoint_manager.regenerate_all(wait=True)
            ep = agent2.endpoint_manager.get(7)
            return {"ep": ep.to_json(), "ids": len(agent2.allocator),
                    "ip": agent2.ipcache.lookup(ep.ipv4),
                    "avail": agent2.ipam.available}

    got = both(run)
    assert got["ep"]["labels"][0] == "k8s:app=web" or \
        "k8s:app=web" in got["ep"]["labels"]


def test_agent_fqdn_flow_to_regeneration():
    def run(P, tmp):
        agent = make_agent(P, tmp, start=False)
        try:
            agent.endpoint_add(1, {"app": "crawler"}, ipv4="10.0.0.1")
            agent.policy_add_file(
                os.path.join(FIXTURES, "dns", "fqdn-egress.yaml"))
            agent.dns_proxy.observe_response(1753866000.0, "www.cilium.io",
                                             ["198.51.100.7"], ttl=600)
            agent.endpoint_manager.regenerate_all(wait=True)
            cid = agent.ipcache.lookup("198.51.100.7")
            crawler = agent.endpoint_manager.get(1).identity
            f = flow(P, crawler, cid, 443,
                     direction=P.flow.TrafficDirection.EGRESS)
            return {"cid": cid, "v": lanes(
                agent.loader.engine.verdict_flows([f]))}
        finally:
            agent.stop()

    got = both(run)
    assert got["cid"] is not None and got["v"]["verdict"] == [1]


def test_controller_backoff_and_status():
    def run(P, tmp):
        mgr = P.controller.ControllerManager()
        runs = []
        done = threading.Event()

        def flaky():
            runs.append(1)
            if len(runs) < 2:
                raise RuntimeError("boom")
            done.set()

        mgr.update("test-ctrl", flaky, interval=0.05)
        assert done.wait(10)
        deadline = time.time() + 5
        while mgr.status()["test-ctrl"]["success-count"] < 1 \
                and time.time() < deadline:
            time.sleep(0.01)
        st = mgr.status()["test-ctrl"]
        mgr.stop_all()
        return {"ok": st["success-count"] >= 1,
                "after": mgr.status()}

    assert both(run) == {"ok": True, "after": {}}


def test_controller_failure_status_and_restart():
    """A failing controller reports its error and count; ``stop_all``
    leaves the manager restartable; ``remove`` and ``trigger``."""

    def run(P, tmp):
        mgr = P.controller.ControllerManager()
        ran = threading.Event()

        def bad():
            ran.set()
            raise ValueError("nope")

        c = mgr.update("bad", bad, interval=30.0)
        assert ran.wait(10)
        deadline = time.time() + 5
        while c.failures < 1 and time.time() < deadline:
            time.sleep(0.01)
        st = dict(mgr.status()["bad"])
        mgr.stop_all()
        hits = []
        mgr.update("again", lambda: hits.append(1), interval=30.0)
        mgr.trigger("again")
        deadline = time.time() + 5
        while not hits and time.time() < deadline:
            time.sleep(0.01)
        names = sorted(mgr.status())
        mgr.remove("again")
        return {"st": st, "names": names, "left": mgr.status(),
                "hits": bool(hits)}

    got = both(run)
    assert got["st"]["last-error"] == "ValueError: nope"


def test_hubble_observer_ring_and_metrics():
    def run(P, tmp):
        H, V = P.hubble, P.flow.Verdict
        obs = H.Observer(capacity=8, handlers=[H.FlowMetrics()])
        flows = [flow(P, 1, 2, 80, "/x") for _ in range(20)]
        H.annotate_flows(flows,
                         {"verdict": np.full(20, int(V.DROPPED))})
        obs.observe(flows)
        return {"n": len(list(obs.get_flows())),
                "fwd": len(list(obs.get_flows(
                    H.FlowFilter(verdict=V.FORWARDED)))),
                "lost": obs.lost_reported}

    assert both(run) == {"n": 8, "fwd": 0, "lost": 0}


# ================================================ process_flows, the slice
N_RULES, N_FLOWS = 40, 256


def scenario_agent(P, tmp, **kw):
    """The http scenario's endpoints and rules in ``P``'s agent (gate
    on), with the auth policy's checkout and payments beside them;
    returns (agent, flows with the agent's identities)."""
    S = P.synth
    sc = S.synth_http_scenario(N_RULES, N_FLOWS, seed=3)
    agent = make_agent(P, tmp, offload=True, **kw)
    ids = {}
    for i, (name, labels) in enumerate(sorted(sc.endpoints.items())):
        ids[name] = agent.endpoint_add(10 + i, labels).identity
    cnp = P.cnp.CiliumNetworkPolicy(name="synth-http", namespace="default",
                                    rules=tuple(sc.rules))
    agent.policy_add(cnp)
    with open(os.path.join(FIXTURES, "l7", "auth-required.yaml")) as fp:
        for c in P.cnp.load_cnp_yaml_text(fp.read()):
            agent.policy_add(c, wait=False)
    ns = {"io.kubernetes.pod.namespace": "default"}
    ids["checkout"] = agent.endpoint_add(
        20, dict(ns, app="checkout")).identity
    ids["payments"] = agent.endpoint_add(
        21, dict(ns, app="payments")).identity
    agent.endpoint_manager.regenerate_all(wait=True)
    for f in sc.flows:
        f.src_identity, f.dst_identity = ids["client"], ids["server"]
    return agent, sc.flows, ids


def test_process_flows_lanes_auth_monitor_and_hubble():
    def run(P, tmp):
        agent, flows, ids = scenario_agent(P, tmp)
        try:
            events = []
            agent.monitor.subscribe(events.append)
            out = {"engine": type(agent.loader.engine).__name__}
            res = agent.process_flows(flows)
            out["lanes"] = lanes(res)
            out["dtypes"] = sorted(str(np.asarray(v).dtype)
                                   for v in res.values())
            pay = flow(P, ids["checkout"], ids["payments"], 8443,
                       direction=P.flow.TrafficDirection.INGRESS)
            out["pre"] = lanes(agent.process_flows([pay]))
            agent.auth.authenticate(ids["checkout"], ids["payments"])
            out["authed"] = lanes(agent.process_flows([pay]))
            agent.auth.revoke(ids["checkout"], ids["payments"])
            out["revoked"] = lanes(agent.process_flows([pay]))
            ring = list(agent.observer.get_flows())
            out["ring"] = [(int(f.verdict), int(f.policy_match_type),
                            f.src_identity, f.dst_identity, f.dport)
                           for f in ring]
            out["events"] = len(events)
            st = agent.status()
            out["status"] = {k: st[k] for k in (
                "revision", "rules", "endpoints", "identities",
                "backend", "engine_revision", "ipam", "services")}
            out["gens"] = [agent.endpoint_manager._gen_done,
                           agent.loader.revision]
            return out
        finally:
            agent.stop()

    port_name = {"cilium_tpu": "VerdictEngine",
                 "cilium_tpu_torch": "TorchVerdictEngine"}
    res = []
    for P in PKGS:
        with short_dir() as tmp:
            r = run(P, tmp)
            assert r.pop("engine") == port_name[P.root]
            res.append(r)
    jax_r, port_r = res
    # the reference's readback lanes are numpy of its own dtypes
    jax_r.pop("dtypes"), port_r.pop("dtypes")
    assert jax_r == port_r
    assert port_r["pre"]["verdict"] == [2]
    assert port_r["pre"]["auth_required"] == [True]
    assert port_r["authed"]["verdict"] == [1]
    assert port_r["revoked"]["verdict"] == [2]
    assert len(port_r["ring"]) == N_FLOWS + 3


def test_process_flows_monitor_events_equal():
    """The monitor's events of one ``process_flows`` batch, at the
    agent's default aggregation, in both packages."""

    def run(P, tmp):
        agent = make_agent(P, tmp, offload=False, start=False)
        try:
            agent.endpoint_add(1, {"app": "service"}, ipv4="10.0.0.1")
            agent.endpoint_add(2, {"app": "frontend"}, ipv4="10.0.0.2")
            agent.policy_add_file(
                os.path.join(FIXTURES, "l7", "http-api.yaml"))
            sid = agent.endpoint_manager.get(1).identity
            fid = agent.endpoint_manager.get(2).identity
            got = []
            agent.monitor.subscribe(got.append)
            flows = [flow(P, fid, sid, 80, "/api/v1/x"),
                     flow(P, fid, sid, 80, "/nope", method="PUT"),
                     flow(P, fid, sid, 81)]
            out = lanes(agent.process_flows(flows))
            ring = [(int(f.verdict), int(f.policy_match_type))
                    for f in agent.observer.get_flows()]
            evs = [{k: v for k, v in
                    P.monitor.event_to_dict(e).items()
                    if k not in ("ts", "time", "timestamp")}
                   for e in got]
            return {"out": out, "ring": ring, "events": evs}
        finally:
            agent.stop()

    got = both(run)
    assert got["out"]["verdict"] == [5, 2, 2]


def test_agent_process_flows_feeds_monitor_and_hubble():
    """``tests/test_observability.py``'s case: one flow through
    ``process_flows`` reaches the monitor as a policy-verdict event and
    the Hubble ring, annotated, and bugtool collects a coherent bundle
    over the agent (the same files in both packages)."""
    import tarfile

    def run(P, tmp):
        agent = make_agent(P, tmp, start=False)
        try:
            agent.endpoint_add(1, {"app": "web"}, ipv4="10.0.0.1")
            events = []
            agent.monitor.subscribe(events.append)
            flows = [flow(P, 2, agent.endpoint_manager.get(1).identity, 80)]
            out = agent.process_flows(flows)
            path = importlib.import_module(f"{P.root}.bugtool").collect(
                agent, tmp)
            with tarfile.open(path) as tar:
                names = sorted(os.path.basename(m.name)
                               for m in tar.getmembers() if m.isfile())
            return {"lanes": sorted(out), "verdict": flows[0].verdict.name,
                    "events": [P.monitor.event_to_dict(e)["type"]
                               for e in events],
                    "ring": len(list(agent.observer.get_flows())),
                    "bundle": (path.endswith(".tar.gz"), names)}
        finally:
            agent.stop()

    got = both(run)
    assert "verdict" in got["lanes"] and got["ring"] == 1
    assert "POLICY_VERDICT" in got["events"]
    assert got["verdict"] in ("FORWARDED", "DROPPED")
    assert got["bundle"][0] and {
        "MANIFEST.json", "status.json", "engine.json", "metrics.txt",
        "endpoints.json"} <= set(got["bundle"][1])


def test_kvstore_identity_mode_two_agents():
    """``identity_allocation_mode="kvstore"``: two agents over one
    store map the same labels to the same identity."""

    def run(P, tmp):
        store = P.kvstore.KVStore()
        a = make_agent(P, os.path.join(tmp, "a"),
                       cfg_fields={"identity_allocation_mode": "kvstore",
                                   "node_name": "na"}, kvstore=store)
        b = make_agent(P, os.path.join(tmp, "b"),
                       cfg_fields={"identity_allocation_mode": "kvstore",
                                   "node_name": "nb"}, kvstore=store)
        try:
            ea = a.endpoint_add(1, {"app": "web"})
            eb = b.endpoint_add(1, {"app": "web"})
            ec = b.endpoint_add(2, {"app": "db"})
            return {"same": ea.identity == eb.identity,
                    "ids": [ea.identity, eb.identity, ec.identity],
                    "keys": sorted(store.list_prefix(""))}
        finally:
            b.stop()
            a.stop()

    assert both(run)["same"] is True


#: the cluster configurations (queue 1's Q13b part 2, ported): each
#: with the field it sets beside ``k8s_api_socket``
_CLUSTER_FIELDS = {
    "crd": {"identity_allocation_mode": "crd"},
    "k8s_api_socket": {},
    "cluster-pool": {"ipam_mode": "cluster-pool"},
}


@pytest.mark.parametrize("what", ["crd", "k8s_api_socket", "cluster-pool",
                                  "from_toml", "bugtool"])
def test_unported_configurations_raise(what, monkeypatch):
    """The configurations that once waited for a later slice, each now
    ported: ``crd`` identities, ``k8s_api_socket`` and ``cluster-pool``
    IPAM build and start; ``Config.from_toml`` reads a file as the
    reference does (equal configurations) and an agent from it starts;
    the service's ``bugtool`` op answers with the bundle's path. Each
    agent defaults to ``cuda`` and raises without it unless the caller
    names the CPU."""
    import tarfile

    import torch

    before = set(threading.enumerate())
    with short_dir() as tmp:
        if what in ("from_toml", "bugtool"):
            toml = os.path.join(tmp, "agent.toml")
            with open(toml, "w") as f:
                f.write('enable_tpu_offload = false\nnode_name = "n-toml"'
                        '\n[engine]\n'
                        'bank_size = 128\nhttp_path_buckets = [64, 128]\n'
                        f'[loader]\ncache_dir = "{tmp}/cache"\n'
                        '[compile]\ndeadline_s = 600.0\n')
            cfg = PORT.config.Config.from_toml(toml)
            ref = JAX.config.Config.from_toml(toml)
            assert not differing(dataclasses.asdict(ref),
                                 dataclasses.asdict(cfg))
            cfg.configure_logging = False
            with monkeypatch.context() as m:
                m.setattr(torch.cuda, "is_available", lambda: False)
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    PORT.agent.Agent(cfg)
            agent = PORT.agent.Agent(cfg, device="cpu").start()
            try:
                assert agent.device.type == "cpu"
                assert agent.config.node_name == "n-toml"
                assert agent.config.engine.http_path_buckets == (64, 128)
                if what == "bugtool":
                    svc = PORT.service.VerdictService(
                        agent.loader, os.path.join(tmp, "v.sock"),
                        agent=agent)
                    got = svc.handle({"op": "bugtool",
                                      "out": os.path.join(tmp, "bt")})
                    svc.bridge.batcher.close()
                    with tarfile.open(got["path"]) as tar:
                        names = {os.path.basename(n.name)
                                 for n in tar.getmembers()}
                    assert "MANIFEST.json" in names
                    assert "engine.json" in names
            finally:
                agent.stop()
            assert threads_settle(before) == []
            return
        kv = PORT.kvstore.KVStore()
        api = k8s.APIServer(os.path.join(tmp, "k8s.sock")).start()
        op = operator.Operator(kv, pool_cidr="10.123.0.0/16").start()
        fields = dict(_CLUSTER_FIELDS[what], k8s_api_socket=api.socket_path)
        try:
            with monkeypatch.context() as m:
                m.setattr(torch.cuda, "is_available", lambda: False)
                cfg = config(PORT, os.path.join(tmp, "cache"), **fields)
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    PORT.agent.Agent(cfg, kvstore=kv)
            agent = make_agent(PORT, tmp, cfg_fields=fields, kvstore=kv)
            try:
                assert agent.device.type == "cpu"
                assert agent.k8s_bridge is not None
                ep = agent.endpoint_add(1, {"app": "x"})
                client = k8s.K8sClient(api.socket_path)
                got = client.get("ciliumendpoints", "node-0-ep-1")
                assert got["status"]["identity"]["id"] == ep.identity
                if what == "cluster-pool":
                    assert str(agent.ipam.cidr) == "10.123.0.0/24"
                    assert agent.node_registration is not None
                if what == "crd":
                    assert client.get("ciliumidentities",
                                      str(int(ep.identity)))
            finally:
                api.stop()  # the informers stop at once
                agent.stop()
        finally:
            api.stop()
            op.stop()
    assert threads_settle(before) == []


def test_agent_without_cuda_raises_unless_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with short_dir() as tmp:
        cfg = config(PORT, os.path.join(tmp, "cache"), offload=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PORT.agent.Agent(cfg)
        # the gate off still needs the card for a later PATCH back on
        cfg.enable_tpu_offload = False
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PORT.agent.Agent(cfg)
        a = PORT.agent.Agent(cfg, device="cpu")
        try:
            assert a.device.type == "cpu" and a.loader.device.type == "cpu"
            assert a.dns_proxy.device.type == "cpu"
        finally:
            a.stop()


def test_auth_unenforced_is_the_engines_object():
    from cilium_tpu_torch.engine import verdict

    assert PORT.auth.AUTH_UNENFORCED is verdict.AUTH_UNENFORCED
    assert PORT.auth.PAIR_SENTINEL == JAX.auth.PAIR_SENTINEL


def test_agent_stop_joins_every_thread():
    before = set(threading.enumerate())
    with short_dir() as tmp:
        a = make_agent(PORT, tmp,
                       socket_path=os.path.join(tmp, "v.sock"),
                       api_socket_path=os.path.join(tmp, "a.sock"),
                       hubble_socket_path=os.path.join(tmp, "h.sock"),
                       monitor_socket_path=os.path.join(tmp, "m.sock"),
                       accesslog_socket_path=os.path.join(tmp, "l.sock"),
                       policy_dir=tmp)
        a.endpoint_add(1, {"app": "x"})
        a.stop()
    assert threads_settle(before) == []


# ============================================== the service's agent ops
def _service_session(P, tmp):
    from_dict = P.ingest.flow_to_dict
    sock = os.path.join(tmp, "v.sock")
    agent = make_agent(P, tmp, start=False, socket_path=sock)
    agent.start()
    try:
        agent.endpoint_add(1, {"app": "service"}, ipv4="10.0.0.1")
        agent.endpoint_add(2, {"app": "frontend"}, ipv4="10.0.0.2")
        agent.policy_add_file(os.path.join(FIXTURES, "l7", "http-api.yaml"))
        sid = agent.endpoint_manager.get(1).identity
        fid = agent.endpoint_manager.get(2).identity
        events = []
        agent.monitor.subscribe(events.append)
        client = svc_client(P, sock)
        try:
            out = {}
            st = client.call({"op": "status"})
            out["status"] = {k: st[k] for k in (
                "revision", "rules", "endpoints", "identities", "backend",
                "engine_revision", "ipam", "services", "health")}
            out["status_keys"] = sorted(st)
            out["policy"] = client.call({"op": "policy_get"})
            flows = [flow(P, fid, sid, 80, "/api/v1/x"),
                     flow(P, fid, sid, 80, "/bad", method="PUT")]
            r = client.call({"op": "verdict",
                             "flows": [from_dict(f) for f in flows]})
            out["verdicts"] = r["verdicts"]
            out["events"] = len(events)
            out["ring"] = [int(f.verdict)
                           for f in agent.observer.get_flows()]
            prof = client.call({"op": "profile", "mode": "host",
                                "seconds": 0.1,
                                "out": os.path.join(tmp, "prof")})
            out["profile"] = sorted(prof)
            out["profile_mode"] = prof["mode"]
            out["bad_mode"] = client.call({"op": "profile", "mode": "x",
                                           "seconds": 0.1,
                                           "out": os.path.join(tmp, "p")})
            return out, client.call({"op": "bugtool",
                                     "out": os.path.join(tmp, "bt")})
        finally:
            client.close()
    finally:
        agent.stop()


def test_service_agent_ops_equal_reference():
    res = []
    for P in PKGS:
        with short_dir() as tmp:
            res.append(_service_session(P, tmp))
    (jax_out, jax_bug), (port_out, port_bug) = res
    assert jax_out == port_out
    assert port_out["verdicts"] == [5, 2] and port_out["events"] >= 2
    assert jax_bug["path"].endswith(".tar.gz")
    assert port_bug["path"].endswith(".tar.gz")
    assert os.path.basename(port_bug["path"]).startswith(
        "cilium-tpu-bugtool-")


def test_service_accesslog_sink_lands_in_observer():
    """The LOG sink: ``PolicyBridge.accesslog_fn`` is the service's
    ``_accesslog`` once an agent is attached, and puts the L7 flow in
    the agent's ring with match type L7."""

    def run(P, tmp):
        agent = make_agent(P, tmp, start=False)
        try:
            svc = P.service.VerdictService(
                agent.loader, os.path.join(tmp, "v.sock"), agent=agent)
            assert svc.bridge.accesslog_fn == svc._accesslog
            f = flow(P, 1, 2, 80, "/x")
            svc.bridge.accesslog_fn(f)
            got = list(agent.observer.get_flows())
            svc.bridge.batcher.close()
            return [(g.policy_match_type.name, g.time > 0) for g in got]
        finally:
            agent.stop()

    assert both(run) == [("L7", True)]


# ================================= the reference tests that need no CLI
def test_accesslog_records_reach_the_observer():
    """``tests/test_accesslog_server.py``: newline-delimited access-log
    and flowpb lines over the agent's access-log socket land in its
    Observer ring; a malformed line is skipped, not fatal."""
    import json
    import socket

    lines = [
        json.dumps({"entry_type": "Request", "is_ingress": True,
                    "source_security_id": 101,
                    "destination_security_id": 202,
                    "destination_address": "10.0.0.2:80",
                    "http": {"method": "GET", "path": "/a",
                             "host": "svc.local"}}),
        "{not json",
        json.dumps({"traffic_direction": "INGRESS",
                    "verdict": "FORWARDED",
                    "source": {"identity": 101},
                    "destination": {"identity": 202},
                    "l4": {"TCP": {"destination_port": 9092}},
                    "l7": {"kafka": {"api_key": 1, "api_version": 2,
                                     "topic": "t"}}}),
    ]

    def run(P, tmp):
        path = os.path.join(tmp, "accesslog.sock")
        agent = make_agent(P, tmp, accesslog_socket_path=path)
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.connect(path)
                s.sendall(("\n".join(lines) + "\n").encode())
            deadline = time.time() + 5
            while time.time() < deadline and agent.observer.seen < 2:
                time.sleep(0.02)
            flows = list(agent.observer.get_flows())
            http = [f for f in flows if f.l7 == P.flow.L7Type.HTTP]
            return {"seen": agent.observer.seen,
                    "kinds": sorted(f.l7.name for f in flows),
                    "http": [(f.src_identity, f.dst_identity, f.dport,
                              f.http.path) for f in http]}
        finally:
            agent.stop()

    got = both(run)
    assert got == {"seen": 2, "kinds": ["HTTP", "KAFKA"],
                   "http": [(101, 202, 80, "/a")]}


def _global_services_setup(P, tmp, beta_offload):
    """``tests/test_clustermesh.py``'s set-up: alpha exports a shared
    ``orders`` service; beta (its gate as given) consumes it beside its
    own local backend."""
    lb = importlib.import_module(f"{P.root}.loadbalancer")
    a = make_agent(P, os.path.join(tmp, "a"),
                   cfg_fields={"cluster_name": "alpha"})
    b = make_agent(P, os.path.join(tmp, "b"), offload=beta_offload,
                   cfg_fields={"cluster_name": "beta"})
    a.endpoint_add(1, {"app": "orders"}, ipv4="10.1.0.7")
    a.services.upsert(lb.Service(
        frontend=lb.Frontend("10.96.1.1", 8080),
        backends=[lb.Backend(ip="10.1.0.7", port=8080)],
        name="orders", namespace="default", shared=True))
    a.publisher.publish_services()
    b.endpoint_add(9, {"app": "client"}, ipv4="10.2.0.9")
    b.endpoint_add(10, {"app": "orders"}, ipv4="10.2.0.7")
    b.services.upsert(lb.Service(
        frontend=lb.Frontend("10.97.1.1", 8080),
        backends=[lb.Backend(ip="10.2.0.7", port=8080)],
        name="orders", namespace="default", shared=True))
    b.clustermesh.connect("alpha", a.kvstore)
    return a, b


TO_SERVICES_CNP = """\
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata: {name: to-global-svc}
spec:
  endpointSelector: {matchLabels: {app: client}}
  egress:
  - toServices:
    - k8sService: {serviceName: orders, namespace: default}
    toPorts: [{ports: [{port: "8080", protocol: TCP}]}]
"""


@pytest.mark.parametrize("offload", [False, True])
def test_to_services_sees_remote_backends(offload):
    """``tests/test_clustermesh.py::test_to_services_sees_remote_backends``:
    a ``toServices`` rule naming a shared remote-cluster service allows
    the remote backends (resolved through the identities the clustermesh
    IP sync created) on both engine backends, and not an unrelated remote
    workload or another port."""

    def run(P, tmp):
        a, b = _global_services_setup(P, tmp, offload)
        try:
            path = os.path.join(tmp, "to-svc.yaml")
            with open(path, "w") as f:
                f.write(TO_SERVICES_CNP)
            b.policy_add_file(path)
            client = b.endpoint_manager.get(9).identity
            local_backend = b.endpoint_manager.get(10).identity
            remote_backend = b.ipcache.lookup("10.1.0.7")
            assert remote_backend is not None
            a.endpoint_add(2, {"app": "other"}, ipv4="10.1.0.8")
            other_remote = b.ipcache.lookup("10.1.0.8")
            b.endpoint_manager.regenerate_all(wait=True)
            F = P.flow
            flows = [F.Flow(src_identity=client, dst_identity=dst,
                            dport=port,
                            direction=F.TrafficDirection.EGRESS)
                     for dst, port in ((local_backend, 8080),
                                       (remote_backend, 8080),
                                       (other_remote, 8080),
                                       (remote_backend, 9999))]
            return lanes(b.loader.engine.verdict_flows(flows))
        finally:
            a.stop()
            b.stop()

    got = both(run)
    assert got["verdict"] == [1, 1, 2, 2]


def test_agent_identity_hook_is_debounced():
    """``tests/dst/test_debounce.py::test_agent_identity_hook_is_debounced``:
    ``_on_cluster_identity`` updates the selector cache at once and
    routes regeneration through the debouncer — 100 identity events in
    one window fire one regeneration, in both packages (each under its
    own ``VirtualClock``)."""

    def run(P, tmp):
        simclock = importlib.import_module(f"{P.root}.runtime.simclock")
        agent = make_agent(P, tmp, start=False)
        try:
            regen_calls = []
            agent._identity_debounce.fire = \
                lambda: regen_calls.append(simclock.now())
            clk = simclock.VirtualClock(autojump=0.003)
            with simclock.use(clk):
                for k in range(100):
                    agent._on_cluster_identity(
                        10_000 + k,
                        P.labels.LabelSet.from_dict({"storm": f"s{k}"}))
                ev = threading.Event()
                for _ in range(2000):
                    if agent._identity_debounce.fires:
                        break
                    ev.wait(0.005)
                return {"fires": agent._identity_debounce.fires,
                        "regens": len(regen_calls),
                        "cache": agent.selector_cache is not None}
        finally:
            agent.stop()

    assert both(run) == {"fires": 1, "regens": 1, "cache": True}
