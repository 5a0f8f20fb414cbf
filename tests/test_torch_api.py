"""The port's REST API and policy-directory watcher against the JAX
package's, on the CPU, each served by its own ``Agent``.

Mirrors ``tests/test_api_watcher.py``, the REST cases of
``tests/test_admission.py`` (``RequestSlots``, the data-class shed,
``POST /v1/drain``, the deadline header, a stop that drains an in-flight
check) and of ``tests/test_explain.py`` (``GET /v1/explain`` for a chunk
served through a ``ServeLoop`` on the agent's loader), plus every other
route: ``/v1/trace`` (span times taken out), ``/v1/canary``,
``/v1/flows``, ``/v1/selectors``, ``/v1/proxy``, ``/v1/auth``,
``/v1/service``, ``/v1/fqdn/cache``, ``/v1/debuginfo``, ``/v1/profile``
and the per-endpoint ``PATCH``. The same requests go to both agents;
the answers are compared as JSON after taking out stamps that are not
data (socket paths, times, profile file names). ``PATCH /v1/config``
flips the gate: off serves the CPU oracle, on serves the port's
``TorchVerdictEngine`` again (on the CPU here, on the card in
``chip_smoke.py``).
"""

import json
import os
import textwrap
import threading
import time

import pytest

from test_torch_agent import (
    FIXTURES,
    PKGS,
    PORT,
    both,
    flow,
    lanes,
    make_agent,
    scenario_agent,
    short_dir,
)

CNP = textwrap.dedent("""\
    apiVersion: cilium.io/v2
    kind: CiliumNetworkPolicy
    metadata: {name: api-test, namespace: default}
    spec:
      endpointSelector: {matchLabels: {app: service}}
      ingress:
        - fromEndpoints: [{matchLabels: {app: frontend}}]
          toPorts:
            - ports: [{port: "80", protocol: TCP}]
              rules:
                http: [{method: GET, path: "/api/.*"}]
    """)

#: keys whose values are stamps, not data: times, paths, and the
#: process-wide counters a provenance record cites (the bank epoch and
#: the generation, alone and packed into the record's word), which
#: count each process's own history
STAMPS = {"t", "ts", "time", "t0", "dur", "expires", "path",
          "last_probe_ts", "last_latency_s", "generation",
          "generation_now", "bank_epoch", "word", "socket", "cache_dir",
          "seconds", "samples", "distinct_stacks"}


def strip(obj):
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if k not in STAMPS}
    if isinstance(obj, list):
        return [strip(v) for v in obj]
    return obj


def api_agent(P, tmp, **kw):
    sock = os.path.join(tmp, "api.sock")
    agent = make_agent(P, tmp, api_socket_path=sock, **kw)
    return agent, P.api.APIClient(sock, timeout=30.0)


# ====================================================== test_api_watcher
def test_rest_endpoint_policy_flow():
    def run(P, tmp):
        agent, c = api_agent(P, tmp)
        try:
            out = {"health": strip(c.healthz())}
            code, ep = c.endpoint_put(1, {"app": "service"},
                                      ipv4="10.0.0.3")
            code2, peer = c.endpoint_put(2, {"app": "frontend"},
                                         ipv4="10.0.0.4")
            out["put"] = [code, ep, code2, peer]
            out["policy_put"] = c.policy_put_yaml(CNP)
            out["policy"] = c.policy_get()
            res = agent.process_flows([
                flow(P, peer["identity"], ep["identity"], 80, "/api/x"),
                flow(P, peer["identity"], ep["identity"], 80, "/admin")])
            out["lanes"] = lanes(res)
            out["eps"] = c.endpoints()
            out["ip"] = c.ipcache()
            out["ids"] = c.identities()
            out["metrics"] = "cilium_tpu" in c.metrics()
            out["again"] = c.policy_put_yaml(CNP)
            out["n_rules"] = len(c.policy_get()["rules"])
            out["del"] = c.policy_delete(
                ["k8s:io.cilium.k8s.policy.name=api-test"])
            out["after"] = c.policy_get()
            out["ep_del"] = c.endpoint_delete(2)
            out["eps2"] = c.endpoints()
            out["selectors"] = c.selectors()
            out["proxy"] = c.proxy_redirects()
            out["fqdn"] = c.fqdn_cache()
            out["svc"] = c.services()
            out["debug"] = strip(c.debuginfo())
            out["one"] = c.request("GET", "/v1/endpoint/1")
            return out
        finally:
            agent.stop()

    got = both(run)
    assert got["lanes"]["verdict"] == [5, 2]
    assert got["n_rules"] == 1 and got["after"]["rules"] == []


def test_rest_config_patch_flips_engine_gate():
    """Gate off → the CPU oracle; on → the device engine again (the
    port's ``TorchVerdictEngine`` on the agent's device)."""

    def run(P, tmp):
        agent, c = api_agent(P, tmp)
        try:
            c.endpoint_put(1, {"app": "service"}, ipv4="10.0.0.3")
            out = {"gate": c.config()["config"]["enable_tpu_offload"],
                   "mutable": c.config()["mutable"]}
            out["engines"] = [type(agent.loader.engine).__name__]
            out["on"] = c.patch_config(enable_tpu_offload=True)
            out["engines"].append(type(agent.loader.engine).__name__)
            out["proxy_on"] = agent.dns_proxy.use_tpu
            out["off"] = c.patch_config(enable_tpu_offload=False)
            out["engines"].append(type(agent.loader.engine).__name__)
            out["proxy_off"] = agent.dns_proxy.use_tpu
            out["bad"] = c.patch_config(pod_cidr="10.9.0.0/24")
            out["cfg"] = strip(c.config()["config"])
            return out
        finally:
            agent.stop()

    res = []
    for P in PKGS:
        with short_dir() as tmp:
            res.append(run(P, tmp))
    jax_r, port_r = res
    assert port_r["engines"] == ["OracleVerdictEngine",
                                 "TorchVerdictEngine",
                                 "OracleVerdictEngine"]
    assert jax_r["engines"] == ["OracleVerdictEngine", "VerdictEngine",
                                "OracleVerdictEngine"]
    for r in res:
        r.pop("engines")
    assert jax_r == port_r
    assert port_r["bad"][0] == 400 and port_r["proxy_on"] is True


def test_rest_gate_on_serves_the_agents_device():
    with short_dir() as tmp:
        agent, c = api_agent(PORT, tmp, offload=True)
        try:
            c.endpoint_put(1, {"app": "service"}, ipv4="10.0.0.3")
            agent.endpoint_manager.regenerate_all(wait=True)
            assert type(agent.loader.engine).__name__ == \
                "TorchVerdictEngine"
            assert agent.loader.engine.device.type == "cpu"
            c.patch_config(enable_tpu_offload=False)
            c.patch_config(enable_tpu_offload=True)
            assert agent.loader.engine.device == agent.device
        finally:
            agent.stop()


def test_rest_errors():
    def run(P, tmp):
        agent, c = api_agent(P, tmp)
        try:
            # no body where the handler answers before it reads one: the
            # server may close first, and the client's write then breaks
            out = [c.request(m, p) for m, p in (
                ("GET", "/v1/endpoint/999"), ("GET", "/v1/nope"),
                ("PUT", "/v1/nope"), ("POST", "/v1/nope"),
                ("DELETE", "/v1/nope"), ("PATCH", "/v1/nope"))]
            code, body = c.request("PUT", "/v1/policy", body="kind: Nope",
                                   content_type="application/yaml")
            out.append([code, body["error"].split(":")[0]])
            for method in ("GET", "PUT", "DELETE"):
                out.append(c.request(method, "/v1/endpoint/abc"))
            out.append(c.request("PATCH", "/v1/endpoint/abc/config"))
            out.append(c.request("PATCH", "/v1/endpoint/9/config",
                                 body={"policy_audit_mode": True}))
            out.append(c.request("PATCH", "/v1/endpoint/9/config",
                                 body={"nope": 1}))
            out.append(c.request("PATCH", "/v1/endpoint/9/config",
                                 body={"policy_audit_mode": "yes"}))
            out.append(c.request("GET", "/v1/trace?limit=x"))
            out.append(c.request("GET", "/v1/flows?limit=x"))
            out.append(c.request("GET", "/v1/explain"))
            return out
        finally:
            agent.stop()

    got = both(run)
    assert got[0][0] == 404 and got[6][0] == 400


def test_rest_config_patch_is_atomic():
    def run(P, tmp):
        agent, c = api_agent(P, tmp)
        try:
            out = [c.request("PATCH", "/v1/config",
                             body={"enable_tpu_offload": True, "bogus": 1}),
                   agent.config.enable_tpu_offload,
                   c.request("PATCH", "/v1/config",
                             body={"enable_tpu_offload": "false"}),
                   agent.config.enable_tpu_offload]
            return out
        finally:
            agent.stop()

    got = both(run)
    assert got[0][0] == 400 and got[1] is False and got[3] is False


def test_rest_endpoint_config_audit_mode():
    def run(P, tmp):
        agent, c = api_agent(P, tmp)
        try:
            c.endpoint_put(1, {"app": "service"}, ipv4="10.0.0.3")
            c.endpoint_put(2, {"app": "frontend"}, ipv4="10.0.0.4")
            c.policy_put_yaml(CNP)
            ids = [e["identity"] for e in sorted(
                c.endpoints(), key=lambda e: e["id"])]
            f = flow(P, ids[1], ids[0], 80, "/admin")
            before = lanes(agent.process_flows([f]))
            r = c.request("PATCH", "/v1/endpoint/1/config",
                          body={"policy_audit_mode": True})
            after = lanes(agent.process_flows([f]))
            return [before, r, after]
        finally:
            agent.stop()

    got = both(run)
    assert got[0]["verdict"] == [2] and got[2]["verdict"] == [4]


def test_api_server_refuses_live_socket(tmp_path):
    def run(P, tmp):
        agent, c = api_agent(P, tmp)
        try:
            out = []
            with pytest.raises(FileExistsError):
                P.api.APIServer(agent, agent.api_socket_path)
            f = os.path.join(tmp, "notasocket")
            with open(f, "w") as fp:
                fp.write("keep me")
            with pytest.raises(FileExistsError):
                P.api.APIServer(agent, f)
            out.append(open(f).read())
            import socket as socket_mod

            stale = os.path.join(tmp, "stale.sock")
            s = socket_mod.socket(socket_mod.AF_UNIX)
            s.bind(stale)
            s.close()
            srv = P.api.APIServer(agent, stale).start()
            out.append(strip(P.api.APIClient(stale).healthz()))
            srv.stop()
            out.append(os.path.exists(stale))
            return out
        finally:
            agent.stop()

    assert both(run)[0] == "keep me"


def test_watcher_bad_file_parsed_once():
    def run(P, tmp):
        agent = make_agent(P, tmp, start=False)
        pdir = os.path.join(tmp, "policies")
        os.makedirs(pdir)
        w = P.watcher.PolicyDirWatcher(agent, pdir)
        try:
            f = os.path.join(pdir, "bad.yaml")
            with open(f, "w") as fp:
                fp.write("metadata: [broken")
            os.utime(f, (1, 1))
            m = P.metrics.METRICS
            before = m.get("cilium_tpu_policy_watch_parse_errors_total")
            ops = [w.scan_once() for _ in range(3)]
            after = m.get("cilium_tpu_policy_watch_parse_errors_total")
            return [ops, after - before]
        finally:
            agent.stop()

    assert both(run) == [[0, 0, 0], 1]


def test_policy_dir_watcher_add_update_delete():
    def run(P, tmp):
        agent = make_agent(P, tmp, start=False)
        pdir = os.path.join(tmp, "policies")
        os.makedirs(pdir)
        w = P.watcher.PolicyDirWatcher(agent, pdir)
        try:
            agent.endpoint_add(1, {"app": "service"})
            agent.endpoint_add(2, {"app": "frontend"})
            f = os.path.join(pdir, "cnp.yaml")
            with open(f, "w") as fp:
                fp.write(CNP)
            out = [w.scan_once()]
            agent.endpoint_manager.regenerate_all(wait=True)
            out.append(len(agent.repo.rules()))
            out.append(w.scan_once())
            os.utime(f, (1, 1))
            with open(f, "w") as fp:
                fp.write(CNP.replace("/api/.*", "/only/.*"))
            os.utime(f, (2, 2))
            out.append(w.scan_once())
            rule = agent.repo.rules()[0]
            out.append(sorted(h.path for ing in rule.ingress
                              for pr in ing.to_ports
                              for h in pr.rules.http))
            with open(f, "w") as fp:
                fp.write("kind: CiliumNetworkPolicy\nmetadata: [broken")
            os.utime(f, (3, 3))
            out.append(w.scan_once())
            out.append(len(agent.repo.rules()))
            os.unlink(f)
            out.append(w.scan_once())
            out.append(len(agent.repo.rules()))
            return out
        finally:
            agent.stop()

    got = both(run)
    assert got[0] == 1 and got[-1] == 0


def test_policy_dir_watcher_as_agent_controller():
    """``Agent(policy_dir=...)`` registers the watcher as a controller:
    a file dropped in the directory reaches the repository."""

    def run(P, tmp):
        pdir = os.path.join(tmp, "policies")
        os.makedirs(pdir)
        with open(os.path.join(pdir, "a.yaml"), "w") as fp:
            fp.write(CNP)
        agent = make_agent(P, tmp, policy_dir=pdir)
        try:
            deadline = time.monotonic() + 20
            while not agent.repo.rules() and time.monotonic() < deadline:
                time.sleep(0.02)
            st = agent.controllers.status()
            return [len(agent.repo.rules()), "policy-dir-watcher" in st,
                    sorted(st)]
        finally:
            agent.stop()

    assert both(run)[0] == 1


# ========================================================= test_admission
def test_request_slots_control_reserve():
    def run(P, tmp):
        A = P.admission
        slots = A.RequestSlots(max_inflight=1, control_reserve=1)
        out = [slots.acquire(A.CLASS_DATA), slots.acquire(A.CLASS_DATA),
               slots.acquire(A.CLASS_CONTROL),
               slots.acquire(A.CLASS_CONTROL)]
        slots.release()
        slots.release()
        out += [slots.inflight, slots.acquire(A.CLASS_DATA)]
        off = A.RequestSlots(max_inflight=0, enabled=False)
        out += [off.acquire(A.CLASS_DATA), off.inflight]
        cfg = P.config.Config()
        s = A.RequestSlots.from_config(cfg.admission)
        out += [s.max_inflight, s.control_reserve, s.enabled]
        return [list(x) if isinstance(x, tuple) else x for x in out]

    got = both(run)
    assert got[1] == [False, "queue-full"] and got[-3] == 64


def test_rest_sheds_data_class_but_not_control():
    def run(P, tmp):
        agent, c = api_agent(P, tmp,
                             socket_path=os.path.join(tmp, "svc.sock"))
        try:
            slots = agent.api_server._server.slots
            slots.max_inflight = 0
            out = [c.request("GET", "/v1/endpoint"),
                   strip(c.healthz()),
                   c.request("GET", "/v1/healthz")[0]]
            slots.max_inflight = 64
            return out
        finally:
            agent.stop()

    got = both(run)
    assert got[0][0] == 503 and got[0][1]["shed"] is True


def test_rest_drain_endpoint_and_deadline_header():
    def run(P, tmp):
        agent, c = api_agent(P, tmp,
                             socket_path=os.path.join(tmp, "svc.sock"))
        try:
            out = [strip(c.drain()), strip(c.healthz()),
                   agent.service.gate.draining]
            conn = P.api._UnixHTTPConnection(agent.api_socket_path)
            try:
                conn.request("GET", "/v1/endpoint",
                             headers={"X-Cilium-Deadline-Ms": "0"})
                resp = conn.getresponse()
                out.append([resp.status, json.loads(resp.read())])
            finally:
                conn.close()
            return out
        finally:
            agent.stop()

    got = both(run)
    assert got[0][0] == 200 and got[3][0] == 503


def test_drain_without_service():
    def run(P, tmp):
        agent, c = api_agent(P, tmp)
        try:
            return strip(c.drain())
        finally:
            agent.stop()

    assert both(run)[1]["ok"] is True


def test_agent_stop_drains_in_flight_requests():
    """``Agent.stop()`` uses the drain path: a check in flight when
    stop begins resolves with a real verdict, not ERROR."""

    def run(P, tmp):
        agent = make_agent(P, tmp,
                           socket_path=os.path.join(tmp, "svc.sock"))
        agent.endpoint_add(1, {"app": "service"}, ipv4="10.0.0.3")
        agent.endpoint_add(2, {"app": "frontend"}, ipv4="10.0.0.4")
        agent.policy_add_file(os.path.join(FIXTURES, "l7", "http-api.yaml"))
        sid = agent.endpoint_manager.get(1).identity
        fid = agent.endpoint_manager.get(2).identity
        batcher = agent.service.bridge.batcher
        stall, entered = threading.Event(), threading.Event()
        orig = batcher.verdict_fn

        def gated(flows, deadline=None):
            entered.set()
            stall.wait(2.0)
            return orig(flows, deadline=deadline)

        batcher.verdict_fn = gated
        got = []
        t = threading.Thread(target=lambda: got.append(batcher.check(
            flow(P, fid, sid, 80, "/api/v1/x"), timeout=10.0)))
        t.start()
        # the check is in flight (its batch inside the engine call)
        # before the stop begins
        assert entered.wait(10.0)
        stopper = threading.Thread(target=agent.stop)
        stopper.start()
        time.sleep(0.05)
        stall.set()
        t.join(timeout=10.0)
        stopper.join(timeout=15.0)
        return got

    assert both(run) == [5]


# ======================================= explain, trace, profile, auth
def test_rest_explain_trace_and_canary_for_a_served_chunk():
    """A chunk served through a ``ServeLoop`` on the agent's loader
    under a pinned trace id: ``GET /v1/explain`` equals
    ``resolve_explain`` in process, and equals the reference's;
    ``/v1/trace`` (span times out), ``/v1/canary`` and ``/v1/flows``."""
    tid = "0123456789abcdef"

    def run(P, tmp):
        import importlib

        binary = importlib.import_module(f"{P.root}.ingest.binary")
        serveloop = importlib.import_module(f"{P.root}.runtime.serveloop")
        explain = importlib.import_module(f"{P.root}.runtime.explain")
        tracer = P.tracing.TRACER
        explain.EXPLAIN.clear()
        tracer.clear()
        agent, c = api_agent(P, tmp)
        agent.endpoint_add(1, {"app": "service"}, ipv4="10.0.0.3")
        agent.endpoint_add(2, {"app": "frontend"}, ipv4="10.0.0.4")
        agent.policy_add_file(os.path.join(FIXTURES, "l7", "http-api.yaml"))
        sid = agent.endpoint_manager.get(1).identity
        fid = agent.endpoint_manager.get(2).identity
        # the serve loop needs the device engine: the gate on for it
        c.patch_config(enable_tpu_offload=True)
        loop = serveloop.ServeLoop(agent.loader, capacity=8,
                                   lease_ttl_s=60.0, pack_interval_s=0.01)
        try:
            flows = [flow(P, fid, sid, 80, p) for p in
                     ("/api/v1/a", "/nope", "/api/v1/b", "/x")]
            lease = loop.connect("s")
            tracer.configure(enabled=True, sample_rate=1.0)
            with tracer.trace("stream.chunk", trace_id=tid):
                ticket = loop.submit(lease, *binary.capture_from_bytes(
                    binary.capture_to_bytes(flows)))
            loop.step()
            assert ticket.done
            code, rest = c.request("GET", f"/v1/explain?trace_id={tid}")
            inproc = json.loads(json.dumps(
                explain.resolve_explain(agent.loader, tid), default=str))
            assert code == 200 and strip(rest) == strip(inproc)
            tr = c.traces(trace_id=tid)
            chrome = c.traces(trace_id=tid, chrome=True)
            return {"explain": strip(rest),
                    "miss": c.request("GET",
                                      "/v1/explain?trace_id=ffff")[1],
                    "traced": tid in tr["trace_ids"],
                    "spans": sorted((s["name"], s.get("phase", ""))
                                    for s in tr["spans"]),
                    "chrome": sorted((e["ph"], e["name"])
                                     for e in chrome["traceEvents"]),
                    "stitched": strip(c.request(
                        "GET",
                        f"/v1/trace?trace_id={tid}&stitch=1")[1]).get(
                            "hosts"),
                    "canary": c.canary(),
                    "flows": c.flows(limit=5)}
        finally:
            loop.stop() if hasattr(loop, "stop") else None
            agent.stop()
            explain.EXPLAIN.clear()

    got = both(run)
    assert got["explain"]["found"] is True
    assert got["explain"]["served_equals_fresh"] is True


def test_rest_auth_routes_drive_enforcement():
    def run(P, tmp):
        agent, c = api_agent(P, tmp)
        try:
            cnp = textwrap.dedent("""\
                apiVersion: cilium.io/v2
                kind: CiliumNetworkPolicy
                metadata: {name: mtls}
                spec:
                  endpointSelector: {matchLabels: {app: svc}}
                  ingress:
                  - fromEndpoints: [{matchLabels: {app: peer}}]
                    authentication: {mode: required}
                    toPorts: [{ports: [{port: "443", protocol: TCP}]}]
                """)
            _, svc = c.endpoint_put(1, {"app": "svc"})
            _, peer = c.endpoint_put(2, {"app": "peer"})
            c.policy_put_yaml(cnp)
            f = flow(P, peer["identity"], svc["identity"], 443)
            out = [lanes(agent.process_flows([f]))]
            out.append(c.auth_put(peer["identity"], svc["identity"]))
            out.append(strip(c.auth_list()))
            out.append(lanes(agent.process_flows([f])))
            out.append(c.auth_delete(peer["identity"], svc["identity"]))
            out.append(c.auth_delete(peer["identity"], svc["identity"]))
            out.append(lanes(agent.process_flows([f])))
            out.append(c.request("PUT", "/v1/auth", body={})[0])
            return out
        finally:
            agent.stop()

    got = both(run)
    assert [got[0]["verdict"], got[3]["verdict"], got[6]["verdict"]] == \
        [[2], [1], [2]]


def test_rest_profile_host_mode_and_busy():
    def run(P, tmp):
        agent, c = api_agent(P, tmp)
        try:
            out_dir = os.path.join(tmp, "prof")
            code, body = c.request("PUT", "/v1/profile", body={
                "mode": "host", "seconds": 0.2, "out": out_dir})
            res = [code, strip(body), os.path.exists(body["path"]),
                   os.path.dirname(body["path"]) == out_dir]
            res.append(c.request("PUT", "/v1/profile", body={
                "mode": "nope", "seconds": 0.1, "out": out_dir}))
            P.profiling.PROFILER._active = "host"
            try:
                res.append(c.request("PUT", "/v1/profile", body={
                    "mode": "host", "seconds": 0.1, "out": out_dir}))
            finally:
                P.profiling.PROFILER._active = None
            return res
        finally:
            agent.stop()

    got = both(run)
    assert got[0] == 200 and got[2] and got[-1][0] == 409


def test_policy_trace_over_rest_equals_in_process():
    cnp = textwrap.dedent("""\
        apiVersion: cilium.io/v2
        kind: CiliumNetworkPolicy
        metadata: {name: api}
        spec:
          endpointSelector: {matchLabels: {app: svc}}
          ingress:
          - fromEndpoints: [{matchLabels: {app: peer}}]
            toPorts:
            - ports: [{port: "80", protocol: TCP}]
              rules:
                http: [{method: GET}]
          - fromEndpoints: [{matchLabels: {app: peer}}]
            toPorts: [{ports: [{port: "web", protocol: TCP}]}]
          - fromCIDR: ["10.0.0.0/8"]
          - fromEntities: [cluster]
            toPorts: [{ports: [{port: "443", protocol: TCP}]}]
          ingressDeny:
          - fromEndpoints: [{matchLabels: {app: bad}}]
        """)
    cases = [({"app": "peer"}, {"app": "svc"}, 80, None),
             ({"app": "bad"}, {"app": "svc"}, 80, None),
             ({"app": "peer"}, {"app": "svc"}, 22, None),
             ({"app": "peer"}, {"app": "other"}, 80, None),
             (["cidr:10.0.0.0/8"], {"app": "svc"}, 80, None),
             (["reserved:world"], {"app": "svc"}, 443, None),
             ({"app": "x"}, {"app": "svc"}, 443, None),
             ({"app": "peer"}, {"app": "svc"}, 8080, None),
             ({"app": "peer"}, {"app": "svc"}, 8080, {"web": 8080})]

    def run(P, tmp):
        agent, c = api_agent(P, tmp)
        try:
            c.policy_put_yaml(cnp)
            out = []
            for src, dst, dport, named in cases:
                out.append(c.policy_trace(src, dst, dport=dport,
                                          named_ports=named))
            out.append(c.policy_trace({"app": "svc"}, {"app": "x"},
                                      dport=80, direction="egress"))
            return out
        finally:
            agent.stop()

    got = both(run)
    assert [g["verdict"] for g in got[:3]] == ["ALLOWED", "DENIED",
                                               "DENIED"]
    assert got[4]["verdict"] == "ALLOWED"
    assert got[5]["verdict"] == "DENIED"
    assert got[8]["verdict"] == "ALLOWED"


def test_scenario_rest_ops_equal_reference():
    """The http scenario's agent (gate on): trace answers for a sample
    of its label pairs and healthz, the same in both packages."""

    def run(P, tmp):
        sock = os.path.join(tmp, "api.sock")
        agent, flows, ids = scenario_agent(P, tmp, api_socket_path=sock)
        try:
            c = P.api.APIClient(sock)
            out = [strip(c.healthz())]
            for src, dst in (("client", "server"), ("server", "client"),
                             ("checkout", "payments")):
                labels = {e.identity: e.to_json()["labels"]
                          for e in agent.endpoint_manager.endpoints()}
                out.append(c.policy_trace(labels[ids[src]],
                                          labels[ids[dst]], dport=80))
            return out
        finally:
            agent.stop()

    got = both(run)
    assert got[0]["engine_revision"] > 0
