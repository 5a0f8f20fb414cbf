"""The port's CLI (``cilium_tpu_torch/cli.py``) against the JAX
package's (``cilium_tpu/cli.py``), on the CPU.

Both packages' ``cli.main(argv)`` run the same command lines against
their own live agent (built from one configuration, the port's with
``device="cpu"``) or on the same files, in this process with standard
output captured; what each prints is compared. Tolerance: exact — the
same exit codes and the same JSON, after the stamps that are not data
are taken out (socket and temporary paths, times, rates, instance ids,
counts of the process's own metrics). Files the CLI writes (``capture
synth`` and ``capture convert``) are compared byte for byte.

Counterparts of the reference tests that drive the CLI, each named in
its docstring: ``tests/test_cli.py`` (7 cases),
``tests/test_agent.py::test_cli_over_socket_and_replay``,
``tests/test_k8s_agent.py::test_k8s_cli_apply_get_delete``,
``tests/test_hubble_server.py::test_agent_hubble_socket_and_cli``,
``tests/test_replay_cursor.py::test_cli_replay_with_cursor_resumes``
and the CLI cases of ``tests/test_binary_capture.py``,
``tests/test_capture_l7.py``, ``tests/test_monitor_socket.py``,
``tests/test_flowpb.py``, ``tests/test_accesslog_ingest.py``,
``tests/test_policy_trace.py``, ``tests/test_auth_mode.py`` and
``tests/test_profiling.py``.

``replay`` reads ``Config.from_env()``: the reference's gate is off (the
CPU oracle) unless ``--tpu``, the port's on (its engine on
``--device cpu``, the plain versions); the verdict counts are equal
either way, and each package's cache is a directory of its own
(``CILIUM_TPU_CACHE_DIR``).
"""

import contextlib
import importlib
import io
import json
import os
import subprocess
import sys
import tarfile
import time

import numpy as np
import pytest

from test_torch_agent import (
    FIXTURES,
    JAX,
    PKGS,
    PORT,
    REPO,
    differing,
    make_agent,
    short_dir,
)

#: keys whose values are stamps, not data
STAMPS = {"ts", "time", "timestamp", "seconds", "records_per_sec",
          "instance", "created", "uid", "creationTimestamp", "uptime_s",
          "duration_s", "trace_id", "path", "out", "trace_out",
          "resourceVersion", "generation_now", "last-success",
          "last-failure", "success-count", "failure-count",
          "consecutive-failures", "last-error", "peers", "nodes",
          "expires"}

CNP = """\
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata: {name: cli-test, namespace: default}
spec:
  endpointSelector: {matchLabels: {app: service}}
  ingress:
    - fromEndpoints: [{matchLabels: {app: frontend}}]
      toPorts:
        - ports: [{port: "80", protocol: TCP}]
          rules:
            http: [{method: GET, path: "/api/.*"}]
"""

L4_CNP = """
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata: {name: t}
spec:
  endpointSelector: {matchLabels: {app: svc}}
  ingress:
  - toPorts: [{ports: [{port: "80", protocol: TCP}]}]
"""

HTTP_CNP = """
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata: {name: t}
spec:
  endpointSelector: {matchLabels: {app: svc}}
  ingress:
  - toPorts: [{ports: [{port: "80", protocol: TCP}],
               rules: {http: [{method: GET, path: "/api/.*"}]}}]
"""


def cli_of(P):
    return importlib.import_module(f"{P.root}.cli")


def mod(P, name):
    return importlib.import_module(f"{P.root}.{name}")


def scrub(text, tmp):
    return text.replace(tmp, "<tmp>")


def run(P, tmp, *argv):
    """``P``'s ``cli.main(argv)`` → (rc, stdout, stderr), the temporary
    directory's path written as ``<tmp>``. The port's ``replay`` runs
    on ``--device cpu``; each package's replay caches in ``tmp``."""
    argv = [str(a) for a in argv]
    if not P.jax and argv[0] == "replay":
        argv += ["--device", "cpu"]
    out, err = io.StringIO(), io.StringIO()
    old = os.environ.get("CILIUM_TPU_CACHE_DIR")
    os.environ["CILIUM_TPU_CACHE_DIR"] = os.path.join(tmp, "cli-cache")
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli_of(P).main(argv)
    finally:
        if old is None:
            del os.environ["CILIUM_TPU_CACHE_DIR"]
        else:
            os.environ["CILIUM_TPU_CACHE_DIR"] = old
    return rc, scrub(out.getvalue(), tmp), scrub(err.getvalue(), tmp)


def stampless(obj):
    if isinstance(obj, dict):
        return {k: stampless(v) for k, v in obj.items() if k not in STAMPS}
    if isinstance(obj, list):
        return [stampless(v) for v in obj]
    return obj


def run_json(P, tmp, *argv):
    """(rc, the JSON it printed without stamps)."""
    rc, out, err = run(P, tmp, *argv)
    try:
        body = json.loads(out)
    except ValueError:
        body = [json.loads(ln) for ln in out.splitlines() if ln.strip()]
    return rc, stampless(body)


def both(fn, *args):
    """``fn(P, tmp, *args)`` in each package, in a short directory of
    its own; the two results must be equal. Returns the port's."""
    res = []
    for P in PKGS:
        with short_dir() as tmp:
            res.append(fn(P, tmp, *args))
    diff = differing(*res)
    assert not diff, diff[:20]
    return res[1]


@contextlib.contextmanager
def live(P, tmp, offload=False, **kw):
    """``P``'s agent with its verdict, REST, Hubble and monitor
    sockets, started."""
    socks = {k: os.path.join(tmp, f"{k}.sock")
             for k in ("svc", "api", "hub", "mon")}
    agent = make_agent(P, tmp, offload=offload, socket_path=socks["svc"],
                       api_socket_path=socks["api"],
                       hubble_socket_path=socks["hub"],
                       monitor_socket_path=socks["mon"], **kw)
    try:
        yield agent, socks
    finally:
        agent.stop()


def write(tmp, name, text):
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        f.write(text)
    return path


def http_flow(P, src, dst, path="/api/x", method="GET", port=80):
    F = P.flow
    return F.Flow(src_identity=src, dst_identity=dst, dport=port,
                  protocol=F.Protocol.TCP,
                  direction=F.TrafficDirection.INGRESS, l7=F.L7Type.HTTP,
                  http=F.HTTPInfo(method=method, path=path, host="h"))


# ============================================================ socket
def test_socket_commands_equal_reference():
    """``tests/test_cli.py::test_status_policy_metrics``,
    ``test_drain_command`` and ``tests/test_agent.py::
    test_cli_over_socket_and_replay`` (its socket half): ``status``,
    ``policy get``, ``metrics``, ``explain`` of an unknown trace id,
    ``drain`` and ``status`` after it."""

    def go(P, tmp):
        with live(P, tmp) as (agent, s):
            agent.endpoint_add(1, {"app": "service"})
            agent.policy_add_file(os.path.join(FIXTURES, "l7",
                                               "http-api.yaml"))
            out = {"status": run_json(P, tmp, "status", "--socket",
                                      s["svc"]),
                   "policy": run_json(P, tmp, "policy", "get",
                                      "--socket", s["svc"])}
            rc, text, _ = run(P, tmp, "metrics", "--socket", s["svc"])
            out["metrics"] = (rc, "cilium_tpu" in text)
            out["explain"] = run_json(P, tmp, "explain", "0" * 16,
                                      "--socket", s["svc"], "--json")
            rc, text, _ = run(P, tmp, "explain", "0" * 16, "--socket",
                              s["svc"])
            out["explain_text"] = (rc, text)
            out["drain"] = run_json(P, tmp, "drain", "--socket", s["svc"])
            out["draining"] = agent.service.gate.draining
            out["after"] = run_json(P, tmp, "status", "--socket", s["svc"])
        # the backend names the engine class, which differs by design
        for k in ("status", "after"):
            out[k][1].pop("backend")
        return out

    got = both(go)
    assert got["status"][0] == 0 and got["status"][1]["endpoints"] == 1
    assert got["status"][1]["rules"] >= 1
    assert any("l7-http-api" in ",".join(r["labels"])
               for r in got["policy"][1]["rules"])
    assert got["metrics"] == (0, True)
    assert got["drain"][0] == 0 and got["drain"][1]["ok"] is True
    assert got["draining"] is True and got["after"][0] == 0


def test_unreachable_socket_is_an_error_not_a_traceback():
    """``tests/test_cli.py::
    test_unreachable_socket_is_an_error_not_a_traceback``."""

    def go(P, tmp):
        rc, out, err = run(P, tmp, "status", "--socket",
                           os.path.join(tmp, "nope.sock"))
        return rc, out, "error" in err

    assert both(go) == (1, "", True)


# ============================================================ REST
def test_rest_commands_equal_reference():
    """``tests/test_cli.py::test_rest_commands``: healthz, endpoint
    add/list/get/config/delete, policy import/delete, identity, ip,
    proxy, fqdn, service, config get/set, canary, trace dump and flows,
    each command's output equal to the reference's."""

    def go(P, tmp):
        cnp = write(tmp, "cli-test.yaml", CNP)
        out = {}
        with live(P, tmp) as (agent, s):
            api = s["api"]
            steps = [
                ("healthz", ["healthz"]),
                ("ep1", ["endpoint", "add", "1", "--labels",
                         "app=service"]),
                ("ep2", ["endpoint", "add", "2", "--labels",
                         "app=frontend"]),
                ("eps", ["endpoint", "list"]),
                ("import", ["policy", "import", cnp]),
                ("ids", ["identity", "list"]),
                ("ip", ["ip", "list"]),
                ("proxy", ["proxy", "list"]),
                ("fqdn", ["fqdn", "cache"]),
                ("svc", ["service", "list"]),
                ("selectors", ["policy", "selectors"]),
                ("cfg", ["config", "get"]),
                ("cfg_set", ["config", "set", "policy_audit_mode=true"]),
                ("cfg_unset", ["config", "set",
                               "policy_audit_mode=false"]),
                ("canary", ["canary", "--json"]),
                ("canary_text", ["canary"]),
                ("flows", ["flows", "--json"]),
                ("delete", ["policy", "delete", "k8s:name=cli-test"]),
                ("audit_on", ["endpoint", "config", "1",
                              "PolicyAuditMode=Enabled"]),
                ("get1", ["endpoint", "get", "1"]),
                ("audit_off", ["endpoint", "config", "1",
                               "PolicyAuditMode=Disabled"]),
                ("bogus", ["endpoint", "config", "1", "Bogus=1"]),
                ("bad_value", ["endpoint", "config", "1",
                               "PolicyAuditMode=maybe"]),
                ("get9", ["endpoint", "get", "9"]),
                ("del2", ["endpoint", "delete", "2"]),
                ("eps_after", ["endpoint", "list"]),
            ]
            for name, argv in steps:
                rc, text, err = run(P, tmp, *argv, "--api", api)
                try:
                    body = stampless(json.loads(text))
                except ValueError:
                    body = text
                out[name] = (rc, body, bool(err))
            rc, text, _ = run(P, tmp, "trace", "dump", "--api", api,
                              "--spans")
            out["trace_spans"] = (rc, sorted(json.loads(text)))
            rc, text, _ = run(P, tmp, "trace", "dump", "--api", api,
                              "--out", os.path.join(tmp, "t.json"))
            out["trace_file"] = (rc, sorted(json.loads(text)))
        # the config's cache directory is each package's own
        for k in ("cfg",):
            out[k][1]["config"]["loader"].pop("cache_dir")
        return out

    got = both(go)
    assert got["healthz"][1]["status"] == "ok"
    assert len(got["eps"][1]) == 2 and got["import"][0] == 0
    assert got["ids"][1] and got["delete"][0] == 0
    assert got["audit_on"][1]["policy_audit_mode"] is True
    assert got["get1"][1]["policy_audit_mode"] is True
    assert got["audit_off"][1]["policy_audit_mode"] is False
    assert got["bogus"][0] == 1 and got["bad_value"][0] == 1
    assert got["get9"][0] == 1 and len(got["eps_after"][1]) == 1


TRACE_CNP = """
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata: {name: trace}
spec:
  endpointSelector: {matchLabels: {app: svc}}
  ingress:
  - fromEndpoints: [{matchLabels: {app: peer}}]
    toPorts: [{ports: [{port: "80", protocol: TCP}]}]
  - fromCIDR: ["10.0.0.0/8"]
    toPorts: [{ports: [{port: "443", protocol: TCP}]}]
  - fromEndpoints: [{matchLabels: {app: peer}}]
    toPorts: [{ports: [{port: "web", protocol: TCP}]}]
"""


def test_policy_trace_and_auth_equal_reference():
    """``tests/test_policy_trace.py``'s CLI cases (``policy trace`` by
    labels, by ``cidr:`` and ``reserved:`` labels, with and without
    ``--named-port``, ``policy selectors``) and ``tests/
    test_auth_mode.py``'s ``auth add|list|delete`` round trip with the
    verdicts it moves."""

    def go(P, tmp):
        cnp = write(tmp, "trace.yaml", TRACE_CNP)
        out = {}
        with live(P, tmp) as (agent, s):
            api = s["api"]
            out["import"] = run_json(P, tmp, "policy", "import", cnp,
                                     "--api", api)
            for name, argv in (
                    ("allowed", ["--src", "app=peer", "--dst", "app=svc",
                                 "--dport", "80"]),
                    ("denied", ["--src", "app=bad", "--dst", "app=svc",
                                "--dport", "80"]),
                    ("cidr", ["--src", "cidr:10.0.0.0/8", "--dst",
                              "app=svc", "--dport", "443"]),
                    ("world", ["--src", "reserved:world", "--dst",
                               "app=svc", "--dport", "443"]),
                    ("unnamed", ["--src", "app=peer", "--dst", "app=svc",
                                 "--dport", "8080"]),
                    ("named", ["--src", "app=peer", "--dst", "app=svc",
                               "--dport", "8080", "--named-port",
                               "web=8080"]),
                    ("bad_named", ["--src", "app=peer", "--dst",
                                   "app=svc", "--named-port", "web"])):
                out[name] = run_json(P, tmp, "policy", "trace", "--api",
                                     api, *argv)
            out["selectors"] = run_json(P, tmp, "policy", "selectors",
                                        "--api", api)
            svc = agent.endpoint_add(1, {"app": "svc"})
            peer = agent.endpoint_add(2, {"app": "peer"})
            F = P.flow
            f = F.Flow(src_identity=peer.identity,
                       dst_identity=svc.identity, dport=80,
                       direction=F.TrafficDirection.INGRESS)
            v = [int(agent.process_flows([f])["verdict"][0])]
            out["add"] = run_json(P, tmp, "auth", "add", peer.identity,
                                  svc.identity, "--api", api)
            v.append(int(agent.process_flows([f])["verdict"][0]))
            out["list"] = run_json(P, tmp, "auth", "list", "--api", api)
            out["delete"] = run_json(P, tmp, "auth", "delete",
                                     peer.identity, svc.identity,
                                     "--api", api)
            out["delete_again"] = run_json(P, tmp, "auth", "delete",
                                           peer.identity, svc.identity,
                                           "--api", api)
            v.append(int(agent.process_flows([f])["verdict"][0]))
            out["verdicts"] = v
        return out

    got = both(go)
    assert got["allowed"][1]["verdict"] == "ALLOWED"
    assert got["denied"][1]["verdict"] == "DENIED"
    assert got["cidr"][1]["verdict"] == "ALLOWED"
    assert got["world"][1]["verdict"] == "DENIED"
    assert got["unnamed"][1]["verdict"] == "DENIED"
    assert got["named"][1]["verdict"] == "ALLOWED"
    assert got["bad_named"][0] == 2
    assert got["list"][1][0]["src_identity"] > 0


# ============================================================ streams
MON_CNP = """
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata: {name: mon}
spec:
  endpointSelector: {matchLabels: {app: svc}}
  ingress:
  - fromEndpoints: [{matchLabels: {app: cli}}]
    toPorts: [{ports: [{port: "80", protocol: TCP}]}]
"""


def monitor_proc(P, *argv):
    """``python -m <P>.cli monitor ...`` in a process of its own (the
    CLI prints to this process's standard output, which threads would
    share)."""
    return subprocess.Popen(
        [sys.executable, "-m", f"{P.root}.cli", "monitor", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)


def monitor_result(proc, timeout=60):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    return (proc.returncode,
            [stampless(json.loads(ln)) for ln in out.splitlines()
             if ln.strip()], err)


def _wait_clients(agent, n, deadline=60.0):
    t0 = time.monotonic()
    while agent.monitor_server.num_clients() < n:
        assert time.monotonic() - t0 < deadline, "no monitor client"
        time.sleep(0.02)


def test_observe_and_monitor_equal_reference():
    """``tests/test_cli.py::test_observe_streams_flows``, ``tests/
    test_hubble_server.py::test_agent_hubble_socket_and_cli`` and
    ``tests/test_monitor_socket.py``'s CLI cases: ``observe`` (flows,
    filters, ``--status``), ``monitor --count`` at the agent's level
    and at ``none``, with a type filter, and a follower without
    ``--count`` that exits 0 when the agent stops."""

    def go(P, tmp):
        out = {}
        with live(P, tmp) as (agent, s):
            svc = agent.endpoint_add(1, {"app": "svc"})
            cli = agent.endpoint_add(2, {"app": "cli"})
            agent.policy_add_file(write(tmp, "cnp.yaml", MON_CNP))
            procs = {"medium": monitor_proc(P, "--socket", s["mon"],
                                            "--count", "3"),
                     "none": monitor_proc(P, "--socket", s["mon"],
                                          "--count", "4", "--level",
                                          "none"),
                     "drop": monitor_proc(P, "--socket", s["mon"],
                                          "--count", "1", "--type",
                                          "drop")}
            # without --count: it follows until the agent stops
            follower = monitor_proc(P, "--socket", s["mon"])
            _wait_clients(agent, 4)
            F = P.flow
            agent.process_flows([
                F.Flow(src_identity=cli.identity,
                       dst_identity=svc.identity, dport=80),
                F.Flow(src_identity=cli.identity,
                       dst_identity=svc.identity, dport=81)])
            for k, proc in procs.items():
                rc, events, _ = monitor_result(proc)
                out[f"monitor_{k}"] = (rc, events)
            h = s["hub"]
            out["observe"] = run_json(P, tmp, "observe", "--hubble", h)
            out["observe1"] = run_json(P, tmp, "observe", "--hubble", h,
                                       "--limit", "1")
            out["dropped"] = run_json(P, tmp, "observe", "--hubble", h,
                                      "--verdict", "dropped", "--dport",
                                      "81")
            out["status"] = run_json(P, tmp, "observe", "--hubble", h,
                                     "--status")
        rc, events, err = monitor_result(follower)
        out["follower"] = (rc, events, "closed by agent" in err)
        return out

    got = both(go)
    types = [e["type"] for e in got["monitor_medium"][1]]
    assert got["monitor_medium"][0] == 0
    assert types.count("POLICY_VERDICT") == 2 and types.count("DROP") == 1
    assert [e["type"] for e in got["monitor_none"][1]] == [
        "POLICY_VERDICT", "TRACE", "POLICY_VERDICT", "DROP"]
    assert [e["type"] for e in got["monitor_drop"][1]] == ["DROP"]
    assert len(got["observe"][1]) == 2
    assert got["observe1"][1]["l4"] == {"TCP": {"destination_port": 80}}
    assert got["dropped"][1]["verdict"] == "DROPPED"
    assert got["status"][1]["seen"] == 2
    assert got["follower"] == (0, got["monitor_medium"][1], True)


def test_capture_stream_against_live_agent():
    """``tests/test_cli.py::test_capture_stream_against_live_agent``:
    ``capture synth`` (byte-equal files) and ``capture stream`` through
    each package's verdict socket; the summaries equal but for the
    stamps, and each record's verdict read through the port's
    ``StreamClient`` equal to a plain engine of the agent's policy."""

    def go(P, tmp):
        with live(P, tmp, offload=True) as (agent, s):
            agent.policy_add_file(write(tmp, "cnp.yaml", CNP), wait=False)
            agent.endpoint_add(1, {"app": "service"})
            agent.endpoint_manager.regenerate_all(wait=True)
            cap = os.path.join(tmp, "cap.bin")
            synth = run_json(P, tmp, "capture", "synth", cap, "--scenario",
                             "http", "--rules", "20", "--flows", "500")
            with open(cap, "rb") as f:
                raw = f.read()
            stream = run_json(P, tmp, "capture", "stream", cap,
                              "--socket", s["svc"], "--chunk", "128")
            per_record = None
            if not P.jax:
                per_record = _stream_verdicts(agent, cap, s["svc"])
            return {"synth": synth, "bytes": raw, "stream": stream,
                    "per_record": per_record}

    res = []
    for P in PKGS:
        with short_dir() as tmp:
            res.append(go(P, tmp))
    port = res[1]
    want = port.pop("per_record")
    res[0].pop("per_record")
    assert not differing(*res)
    rc, info = port["stream"]
    assert rc == 0 and info["records"] == 500 and info["errors"] == 0
    assert info["verdicts"] == np.bincount(want, minlength=6).tolist()


def _stream_verdicts(agent, cap, sock):
    """Each record's verdict through the port's ``StreamClient`` over
    the agent's socket, held against a plain engine of its policy."""
    from cilium_tpu_torch.engine.verdict import TorchVerdictEngine
    from cilium_tpu_torch.ingest import binary
    from cilium_tpu_torch.runtime.stream import StreamClient

    rec = binary.map_capture(cap)
    l7, offsets, blob = binary.read_l7_sidecar(cap)
    client = StreamClient(sock, widths=binary.capture_field_widths(
        l7, offsets))
    try:
        for i in range(0, len(rec), 128):
            client.send_image(binary.sections_to_bytes(
                np.asarray(rec[i:i + 128]), l7[i:i + 128], offsets, blob))
        client.finish()
        got = np.concatenate([v for _, v in client.results()])
    finally:
        client.close()
    e = agent.loader.engine
    plain = TorchVerdictEngine(e.policy, device="cpu", cfg=e.cfg)
    want = plain.verdict_l7_records(np.asarray(rec), l7, offsets, blob)
    np.testing.assert_array_equal(got, want["verdict"])
    return got


def test_profile_over_the_socket():
    """``tests/test_profiling.py``'s CLI case: ``profile --mode host``
    over the service socket writes its profile; an unknown mode is an
    argparse error in both."""

    def go(P, tmp):
        with live(P, tmp) as (agent, s):
            rc, body = run_json(P, tmp, "profile", "--socket", s["svc"],
                                "--seconds", "0.2", "--out",
                                os.path.join(tmp, "p1"))
        return rc, sorted(body)

    rc, keys = both(go)
    assert rc == 0 and keys


def test_k8s_cli_apply_get_delete():
    """``tests/test_k8s_agent.py::test_k8s_cli_apply_get_delete``:
    ``k8s apply|get|delete`` of a CNP file against each package's
    apiserver (the port reads the YAML with its own reader)."""
    doc = """\
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata:
  name: from-cli
  namespace: default
spec:
  endpointSelector:
    matchLabels:
      app: db
  ingress:
  - fromEndpoints:
    - matchLabels:
        app: web
"""

    def go(P, tmp):
        server = mod(P, "k8s.apiserver").APIServer(
            os.path.join(tmp, "k8s.sock")).start()
        sock = server.socket_path
        f = write(tmp, "cnp.yaml", doc)
        try:
            out = {"apply": run_json(P, tmp, "k8s", "apply", "--socket",
                                     sock, "-f", f),
                   "get": run_json(P, tmp, "k8s", "get", "--socket", sock,
                                   "ciliumnetworkpolicies", "from-cli"),
                   "list": run_json(P, tmp, "k8s", "get", "--socket", sock,
                                    "ciliumnetworkpolicies"),
                   "again": run_json(P, tmp, "k8s", "apply", "--socket",
                                     sock, "-f", f),
                   "delete": run_json(P, tmp, "k8s", "delete", "--socket",
                                      sock, "ciliumnetworkpolicies",
                                      "from-cli")}
            rc, text, err = run(P, tmp, "k8s", "get", "--socket", sock,
                                "ciliumnetworkpolicies", "from-cli")
            out["gone"] = (rc, text, bool(err))
        finally:
            server.stop()
        return out

    got = both(go)
    assert got["get"][1]["spec"]["endpointSelector"]["matchLabels"] == {
        "app": "db"}
    assert got["delete"][0] == 0 and got["gone"][0] == 1


# ============================================================ offline
def _capture_flows(P):
    F = P.flow
    return [F.Flow(src_identity=100 + i % 3, dst_identity=200,
                   dport=80 + (i % 4), protocol=F.Protocol.TCP,
                   direction=F.TrafficDirection.INGRESS)
            for i in range(20)]


def _l7_flows(P):
    F = P.flow
    return [
        F.Flow(src_identity=1001, dst_identity=2002, dport=80,
               l7=F.L7Type.HTTP,
               http=F.HTTPInfo(method="GET", path="/api/v1/items/7",
                               host="SVC.Local",
                               headers=(("X-Role", "admin"),
                                        ("Accept", "json")))),
        F.Flow(src_identity=1001, dst_identity=2002, dport=9092,
               l7=F.L7Type.KAFKA,
               kafka=F.KafkaInfo(api_key=0, api_version=3,
                                 client_id="producer-1", topic="orders")),
        F.Flow(src_identity=1001, dst_identity=2002, dport=53,
               protocol=F.Protocol.UDP,
               direction=F.TrafficDirection.EGRESS, l7=F.L7Type.DNS,
               dns=F.DNSInfo(query="API.Example.COM.")),
        F.Flow(src_identity=1001, dst_identity=2002, dport=443),
    ]


def _jsonl(P, tmp, name, flows):
    path = os.path.join(tmp, name)
    to_dict = mod(P, "ingest.hubble").flow_to_dict
    with open(path, "w") as f:
        f.write("\n".join(json.dumps(to_dict(x)) for x in flows) + "\n")
    return path


def _scenario_flows(P, kind, rules, flows):
    synth = mod(P, "ingest.synth")
    sc = (synth.synth_http_scenario(n_rules=rules, n_flows=flows)
          if kind == "http" else
          synth.synth_generic_scenario(n_rules=rules, n_flows=flows))
    _, sc = synth.realize_scenario(sc)
    for f in sc.flows:
        f.src_labels = ()
        f.dst_labels = ()
    return sc.flows


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _offline_l4(P, tmp):
    """``tests/test_binary_capture.py::test_cli_convert_info_replay``
    and ``test_cli_fast_replay_matches_object_path``."""
    jsonl = _jsonl(P, tmp, "cap.jsonl", _capture_flows(P))
    b = os.path.join(tmp, "cap.bin")
    cnp = write(tmp, "p.yaml", L4_CNP)
    base = ["--policy", cnp, "--endpoint", "app=svc"]
    return {
        "convert": run_json(P, tmp, "capture", "convert", jsonl, b),
        "bytes": _read(b),
        "info": run_json(P, tmp, "capture", "info", b),
        "cursor": run_json(P, tmp, "replay", b, *base, "--cursor",
                           os.path.join(tmp, "cur.json")),
        "slow": run_json(P, tmp, "replay", b, *base),
        "fast": run_json(P, tmp, "replay", b, "--fast", *base),
        "fast_jsonl": run(P, tmp, "replay", jsonl, "--fast", *base)[0:1],
    }


def _offline_invalid(P, tmp):
    """``tests/test_binary_capture.py::
    test_cli_reports_invalid_captures_cleanly``."""
    bad = write(tmp, "bad.bin", "garbage")
    out = {}
    for name, path in (("missing", os.path.join(tmp, "missing.bin")),
                       ("bad", bad)):
        rc, text, err = run(P, tmp, "capture", "info", path)
        out[name] = (rc, text, err)
    return out


def _offline_v2(P, tmp):
    """``tests/test_capture_l7.py::test_cli_v2_convert_info_fast_replay``
    and the ``--l4-only`` flattening of the same JSONL."""
    jsonl = _jsonl(P, tmp, "cap.jsonl", _l7_flows(P))
    b, v1 = os.path.join(tmp, "cap2.bin"), os.path.join(tmp, "cap1.bin")
    cnp = write(tmp, "p.yaml", HTTP_CNP)
    base = ["--policy", cnp, "--endpoint", "app=svc"]
    return {
        "convert": run_json(P, tmp, "capture", "convert", jsonl, b),
        "bytes": _read(b),
        "info": run_json(P, tmp, "capture", "info", b),
        "l4_only": run_json(P, tmp, "capture", "convert", jsonl, v1,
                            "--l4-only"),
        "v1_bytes": _read(v1),
        "v1_info": run_json(P, tmp, "capture", "info", v1),
        "slow": run_json(P, tmp, "replay", b, *base),
        "fast": run_json(P, tmp, "replay", b, "--fast", *base),
    }


def _offline_fast_tpu(P, tmp):
    """``tests/test_capture_l7.py::
    test_cli_fast_tpu_uses_staged_replay_and_agrees``: ``--tpu`` in
    both packages (the reference's jitted engine, the port's engine on
    the CPU)."""
    jsonl = _jsonl(P, tmp, "cap.jsonl", _scenario_flows(P, "http", 12, 120))
    b = os.path.join(tmp, "cap2.bin")
    cnp = write(tmp, "p.yaml", HTTP_CNP)
    base = ["--policy", cnp, "--endpoint", "app=svc", "--tpu"]
    return {
        "convert": run_json(P, tmp, "capture", "convert", jsonl, b),
        "bytes": _read(b),
        "slow": run_json(P, tmp, "replay", b, *base),
        "fast": run_json(P, tmp, "replay", b, "--fast", *base),
    }


R2D2_CNP = """
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata: {name: t}
spec:
  endpointSelector: {matchLabels: {app: r2d2}}
  ingress:
  - toPorts: [{ports: [{port: "4242", protocol: TCP}],
               rules: {l7proto: r2d2,
                       l7: [{cmd: READ, file: f0.txt},
                            {cmd: HALT}]}}]
"""


def _offline_generic(P, tmp):
    """``tests/test_capture_l7.py``'s v3 case (a generic capture
    replayed as JSONL, binary and ``--fast``)."""
    jsonl = _jsonl(P, tmp, "cap.jsonl",
                   _scenario_flows(P, "generic", 9, 120))
    b = os.path.join(tmp, "cap3.bin")
    cnp = write(tmp, "p.yaml", R2D2_CNP)
    base = ["--policy", cnp, "--endpoint", "app=r2d2", "--tpu"]
    return {
        "convert": run_json(P, tmp, "capture", "convert", jsonl, b),
        "bytes": _read(b),
        "info": run_json(P, tmp, "capture", "info", b),
        "twin": run_json(P, tmp, "replay", jsonl, *base),
        "slow": run_json(P, tmp, "replay", b, *base),
        "fast": run_json(P, tmp, "replay", b, "--fast", *base),
    }


def _offline_synth(P, tmp):
    """``tests/test_capture_l7.py::test_cli_capture_synth_is_reproducible``
    across packages and scenarios (byte-equal files), and an unknown
    scenario size refused."""
    out = {}
    for sc in ("http", "fqdn", "kafka", "generic"):
        p = os.path.join(tmp, f"{sc}.bin")
        out[sc] = run_json(P, tmp, "capture", "synth", p, "--scenario", sc,
                           "--rules", "10", "--flows", "200", "--seed", "7")
        out[f"{sc}_bytes"] = _read(p)
        out[f"{sc}_info"] = run_json(P, tmp, "capture", "info", p)
    return out


def _offline_flowpb(P, tmp):
    """``tests/test_flowpb.py``'s CLI cases: replay of a flowpb stream
    equal to its JSONL twin, ``--limit``, ``capture convert`` of the
    stream (v2, and ``--l4-only``) and ``capture info`` on it."""
    flowpb = mod(P, "ingest.flowpb")
    F = P.flow
    flows = []
    for i in range(30):
        flows.append(F.Flow(
            src_identity=0, dst_identity=0, dport=80,
            protocol=F.Protocol.TCP, direction=F.TrafficDirection.INGRESS,
            l7=F.L7Type.HTTP,
            http=F.HTTPInfo(method="GET" if i % 2 else "PUT",
                            path=f"/api/{i}" if i % 3 else "/nope",
                            host="h"),
            src_labels=("k8s:app=frontend",) if i % 5 else
            ("k8s:app=other",),
            dst_labels=("k8s:app=service",)))
    pb = os.path.join(tmp, "cap.pb")
    flowpb.write_pb_capture(pb, flows)
    jsonl = _jsonl(P, tmp, "cap.jsonl", flows)
    cnp = write(tmp, "p.yaml", """
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata: {name: t}
spec:
  endpointSelector: {matchLabels: {app: service}}
  ingress:
  - fromEndpoints: [{matchLabels: {app: frontend}}]
    toPorts: [{ports: [{port: "80", protocol: TCP}],
               rules: {http: [{method: GET, path: "/api/.*"}]}}]
""")
    base = ["--policy", cnp, "--endpoint", "app=service", "--endpoint",
            "app=frontend", "--endpoint", "app=other"]
    b, v1 = os.path.join(tmp, "c.bin"), os.path.join(tmp, "c1.bin")
    return {
        "pb": run_json(P, tmp, "replay", pb, *base),
        "jsonl": run_json(P, tmp, "replay", jsonl, *base),
        "limit": run_json(P, tmp, "replay", pb, "--limit", "10", *base),
        "convert": run_json(P, tmp, "capture", "convert", pb, b),
        "bytes": _read(b),
        "l4_only": run_json(P, tmp, "capture", "convert", pb, v1,
                            "--l4-only"),
        "v1_bytes": _read(v1),
        "info": run_json(P, tmp, "capture", "info", pb),
    }


def _offline_golden(P, tmp):
    """``tests/test_accesslog_ingest.py::
    test_golden_reference_capture_replays``: the golden access-log
    capture through ``replay`` and through ``capture convert``."""
    import test_accesslog_ingest as ref

    cnp = write(tmp, "cnp.yaml", ref.CNP)
    b = os.path.join(tmp, "g.bin")
    args = [str(a) for a in ref._replay_args(cnp)]
    return {"replay": run_json(P, tmp, "replay", ref.GOLDEN, *args),
            "convert": run_json(P, tmp, "capture", "convert", ref.GOLDEN,
                                b),
            "bytes": _read(b),
            "fast": run_json(P, tmp, "replay", b, "--fast", *args)}


def _offline_cursor(P, tmp):
    """``tests/test_replay_cursor.py::test_cli_replay_with_cursor_resumes``
    on a JSONL capture and on its binary conversion."""
    jsonl = _jsonl(P, tmp, "cap.jsonl", _capture_flows(P)[:8])
    b = os.path.join(tmp, "cap.bin")
    run(P, tmp, "capture", "convert", jsonl, b)
    cnp = write(tmp, "p.yaml", L4_CNP)
    out = {}
    for name, cap in (("jsonl", jsonl), ("bin", b)):
        argv = ["replay", cap, "--policy", cnp, "--endpoint", "app=svc",
                "--cursor", os.path.join(tmp, f"cur-{name}.json")]
        out[name] = [run_json(P, tmp, *argv, "--limit", "5"),
                     run_json(P, tmp, *argv),
                     run_json(P, tmp, *argv)]
    return out


OFFLINE = {"l4": _offline_l4, "invalid": _offline_invalid,
           "v2": _offline_v2, "fast_tpu": _offline_fast_tpu,
           "generic": _offline_generic, "synth": _offline_synth,
           "flowpb": _offline_flowpb, "golden": _offline_golden,
           "cursor": _offline_cursor}


@pytest.mark.parametrize("case", sorted(OFFLINE))
def test_offline_capture_and_replay_equal_reference(case):
    """The offline commands (``capture convert|info|synth``, ``replay``
    on the object path, ``--fast``, ``--cursor``, ``--limit``) on the
    same inputs in both packages: equal output, byte-equal files."""
    got = both(OFFLINE[case])
    if case == "l4":
        assert got["convert"] == (0, {"records": 20, "version": 1,
                                      "l7_payloads_dropped": 0})
        assert got["fast"] == got["slow"] and got["slow"][1]["flows"] == 20
        assert got["fast_jsonl"] == (1,)
    elif case == "invalid":
        assert got["missing"][0] == 1 and got["bad"][0] == 1
        assert "invalid capture" in got["bad"][2]
    elif case == "v2":
        assert got["convert"] == (0, {"records": 4, "version": 2,
                                      "l7_payloads": 3})
        assert got["l4_only"][1]["l7_payloads_dropped"] == 3
        assert got["fast"] == got["slow"] and got["slow"][1]["flows"] == 4
    elif case in ("fast_tpu", "generic"):
        assert got["fast"] == got["slow"] and got["slow"][1]["flows"] == 120
        assert len(got["slow"][1]["verdicts"]) > 1
    elif case == "synth":
        assert got["http"] == (0, {"records": 200, "version": 2,
                                   "scenario": "http", "rules": 10,
                                   "seed": 7})
    elif case == "flowpb":
        assert got["pb"] == got["jsonl"] and got["pb"][1]["flows"] == 30
        assert got["limit"][1]["flows"] == 10
        assert got["info"][1]["format"] == "flowpb-stream"
    elif case == "golden":
        assert got["replay"][0] == 0 and got["replay"][1]["flows"] > 0
    else:
        for name in ("jsonl", "bin"):
            assert [r[1]["flows"] for r in got[name]] == [5, 3, 8]


def test_bugtool_and_offline_replay():
    """``tests/test_cli.py::test_bugtool_and_offline_replay`` and
    ``tests/test_agent.py::test_cli_over_socket_and_replay`` (its
    replay half): ``bugtool`` over the socket prints the bundle's path,
    whose archive holds the reference's files; ``replay`` of a JSONL
    capture against the CNP."""

    def go(P, tmp):
        with live(P, tmp) as (agent, s):
            rc, text, _ = run(P, tmp, "bugtool", "--socket", s["svc"],
                              "--out", os.path.join(tmp, "bundle"))
            path = text.strip().replace("<tmp>", tmp)
            with tarfile.open(path) as tar:
                names = sorted(n.split("/", 1)[1] for n in tar.getnames()
                               if "/" in n)
            web = agent.endpoint_add(1, {"app": "service"})
            fe = agent.endpoint_add(2, {"app": "frontend"})
            flows = [http_flow(P, fe.identity, web.identity),
                     http_flow(P, fe.identity, web.identity,
                               path="/nope", method="PUT")]
        cap = _jsonl(P, tmp, "cap.jsonl", flows)
        cnp = write(tmp, "cli-test.yaml", CNP)
        summary = run_json(P, tmp, "replay", cap, "--policy", cnp,
                           "--endpoint", "app=service", "--endpoint",
                           "app=frontend")
        return {"bugtool": (rc, names), "replay": summary}

    got = both(go)
    assert got["bugtool"][0] == 0 and "MANIFEST.json" in got["bugtool"][1]
    assert got["replay"] == (0, {"flows": 2, "verdicts": {
        "REDIRECTED": 1, "DROPPED": 1}})


def test_replay_trace_out_has_a_trace_a_chunk():
    """``replay --trace-out`` writes the run's Chrome trace with one
    trace id a chunk, in both packages (two chunks of
    ``CILIUM_TPU_BATCH_SIZE``). The summary's ``trace_ids`` also counts
    the loader's regeneration traces, and whether the endpoint's own
    regeneration folds into ``regenerate_all``'s is thread timing in
    either package; so each package holds ``trace_ids`` to its tracer's
    traces (a chunk's or a regeneration's, nothing else), and the
    packages compare the chunk traces and the rest of the summary."""

    def go(P, tmp):
        jsonl = _jsonl(P, tmp, "cap.jsonl", _capture_flows(P))
        cnp = write(tmp, "p.yaml", L4_CNP)
        trace = os.path.join(tmp, "trace.json")
        P.tracing.TRACER.clear()
        rc, body = run_json(P, tmp, "replay", jsonl, "--policy", cnp,
                            "--endpoint", "app=svc", "--trace-out", trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        chunks = sorted(e["args"]["chunk"] for e in events
                        if e.get("name") == "replay.chunk")
        names = {}
        for r in P.tracing.TRACER.dump():
            names.setdefault(r["trace_id"], set()).add(r["name"])
        kinds = sorted("chunk" if "replay.chunk" in n else
                       "regenerate" if "loader.regenerate" in n else
                       repr(sorted(n)) for n in names.values())
        assert body["trace_ids"] == len(names) == len(kinds)
        regens = kinds.count("regenerate")
        assert 1 <= regens <= 3, kinds
        body = {k: v for k, v in body.items() if k != "trace_ids"}
        return rc, body, chunks, [k for k in kinds if k != "regenerate"]

    # the gate alike in both packages: the loader's regenerations are
    # traced too, and how many there are follows the gate
    env = {"CILIUM_TPU_BATCH_SIZE": "10", "CILIUM_TPU_ENABLE_OFFLOAD": "1"}
    os.environ.update(env)
    try:
        rc, body, chunks, traced = both(go)
    finally:
        for k in env:
            del os.environ[k]
    assert rc == 0 and body["flows"] == 20 and chunks == [10, 20]
    assert traced == ["chunk", "chunk"]


def _inspect(P, tmp):
    synth = mod(P, "ingest.synth")
    pi, _ = synth.realize_scenario(synth.scenario_by_name("http", 12, 10))
    cfg = P.config.Config()
    where = "engine.verdict" if P.jax else "engine.compiled"
    pol = mod(P, where).CompiledPolicy.build(pi, cfg.engine)
    path = os.path.join(tmp, "policy.pkl")
    import pickle

    with open(path, "wb") as f:
        pickle.dump(pol, f)
    return run_json(P, tmp, "inspect", path)


def test_inspect_equal_reference():
    """``inspect`` of the same compiled policy (the http scenario at 12
    rules, pickled by each package): equal output."""
    rc, info = both(_inspect)
    assert rc == 0 and info["http_rules"] > 0 and info["tensors"]


def test_perf_report_equal_reference(tmp_path):
    """``perf-report`` over the port's ``perf_report.run_cli``: an
    empty root is an error (2), the repo's artifacts report alike."""

    def go(P, tmp):
        rc_empty = run(P, tmp, "perf-report", "--root", tmp)[0]
        rc, body = run_json(P, tmp, "perf-report", "--root", REPO,
                            "--format", "json", "--no-fail")
        return rc_empty, rc, body

    rc_empty, rc, body = both(go)
    assert rc_empty == 2 and rc == 0 and body


def test_lint_names_q12b():
    """``lint`` takes the reference's arguments and answers an unknown
    rule as the reference's ``cli.main`` does: exit 2, nothing on
    standard output, the same unknown-rule error (each package over its
    own tree; the rule filter is checked before ``--changed-only``
    asks git anything)."""
    answers = {}
    with short_dir() as tmp:
        for P, target in ((JAX, "cilium_tpu"), (PORT, "cilium_tpu_torch")):
            answers[target] = run(P, tmp, "lint", target, "--format",
                                  "json", "--rule", "X", "--changed-only")
    assert answers["cilium_tpu_torch"] == answers["cilium_tpu"]
    rc, out, err = answers["cilium_tpu_torch"]
    assert rc == 2 and out == ""
    assert err.strip() == "error: unknown rule(s) ['X'] (--list-rules)"


def test_replay_without_device_raises_without_cuda(monkeypatch):
    """``replay`` defaults to ``cuda``: without it, and without
    ``--device cpu``, it raises; with ``--device cpu`` it runs."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with short_dir() as tmp:
        jsonl = _jsonl(PORT, tmp, "cap.jsonl", _capture_flows(PORT))
        cnp = write(tmp, "p.yaml", L4_CNP)
        argv = ["replay", jsonl, "--policy", cnp, "--endpoint", "app=svc"]
        monkeypatch.setenv("CILIUM_TPU_CACHE_DIR", os.path.join(tmp, "c"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_of(PORT).main(argv)
        rc, body = run_json(PORT, tmp, *argv)
    assert rc == 0 and body["flows"] == 20
