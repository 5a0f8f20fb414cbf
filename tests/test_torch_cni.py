"""The port's CNI plugin against the JAX package's, on the CPU: the
exec contract (``CNI_*`` environment, netconf on standard input, a
result or a spec error object on standard output) against each
package's agent API socket.

Mirrors ``tests/test_cni.py`` case for case, through both packages'
``cni.main`` (results compared field for field), plus the plugin run as
``python -m cilium_tpu_torch.cni`` subprocesses for ADD, CHECK and DEL
against the port's agent, and the endpoint-id hash, which must equal
the reference's.
"""

import io
import json
import os
import subprocess
import sys

from test_torch_agent import (
    JAX,
    PKGS,
    PORT,
    REPO,
    both,
    make_agent,
    short_dir,
)

NETCONF = json.dumps({"cniVersion": "1.0.0", "name": "cilium-tpu",
                      "type": "cilium-tpu-cni"})


def run_cni(P, env, netconf=NETCONF):
    out = io.StringIO()
    rc = P.cni.main(env=env, stdin=io.StringIO(netconf), stdout=out)
    return rc, json.loads(out.getvalue())


def base_env(sock, command, container="cont-abc123"):
    return {
        "CNI_COMMAND": command,
        "CNI_CONTAINERID": container,
        "CNI_IFNAME": "eth0",
        "CNI_NETNS": "/var/run/netns/x",
        "CNI_ARGS": ("K8S_POD_NAMESPACE=default;K8S_POD_NAME=web-0;"
                     "K8S_POD_LABEL_APP=web;junk"),
        "CILIUM_TPU_API_SOCKET": sock,
    }


def with_agent(fn):
    """``fn(P, agent, sock)`` against a running agent of each package;
    the results must be equal."""

    def run(P, tmp):
        sock = os.path.join(tmp, "api.sock")
        agent = make_agent(P, tmp, api_socket_path=sock)
        try:
            return fn(P, agent, sock)
        finally:
            agent.stop()

    return both(run)


def eps_of(agent):
    return sorted((e.endpoint_id, e.ipv4,
                   sorted(str(x) for x in agent.allocator.lookup(
                       e.identity)))
                  for e in agent.endpoint_manager.endpoints())


def test_add_creates_endpoint_with_ip():
    def fn(P, agent, sock):
        rc, result = run_cni(P, base_env(sock, "ADD"))
        return [rc, result, eps_of(agent)]

    rc, result, eps = with_agent(fn)
    assert rc == 0 and result["ips"][0]["address"].endswith("/32")
    assert "k8s:io.kubernetes.pod.namespace=default" in eps[0][2]


def test_add_is_idempotent_same_ip():
    def fn(P, agent, sock):
        _, first = run_cni(P, base_env(sock, "ADD"))
        rc, second = run_cni(P, base_env(sock, "ADD"))
        return [rc, first == second, eps_of(agent)]

    got = with_agent(fn)
    assert got[1] is True and len(got[2]) == 1


def test_del_removes_endpoint_and_is_idempotent():
    def fn(P, agent, sock):
        run_cni(P, base_env(sock, "ADD"))
        out = [run_cni(P, base_env(sock, "DEL")), eps_of(agent),
               run_cni(P, base_env(sock, "DEL"))]
        return out

    got = with_agent(fn)
    assert got[0][0] == 0 and got[1] == [] and got[2][0] == 0


def test_check_reflects_endpoint_lifecycle():
    def fn(P, agent, sock):
        env = base_env(sock, "CHECK")
        out = [run_cni(P, env)]
        run_cni(P, base_env(sock, "ADD"))
        out.append(run_cni(P, env))
        return out

    got = with_agent(fn)
    assert got[0][0] == 1 and got[0][1]["code"] == PORT.cni.ERR_UNKNOWN_CONTAINER
    assert got[1][0] == 0


def test_version_and_spec_error_codes():
    def run(P, tmp):
        out = [run_cni(P, {"CNI_COMMAND": "VERSION"}),
               run_cni(P, {"CNI_COMMAND": "ADD"}),
               run_cni(P, {})]
        missing = os.path.join(tmp, "missing.sock")
        env = base_env(missing, "ADD")
        o = io.StringIO()
        rc = P.cni.main(env=env, stdin=io.StringIO("{nope"), stdout=o)
        out.append([rc, json.loads(o.getvalue())["code"]])
        out.append(run_cni(P, env, netconf="[1, 2]"))
        out.append(run_cni(P, env,
                           netconf=json.dumps({"cniVersion": "9.9.9"})))
        out.append(run_cni(P, env))
        out.append(run_cni(P, base_env(missing, "DEL")))
        out.append(run_cni(P, base_env(missing, "BOGUS")))
        out.append(run_cni(P, base_env(missing, "ADD"), netconf=""))
        # the socket path appears in one message; it differs by package
        return json.loads(json.dumps(out).replace(tmp, "<tmp>"))

    got = both(run)
    assert got[0][0] == 0 and "1.0.0" in got[0][1]["supportedVersions"]
    assert got[1][1]["code"] == PORT.cni.ERR_INVALID_ENV


def test_del_ignores_bad_netconf_and_error_echoes_version():
    def fn(P, agent, sock):
        run_cni(P, base_env(sock, "ADD"))
        o = io.StringIO()
        rc = P.cni.main(env=base_env(sock, "DEL"), stdin=io.StringIO("{nope"),
                        stdout=o)
        out = [rc, eps_of(agent)]
        out.append(run_cni(P, base_env(sock, "DEL"),
                           netconf=json.dumps({"cniVersion": "9.9.9"})))
        out.append(run_cni(P, base_env(sock, "CHECK", container="never"),
                           netconf=json.dumps({"cniVersion": "0.4.0"})))
        return out

    got = with_agent(fn)
    assert got[0] == 0 and got[1] == []
    assert got[3][1]["cniVersion"] == "0.4.0"


def test_unexpected_exception_becomes_cni_error(monkeypatch):
    res = []
    for P in PKGS:
        monkeypatch.setattr(P.cni, "_client", lambda env: (_ for _ in ())
                            .throw(RuntimeError("agent sent garbage")))
        res.append(run_cni(P, base_env("/nonexistent/x.sock", "ADD")))
    assert res[0] == res[1]
    assert res[1][1]["code"] == PORT.cni.ERR_IO_FAILURE


def test_endpoint_id_hash_equals_reference():
    ids = [f"cont-{i:06d}" for i in range(200)] + ["", "x" * 300, "é"]
    assert [PORT.cni.endpoint_id_for(c) for c in ids] == \
        [JAX.cni.endpoint_id_for(c) for c in ids]
    a = PORT.cni.endpoint_id_for("cont-abc123")
    assert a > 0 and a != PORT.cni.endpoint_id_for("cont-abc124")
    env = base_env("s", "ADD")
    assert PORT.cni.labels_from_env(env) == JAX.cni.labels_from_env(env)


def test_cni_as_a_subprocess_against_the_ports_agent():
    """``python -m cilium_tpu_torch.cni``: ADD, CHECK, DEL as the
    container runtime execs it."""

    def run(P, tmp):
        sock = os.path.join(tmp, "api.sock")
        agent = make_agent(P, tmp, api_socket_path=sock)
        try:
            out = []
            for cmd in ("ADD", "CHECK", "DEL", "CHECK"):
                env = dict(base_env(sock, cmd), PATH=os.environ["PATH"],
                           JAX_PLATFORMS="cpu")
                p = subprocess.run(
                    [sys.executable, "-m", f"{P.root}.cni"], input=NETCONF,
                    capture_output=True, text=True, env=env, cwd=REPO,
                    timeout=120)
                out.append([p.returncode, json.loads(p.stdout)])
            return out
        finally:
            agent.stop()

    # the reference's subprocess imports JAX; the port's is held alone
    # here and against the in-process reference below
    with short_dir() as tmp:
        with_port = run(PORT, tmp)
    assert [r[0] for r in with_port] == [0, 0, 0, 1]
    assert with_port[3][1]["code"] == PORT.cni.ERR_UNKNOWN_CONTAINER

    def inproc(P, agent, sock):
        return [run_cni(P, base_env(sock, c))
                for c in ("ADD", "CHECK", "DEL", "CHECK")]

    assert [[rc, r] for rc, r in with_agent(inproc)] == with_port
