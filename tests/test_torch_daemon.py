"""The port's daemon (``cilium_tpu_torch/daemon.py``) and
``Config.from_toml`` against the JAX package's, on the CPU, and the
cross-cluster churn leg of ``tools/bench_protocols``.

* ``Config.from_toml`` on a file that sets every section (one or more
  keys of each, lists among them) gives ``dataclasses.asdict`` equal to
  the reference's; a file that does not set ``enable_tpu_offload``
  keeps each package's own default (the reference's False, the port's
  True — the port's deliberate deviation, pinned here);
* ``tests/test_daemon.py``'s three cases: flags over the TOML
  (``config_from_args``), the single-process ``build`` with
  ``--run-operator`` (both packages, the port's agent with ``--device
  cpu``), and the three-process deployment with the port's modules;
* the daemon as a process: its TOML, its sockets, ``endpoint add`` and
  ``policy import`` through the CLI, SIGTERM → drain → rc 0, and a
  restart on the same ``--state-dir`` that restores the endpoints and
  the policy warm (no bank compile submitted);
* without CUDA the daemon raises unless it is given ``--device cpu``;
* the cross-cluster leg at 6 updates in both packages: 0 stale, 0
  ``ERROR``, the same keys on the line; an armed gate needs the churn
  lane's p99, and a miss raises its own ``AssertionError`` subclass.

Tolerance: exact (configurations, exit codes, endpoint and policy
answers). Processes run with ``--device cpu`` under a deadline each;
every process is stopped in a ``finally``.
"""

import dataclasses
import importlib
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from test_torch_agent import JAX, PKGS, PORT, REPO, differing, short_dir
from test_torch_cli import run, run_json

sys.path.insert(0, REPO)
import bench_protocols as ref_bench_protocols  # noqa: E402

from cilium_tpu_torch.runtime.fleet import P99GateError  # noqa: E402
from cilium_tpu_torch.tools import bench_protocols  # noqa: E402


def daemon_of(P):
    return importlib.import_module(f"{P.root}.daemon")


def parse(P, argv):
    return daemon_of(P).build_parser().parse_args(argv)


def _toml_value(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return json.dumps(v)
    return "[" + ", ".join(_toml_value(x) for x in v) + "]"


def _changed(v):
    """A value of the same type as ``v`` that differs from it."""
    if isinstance(v, bool):
        return not v
    if isinstance(v, int):
        return v + 3
    if isinstance(v, float):
        return v * 2 + 0.5
    if isinstance(v, str):
        return v + "-toml"
    if isinstance(v, tuple) and all(isinstance(x, int) and not
                                    isinstance(x, bool) for x in v):
        return [x + 1 for x in v] or [7, 9]
    return None


SECTIONS = ("engine", "loader", "parallel", "breaker", "tracing",
            "admission", "compile", "serve", "slo", "provenance", "dst",
            "fleet", "tenant", "canary")


def full_toml(tmp):
    """A TOML file that sets the root keys and every section's keys of
    a scalar or integer-list type, each to a value off its default (the
    reference's defaults, which the port shares but for the gate and
    the cache directory)."""
    ref = JAX.config.Config()
    lines = ['enable_tpu_offload = false', 'cluster_name = "c-toml"',
             'node_name = "n-toml"', 'ipam_mode = "cluster-pool"',
             'pod_cidr = "10.9.0.0/24"', 'identity_allocation_mode = "kvstore"',
             'log_level = "warning"', 'monitor_aggregation = "none"',
             'kube_apiserver_ips = ["10.96.0.1", "10.96.0.2"]']
    for section in SECTIONS:
        lines.append(f"[{section}]")
        for f in dataclasses.fields(getattr(ref, section)):
            if (section, f.name) == ("loader", "cache_dir"):
                continue
            new = _changed(getattr(getattr(ref, section), f.name))
            if new is not None:
                lines.append(f"{f.name} = {_toml_value(new)}")
        if section == "loader":
            lines.append(f'cache_dir = "{tmp}/cache"')
    path = os.path.join(tmp, "full.toml")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def test_from_toml_every_section_equal_reference():
    """Every section of the reference's reader set in one file: both
    packages read it into equal configurations; lists become tuples."""
    with short_dir() as tmp:
        path = full_toml(tmp)
        ref, port = (P.config.Config.from_toml(path) for P in PKGS)
    a, b = dataclasses.asdict(ref), dataclasses.asdict(port)
    assert not differing(a, b), differing(a, b)[:20]
    assert port.kube_apiserver_ips == ("10.96.0.1", "10.96.0.2")
    assert isinstance(port.engine.http_path_buckets, tuple)
    assert port.enable_tpu_offload is False
    # every section moved off its default
    for section in SECTIONS:
        assert getattr(port, section) != getattr(PORT.config.Config(),
                                                 section), section


def test_from_toml_without_the_gate_keeps_each_packages_default():
    """A file that does not set ``enable_tpu_offload``: the reference
    reads False (its oracle), the port True (its engine on the card);
    the rest is equal but the cache directory, whose default is each
    package's own."""
    with short_dir() as tmp:
        path = os.path.join(tmp, "a.toml")
        with open(path, "w") as f:
            f.write('node_name = "n1"\n[engine]\nbank_size = 128\n'
                    'kernel_impl = "nfa-bitset"\n[loader]\n'
                    'warm_restore = true\n')
        ref, port = (P.config.Config.from_toml(path) for P in PKGS)
    assert ref.enable_tpu_offload is False and port.enable_tpu_offload is True
    a, b = dataclasses.asdict(ref), dataclasses.asdict(port)
    diff = [k for k, _, _ in differing(a, b)]
    assert diff == [".enable_tpu_offload", ".loader.cache_dir"], diff
    assert port.engine.kernel_impl == "nfa-bitset"
    assert port.loader.warm_restore is True and port.node_name == "n1"


@pytest.mark.parametrize("root", ["cilium_tpu", "cilium_tpu_torch"])
def test_flags_override_config(root):
    """``tests/test_daemon.py::test_flags_override_config``."""
    P = JAX if root == "cilium_tpu" else PORT
    with short_dir() as tmp:
        toml = os.path.join(tmp, "agent.toml")
        with open(toml, "w") as f:
            f.write('node_name = "from-toml"\nlog_level = "warning"\n')
        args = parse(P, ["--config", toml, "--node-name", "from-flag",
                         "--enable-tpu-offload", "--k8s-api-socket",
                         "/k8s.sock", "--monitor-aggregation", "none"])
        cfg = daemon_of(P).config_from_args(args)
    assert cfg.node_name == "from-flag"  # flag wins
    assert cfg.log_level == "warning"    # toml survives
    assert cfg.enable_tpu_offload
    assert (cfg.k8s_api_socket, cfg.monitor_aggregation) == ("/k8s.sock",
                                                             "none")


def test_build_single_process_with_operator(monkeypatch):
    """``tests/test_daemon.py::test_build_single_process_with_operator``
    in both packages: the operator embedded, cluster-pool IPAM from its
    pool, healthz over the REST socket."""
    got = []
    for P in PKGS:
        with short_dir() as tmp:
            argv = ["--run-operator", "--ipam-mode", "cluster-pool",
                    "--node-name", "solo", "--operator-pool-cidr",
                    "10.230.0.0/16", "--api-socket",
                    os.path.join(tmp, "api.sock")]
            if not P.jax:
                argv += ["--device", "cpu"]
            args = parse(P, argv)
            monkeypatch.setenv("CILIUM_TPU_CACHE_DIR",
                               os.path.join(tmp, "cache"))
            agent, operator, kv = daemon_of(P).build(args)
            agent.config.configure_logging = False
            assert operator is not None and kv is None
            operator.start()
            agent.start()
            try:
                c = P.api.APIClient(os.path.join(tmp, "api.sock"))
                got.append((str(agent.ipam.cidr), c.healthz()["status"],
                            getattr(agent, "device", None) is None
                            or agent.device.type == "cpu"))
            finally:
                agent.stop()
                operator.stop()
    assert got[0] == got[1]
    assert got[1][0].startswith("10.230.") and got[1][1:] == ("ok", True)


def _wait_for(path, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            return True
        time.sleep(0.05)
    return False


def _env():
    return dict(os.environ, PYTHONPATH=REPO)


def test_three_process_deployment():
    """``tests/test_daemon.py::test_three_process_deployment`` with the
    port's modules: kvstore server, operator and ``python -m
    cilium_tpu_torch.daemon --device cpu`` as OS processes; the podCIDR
    from the operator's pool, endpoint CRUD over the process boundary,
    SIGTERM → every process rc 0."""
    from cilium_tpu_torch.runtime.api import APIClient

    with short_dir() as tmp:
        kv_sock = os.path.join(tmp, "kv.sock")
        api_sock = os.path.join(tmp, "api.sock")
        procs = []
        try:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "cilium_tpu_torch.kvstore_service",
                 kv_sock], cwd=REPO, env=_env()))
            assert _wait_for(kv_sock), "kvstore server never came up"
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "cilium_tpu_torch.operator",
                 "--kvstore", kv_sock, "--pool-cidr", "10.240.0.0/16"],
                cwd=REPO, env=_env()))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "cilium_tpu_torch.daemon",
                 "--kvstore", kv_sock, "--ipam-mode", "cluster-pool",
                 "--node-name", "proc-node", "--api-socket", api_sock,
                 "--device", "cpu"],
                cwd=REPO, env=dict(_env(), CILIUM_TPU_CACHE_DIR=os.path.join(
                    tmp, "cache"))))
            assert _wait_for(api_sock, timeout=60.0), "agent never came up"
            client = APIClient(api_sock)
            deadline = time.monotonic() + 15
            status = None
            while time.monotonic() < deadline:
                try:
                    status = client.request("GET", "/v1/debuginfo")[1]
                    if status["ipam"]["cidr"].startswith("10.240."):
                        break
                except OSError:
                    pass
                time.sleep(0.2)
            assert status is not None
            assert status["ipam"]["mode"] == "cluster-pool"
            assert status["ipam"]["cidr"].startswith("10.240."), status
            code, ep = client.endpoint_put(1, {"app": "proc"})
            assert code in (200, 201) and ep["ipv4"].startswith("10.240.")
            for p in reversed(procs):
                p.send_signal(signal.SIGTERM)
            for p in procs:
                assert p.wait(timeout=20) == 0
            procs = []
        finally:
            for p in procs:
                p.kill()


DAEMON_CNP = """\
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata: {name: daemon-test, namespace: default}
spec:
  endpointSelector: {matchLabels: {app: service}}
  ingress:
    - fromEndpoints: [{matchLabels: {app: frontend}}]
      toPorts:
        - ports: [{port: "80", protocol: TCP}]
          rules:
            http: [{method: GET, path: "/api/.*"}]
"""


def _metric(text, name):
    m = re.search(rf"^{name}(?:{{[^}}]*}})? ([0-9.e+]+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


def test_daemon_process_drains_on_sigterm_and_restores_warm():
    """``python -m cilium_tpu_torch.daemon --config daemon.toml`` (the
    gate on, ``nfa-bitset``, bank size 128, warm restore) with its
    verdict, REST, Hubble and monitor sockets and a state directory:
    endpoints and the policy through the CLI, ``status`` seeing the
    engine's revision move, SIGTERM → drain → rc 0. A second process on
    the same state directory restores the endpoints and the drain's
    snapshot with no compile; the policy re-imported (as its source
    re-delivers it) compiles no bank either; SIGTERM → rc 0."""
    with short_dir() as tmp:
        toml = os.path.join(tmp, "daemon.toml")
        with open(toml, "w") as f:
            f.write('node_name = "daemon-node"\n[engine]\n'
                    'kernel_impl = "nfa-bitset"\nbank_size = 128\n'
                    f'[loader]\nwarm_restore = true\ncache_dir = '
                    f'"{tmp}/cache"\n')
        cnp = os.path.join(tmp, "cnp.yaml")
        with open(cnp, "w") as f:
            f.write(DAEMON_CNP)
        socks = {k: os.path.join(tmp, f"{k}.sock")
                 for k in ("svc", "api", "hub", "mon")}
        argv = [sys.executable, "-m", "cilium_tpu_torch.daemon",
                "--config", toml, "--socket", socks["svc"],
                "--api-socket", socks["api"], "--hubble-socket",
                socks["hub"], "--monitor-socket", socks["mon"],
                "--state-dir", os.path.join(tmp, "state"),
                "--device", "cpu"]
        out = {}
        for life in ("first", "restart"):
            err = open(os.path.join(tmp, f"{life}.err"), "w+")
            proc = subprocess.Popen(argv, cwd=REPO, env=_env(),
                                    stdout=subprocess.DEVNULL, stderr=err)
            try:
                assert _wait_for(socks["api"], timeout=60.0), (
                    err.seek(0), err.read()[-2000:])
                assert _wait_for(socks["svc"], timeout=30.0)
                if life == "restart":
                    # what the restart did before any policy source
                    # re-delivers the rules
                    rc, text, _ = run(PORT, tmp, "metrics", "--socket",
                                      socks["svc"])
                    out["restored"] = {
                        "warm": _metric(
                            text, "cilium_tpu_warm_restores_total"),
                        "submitted": _metric(
                            text,
                            "cilium_tpu_compile_queue_submitted_total")}
                    regens = _metric(
                        text, "cilium_tpu_endpoint_regenerations_total")
                else:
                    for i, app in ((1, "service"), (2, "frontend")):
                        rc, _ = run_json(PORT, tmp, "endpoint", "add",
                                         str(i), "--labels", f"app={app}",
                                         "--api", socks["api"])
                        assert rc == 0
                rc, body = run_json(PORT, tmp, "policy", "import", cnp,
                                    "--api", socks["api"])
                assert rc == 0 and body["revision"] >= 1
                deadline = time.monotonic() + 60
                while True:
                    rc, st = run_json(PORT, tmp, "status", "--socket",
                                      socks["svc"])
                    if st.get("engine_revision", 0) >= 1:
                        break
                    assert time.monotonic() < deadline, st
                    time.sleep(0.05)
                if life == "restart":
                    # the import's regenerations ran and held still
                    last = None
                    while True:
                        n = _metric(run(PORT, tmp, "metrics", "--socket",
                                        socks["svc"])[1],
                                    "cilium_tpu_endpoint_regenerations_total")
                        if n > regens and n == last:
                            break
                        assert time.monotonic() < deadline
                        last = n
                        time.sleep(0.3)
                rc, hz = run_json(PORT, tmp, "healthz", "--api",
                                  socks["api"])
                rc, eps = run_json(PORT, tmp, "endpoint", "list", "--api",
                                   socks["api"])
                rc, text, _ = run(PORT, tmp, "metrics", "--socket",
                                  socks["svc"])
                out[life] = {"status": st, "healthz": hz,
                             "endpoints": sorted((e["id"], e["labels"][0])
                                                 for e in eps),
                             "warm": _metric(
                                 text, "cilium_tpu_warm_restores_total"),
                             "submitted": _metric(
                                 text,
                                 "cilium_tpu_compile_queue_submitted_total")}
                proc.send_signal(signal.SIGTERM)
                out[life]["rc"] = proc.wait(timeout=20)
            finally:
                if proc.poll() is None:
                    proc.kill()
                err.close()
    first, again, restored = out["first"], out["restart"], out["restored"]
    assert first["rc"] == 0 and again["rc"] == 0
    assert first["endpoints"] == again["endpoints"] == [
        (1, "k8s:app=service"), (2, "k8s:app=frontend")]
    assert first["submitted"] > 0
    assert restored == {"warm": 1.0, "submitted": 0.0}, restored
    assert first["status"]["rules"] == again["status"]["rules"] == 1
    assert again["submitted"] == 0 and again["warm"] == 1, again
    assert again["healthz"]["status"] == "ok"


def test_daemon_raises_without_cuda_unless_cpu(monkeypatch):
    """The daemon's device defaults to ``cuda``: without CUDA ``build``
    raises, as a process too (rc 1, the error on standard error), unless
    it is given ``--device cpu``."""
    import torch

    with short_dir() as tmp:
        env = dict(_env(), CUDA_VISIBLE_DEVICES="",
                   CILIUM_TPU_CACHE_DIR=os.path.join(tmp, "cache"))
        r = subprocess.run(
            [sys.executable, "-m", "cilium_tpu_torch.daemon",
             "--api-socket", os.path.join(tmp, "api.sock")],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert r.returncode == 1 and "no CUDA device" in r.stderr
        assert not os.path.exists(os.path.join(tmp, "api.sock"))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setenv("CILIUM_TPU_CACHE_DIR", os.path.join(tmp, "c"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            daemon_of(PORT).build(parse(PORT, []))
        agent, op, kv = daemon_of(PORT).build(parse(PORT, ["--device",
                                                           "cpu"]))
        try:
            assert agent.device.type == "cpu" and op is None and kv is None
        finally:
            agent.stop()


# ============================================================ cross-cluster
def test_crosscluster_leg_equal_reference():
    """``bench_protocols.run_crosscluster`` at 6 updates in both
    packages (the reference's gate off, since its denominator is a
    committed CPU bench file; the port's beta on ``device="cpu"``): 0
    stale, 0 ``ERROR``, the same keys on the line."""
    log = []
    ref = ref_bench_protocols.run_crosscluster(6, log.append, root=REPO,
                                               gate_p99=False)
    port = bench_protocols.run_crosscluster(6, log.append, gate_p99=False,
                                            device="cpu")
    assert sorted(ref) == sorted(port)
    for line in (ref, port):
        assert (line["stale"], line["errors"]) == (0, 0)
        assert line["updates"] == 6 and line["protocol"] == "cassandra"
    assert port["p99_gated"] is False and port["p99_bound_ms"] is None


def test_crosscluster_gate_needs_a_base_and_raises_the_gate_error():
    """An armed gate without the churn lane's p99 is a ``ValueError``
    (before any agent starts); a miss is the storm's ``P99GateError``
    carrying the whole line; ``main`` refuses an armed gate without
    ``--base-p99-ms``."""
    with pytest.raises(ValueError, match="base_p99_ms"):
        bench_protocols.run_crosscluster(3, print)
    with pytest.raises(P99GateError) as e:
        bench_protocols.run_crosscluster(3, print, base_p99_ms=1e-6,
                                         device="cpu")
    line = e.value.result
    assert isinstance(e.value, AssertionError)
    assert line["p99_gated"] is True and line["value"] > line["p99_bound_ms"]
    assert (line["stale"], line["errors"]) == (0, 0)
    with pytest.raises(SystemExit) as e:
        bench_protocols.main(["--skip-throughput"])
    assert e.value.code == 2
