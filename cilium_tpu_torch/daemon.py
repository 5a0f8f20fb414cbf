"""cilium-agent entry point: assemble and run the daemon (the
reference's ``daemon.py``, on the port's modules).

Reference: ``daemon/cmd/daemon_main.go`` — flags over config, assemble
the hive, run until signalled. Ours: ``python -m
cilium_tpu_torch.daemon`` builds :class:`~cilium_tpu_torch.agent.Agent`
from a TOML config (``Config.from_toml``) plus flag overrides,
optionally connects to a socket-served kvstore (``--kvstore``) or
embeds the cluster operator for single-process deployments
(``--run-operator``), starts every configured server socket, and
blocks until SIGINT/SIGTERM. SIGTERM drains first (``agent.drain()``,
then ``agent.stop()``); SIGINT stops at once.

Where the port differs from the reference: ``--device`` (default
``cuda``) is the agent's device. Without CUDA the daemon raises unless
it is given ``--device cpu`` (the plain versions).

Examples::

  # single process: agent + operator + cluster-pool IPAM, on the card
  python -m cilium_tpu_torch.daemon --run-operator \\
      --ipam-mode cluster-pool \\
      --api-socket /run/ct/api.sock --socket /run/ct/verdict.sock

  # multi-process: kvstore server, operator, agent in separate processes
  python -m cilium_tpu_torch.kvstore_service /run/ct/kv.sock &
  python -m cilium_tpu_torch.operator --kvstore /run/ct/kv.sock &
  python -m cilium_tpu_torch.daemon --kvstore /run/ct/kv.sock \\
      --ipam-mode cluster-pool --node-name node-1
"""

from __future__ import annotations

import argparse
import signal
import threading
from typing import List, Optional

from cilium_tpu_torch.core.config import Config
from cilium_tpu_torch.monitor import AggregationLevel
from cilium_tpu_torch.runtime.logging import get_logger


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="cilium-tpu-agent",
        description="run the cilium-tpu agent (cilium-agent analog)")
    ap.add_argument("--config", help="TOML config file")
    ap.add_argument("--policy-audit-mode", action="store_true",
                    help="evaluate policy but do not enforce it: "
                         "would-be denials forward with verdict AUDIT "
                         "(--policy-audit-mode analog)")
    ap.add_argument("--enable-tpu-offload", action="store_true",
                    help="master feature gate: stage policy on the "
                         "device engine instead of the CPU oracle (the "
                         "port's default is on already)")
    ap.add_argument("--device", default=None,
                    help="torch device of the agent's engine (default "
                         "cuda; cpu runs the plain versions)")
    ap.add_argument("--node-name")
    ap.add_argument("--cluster-name")
    ap.add_argument("--ipam-mode", choices=["static", "cluster-pool"])
    ap.add_argument("--identity-allocation-mode",
                    choices=["local", "kvstore", "crd"],
                    help="kvstore = cluster-wide label→identity "
                         "agreement through the shared store; crd = "
                         "through CiliumIdentity objects on the "
                         "--k8s-api-socket apiserver")
    ap.add_argument("--pod-cidr", help="static-mode podCIDR")
    ap.add_argument("--log-level")
    ap.add_argument("--socket", help="verdict service unix socket")
    ap.add_argument("--api-socket", help="REST API unix socket")
    ap.add_argument("--hubble-socket", help="hubble observer unix socket")
    ap.add_argument("--accesslog-socket",
                    help="proxy accesslog ingest unix socket "
                         "(pkg/envoy accesslog server analog)")
    ap.add_argument("--monitor-socket",
                    help="monitor event stream unix socket "
                         "(`cilium-dbg monitor` analog; per-subscriber "
                         "aggregation levels)")
    ap.add_argument("--monitor-aggregation",
                    choices=[m.name.lower() for m in AggregationLevel],
                    help="default monitor aggregation level "
                         "(reference `--monitor-aggregation`)")
    ap.add_argument("--k8s-api-socket",
                    help="apiserver unix socket: consume CNP/CCNP "
                         "via list+watch informers and publish "
                         "CiliumEndpoint/CiliumNode status "
                         "(pkg/k8s watcher-layer analog)")
    ap.add_argument("--policy-dir",
                    help="directory of CNP YAML to watch (k8s-watcher "
                         "analog)")
    ap.add_argument("--state-dir",
                    help="checkpoint/restore directory")
    ap.add_argument("--dns-proxy", metavar="HOST:PORT",
                    help="bind the transparent DNS proxy")
    ap.add_argument("--dns-upstream", metavar="HOST:PORT",
                    default="127.0.0.53:53")
    ap.add_argument("--kvstore", metavar="SOCKET",
                    help="connect to a socket-served kvstore "
                         "(python -m cilium_tpu_torch.kvstore_service)")
    ap.add_argument("--run-operator", action="store_true",
                    help="embed the cluster operator (single-process "
                         "deployments)")
    ap.add_argument("--operator-pool-cidr", default="10.0.0.0/8")
    ap.add_argument("--operator-node-mask", type=int, default=24)
    return ap


def config_from_args(args) -> Config:
    cfg = (Config.from_toml(args.config) if args.config
           else Config.from_env())
    if args.enable_tpu_offload:
        cfg.enable_tpu_offload = True
    if args.policy_audit_mode:
        cfg.policy_audit_mode = True
    for flag in ("node_name", "cluster_name", "ipam_mode", "pod_cidr",
                 "identity_allocation_mode", "log_level",
                 "monitor_aggregation", "k8s_api_socket"):
        val = getattr(args, flag)
        if val is not None:
            setattr(cfg, flag, val)
    return cfg


def _hostport(spec: str) -> tuple:
    host, _, port = spec.rpartition(":")
    return (host, int(port))


def build(args):
    """Assemble (agent, operator, kvstore_client) from parsed flags —
    apart from :func:`main` so tests drive the daemon's wiring without
    processes or signals."""
    from cilium_tpu_torch.agent import Agent

    cfg = config_from_args(args)
    kv = None
    if args.kvstore:
        from cilium_tpu_torch.kvstore_service import RemoteKVStore

        kv = RemoteKVStore(args.kvstore)
    operator = None
    agent = Agent(
        config=cfg,
        state_dir=args.state_dir,
        socket_path=args.socket,
        api_socket_path=args.api_socket,
        hubble_socket_path=args.hubble_socket,
        accesslog_socket_path=args.accesslog_socket,
        monitor_socket_path=args.monitor_socket,
        policy_dir=args.policy_dir,
        dns_proxy_bind=_hostport(args.dns_proxy) if args.dns_proxy
        else None,
        dns_upstream=_hostport(args.dns_upstream),
        kvstore=kv,
        device=args.device,
    )
    if args.run_operator:
        from cilium_tpu_torch.operator import Operator

        # the operator must be live before Agent.start() blocks on its
        # podCIDR assignment (cluster-pool mode)
        operator = Operator(agent.kvstore,
                            pool_cidr=args.operator_pool_cidr,
                            node_mask_size=args.operator_node_mask)
    return agent, operator, kv


def main(argv: Optional[List[str]] = None,
         ready: Optional[threading.Event] = None) -> int:
    args = build_parser().parse_args(argv)
    agent, operator, kv = build(args)
    stop = threading.Event()
    # SIGTERM is the orchestrated shutdown (kubelet's grace period):
    # drain first — stop admitting, flush pending verdicts, snapshot
    # warm-restart state — so in-flight requests finish with real
    # verdicts and the next process restores without recompiling.
    # SIGINT (^C) stays the fast path: stop without the drain flush.
    drain_first = threading.Event()

    def _sigterm(*_):
        drain_first.set()
        stop.set()

    signal.signal(signal.SIGTERM, _sigterm)
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    if operator is not None:
        operator.start()
    agent.start()
    if ready is not None:
        ready.set()
    try:
        stop.wait()
    finally:
        if drain_first.is_set():
            try:
                agent.drain()
            except Exception as e:  # noqa: BLE001 — still stop cleanly
                # a failed drain (an injected service.drain fault) must
                # not block shutdown; pending entries resolve through
                # the stop path instead
                get_logger("daemon").warning(
                    "drain before stop failed: %s", e)
        agent.stop()
        if operator is not None:
            operator.stop()
        if kv is not None:
            kv.close()
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
