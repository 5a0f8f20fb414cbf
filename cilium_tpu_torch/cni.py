"""CNI plugin: kubelet-facing ADD/DEL/CHECK/VERSION surface.

Reference: ``plugins/cilium-cni`` (SURVEY.md §1/L5 "CNI ADD/DEL",
§2.4) — the container runtime execs the plugin with ``CNI_*``
environment variables and the network configuration JSON on stdin; the
plugin delegates endpoint creation and IPAM to the running agent over
its API socket and prints a CNI result (or a CNI error object with a
spec error code) on stdout.

Ours implements the same protocol surface against
:class:`cilium_tpu_torch.runtime.api.APIClient`. There is no kernel
netns/veth to plumb — the datapath is the verdict engine on the card, flows
enter via Hubble replay/the verdict service — so the returned
``interfaces`` entry records the endpoint rather than a moved veth
(documented deviation; everything kubelet consumes — the IP, the
idempotency, the error codes — is spec-shaped).

Endpoint ids derive deterministically from ``CNI_CONTAINERID`` so DEL
and CHECK (and ADD retries) need no local state file, mirroring how the
reference keys endpoint lookup by container id.

Run as ``python -m cilium_tpu_torch.cni`` with the standard CNI environment.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Dict, Optional, TextIO

#: CNI spec versions this plugin speaks.
CNI_VERSION = "1.0.0"
SUPPORTED_VERSIONS = ("0.3.1", "0.4.0", "1.0.0")

# CNI spec error codes (§ "Error" of the CNI spec)
ERR_INCOMPATIBLE_VERSION = 1
ERR_UNSUPPORTED_FIELD = 2
ERR_UNKNOWN_CONTAINER = 3
ERR_INVALID_ENV = 4
ERR_IO_FAILURE = 5
ERR_FAILED_DECODE = 6
ERR_INVALID_NETCONF = 7
ERR_TRY_AGAIN_LATER = 11


class CNIError(Exception):
    def __init__(self, code: int, msg: str, details: str = ""):
        super().__init__(msg)
        self.code = code
        self.msg = msg
        self.details = details

    def to_json(self, cni_version: str = CNI_VERSION) -> Dict:
        return {"cniVersion": cni_version, "code": self.code,
                "msg": self.msg, "details": self.details}


def endpoint_id_for(container_id: str) -> int:
    """Deterministic container-id → endpoint-id mapping (63-bit, >0).

    Stateless by design: DEL/CHECK recompute it instead of reading a
    state file, so a node reboot loses nothing. 63 bits because two
    live containers colliding would silently share one endpoint
    (identity mixup + cross-deletes); at a realistic node's container
    count the birthday bound at 2^63 is negligible where 2^31 is not.
    """
    h = hashlib.sha256(container_id.encode()).digest()
    return (int.from_bytes(h[:8], "big") & 0x7FFFFFFFFFFFFFFF) or 1


def labels_from_env(env) -> Dict[str, str]:
    """Pod labels from ``CNI_ARGS`` (``K8S_POD_NAMESPACE;K8S_POD_NAME``
    pairs, per the k8s CNI contract). Keys are bare — the agent's label
    layer adds the ``k8s:`` source prefix."""
    labels: Dict[str, str] = {}
    for kv in (env.get("CNI_ARGS") or "").split(";"):
        if "=" not in kv:
            continue
        k, v = kv.split("=", 1)
        if k == "K8S_POD_NAMESPACE":
            labels["io.kubernetes.pod.namespace"] = v
        elif k == "K8S_POD_NAME":
            labels["io.kubernetes.pod.name"] = v
        elif k.startswith("K8S_POD_LABEL_"):
            labels[k[len("K8S_POD_LABEL_"):].lower()] = v
    return labels


def _require(env, key: str) -> str:
    val = env.get(key)
    if not val:
        raise CNIError(ERR_INVALID_ENV, f"required env {key} missing")
    return val


def _client(env):
    from cilium_tpu_torch.runtime.api import APIClient

    path = env.get("CILIUM_TPU_API_SOCKET",
                   "/var/run/cilium_tpu_torch/api.sock")
    if not os.path.exists(path):
        raise CNIError(ERR_TRY_AGAIN_LATER,
                       f"agent API socket {path} not present "
                       "(agent not running yet?)")
    return APIClient(path)


def _parse_netconf(stdin: TextIO) -> Dict:
    raw = stdin.read()
    try:
        conf = json.loads(raw) if raw.strip() else {}
    except json.JSONDecodeError as e:
        raise CNIError(ERR_FAILED_DECODE, "netconf is not valid JSON",
                       str(e))
    if not isinstance(conf, dict):
        raise CNIError(ERR_INVALID_NETCONF, "netconf must be a JSON object")
    return conf


def _check_version(conf: Dict) -> None:
    version = conf.get("cniVersion", CNI_VERSION)
    if version not in SUPPORTED_VERSIONS:
        raise CNIError(ERR_INCOMPATIBLE_VERSION,
                       f"cniVersion {version} unsupported",
                       f"supported: {', '.join(SUPPORTED_VERSIONS)}")


def cmd_add(env, netconf: Dict) -> Dict:
    container_id = _require(env, "CNI_CONTAINERID")
    ifname = env.get("CNI_IFNAME", "eth0")
    ep_id = endpoint_id_for(container_id)
    labels = labels_from_env(env)
    client = _client(env)
    try:
        code, ep = client.endpoint_put(ep_id, labels)
    except OSError as e:
        raise CNIError(ERR_TRY_AGAIN_LATER, "agent unreachable", str(e))
    if code not in (200, 201) or not isinstance(ep, dict):
        raise CNIError(ERR_IO_FAILURE,
                       f"agent refused endpoint (HTTP {code})",
                       json.dumps(ep))
    ip = ep.get("ipv4")
    if not ip:
        raise CNIError(ERR_IO_FAILURE, "agent returned endpoint without IP")
    return {
        "cniVersion": netconf.get("cniVersion", CNI_VERSION),
        "interfaces": [{"name": ifname, "sandbox": env.get("CNI_NETNS", "")}],
        "ips": [{"address": f"{ip}/32", "interface": 0}],
        "dns": {},
    }


def cmd_del(env) -> Dict:
    container_id = _require(env, "CNI_CONTAINERID")
    ep_id = endpoint_id_for(container_id)
    try:
        client = _client(env)
    except CNIError:
        # DEL must be idempotent and succeed even when the agent is
        # gone (the CNI spec requires best-effort cleanup on DEL)
        return {}
    try:
        client.endpoint_delete(ep_id)
    except OSError:
        pass
    return {}


def cmd_check(env, netconf: Dict) -> Dict:
    container_id = _require(env, "CNI_CONTAINERID")
    ep_id = endpoint_id_for(container_id)
    client = _client(env)
    try:
        code, ep = client.request("GET", f"/v1/endpoint/{ep_id}")
    except OSError as e:
        raise CNIError(ERR_TRY_AGAIN_LATER, "agent unreachable", str(e))
    if code == 404:
        raise CNIError(ERR_UNKNOWN_CONTAINER,
                       f"no endpoint for container {container_id}")
    if code != 200:
        # a 500 from the agent is a transient agent fault, not proof
        # the endpoint is gone — reporting unknown-container here would
        # make the runtime tear down a healthy pod instead of retrying
        raise CNIError(ERR_TRY_AGAIN_LATER,
                       f"agent error on endpoint lookup (HTTP {code})")
    return {}


def cmd_version() -> Dict:
    return {"cniVersion": CNI_VERSION,
            "supportedVersions": list(SUPPORTED_VERSIONS)}


def main(env=None, stdin: Optional[TextIO] = None,
         stdout: Optional[TextIO] = None) -> int:
    env = os.environ if env is None else env
    stdin = sys.stdin if stdin is None else stdin
    stdout = sys.stdout if stdout is None else stdout
    version = CNI_VERSION  # error objects must echo the input's version
    try:
        command = _require(env, "CNI_COMMAND")
        if command == "VERSION":
            result = cmd_version()
        elif command == "DEL":
            # best-effort cleanup: a malformed or since-unsupported
            # cached netconf must not leave the pod stuck terminating,
            # so DEL skips netconf validation entirely
            try:
                version = _parse_netconf(stdin).get("cniVersion", version)
            except CNIError:
                pass
            result = cmd_del(env)
        else:
            netconf = _parse_netconf(stdin)
            version = netconf.get("cniVersion", version)
            _check_version(netconf)
            if command == "ADD":
                result = cmd_add(env, netconf)
            elif command == "CHECK":
                result = cmd_check(env, netconf)
            else:
                raise CNIError(ERR_INVALID_ENV,
                               f"unknown CNI_COMMAND {command}")
    except CNIError as e:
        json.dump(e.to_json(version), stdout)
        stdout.write("\n")
        return 1
    except Exception as e:  # the CNI contract: errors are JSON objects
        # on stdout, never tracebacks (e.g. a malformed agent response
        # raising from APIClient)
        err = CNIError(ERR_IO_FAILURE, f"{type(e).__name__}: {e}")
        json.dump(err.to_json(version), stdout)
        stdout.write("\n")
        return 1
    json.dump(result, stdout)
    stdout.write("\n")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
