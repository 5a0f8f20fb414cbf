"""Agent REST API over a Unix socket + client.

Reference: cilium's go-swagger REST API served on the agent's Unix
socket (``api/v1/openapi.yaml`` → generated server, ``pkg/client``
consumer — SURVEY.md §2.4); ``cilium-dbg`` drives it. We serve plain
HTTP/1.1 + JSON on an ``AF_UNIX`` socket with the same resource
shapes:

  GET    /v1/healthz        agent liveness + subsystem summary
  GET    /v1/config         daemon config (read)
  PATCH  /v1/config         mutate runtime-mutable fields (feature gate)
  GET    /v1/endpoint       list endpoints
  GET    /v1/endpoint/{id}  one endpoint
  PUT    /v1/endpoint/{id}  create/update (CNI ADD analog)
  DELETE /v1/endpoint/{id}  remove (CNI DEL analog)
  GET    /v1/policy         rules + revision
  PUT    /v1/policy         add CNP (YAML text or JSON body)
  DELETE /v1/policy         delete by labels (JSON body: {"labels": [...]})
  GET    /v1/identity       allocated identities
  GET    /v1/ip             ipcache dump
  GET    /v1/fqdn/cache     DNS cache dump
  GET    /v1/service        load-balancer services
  GET    /v1/metrics        Prometheus text exposition
  GET    /v1/explain        verdict provenance for ?trace_id= — the
                            recorded (rule, bank, generation), each
                            re-resolved through the CPU oracle
  GET    /v1/canary         shadow/canary rollout status: the staged
                            generation, the verdict-diff ledger, and
                            the commit/refuse decision surface
  GET    /v1/trace          flight-recorder spans (runtime/tracing.py);
                            ?trace_id= filters, ?limit= bounds,
                            ?format=chrome → Chrome trace-event JSON
  GET    /v1/debuginfo      full status dict

The verdict/proxylib data path stays on the binary verdict-service
socket (runtime/service.py) — control plane and data plane sockets are
separate, as in the reference (REST vs monitor/accesslog sockets).
"""

from __future__ import annotations

import http.client
import http.server
import json
import os
import socket
import socketserver
import threading
import urllib.parse
from typing import Dict, Optional, Tuple

from cilium_tpu_torch.runtime import admission
from cilium_tpu_torch.runtime.metrics import METRICS
from cilium_tpu_torch.runtime.unixsock import unlink_if_stale

#: config fields PATCHable at runtime (the reference's runtime-mutable
#: DaemonConfig subset; everything else requires an agent restart)
_MUTABLE_CONFIG = ("enable_tpu_offload",)

#: control-class resources: the ops an operator needs DURING an
#: overload (health, config, policy mutation, drain, auth, the scrape
#: surface) — admitted with reserved headroom above the data-class
#: in-flight bound, so they never shed behind bulk reads
_CONTROL_PATHS = ("/v1/healthz", "/v1/config", "/v1/policy",
                  "/v1/drain", "/v1/auth", "/v1/metrics")


class _UnixHTTPServer(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True


class _Handler(http.server.BaseHTTPRequestHandler):
    # BaseHTTPRequestHandler expects TCP peers; over AF_UNIX the peer
    # address is a bare string — normalize so logging never crashes
    def address_string(self) -> str:  # noqa: D102
        return "unix"

    def log_message(self, fmt, *args):  # quiet; metrics cover access
        METRICS.inc("cilium_tpu_api_requests_total", 1)

    server_version = "cilium-tpu-api/1.0"
    agent = None  # set by APIServer

    # -- helpers ----------------------------------------------------------
    def _send(self, code: int, body, content_type="application/json"):
        data = (body if isinstance(body, bytes)
                else json.dumps(body, indent=2, default=str).encode())
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length", 0) or 0)
        return self.rfile.read(n) if n else b""

    def _route(self) -> Tuple[str, Dict[str, str]]:
        parsed = urllib.parse.urlparse(self.path)
        query = dict(urllib.parse.parse_qsl(parsed.query))
        return parsed.path.rstrip("/"), query

    def _ep_id(self, path: str) -> Optional[int]:
        try:
            return int(path.rsplit("/", 1)[1])
        except ValueError:
            return None

    # -- admission --------------------------------------------------------
    @staticmethod
    def _klass(path: str) -> str:
        for prefix in _CONTROL_PATHS:
            if path == prefix or path.startswith(prefix + "/"):
                return admission.CLASS_CONTROL
        return admission.CLASS_DATA

    def _admit(self) -> bool:
        """Bounded in-flight admission for REST ops: sheds with an
        explicit 503 (``shed: true``) instead of piling handler
        threads. Control paths get reserved headroom. A client-carried
        ``X-Cilium-Deadline-Ms`` that is already non-positive sheds
        immediately — the caller has given up."""
        slots = getattr(self.server, "slots", None)
        if slots is None:
            self._held_slot = False
            return True
        path, _ = self._route()
        klass = self._klass(path)
        deadline_ms = self.headers.get("X-Cilium-Deadline-Ms")
        if deadline_ms is not None:
            try:
                if float(deadline_ms) <= 0.0:
                    admission.count_shed("api", klass,
                                         admission.SHED_DEADLINE)
                    self._held_slot = False
                    self._send(503, {"error": "shed: deadline",
                                     "shed": True,
                                     "reason": admission.SHED_DEADLINE})
                    return False
            except ValueError:
                pass  # unparsable header: ignore, admit normally
        ok, reason = slots.acquire(klass)
        if not ok:
            self._held_slot = False
            self._send(503, {"error": f"shed: {reason}", "shed": True,
                             "reason": reason})
            return False
        self._held_slot = True
        return True

    def _release(self) -> None:
        if getattr(self, "_held_slot", False):
            self.server.slots.release()
            self._held_slot = False

    # -- methods ----------------------------------------------------------
    def do_GET(self):  # noqa: N802
        if not self._admit():
            return
        try:
            self._do_GET()
        finally:
            self._release()

    def _do_GET(self):
        agent = self.agent
        path, query = self._route()
        try:
            if path == "/v1/healthz":
                return self._send(200, {
                    "status": "ok",
                    "endpoints": len(list(agent.endpoint_manager.endpoints())),
                    "policy_revision": agent.repo.revision,
                    "engine_revision": agent.loader.revision,
                    "nodes": agent.health.summary()
                    if hasattr(agent.health, "summary") else {},
                })
            if path == "/v1/config":
                import dataclasses

                cfg = dataclasses.asdict(agent.config)
                return self._send(200, {"config": cfg,
                                        "mutable": list(_MUTABLE_CONFIG)})
            if path == "/v1/endpoint":
                return self._send(200, [
                    ep.to_json() for ep in agent.endpoint_manager.endpoints()
                ])
            if path.startswith("/v1/endpoint/"):
                ep_id = self._ep_id(path)
                if ep_id is None:
                    return self._send(400, {"error": "endpoint id must be "
                                            "an integer"})
                ep = agent.endpoint_manager.get(ep_id)
                if ep is None:
                    return self._send(404, {"error": "endpoint not found"})
                return self._send(200, ep.to_json())
            if path == "/v1/policy":
                return self._send(200, {
                    "rules": [
                        {"labels": list(r.labels),
                         "description": r.description}
                        for r in agent.repo.rules()
                    ],
                    "revision": agent.repo.revision,
                })
            if path == "/v1/identity":
                out = []
                for nid in agent.allocator.identities():
                    labels = agent.allocator.lookup(nid)
                    out.append({"id": int(nid),
                                "labels": sorted(map(str, labels))
                                if labels else []})
                return self._send(200, out)
            if path == "/v1/auth":
                return self._send(200, [
                    {"src_identity": s, "dst_identity": d,
                     "expires": exp}
                    for (s, d), exp in sorted(agent.auth.pairs().items())
                ])
            if path == "/v1/ip":
                return self._send(200, agent.ipcache.dump())
            if path == "/v1/fqdn/cache":
                return self._send(200, json.loads(agent.dns_cache.to_json()))
            if path == "/v1/service":
                return self._send(200, [
                    {"frontend": s.frontend.name,
                     "type": s.svc_type.name,
                     "backends": [b.name for b in s.backends],
                     "affinity": s.affinity}
                    for s in agent.services.list()
                ])
            if path == "/v1/selectors":
                # `cilium-dbg policy selectors` analog: live selector →
                # identity resolution state
                return self._send(200, agent.selector_cache.dump())
            if path == "/v1/proxy":
                # redirect table (`cilium-dbg status --all-redirects`
                # analog): live (l7proto, direction) → proxy port
                return self._send(200, agent.proxy_manager.dump())
            if path == "/v1/metrics":
                # Config.enable_metrics gates the scrape surface (the
                # reference's --enable-metrics): counters still count
                # internally, the exposition endpoint just declines
                if not getattr(agent.config, "enable_metrics", True):
                    return self._send(
                        404, b'{"error": "metrics disabled"}')
                return self._send(200, METRICS.expose().encode(),
                                  content_type="text/plain; version=0.0.4")
            if path == "/v1/explain":
                # verdict provenance for one trace id, re-resolved
                # through the CPU oracle (runtime/explain.py)
                from cilium_tpu_torch.runtime.explain import resolve_explain

                tid = query.get("trace_id") or ""
                if not tid:
                    return self._send(400, {"error": "explain needs "
                                            "?trace_id="})
                # an agent fronting a serving fleet router-forwards
                # the query to whichever replica recorded the trace
                # (runtime/fleetserve.py — the store travels with the
                # host, so the answer survives handoffs and rejoins)
                fleet = getattr(agent, "fleet", None)
                if fleet is not None:
                    return self._send(200, fleet.explain(tid))
                return self._send(200,
                                  resolve_explain(agent.loader, tid))
            if path == "/v1/canary":
                # shadow/canary rollout status (runtime/canary.py):
                # the verdict-diff ledger for the staged generation.
                # The controller usually rides on the serve loop; an
                # agent without one still reports the loader's staged
                # revision so operators can see a canary is parked.
                ctrl = getattr(agent, "canary", None)
                if ctrl is None:
                    loop = getattr(agent, "serve_loop", None)
                    ctrl = getattr(loop, "canary", None) \
                        if loop is not None else None
                if ctrl is not None:
                    return self._send(200, ctrl.report())
                return self._send(200, {
                    "state": "idle",
                    "staged_revision": agent.loader.canary_revision,
                    "serving_revision": agent.loader.revision,
                })
            if path == "/v1/trace":
                from cilium_tpu_torch.runtime.tracing import TRACER

                tid = query.get("trace_id") or None
                if query.get("format") == "chrome":
                    return self._send(200,
                                      TRACER.chrome_trace(trace_id=tid))
                try:
                    limit = int(query.get("limit", 0)) or None
                except ValueError:
                    return self._send(400, {"error": "limit must be "
                                            "an integer"})
                # a trace-id query against a fleet (or ?stitch=1)
                # returns the STITCHED cross-host timeline — spans
                # merged by id, ordered by (causal epoch, ts), host-
                # attributed (runtime/fleetserve.py handoff stitching)
                fleet = getattr(agent, "fleet", None)
                if tid and (fleet is not None or query.get("stitch")):
                    stitched = (fleet.trace(tid) if fleet is not None
                                else TRACER.stitch(tid))
                    if limit:
                        stitched["records"] = \
                            stitched["records"][:limit]
                    return self._send(200, stitched)
                return self._send(200, {
                    "enabled": TRACER.enabled,
                    "sample_rate": TRACER.sample_rate,
                    "dropped": TRACER.dropped,
                    "trace_ids": TRACER.trace_ids(),
                    "spans": TRACER.dump(trace_id=tid, limit=limit),
                })
            if path == "/v1/flows":
                # continuous Hubble flow export: per-host aggregated
                # (identity, identity, verdict, rule, bank,
                # generation) counts — router-merged with host
                # attribution when fronting a fleet
                try:
                    limit = int(query.get("limit", 0)) or None
                except ValueError:
                    return self._send(400, {"error": "limit must be "
                                            "an integer"})
                fleet = getattr(agent, "fleet", None)
                if fleet is not None:
                    return self._send(200, fleet.flows(limit=limit))
                loop = getattr(agent, "serve_loop", None)
                if loop is not None and \
                        getattr(loop, "flows", None) is not None:
                    return self._send(200,
                                      loop.flows.snapshot(limit=limit))
                from cilium_tpu_torch.hubble.flowagg import merge_snapshots

                return self._send(200, merge_snapshots(()))
            if path == "/v1/debuginfo":
                return self._send(200, agent.status())
            return self._send(404, {"error": f"no such resource {path}"})
        except Exception as e:  # surface, never kill the server thread
            return self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def do_PUT(self):  # noqa: N802
        if not self._admit():
            return
        try:
            self._do_PUT()
        finally:
            self._release()

    def _do_PUT(self):
        agent = self.agent
        path, _ = self._route()
        try:
            if path.startswith("/v1/endpoint/"):
                ep_id = self._ep_id(path)
                if ep_id is None:
                    return self._send(400, {"error": "endpoint id must be "
                                            "an integer"})
                body = json.loads(self._body() or b"{}")
                named_ports = body.get("named_ports")
                with agent.write_lock:
                    ep = agent.endpoint_add(
                        ep_id,
                        dict(body.get("labels", {})),
                        ipv4=body.get("ipv4", ""),
                        # None (field absent) preserves an existing
                        # endpoint's table on re-PUT
                        named_ports=(
                            {str(k): int(v)
                             for k, v in named_ports.items()}
                            if named_ports is not None else None),
                    )
                return self._send(201, ep.to_json())
            if path == "/v1/policy":
                ctype = self.headers.get("Content-Type", "")
                raw = self._body()
                from cilium_tpu_torch.policy.api.cnp import (
                    load_cnp_yaml_text,
                    parse_cnp,
                )

                if "json" in ctype:
                    cnps = [parse_cnp(json.loads(raw))]
                else:
                    cnps = load_cnp_yaml_text(raw.decode())
                rev = 0
                with agent.write_lock:
                    for cnp in cnps:
                        # upsert: a CNP update replaces same-name rules
                        agent.policy_delete(list(cnp.labels), wait=False)
                        rev = agent.policy_add(cnp, wait=False)
                    # ONE regeneration for the whole body, not per CNP
                    agent.endpoint_manager.regenerate_all(wait=True)
                return self._send(200, {"revision": rev,
                                        "count": len(cnps)})
            if path == "/v1/auth":
                # mutual-auth handshake completion (the auth service's
                # upsert into the auth map)
                body = json.loads(self._body() or b"{}")
                agent.auth.authenticate(
                    int(body["src_identity"]), int(body["dst_identity"]),
                    ttl=body.get("ttl"))
                return self._send(201, {"ok": True})
            if path == "/v1/profile":
                # pkg/pprof analog: profile the LIVE agent on demand
                # (SURVEY §5.1); blocks for `seconds`, returns the
                # artifact path
                from cilium_tpu_torch.runtime.profiling import (
                    PROFILER,
                    ProfileBusy,
                    default_profile_dir,
                )

                body = json.loads(self._body() or b"{}")
                try:
                    result = PROFILER.capture(
                        body.get("out") or default_profile_dir(),
                        seconds=float(body.get("seconds", 2.0)),
                        mode=body.get("mode", "host"),
                    )
                except ProfileBusy as e:
                    return self._send(409, {"error": str(e)})
                except ValueError as e:
                    return self._send(400, {"error": str(e)})
                return self._send(200, result)
            if path == "/v1/policy/trace":
                # `cilium policy trace` analog: explain the verdict
                # for HYPOTHETICAL src/dst label sets
                from cilium_tpu_torch.core.labels import LabelSet
                from cilium_tpu_torch.endpoint import with_cluster_label
                from cilium_tpu_torch.policy.trace import trace

                body = json.loads(self._body() or b"{}")
                cluster = agent.config.cluster_name

                def _ls(v):
                    # list form preserves sources ("cidr:10.0.0.0/8",
                    # "reserved:world"); dict form parses each k=v via
                    # the shared label parser so source-prefixed keys
                    # survive too
                    if isinstance(v, dict):
                        items = [f"{k}={val}" if val else str(k)
                                 for k, val in v.items()]
                    else:
                        items = [str(s) for s in (v or ())]
                    return with_cluster_label(LabelSet.parse(items),
                                              cluster)

                result = trace(
                    agent.repo,
                    src_labels=_ls(body.get("src_labels")),
                    dst_labels=_ls(body.get("dst_labels")),
                    dport=int(body.get("dport", 0) or 0),
                    proto=int(body.get("protocol", 6) or 6),
                    ingress=(str(body.get("direction", "ingress"))
                             .lower() != "egress"),
                    cluster_name=cluster,
                    named_ports=body.get("named_ports"),
                )
                return self._send(200, result)
            return self._send(404, {"error": f"no such resource {path}"})
        except Exception as e:
            return self._send(400, {"error": f"{type(e).__name__}: {e}"})

    def do_POST(self):  # noqa: N802
        if not self._admit():
            return
        try:
            self._do_POST()
        finally:
            self._release()

    def _do_POST(self):
        agent = self.agent
        path, _ = self._route()
        try:
            if path == "/v1/drain":
                # graceful drain (SIGTERM's REST face): stop admitting
                # data-path verdicts, flush pending batches through the
                # engine, snapshot warm-restart state. The service
                # keeps answering control ops afterwards; restart +
                # Loader.restore_warm completes the warm cycle.
                return self._send(200, agent.drain())
            return self._send(404, {"error": f"no such resource {path}"})
        except Exception as e:
            return self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def do_PATCH(self):  # noqa: N802
        if not self._admit():
            return
        try:
            self._do_PATCH()
        finally:
            self._release()

    def _do_PATCH(self):
        agent = self.agent
        path, _ = self._route()
        try:
            if path == "/v1/config":
                body = json.loads(self._body() or b"{}")
                # validate ALL keys and value types first: a rejected
                # request must not leave earlier fields mutated, and a
                # JSON string "false" must not truthy-enable a bool gate
                for k, v in body.items():
                    if k not in _MUTABLE_CONFIG:
                        return self._send(
                            400, {"error": f"config field {k!r} is not "
                                  f"runtime-mutable"})
                    want = type(getattr(agent.config, k))
                    if not isinstance(v, want):
                        return self._send(
                            400, {"error": f"config field {k!r} expects "
                                  f"{want.__name__}, got "
                                  f"{type(v).__name__}"})
                with agent.write_lock:
                    for k, v in body.items():
                        setattr(agent.config, k, v)
                    if "enable_tpu_offload" in body:
                        # the gate selects the loader's engine AND the
                        # DNS proxy's matcher — flip both, then restage
                        # (the reference's datapath reload)
                        agent.dns_proxy.use_tpu = bool(
                            body["enable_tpu_offload"])
                        agent.endpoint_manager.regenerate_all(wait=True)
                return self._send(200, {"changed": dict(body)})
            if path.startswith("/v1/endpoint/") \
                    and path.endswith("/config"):
                # per-endpoint options (`cilium-dbg endpoint config`):
                # currently PolicyAuditMode
                try:
                    ep_id = int(path.split("/")[3])
                except (ValueError, IndexError):
                    return self._send(400, {"error": "endpoint id must "
                                            "be an integer"})
                body = json.loads(self._body() or b"{}")
                unknown = set(body) - {"policy_audit_mode"}
                if unknown:
                    return self._send(
                        400, {"error": f"unknown endpoint option(s) "
                              f"{sorted(unknown)}"})
                pam = body.get("policy_audit_mode")
                if pam is not None and not isinstance(pam, bool):
                    return self._send(
                        400, {"error": "policy_audit_mode expects bool"})
                try:
                    ep = agent.endpoint_config(
                        ep_id, policy_audit_mode=pam)
                except KeyError:
                    return self._send(404, {"error": "endpoint not found"})
                return self._send(200, ep.to_json())
            return self._send(404, {"error": f"no such resource {path}"})
        except Exception as e:
            return self._send(400, {"error": f"{type(e).__name__}: {e}"})

    def do_DELETE(self):  # noqa: N802
        if not self._admit():
            return
        try:
            self._do_DELETE()
        finally:
            self._release()

    def _do_DELETE(self):
        agent = self.agent
        path, _ = self._route()
        try:
            if path.startswith("/v1/endpoint/"):
                ep_id = self._ep_id(path)
                if ep_id is None:
                    return self._send(400, {"error": "endpoint id must be "
                                            "an integer"})
                with agent.write_lock:
                    agent.endpoint_remove(ep_id)
                return self._send(200, {"deleted": True})
            if path == "/v1/policy":
                body = json.loads(self._body() or b"{}")
                labels = list(body.get("labels", ()))
                with agent.write_lock:
                    deleted = agent.policy_delete(labels)
                    rev = agent.repo.revision
                return self._send(200, {"deleted": deleted,
                                        "revision": rev})
            if path == "/v1/auth":
                body = json.loads(self._body() or b"{}")
                deleted = agent.auth.revoke(int(body["src_identity"]),
                                            int(body["dst_identity"]))
                return self._send(200, {"deleted": deleted})
            return self._send(404, {"error": f"no such resource {path}"})
        except Exception as e:
            return self._send(400, {"error": f"{type(e).__name__}: {e}"})


class APIServer:
    """Serve the REST API on ``socket_path`` (background thread pool)."""

    def __init__(self, agent, socket_path: str):
        self.socket_path = socket_path
        if os.path.exists(socket_path):
            unlink_if_stale(socket_path)
        handler = type("BoundHandler", (_Handler,), {"agent": agent})
        self._server = _UnixHTTPServer(socket_path, handler)
        # bounded in-flight admission (runtime/admission.py): data-
        # class requests shed at api_max_inflight; control paths get
        # control_reserve headroom
        self._server.slots = admission.RequestSlots.from_config(
            getattr(agent.config, "admission", None))
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "APIServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="api-server",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, socket_path: str, timeout: float = 30.0):
        super().__init__("localhost", timeout=timeout)
        self._socket_path = socket_path

    def connect(self) -> None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self._socket_path)
        self.sock = sock


class APIClient:
    """``pkg/client`` analog: typed access to the agent REST API."""

    def __init__(self, socket_path: str, timeout: float = 30.0):
        self.socket_path = socket_path
        self.timeout = timeout

    def request(self, method: str, path: str, body=None,
                content_type: str = "application/json"):
        conn = _UnixHTTPConnection(self.socket_path, timeout=self.timeout)
        try:
            data = None
            if body is not None:
                data = (body if isinstance(body, (bytes, str))
                        else json.dumps(body))
            conn.request(method, path, body=data,
                         headers={"Content-Type": content_type})
            resp = conn.getresponse()
            raw = resp.read()
            if resp.headers.get_content_type() == "application/json":
                return resp.status, json.loads(raw or b"null")
            return resp.status, raw.decode()
        finally:
            conn.close()

    # typed helpers
    def healthz(self):
        return self.request("GET", "/v1/healthz")[1]

    def config(self):
        return self.request("GET", "/v1/config")[1]

    def patch_config(self, **fields):
        return self.request("PATCH", "/v1/config", body=fields)

    def endpoints(self):
        return self.request("GET", "/v1/endpoint")[1]

    def endpoint_put(self, endpoint_id: int, labels: Dict[str, str],
                     ipv4: str = ""):
        return self.request("PUT", f"/v1/endpoint/{endpoint_id}",
                            body={"labels": labels, "ipv4": ipv4})

    def endpoint_delete(self, endpoint_id: int):
        return self.request("DELETE", f"/v1/endpoint/{endpoint_id}")

    def auth_list(self):
        return self.request("GET", "/v1/auth")[1]

    def auth_put(self, src_identity: int, dst_identity: int, ttl=None):
        body = {"src_identity": src_identity,
                "dst_identity": dst_identity}
        if ttl is not None:
            body["ttl"] = ttl
        return self.request("PUT", "/v1/auth", body=body)

    def auth_delete(self, src_identity: int, dst_identity: int):
        return self.request("DELETE", "/v1/auth",
                            body={"src_identity": src_identity,
                                  "dst_identity": dst_identity})

    def drain(self):
        """Graceful drain: stop admitting, flush, warm-snapshot."""
        return self.request("POST", "/v1/drain")

    def policy_get(self):
        return self.request("GET", "/v1/policy")[1]

    def policy_put_yaml(self, yaml_text: str):
        return self.request("PUT", "/v1/policy", body=yaml_text,
                            content_type="application/yaml")

    def policy_delete(self, labels):
        return self.request("DELETE", "/v1/policy",
                            body={"labels": list(labels)})

    def identities(self):
        return self.request("GET", "/v1/identity")[1]

    def proxy_redirects(self):
        return self.request("GET", "/v1/proxy")[1]

    def selectors(self):
        return self.request("GET", "/v1/selectors")[1]

    def policy_trace(self, src_labels, dst_labels, dport=0,
                     protocol=6, direction="ingress", named_ports=None):
        return self.request("PUT", "/v1/policy/trace", {
            "src_labels": src_labels, "dst_labels": dst_labels,
            "dport": dport, "protocol": protocol,
            "direction": direction, "named_ports": named_ports})[1]

    def ipcache(self):
        return self.request("GET", "/v1/ip")[1]

    def fqdn_cache(self):
        return self.request("GET", "/v1/fqdn/cache")[1]

    def services(self):
        return self.request("GET", "/v1/service")[1]

    def metrics(self) -> str:
        return self.request("GET", "/v1/metrics")[1]

    def traces(self, trace_id: Optional[str] = None,
               limit: Optional[int] = None, chrome: bool = False):
        q = []
        if trace_id:
            q.append(f"trace_id={trace_id}")
        if limit:
            q.append(f"limit={int(limit)}")
        if chrome:
            q.append("format=chrome")
        path = "/v1/trace" + ("?" + "&".join(q) if q else "")
        return self.request("GET", path)[1]

    def canary(self):
        return self.request("GET", "/v1/canary")[1]

    def flows(self, limit: Optional[int] = None):
        q = f"?limit={int(limit)}" if limit else ""
        return self.request("GET", "/v1/flows" + q)[1]

    def debuginfo(self):
        return self.request("GET", "/v1/debuginfo")[1]
