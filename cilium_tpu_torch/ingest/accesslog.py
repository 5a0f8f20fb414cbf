"""Envoy accesslog ingest: reference-shaped L7 capture lines → Flow.

Reference: the cilium-envoy accesslog (``pkg/envoy`` accesslog server,
``proxylib/accesslog`` proto — ``LogEntry`` with ``http``/``kafka``
sub-records and source/destination security identities) feeds
``pkg/hubble/parser/seven``. This module accepts the JSON encoding of
those entries so a capture taken against the reference proxy can
replay through this engine directly.

Accepted line shape (tolerant; unknown fields ignored)::

    {"entry_type": "Request"|"Denied",
     "timestamp": <epoch or RFC3339>,
     "is_ingress": true,
     "source_security_id": 1234, "destination_security_id": 5678,
     "source_address": "10.0.0.1:42342",
     "destination_address": "10.0.0.2:80",
     "http": {"http_protocol": "HTTP/1.1", "host": "svc.local",
              "path": "/api/v1", "method": "GET",
              "headers": [{"key": "X-A", "value": "b"}, ...]},
     "kafka": {"api_key": 0, "api_version": 3, "topic": "t",
               "correlation_id": 7}}

``parse_capture_line`` dispatches between this shape and the flowpb
JSON shape (ingest/hubble.py), so one capture file may mix both.
"""

from __future__ import annotations

from typing import Dict

from cilium_tpu_torch.core.flow import (
    Flow,
    HTTPInfo,
    KafkaInfo,
    L7Type,
    Protocol,
    TrafficDirection,
)
from cilium_tpu_torch.ingest.hubble import _to_time, flow_from_dict


def is_accesslog_entry(d: Dict) -> bool:
    """Accesslog entries carry the proxy-side field names; flowpb
    flows carry ``source``/``destination``/``l4``/``l7`` objects."""
    return ("source" not in d and "flow" not in d) and (
        "entry_type" in d or "is_ingress" in d
        or "source_security_id" in d or "http" in d or "kafka" in d)


def _split_addr(addr: str) -> tuple:
    """``ip:port`` → (ip, port), handling IPv6: bracketed
    ``[2001:db8::1]:80`` and bare v6 literals (no port — a bare
    literal's last hextet must NOT be read as a port)."""
    if not addr:
        return "", 0
    if addr.startswith("["):
        host, _, rest = addr[1:].partition("]")
        if rest.startswith(":"):
            try:
                return host, int(rest[1:])
            except ValueError:
                return host, 0
        return host, 0
    if addr.count(":") == 1:
        host, _, port = addr.partition(":")
        try:
            return host, int(port)
        except ValueError:
            return host, 0
    return addr, 0  # bare IPv6 literal (or plain v4 host)


def accesslog_to_flow(d: Dict) -> Flow:
    from cilium_tpu_torch.core.flow import Verdict

    f = Flow()
    f.time = _to_time(d.get("timestamp"))
    if str(d.get("entry_type", "")).lower() == "denied":
        # a Denied entry IS the proxy's verdict — hubble metrics and
        # GetFlows must see DROPPED, not VERDICT_UNKNOWN
        f.verdict = Verdict.DROPPED
    ingress = bool(d.get("is_ingress", True))
    f.direction = (TrafficDirection.INGRESS if ingress
                   else TrafficDirection.EGRESS)
    f.src_identity = int(d.get("source_security_id", 0) or 0)
    f.dst_identity = int(d.get("destination_security_id", 0) or 0)
    f.src_ip, f.sport = _split_addr(d.get("source_address", "") or "")
    f.dst_ip, f.dport = _split_addr(
        d.get("destination_address", "") or "")
    f.protocol = Protocol.TCP  # the proxy only fronts TCP
    if isinstance(d.get("http"), dict):
        h = d["http"]
        f.l7 = L7Type.HTTP
        f.http = HTTPInfo(
            method=h.get("method", "") or "",
            path=h.get("path", "") or "",
            host=h.get("host", "") or "",
            headers=tuple((x.get("key", ""), x.get("value", ""))
                          for x in (h.get("headers") or ())),
            protocol=h.get("http_protocol", "HTTP/1.1") or "HTTP/1.1",
            code=int(h.get("status", 0) or 0),
        )
    elif isinstance(d.get("kafka"), dict):
        k = d["kafka"]
        f.l7 = L7Type.KAFKA
        f.kafka = KafkaInfo(
            api_key=int(k.get("api_key", 0) or 0),
            api_version=int(k.get("api_version", 0) or 0),
            client_id=k.get("client_id", "") or "",
            topic=k.get("topic", "") or "",
            correlation_id=int(k.get("correlation_id", 0) or 0),
        )
    return f


def parse_capture_line(d: Dict) -> Flow:
    """One capture line (either schema) → Flow."""
    if is_accesslog_entry(d):
        return accesslog_to_flow(d)
    return flow_from_dict(d)


def accesslog_to_columns(d: Dict) -> tuple:
    """One accesslog entry → the flat column tuple of
    ``ingest.columnar`` (COLUMN_FIELDS order) — the Flow-object-free
    half of :func:`accesslog_to_flow`, sharing its normalization
    (header serialization, host lowering, Denied→DROPPED) exactly."""
    from cilium_tpu_torch.core.flow import Verdict
    from cilium_tpu_torch.engine.compiled import serialize_headers

    verdict = (int(Verdict.DROPPED)
               if str(d.get("entry_type", "")).lower() == "denied"
               else int(Verdict.VERDICT_UNKNOWN))
    ingress = bool(d.get("is_ingress", True))
    direction = int(TrafficDirection.INGRESS if ingress
                    else TrafficDirection.EGRESS)
    _, sport = _split_addr(d.get("source_address", "") or "")
    _, dport = _split_addr(d.get("destination_address", "") or "")
    l7t = int(L7Type.NONE)
    path = method = host = headers = b""
    kclient = ktopic = b""
    kapi = kver = 0
    if isinstance(d.get("http"), dict):
        h = d["http"]
        l7t = int(L7Type.HTTP)
        path = (h.get("path", "") or "").encode("utf-8")
        method = (h.get("method", "") or "").encode("utf-8")
        host = (h.get("host", "") or "").lower().encode("utf-8")
        headers = serialize_headers(tuple(
            (x.get("key", ""), x.get("value", ""))
            for x in (h.get("headers") or ())))
    elif isinstance(d.get("kafka"), dict):
        k = d["kafka"]
        l7t = int(L7Type.KAFKA)
        kapi = int(k.get("api_key", 0) or 0)
        kver = int(k.get("api_version", 0) or 0)
        kclient = (k.get("client_id", "") or "").encode("utf-8")
        ktopic = (k.get("topic", "") or "").encode("utf-8")
    return (_to_time(d.get("timestamp")), verdict, direction,
            int(d.get("source_security_id", 0) or 0),
            int(d.get("destination_security_id", 0) or 0),
            sport, dport, int(Protocol.TCP), l7t,
            path, method, host, headers, b"",
            kclient, ktopic, kapi, kver, b"", ())


def capture_line_to_columns(d: Dict) -> tuple:
    """One capture line (either schema) → column tuple (the
    Flow-object-free twin of :func:`parse_capture_line`)."""
    from cilium_tpu_torch.ingest.hubble import flow_dict_to_columns

    if is_accesslog_entry(d):
        return accesslog_to_columns(d)
    return flow_dict_to_columns(d)
