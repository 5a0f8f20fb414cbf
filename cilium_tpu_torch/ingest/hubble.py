"""Hubble flow JSONL reader/writer — the counterpart of the reference's
``ingest/hubble.py``.

Schema mirrors ``flowpb.Flow`` JSON encoding (``api/v1/flow/flow.proto``)
for the fields the engine consumes: ``flow_to_dict`` writes it,
``flow_from_dict`` reads it back into a Flow and
``flow_dict_to_columns`` into the flat column tuple of
``ingest.columnar``; ``_to_time`` reads its time stamps. A "Hubble
capture replay" is a stream of these JSON objects, one per line — the
exporter's on-disk format (``write_jsonl`` / ``read_jsonl``).
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, Iterator, Optional

from cilium_tpu_torch.core.flow import (
    DNSInfo,
    Flow,
    GenericL7Info,
    HTTPInfo,
    KafkaInfo,
    L7Type,
    PolicyMatchType,
    Protocol,
    TrafficDirection,
    Verdict,
)

_VERDICT_NAMES = {v.name: v for v in Verdict}
_DIR_NAMES = {"INGRESS": TrafficDirection.INGRESS,
              "EGRESS": TrafficDirection.EGRESS}


def _to_time(v) -> float:
    """flowpb encodes time as an RFC3339 string; our writer uses epoch
    floats. Accept both. Protobuf Timestamps carry NANOSECOND fractions
    (9 digits) which fromisoformat rejects — truncate to microseconds
    first."""
    if not v:
        return 0.0
    if isinstance(v, (int, float)):
        return float(v)
    import datetime
    import re as _re

    s = str(v).replace("Z", "+00:00")
    s = _re.sub(r"(\.\d{6})\d+", r"\1", s)  # ns → µs precision
    try:
        return datetime.datetime.fromisoformat(s).timestamp()
    except ValueError:
        return 0.0


def flow_to_dict(f: Flow) -> Dict:
    d: Dict = {
        "verdict": Verdict(f.verdict).name,
        "traffic_direction": TrafficDirection(f.direction).name,
        "source": {"identity": f.src_identity,
                   **({"labels": list(f.src_labels)}
                      if f.src_labels else {})},
        "destination": {"identity": f.dst_identity,
                        **({"labels": list(f.dst_labels)}
                           if f.dst_labels else {})},
    }
    if f.time:
        d["time"] = f.time
    if f.node_name:
        d["node_name"] = f.node_name
    if f.trace_id:
        d["trace_id"] = f.trace_id
    if f.policy_match_type != PolicyMatchType.NONE:
        # flowpb policy_match_type, finally filled honestly (the
        # attribution lane); omitted when NONE so old flows and new
        # no-match flows serialize identically
        d["policy_match_type"] = int(f.policy_match_type)
    if f.prov_word:
        # verdict provenance (engine/attribution.py): absent on old
        # writers; old READERS ignore the unknown key
        prov = {"word": int(f.prov_word)}
        if f.prov_rule:
            prov["rule"] = f.prov_rule
        if f.prov_bank:
            prov["bank"] = f.prov_bank
        if f.prov_generation >= 0:
            prov["generation"] = int(f.prov_generation)
        if f.prov_memo:
            prov["memo"] = True
        d["provenance"] = prov
    if f.src_ip or f.dst_ip:
        d["IP"] = {"source": f.src_ip, "destination": f.dst_ip}
    l4_proto = Protocol(f.protocol)
    port_obj = {"destination_port": f.dport}
    if f.sport:
        port_obj["source_port"] = f.sport
    if l4_proto == Protocol.TCP:
        d["l4"] = {"TCP": port_obj}
    elif l4_proto == Protocol.UDP:
        d["l4"] = {"UDP": port_obj}
    elif l4_proto == Protocol.SCTP:
        d["l4"] = {"SCTP": port_obj}
    elif l4_proto == Protocol.ICMP:
        d["l4"] = {"ICMPv4": {"type": f.dport}}
    elif l4_proto == Protocol.ICMPV6:
        d["l4"] = {"ICMPv6": {"type": f.dport}}
    if f.l7 == L7Type.HTTP and f.http:
        d["l7"] = {"type": "REQUEST", "http": {
            "method": f.http.method,
            "url": f.http.path,
            "protocol": f.http.protocol,
            "headers": [{"key": k, "value": v} for k, v in f.http.headers],
            **({"host": f.http.host} if f.http.host else {}),
        }}
    elif f.l7 == L7Type.KAFKA and f.kafka:
        d["l7"] = {"type": "REQUEST", "kafka": {
            "api_key": f.kafka.api_key,
            "api_version": f.kafka.api_version,
            "correlation_id": f.kafka.correlation_id,
            "topic": f.kafka.topic,
            **({"client_id": f.kafka.client_id} if f.kafka.client_id else {}),
        }}
    elif f.l7 == L7Type.DNS and f.dns:
        d["l7"] = {"type": "REQUEST", "dns": {
            "query": f.dns.query,
            "qtypes": list(f.dns.qtypes),
            "ips": list(f.dns.ips),
            "ttl": f.dns.ttl,
        }}
    elif f.l7 >= L7Type.GENERIC and f.generic:
        # flowpb models proxylib records as {proto, fields} key/value
        # pairs (flow.proto L7 "kind: generic")
        d["l7"] = {"type": "REQUEST", "generic": {
            "proto": f.generic.proto,
            "fields": dict(f.generic.fields),
        }}
    return d


def split_http_url(url: str) -> tuple:
    """flowpb's ``http.url`` is ABSOLUTE (pkg/hubble/parser/seven
    builds scheme://host/path); policy regexes match the PATH. Returns
    ``(path_with_query, host)`` — host empty for bare paths. Shared by
    the JSONL and protobuf ingest paths so they can never disagree on
    what a policy regex sees."""
    if "://" not in url:
        return url, ""
    from urllib.parse import urlsplit

    parts = urlsplit(url)
    path = parts.path or "/"
    if parts.query:
        path = f"{path}?{parts.query}"
    return path, parts.hostname or ""


def flow_from_dict(d: Dict) -> Flow:
    if isinstance(d.get("flow"), dict):
        # the reference hubble exporter / `hubble observe -o jsonl`
        # envelope: {"flow": {...}, "node_name": ..., "time": ...}
        inner = dict(d["flow"])
        for k in ("node_name", "time"):
            inner.setdefault(k, d.get(k))
        d = inner
    f = Flow()
    f.time = _to_time(d.get("time"))
    f.verdict = _VERDICT_NAMES.get(d.get("verdict", ""),
                                   Verdict.VERDICT_UNKNOWN)
    f.direction = _DIR_NAMES.get(d.get("traffic_direction", ""),
                                 TrafficDirection.INGRESS)
    src = d.get("source") or {}
    dst = d.get("destination") or {}
    f.src_identity = int(src.get("identity", 0) or 0)
    f.dst_identity = int(dst.get("identity", 0) or 0)
    f.src_labels = tuple(src.get("labels") or ())
    f.dst_labels = tuple(dst.get("labels") or ())
    f.node_name = d.get("node_name", "") or ""
    f.trace_id = d.get("trace_id", "") or ""
    try:
        # absent (old writers) decodes to NONE — the compat contract
        f.policy_match_type = PolicyMatchType(
            int(d.get("policy_match_type", 0) or 0))
    except ValueError:
        f.policy_match_type = PolicyMatchType.NONE
    prov = d.get("provenance") or {}
    if isinstance(prov, dict) and prov:
        f.prov_word = int(prov.get("word", 0) or 0)
        f.prov_rule = str(prov.get("rule", "") or "")
        f.prov_bank = str(prov.get("bank", "") or "")
        f.prov_generation = int(prov.get("generation", -1)
                                if prov.get("generation") is not None
                                else -1)
        f.prov_memo = bool(prov.get("memo", False))
    ip = d.get("IP") or {}
    f.src_ip = ip.get("source", "")
    f.dst_ip = ip.get("destination", "")
    l4 = d.get("l4") or {}
    for proto_name, proto in (("TCP", Protocol.TCP), ("UDP", Protocol.UDP),
                              ("SCTP", Protocol.SCTP)):
        if proto_name in l4:
            f.protocol = proto
            f.dport = int(l4[proto_name].get("destination_port", 0))
            f.sport = int(l4[proto_name].get("source_port", 0))
    for proto_name, proto in (("ICMPv4", Protocol.ICMP),
                              ("ICMPv6", Protocol.ICMPV6)):
        if proto_name in l4:
            # flowpb carries {type, code}; the engine keys ICMP rules
            # by type in the port slot (bpf encodes it the same way)
            f.protocol = proto
            f.dport = int(l4[proto_name].get("type", 0))
    l7 = d.get("l7") or {}
    if "http" in l7:
        h = l7["http"]
        f.l7 = L7Type.HTTP
        url, url_host = split_http_url(h.get("url", ""))
        f.http = HTTPInfo(
            method=h.get("method", ""),
            path=url,
            host=h.get("host", "") or url_host,
            headers=tuple((x.get("key", ""), x.get("value", ""))
                          for x in (h.get("headers") or ())),
            protocol=h.get("protocol", "HTTP/1.1"),
            code=int(h.get("code", 0)),
        )
    elif "kafka" in l7:
        k = l7["kafka"]
        f.l7 = L7Type.KAFKA
        f.kafka = KafkaInfo(
            api_key=int(k.get("api_key", 0)),
            api_version=int(k.get("api_version", 0)),
            client_id=k.get("client_id", ""),
            topic=k.get("topic", ""),
            correlation_id=int(k.get("correlation_id", 0)),
        )
    elif "dns" in l7:
        dd = l7["dns"]
        f.l7 = L7Type.DNS
        f.dns = DNSInfo(
            query=dd.get("query", ""),
            qtypes=tuple(dd.get("qtypes") or ("A",)),
            ips=tuple(dd.get("ips") or ()),
            ttl=int(dd.get("ttl", 0)),
        )
    elif "generic" in l7:
        g = l7["generic"]
        f.l7 = L7Type.GENERIC
        f.generic = GenericL7Info(
            proto=g.get("proto", ""),
            fields={str(k): str(v)
                    for k, v in (g.get("fields") or {}).items()},
        )
    return f


def flow_dict_to_columns(d: Dict) -> tuple:
    """One flowpb JSON object → the flat column tuple of
    ``ingest.columnar`` (COLUMN_FIELDS order) — the Flow-object-free
    half of :func:`flow_from_dict`, sharing its field semantics
    (url split, host lowering, header serialization, qname
    sanitization) so the columnar and object ingest paths can never
    disagree on what a policy regex sees."""
    from cilium_tpu_torch.engine.compiled import serialize_headers
    from cilium_tpu_torch.policy.compiler import matchpattern

    if isinstance(d.get("flow"), dict):
        inner = dict(d["flow"])
        for k in ("node_name", "time"):
            inner.setdefault(k, d.get(k))
        d = inner
    verdict = int(_VERDICT_NAMES.get(d.get("verdict", ""),
                                     Verdict.VERDICT_UNKNOWN))
    direction = int(_DIR_NAMES.get(d.get("traffic_direction", ""),
                                   TrafficDirection.INGRESS))
    src = d.get("source") or {}
    dst = d.get("destination") or {}
    proto, dport, sport = int(Protocol.TCP), 0, 0  # Flow() default
    l4 = d.get("l4") or {}
    for name, p in (("TCP", Protocol.TCP), ("UDP", Protocol.UDP),
                    ("SCTP", Protocol.SCTP)):
        if name in l4:
            proto = int(p)
            dport = int(l4[name].get("destination_port", 0))
            sport = int(l4[name].get("source_port", 0))
    for name, p in (("ICMPv4", Protocol.ICMP),
                    ("ICMPv6", Protocol.ICMPV6)):
        if name in l4:
            proto = int(p)
            dport = int(l4[name].get("type", 0))
    l7t = int(L7Type.NONE)
    path = method = host = headers = qname = kclient = ktopic = b""
    kapi = kver = 0
    gproto = b""
    gpairs: tuple = ()
    l7 = d.get("l7") or {}
    if "http" in l7:
        h = l7["http"]
        l7t = int(L7Type.HTTP)
        url, url_host = split_http_url(h.get("url", ""))
        path = url.encode("utf-8")
        method = (h.get("method", "") or "").encode("utf-8")
        host = ((h.get("host", "") or url_host).lower()
                .encode("utf-8"))
        headers = serialize_headers(tuple(
            (x.get("key", ""), x.get("value", ""))
            for x in (h.get("headers") or ())))
    elif "kafka" in l7:
        k = l7["kafka"]
        l7t = int(L7Type.KAFKA)
        kapi = int(k.get("api_key", 0))
        kver = int(k.get("api_version", 0))
        kclient = (k.get("client_id", "") or "").encode("utf-8")
        ktopic = (k.get("topic", "") or "").encode("utf-8")
    elif "dns" in l7:
        q = l7["dns"].get("query", "")
        l7t = int(L7Type.DNS)
        if q:
            qname = matchpattern.sanitize_name(q).encode("utf-8")
    elif "generic" in l7:
        g = l7["generic"]
        l7t = int(L7Type.GENERIC)
        gproto = (g.get("proto", "") or "").encode("utf-8")
        gpairs = tuple(
            (str(k).encode("utf-8"), str(v).encode("utf-8"))
            for k, v in sorted((g.get("fields") or {}).items())
            if str(k))
    return (_to_time(d.get("time")), verdict, direction,
            int(src.get("identity", 0) or 0),
            int(dst.get("identity", 0) or 0),
            sport, dport, proto, l7t,
            path, method, host, headers, qname,
            kclient, ktopic, kapi, kver, gproto, gpairs)


def write_jsonl(path: str, flows: Iterable[Flow]) -> int:
    n = 0
    with open(path, "w") as fp:
        for f in flows:
            fp.write(json.dumps(flow_to_dict(f)) + "\n")
            n += 1
    return n


def read_jsonl(path: str, start: int = 0,
               limit: Optional[int] = None) -> Iterator[Flow]:
    """Stream flows from a JSONL capture; ``start`` supports replay-
    cursor resume (SURVEY.md §5.4). Lines may be flowpb JSON (bare or
    exporter-enveloped) or Envoy accesslog entries — see
    ingest/accesslog.py."""
    from cilium_tpu_torch.ingest.accesslog import parse_capture_line

    with open(path) as fp:
        for i, line in enumerate(fp):
            if i < start:
                continue
            if limit is not None and i >= start + limit:
                return
            line = line.strip()
            if line:
                yield parse_capture_line(json.loads(line))
