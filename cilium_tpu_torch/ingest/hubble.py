"""Hubble flow serde (the part of the reference's ``ingest/hubble.py``
the explain plane needs): ``flow_to_dict`` writes the ``flowpb.Flow``
JSON shape (``api/v1/flow/flow.proto``) for the fields the engine
consumes, and ``_to_time`` reads its time stamps.
"""

from __future__ import annotations

from typing import Dict

from cilium_tpu_torch.core.flow import (
    Flow,
    L7Type,
    PolicyMatchType,
    Protocol,
    TrafficDirection,
    Verdict,
)


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
