"""Flow model — the engine's unit of work.

Mirrors the Hubble flow proto (reference: ``api/v1/flow/flow.proto``,
``flowpb.Flow`` — SURVEY.md §2.5) restricted to the fields the verdict
engine consumes: identities, L4 5-tuple-ish info, traffic direction, and
the L7 record (HTTP / Kafka / DNS).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Tuple


class Protocol(enum.IntEnum):
    """IP next-header protocol numbers (subset)."""

    ANY = 0
    ICMP = 1
    TCP = 6
    UDP = 17
    ICMPV6 = 58
    SCTP = 132


class TrafficDirection(enum.IntEnum):
    # values mirror the policy-map key encoding: 0=egress, 1=ingress
    EGRESS = 0
    INGRESS = 1


class Verdict(enum.IntEnum):
    """Flow verdicts (flowpb.Verdict subset)."""

    VERDICT_UNKNOWN = 0
    FORWARDED = 1
    DROPPED = 2
    ERROR = 3
    AUDIT = 4
    REDIRECTED = 5


class L7Type(enum.IntEnum):
    NONE = 0
    HTTP = 1
    KAFKA = 2
    DNS = 3
    GENERIC = 4   # proxylib-style l7proto parser records
    # Engine-frontend families (policy/compiler/frontends/): records
    # still ride ``Flow.generic``/the capture GENERIC section with
    # l7 == GENERIC on the wire; the engine featurize paths normalize
    # the l7-type lane to the frontend family so the fused dispatch,
    # verdict-memo row mirror (ep, l7type, dport), and bank-reference
    # delta all resolve per protocol. Capped at 7 by the provenance
    # word's 3-bit family field (engine/attribution.py).
    CASSANDRA = 5
    MEMCACHE = 6
    R2D2 = 7


class PolicyMatchType(enum.IntEnum):
    """flowpb policy_match_type values (SURVEY.md §2.5)."""

    NONE = 0
    L3_L4 = 1
    L3_ONLY = 2
    L4_ONLY = 3
    ALL = 4
    L7 = 5  # engine extension: matched at L7


@dataclasses.dataclass
class HTTPInfo:
    method: str = ""
    path: str = ""
    host: str = ""
    headers: Tuple[Tuple[str, str], ...] = ()
    protocol: str = "HTTP/1.1"
    code: int = 0


@dataclasses.dataclass
class KafkaInfo:
    api_key: int = 0
    api_version: int = 0
    client_id: str = ""
    topic: str = ""
    correlation_id: int = 0


@dataclasses.dataclass
class DNSInfo:
    query: str = ""
    qtypes: Tuple[str, ...] = ("A",)
    rcode: int = 0
    ips: Tuple[str, ...] = ()
    ttl: int = 0


@dataclasses.dataclass
class GenericL7Info:
    """A record emitted by a generic ``l7proto`` parser (r2d2,
    memcached, cassandra, …): a flat field map matched against the
    policy's ``l7`` key/value rules (reference: proxylib parsers +
    ``PortRuleL7``). Field values are matched exactly; an empty rule
    value means "field present"."""

    proto: str = ""
    fields: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Flow:
    """One flow/request tuple to be verdicted."""

    src_identity: int = 0
    dst_identity: int = 0
    dport: int = 0
    protocol: Protocol = Protocol.TCP
    direction: TrafficDirection = TrafficDirection.INGRESS
    l7: L7Type = L7Type.NONE
    http: Optional[HTTPInfo] = None
    kafka: Optional[KafkaInfo] = None
    dns: Optional[DNSInfo] = None
    generic: Optional[GenericL7Info] = None
    src_ip: str = ""
    dst_ip: str = ""
    sport: int = 0
    time: float = 0.0
    # endpoint that the policy applies to (for per-endpoint policy): the
    # local endpoint is dst for ingress, src for egress.
    verdict: Verdict = Verdict.VERDICT_UNKNOWN
    policy_match_type: PolicyMatchType = PolicyMatchType.NONE
    drop_reason: str = ""
    #: emitting node (flowpb.Flow.node_name); stamped by the relay so a
    #: merged cluster-wide stream stays attributable
    node_name: str = ""
    #: flight-recorder trace id (runtime/tracing.py), stamped at
    #: verdict annotation when a trace context is active — flows, JSONL
    #: logs, and /v1/trace spans join on this one id
    trace_id: str = ""
    #: flowpb Endpoint.labels of each side — carried so captures from
    #: ANOTHER cluster (whose numeric identities mean nothing here) can
    #: be re-mapped to local identities by label at replay
    src_labels: Tuple[str, ...] = ()
    dst_labels: Tuple[str, ...] = ()
    #: verdict provenance (engine/attribution.py), stamped at
    #: annotation when the engine outputs carried the attribution
    #: lane: the packed provenance word (0 = no provenance recorded —
    #: old captures and oracle-served flows decode to nothing), the
    #: compact rule label (e.g. ``http:g3/r17``), the content-
    #: addressed bank key the match was read from, the
    #: POLICY_GENERATION the verdict was computed under (-1 =
    #: unknown), and whether it was served from the device memo
    prov_word: int = 0
    prov_rule: str = ""
    prov_bank: str = ""
    prov_generation: int = -1
    prov_memo: bool = False

    def l7_record(self):
        if self.l7 == L7Type.HTTP:
            return self.http
        if self.l7 == L7Type.KAFKA:
            return self.kafka
        if self.l7 == L7Type.DNS:
            return self.dns
        if self.l7 >= L7Type.GENERIC:
            # GENERIC and the frontend families all carry their record
            # in the generic slot
            return self.generic
        return None
