"""Rule, IngressRule, EgressRule, PortRule + sanitization.

Reference: ``pkg/policy/api/rule.go``, ``l4.go``, ``rule_validation.go``
(SURVEY.md §2.1, unverified paths). The shape is::

    Rule{EndpointSelector, Ingress[], Egress[], Labels, Description}
    IngressRule{FromEndpoints[], FromEntities[], FromCIDR[], ToPorts[],
                IngressDeny variant via IngressCommonRule}
    PortRule{Ports []PortProtocol, Rules *L7Rules}

Deny rules (``IngressDeny``/``EgressDeny``) carry no L7 rules — the
reference forbids L7 on deny (rule_validation.go), and so do we.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

from cilium_tpu_torch.core.flow import Protocol
from cilium_tpu_torch.core.labels import LabelSet
from cilium_tpu_torch.policy.api.l7 import (
    L7Rules,
    KAFKA_API_KEYS,
    MISMATCH_ACTIONS,
    SanitizeError,
)
from cilium_tpu_torch.policy.api.selector import EndpointSelector, FQDNSelector


# SanitizeError is defined in l7.py (the bottom of the api import
# chain) and re-exported here as the long-standing public name.


_PROTO_NAMES = {
    "": Protocol.ANY,
    "any": Protocol.ANY,
    "tcp": Protocol.TCP,
    "udp": Protocol.UDP,
    "sctp": Protocol.SCTP,
    "icmp": Protocol.ICMP,
}


#: IANA service-name shape (k8s container port names): 1-15 chars of
#: [a-z0-9-], at least one letter, no leading/trailing/double dash
def _valid_port_name(name: str) -> bool:
    if not (1 <= len(name) <= 15) or name != name.lower():
        return False
    if name.startswith("-") or name.endswith("-") or "--" in name:
        return False
    if not all(c.isalnum() or c == "-" for c in name):
        return False
    return any(c.isalpha() for c in name)


@dataclasses.dataclass(frozen=True)
class PortProtocol:
    port: int = 0            # 0 = all ports
    protocol: Protocol = Protocol.ANY
    end_port: int = 0        # inclusive range end; 0 = single port
    #: NAMED port (reference pkg/policy/api/l4.go: Port may be an IANA
    #: service name): resolved against endpoint named-port tables at
    #: regeneration (pkg/policy/l4.go named-port resolution); when set,
    #: ``port`` is 0 until resolution
    name: str = ""

    @classmethod
    def from_dict(cls, d: Dict) -> "PortProtocol":
        port_s = str(d.get("port", "0") or "0")
        proto = _PROTO_NAMES.get(str(d.get("protocol", "") or "").lower())
        if proto is None:
            raise SanitizeError(f"unknown protocol {d.get('protocol')!r}")
        if not port_s.isdigit():
            if not _valid_port_name(port_s):
                raise SanitizeError(f"bad port name {port_s!r}")
            if d.get("endPort"):
                raise SanitizeError("endPort not allowed with a named port")
            return cls(port=0, protocol=proto, name=port_s)
        return cls(
            port=int(port_s),
            protocol=proto,
            end_port=int(d.get("endPort", 0) or 0),
        )

    def ports(self) -> Iterable[int]:
        if self.end_port and self.end_port > self.port:
            return range(self.port, self.end_port + 1)
        return (self.port,)


@dataclasses.dataclass(frozen=True)
class PortRule:
    ports: Tuple[PortProtocol, ...] = ()
    rules: Optional[L7Rules] = None

    @classmethod
    def from_dict(cls, d: Dict) -> "PortRule":
        return cls(
            ports=tuple(PortProtocol.from_dict(p) for p in (d.get("ports") or ())),
            rules=L7Rules.from_dict(d.get("rules")) if d.get("rules") else None,
        )


# Entities (reference: pkg/policy/api/entity.go) map to TUPLES of
# selectors (an entity may cover several reserved classes).
#: label every workload endpoint identity carries (value = local
#: cluster name) — how the ``cluster`` entity selects in-cluster
#: endpoints WITHOUT matching ``reserved:world`` or CIDR identities
#: (reference: EntitySelectorMapping + InitEntities(clusterName))
from cilium_tpu_torch.core.labels import CLUSTER_LABEL_KEY  # noqa: E402,F401
# (canonical definition lives in core.labels; re-exported here for the
# policy-layer consumers that historically imported it from this module)


def _reserved(name: str) -> EndpointSelector:
    return EndpointSelector(match_labels=((f"reserved:{name}", ""),))


def _cluster_entity(cluster_name: str) -> Tuple[EndpointSelector, ...]:
    # reference entity.go: cluster = host + remote-node + init + health
    # + ingress + unmanaged + every endpoint carrying the local
    # cluster label. Notably NOT world / kube-apiserver: a rule
    # `fromEntities: [cluster]` must not admit world traffic.
    return (
        _reserved("host"), _reserved("remote-node"), _reserved("init"),
        _reserved("health"), _reserved("ingress"), _reserved("unmanaged"),
        EndpointSelector(
            match_labels=((f"k8s:{CLUSTER_LABEL_KEY}", cluster_name),)),
    )


_ENTITY_SELECTORS: Dict[str, Tuple[EndpointSelector, ...]] = {
    "all": (EndpointSelector(),),
    "world": (_reserved("world"),),
    "host": (_reserved("host"),),
    "remote-node": (_reserved("remote-node"),),
    "health": (_reserved("health"),),
    "init": (_reserved("init"),),
    "unmanaged": (_reserved("unmanaged"),),
    "ingress": (_reserved("ingress"),),
    "kube-apiserver": (_reserved("kube-apiserver"),),
}


def entity_selectors(entity: str,
                     cluster_name: str = "default",
                     ) -> Tuple[EndpointSelector, ...]:
    """Selectors for an entity. ``cluster`` binds to the CALLER's
    cluster name (reference api.InitEntities binds it once per agent;
    here it's an argument so two agents with different cluster names
    in one process — clustermesh tests do this — don't fight over a
    process-global)."""
    if entity == "cluster":
        return _cluster_entity(cluster_name)
    sels = _ENTITY_SELECTORS.get(entity)
    if sels is None:
        raise SanitizeError(f"unknown entity {entity!r}")
    return sels


@dataclasses.dataclass(frozen=True)
class GroupsSpec:
    """``toGroups`` member (reference: ``pkg/policy/api/groups.go`` —
    cloud-provider group references, e.g. AWS security groups, that an
    operator resolves to CIDR sets). ``provider`` names a registered
    resolver (agent.register_group_provider); ``fields`` carries the
    provider-specific spec verbatim. Resolution happens at every
    regeneration, so refreshed provider data takes effect without
    policy rewrites (the reference re-derives on a timer)."""

    provider: str
    fields: Tuple[Tuple[str, str], ...] = ()

    @classmethod
    def from_dict(cls, d: Dict) -> "GroupsSpec":
        if not isinstance(d, dict) or len(d) != 1:
            raise SanitizeError(f"bad toGroups member {d!r}")
        provider, spec = next(iter(d.items()))
        if not isinstance(spec, dict) or not spec:
            raise SanitizeError(
                f"toGroups {provider!r} spec must be a non-empty object")
        return cls(provider=str(provider),
                   fields=tuple(sorted((str(k), str(v) if not
                                        isinstance(v, (list, tuple))
                                        else ",".join(map(str, v)))
                                       for k, v in spec.items())))


@dataclasses.dataclass(frozen=True)
class CIDRRule:
    """``fromCIDRSet``/``toCIDRSet`` member (reference:
    ``pkg/policy/api/cidr.go ·CIDRRule``): a prefix with carve-outs.
    Excepted sub-CIDRs are SUBTRACTED from the rule's peer set at
    resolve time — they produce no allow entries, so excepted traffic
    falls through to default-deny (matching the reference, where
    excepts become requirements excluding the sub-CIDR identities).

    ``group_ref`` (reference: ``cidrGroupRef``, v2alpha1
    CiliumCIDRGroup): instead of a literal prefix, name a cluster
    CIDR-group object; the resolver expands it to the group's CIDRs at
    resolve time (each inheriting this rule's excepts), so group edits
    re-target referencing policies on the next regeneration without
    touching the policies themselves."""

    cidr: str = ""
    except_cidrs: Tuple[str, ...] = ()
    group_ref: str = ""


@dataclasses.dataclass(frozen=True)
class ICMPField:
    """One ``icmps.fields`` member (reference: api.ICMPField) — an ICMP
    type for a family. The datapath keys ICMP exactly like L4: the type
    rides the key's port slot with the ICMP(v6) protocol number, so the
    engines need no new machinery; flows carry the type in ``dport``."""

    family: str = "IPv4"  # "IPv4" | "IPv6"
    icmp_type: int = 0

    @property
    def protocol(self) -> Protocol:
        return (Protocol.ICMPV6 if self.family == "IPv6"
                else Protocol.ICMP)


@dataclasses.dataclass(frozen=True)
class IngressRule:
    from_endpoints: Tuple[EndpointSelector, ...] = ()
    from_entities: Tuple[str, ...] = ()
    from_cidrs: Tuple[str, ...] = ()
    from_cidr_set: Tuple[CIDRRule, ...] = ()
    from_requires: Tuple[EndpointSelector, ...] = ()
    to_ports: Tuple[PortRule, ...] = ()
    icmps: Tuple[ICMPField, ...] = ()
    #: api.Rule Authentication.Mode: "" (unset) | "required" |
    #: "disabled"; "required" marks matching entries auth_required —
    #: the datapath lane the mutual-auth subsystem keys on
    auth_mode: str = ""
    deny: bool = False

    def peer_selectors(self, cluster_name: str = "default",
                       ) -> Tuple[EndpointSelector, ...]:
        sels = list(self.from_endpoints)
        for e in self.from_entities:
            sels += entity_selectors(e, cluster_name)
        if not sels and not self.from_cidrs and not self.from_cidr_set:
            # no peer constraint AT ALL → wildcard peer. A CIDR-only
            # rule must NOT wildcard: its peers are exactly the
            # CIDR-derived identities (resolved in PolicyResolver) —
            # wildcarding would silently drop the CIDR constraint.
            sels = [EndpointSelector()]
        return tuple(sels)


@dataclasses.dataclass(frozen=True)
class ServiceSelector:
    """``toServices`` member (reference: api.Service) — pick k8s
    services by name+namespace or by a label selector over service
    labels (full matchLabels + matchExpressions semantics via
    :class:`EndpointSelector`); the rule then allows egress to the
    service's backends."""

    name: str = ""
    namespace: str = "default"
    label_selector: Optional[EndpointSelector] = None
    #: namespace scope for the label-selector form; empty = every
    #: namespace (reference k8sServiceSelector semantics) — a NAMED
    #: namespace must constrain the match, or a label an attacker can
    #: apply in their own namespace would open the allow
    selector_namespace: str = ""

    def matches(self, svc_name: str, svc_namespace: str,
                svc_labels) -> bool:
        if self.name:
            return (svc_name == self.name
                    and svc_namespace == self.namespace)
        if self.label_selector is None:
            return False  # neither form given: selects nothing
        if (self.selector_namespace
                and svc_namespace != self.selector_namespace):
            return False
        return self.label_selector.matches(
            LabelSet.from_dict(dict(svc_labels)))


@dataclasses.dataclass(frozen=True)
class EgressRule:
    to_endpoints: Tuple[EndpointSelector, ...] = ()
    to_entities: Tuple[str, ...] = ()
    to_cidrs: Tuple[str, ...] = ()
    to_cidr_set: Tuple[CIDRRule, ...] = ()
    to_requires: Tuple[EndpointSelector, ...] = ()
    to_fqdns: Tuple[FQDNSelector, ...] = ()
    to_services: Tuple[ServiceSelector, ...] = ()
    to_groups: Tuple[GroupsSpec, ...] = ()
    to_ports: Tuple[PortRule, ...] = ()
    icmps: Tuple[ICMPField, ...] = ()
    auth_mode: str = ""  # see IngressRule.auth_mode
    deny: bool = False

    def peer_selectors(self, cluster_name: str = "default",
                       ) -> Tuple[EndpointSelector, ...]:
        sels = list(self.to_endpoints)
        for e in self.to_entities:
            sels += entity_selectors(e, cluster_name)
        if (not sels and not self.to_fqdns and not self.to_services
                and not self.to_cidrs and not self.to_cidr_set
                and not self.to_groups):  # see IngressRule: CIDR-only
            sels = [EndpointSelector()]  # rules must not wildcard
        return tuple(sels)


@dataclasses.dataclass(frozen=True)
class Rule:
    endpoint_selector: EndpointSelector = EndpointSelector()
    ingress: Tuple[IngressRule, ...] = ()
    egress: Tuple[EgressRule, ...] = ()
    labels: Tuple[str, ...] = ()          # rule provenance labels
    description: str = ""
    #: True when the rule came from a CCNP ``nodeSelector`` spec: the
    #: endpoint_selector then selects NODES (host endpoints carrying
    #: ``reserved:host``/``reserved:remote-node`` + node labels) and
    #: never pods — and pod rules never select host endpoints
    #: (reference: CiliumClusterwideNetworkPolicy.Spec.NodeSelector +
    #: host-firewall enforcement on the host endpoint)
    node_selector: bool = False

    def selects(self, endpoint_labels) -> bool:
        """Subject match with the pod/node scope split applied."""
        from cilium_tpu_torch.core.labels import SOURCE_RESERVED

        is_node = any(
            l.source == SOURCE_RESERVED and l.key in ("host",
                                                      "remote-node")
            for l in endpoint_labels)
        if is_node != self.node_selector:
            return False
        return self.endpoint_selector.matches(endpoint_labels)

    def sanitize(self, max_quantifier: int = 64) -> "Rule":
        """Validate the rule; raises SanitizeError.

        Mirrors the reference's ``Rule.Sanitize`` checks that matter for
        verdict semantics: port range validity, at most one L7 protocol
        family per PortRule, no L7 on deny rules, valid regex / match
        patterns, valid Kafka API keys/roles.
        """
        from cilium_tpu_torch.policy.compiler import matchpattern, regex_parser

        import ipaddress

        for direction, rules in (("ingress", self.ingress),
                                 ("egress", self.egress)):
            for r in rules:
                for ent in (getattr(r, "from_entities", ())
                            or getattr(r, "to_entities", ())):
                    entity_selectors(ent)  # raises on unknown entity
                plain_cidrs = (getattr(r, "from_cidrs", ())
                               or getattr(r, "to_cidrs", ()))
                cidr_set = (getattr(r, "from_cidr_set", ())
                            or getattr(r, "to_cidr_set", ()))
                for c in plain_cidrs:
                    try:
                        ipaddress.ip_network(c, strict=False)
                    except ValueError:
                        raise SanitizeError(f"bad CIDR {c!r}")
                for cr in cidr_set:
                    if cr.group_ref:
                        if cr.cidr:
                            # reference rule_validation: cidrGroupRef
                            # and cidr are mutually exclusive members
                            raise SanitizeError(
                                "cidrGroupRef and cidr are exclusive")
                        for ex in cr.except_cidrs:
                            try:
                                ipaddress.ip_network(ex, strict=False)
                            except ValueError:
                                raise SanitizeError(
                                    f"bad except CIDR {ex!r}")
                        continue
                    try:
                        net = ipaddress.ip_network(cr.cidr, strict=False)
                    except ValueError:
                        raise SanitizeError(f"bad CIDR {cr.cidr!r}")
                    for ex in cr.except_cidrs:
                        try:
                            exn = ipaddress.ip_network(ex, strict=False)
                            contained = exn.subnet_of(net)
                        except (ValueError, TypeError):
                            raise SanitizeError(f"bad except CIDR {ex!r}")
                        if not contained:
                            # reference rule_validation: excepts must be
                            # inside the rule's CIDR
                            raise SanitizeError(
                                f"except {ex} not within {cr.cidr}")
                if r.icmps and r.to_ports:
                    # reference Rule.Sanitize: ICMPs cannot coexist
                    # with ToPorts in the same rule
                    raise SanitizeError(
                        "icmps and toPorts are mutually exclusive")
                if r.auth_mode not in ("", "required", "disabled"):
                    raise SanitizeError(
                        f"bad authentication mode {r.auth_mode!r}")
                if r.auth_mode and r.deny:
                    raise SanitizeError(
                        "authentication not allowed on deny rules")
                for ic in r.icmps:
                    if ic.family not in ("IPv4", "IPv6"):
                        raise SanitizeError(
                            f"bad ICMP family {ic.family!r}")
                    if not (0 <= ic.icmp_type <= 255):
                        raise SanitizeError(
                            f"bad ICMP type {ic.icmp_type}")
                for pr in r.to_ports:
                    for pp in pr.ports:
                        if pp.protocol in (Protocol.ICMP, Protocol.ICMPV6):
                            # upstream rule_validation only allows
                            # TCP/UDP/SCTP/ANY in toPorts; an ICMP
                            # toPorts entry would alias a port to an
                            # ICMP type (use the icmps field instead)
                            raise SanitizeError(
                                "ICMP protocols not allowed in toPorts; "
                                "use the icmps field")
                        if not (0 <= pp.port <= 65535):
                            raise SanitizeError(f"bad port {pp.port}")
                        if pp.end_port and pp.end_port < pp.port:
                            raise SanitizeError(
                                f"endPort {pp.end_port} < port {pp.port}")
                    l7 = pr.rules
                    if l7 is None or l7.is_empty():
                        continue
                    if r.deny:
                        raise SanitizeError("L7 rules not allowed on deny")
                    if l7.n_protocols() > 1:
                        raise SanitizeError(
                            "only one L7 protocol family per PortRule")
                    for h in l7.http:
                        for pat in (h.path, h.method, h.host):
                            if pat:
                                regex_parser.parse(
                                    pat, max_quantifier=max_quantifier)
                        for hdr in h.headers:
                            if not hdr.strip():
                                raise SanitizeError("empty header match")
                        for hm in h.header_matches:
                            if hm.mismatch_action not in MISMATCH_ACTIONS:
                                raise SanitizeError(
                                    f"bad mismatch action "
                                    f"{hm.mismatch_action!r}")
                            if not hm.name.strip():
                                raise SanitizeError(
                                    "headerMatches member missing name")
                            if hm.secret is not None and not hm.secret[1]:
                                raise SanitizeError(
                                    "secret reference missing name")
                    for k in l7.kafka:
                        if k.role and k.role not in ("produce", "consume"):
                            raise SanitizeError(f"bad kafka role {k.role!r}")
                        if k.api_key and k.api_key not in KAFKA_API_KEYS:
                            raise SanitizeError(
                                f"unknown kafka apiKey {k.api_key!r}")
                        if k.api_version:
                            try:
                                int(k.api_version)
                            except ValueError:
                                raise SanitizeError(
                                    f"bad kafka apiVersion {k.api_version!r}")
                    for dr in l7.dns:
                        if dr.match_name:
                            matchpattern.validate_name(dr.match_name)
                        if dr.match_pattern:
                            matchpattern.validate(dr.match_pattern)
                        if not (dr.match_name or dr.match_pattern):
                            raise SanitizeError("empty DNS rule")
        for er in self.egress:
            for f in er.to_fqdns:
                if f.match_name:
                    matchpattern.validate_name(f.match_name)
                if f.match_pattern:
                    matchpattern.validate(f.match_pattern)
        return self

    @property
    def key(self) -> str:
        return "&".join(self.labels) or self.description or str(hash(self))
