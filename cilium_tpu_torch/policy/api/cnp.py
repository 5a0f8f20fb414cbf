"""CiliumNetworkPolicy YAML ingest (counterpart of the reference's
``policy/api/cnp.py``, copied).

Supports the spec shape used by the ``examples/policies/`` corpus:
``spec`` or ``specs`` with ``endpointSelector``, ``ingress[]``,
``egress[]``, ``ingressDeny[]``, ``egressDeny[]``. Where the reference
calls ``yaml.safe_load_all``, the port reads the text with its own
reader of the subset CNP files use (``policy/api/_yaml.py``): the
machine with the card has no ``pyyaml``.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import os
from typing import Dict, List, Tuple

from cilium_tpu_torch.policy.api._yaml import safe_load_all
from cilium_tpu_torch.policy.api.rule import (
    CIDRRule,
    EgressRule,
    GroupsSpec,
    ICMPField,
    IngressRule,
    PortRule,
    Rule,
    SanitizeError,
)
from cilium_tpu_torch.policy.api.selector import EndpointSelector, FQDNSelector


@dataclasses.dataclass
class CiliumNetworkPolicy:
    name: str
    namespace: str
    rules: Tuple[Rule, ...]
    #: source CRD kind — CNP vs CCNP must not share provenance labels,
    #: or an upsert of ``default/X`` (CNP) silently deletes clusterwide
    #: policy ``X`` (reference disambiguates with
    #: ``io.cilium.k8s.policy.derived-from``)
    kind: str = "CiliumNetworkPolicy"

    @property
    def labels(self) -> Tuple[str, ...]:
        return (f"k8s:io.cilium.k8s.policy.derived-from={self.kind}",
                f"k8s:io.cilium.k8s.policy.name={self.name}",
                f"k8s:io.cilium.k8s.policy.namespace={self.namespace}")


#: named ICMP types (upstream api.ICMPField.Type is an int-or-string),
#: per family — the common probe/diagnostic set
_ICMP_TYPE_NAMES = {
    "IPv4": {"EchoReply": 0, "DestinationUnreachable": 3, "Redirect": 5,
             "EchoRequest": 8, "TimeExceeded": 11, "ParameterProblem": 12,
             "Timestamp": 13, "TimestampReply": 14},
    "IPv6": {"DestinationUnreachable": 1, "PacketTooBig": 2,
             "TimeExceeded": 3, "ParameterProblem": 4,
             "EchoRequest": 128, "EchoReply": 129},
}


def _parse_icmp_type(family: str, raw) -> int:
    if raw is None:
        # upstream api.ICMPField requires Type; silently defaulting to
        # 0 would turn the entry into an EchoReply-only rule
        raise SanitizeError("icmps fields member missing 'type'")
    if isinstance(raw, str) and not raw.lstrip("-").isdigit():
        named = _ICMP_TYPE_NAMES.get(family, {}).get(raw)
        if named is None:
            raise SanitizeError(f"unknown ICMP type name {raw!r}")
        return named
    try:
        return int(raw)
    except (ValueError, TypeError):
        raise SanitizeError(f"bad ICMP type {raw!r}")


def _parse_icmps(d: Dict):
    return tuple(
        ICMPField(family=f.get("family", "IPv4") or "IPv4",
                  icmp_type=_parse_icmp_type(
                      f.get("family", "IPv4") or "IPv4", f.get("type")))
        for ic in (d.get("icmps") or ())
        for f in (ic.get("fields") or ())
    )


def _parse_cidr_set(raw) -> Tuple[CIDRRule, ...]:
    """``fromCIDRSet``/``toCIDRSet`` members. A plain string member is
    the degenerate no-except form; ``except`` clauses are CARRIED (they
    subtract from the peer set at resolve time — dropping them would
    silently allow the carved-out sub-CIDRs)."""
    out = []
    for c in (raw or ()):
        if isinstance(c, str):
            out.append(CIDRRule(cidr=c))
        elif isinstance(c, dict) and c.get("cidrGroupRef"):
            # v2alpha1 CiliumCIDRGroup reference: expanded to the
            # group's CIDRs at resolve time (group edits re-target the
            # policy on the next regeneration)
            if c.get("cidr"):
                # reference rule_validation: the members are mutually
                # exclusive — dropping one silently would leave a rule
                # meaning something its manifest doesn't say
                raise SanitizeError(
                    "cidrGroupRef and cidr are mutually exclusive")
            out.append(CIDRRule(
                group_ref=str(c["cidrGroupRef"]),
                except_cidrs=tuple(c.get("except") or ()),
            ))
        elif isinstance(c, dict) and c.get("cidr"):
            out.append(CIDRRule(
                cidr=c["cidr"],
                except_cidrs=tuple(c.get("except") or ()),
            ))
        else:
            raise SanitizeError(f"bad CIDRSet member {c!r}")
    return tuple(out)


def _parse_ingress(d: Dict, deny: bool) -> IngressRule:
    return IngressRule(
        from_endpoints=tuple(
            EndpointSelector.from_dict(s) for s in (d.get("fromEndpoints") or ())
        ),
        from_entities=tuple(d.get("fromEntities") or ()),
        from_cidrs=tuple(d.get("fromCIDR") or ()),
        from_cidr_set=_parse_cidr_set(d.get("fromCIDRSet")),
        from_requires=tuple(
            EndpointSelector.from_dict(s)
            for s in (d.get("fromRequires") or ())
        ),
        icmps=_parse_icmps(d),
        auth_mode=(d.get("authentication") or {}).get("mode", "") or "",
        to_ports=tuple(PortRule.from_dict(p) for p in (d.get("toPorts") or ())),
        deny=deny,
    )


def _parse_egress(d: Dict, deny: bool) -> EgressRule:
    return EgressRule(
        to_endpoints=tuple(
            EndpointSelector.from_dict(s) for s in (d.get("toEndpoints") or ())
        ),
        to_entities=tuple(d.get("toEntities") or ()),
        to_cidrs=tuple(d.get("toCIDR") or ()),
        to_cidr_set=_parse_cidr_set(d.get("toCIDRSet")),
        to_requires=tuple(
            EndpointSelector.from_dict(s)
            for s in (d.get("toRequires") or ())
        ),
        to_fqdns=tuple(
            FQDNSelector(
                match_name=f.get("matchName", "") or "",
                match_pattern=f.get("matchPattern", "") or "",
            )
            for f in (d.get("toFQDNs") or ())
        ),
        to_services=tuple(_parse_service_selector(s)
                          for s in (d.get("toServices") or ())),
        to_groups=tuple(GroupsSpec.from_dict(g)
                        for g in (d.get("toGroups") or ())),
        icmps=_parse_icmps(d),
        auth_mode=(d.get("authentication") or {}).get("mode", "") or "",
        to_ports=tuple(PortRule.from_dict(p) for p in (d.get("toPorts") or ())),
        deny=deny,
    )


def _parse_service_selector(d: Dict):
    from cilium_tpu_torch.policy.api.rule import EndpointSelector, ServiceSelector

    ks = d.get("k8sService") or {}
    kss = d.get("k8sServiceSelector") or {}
    sel = kss.get("selector")
    return ServiceSelector(
        name=ks.get("serviceName", "") or "",
        namespace=ks.get("namespace", "default") or "default",
        # full matchLabels + matchExpressions via the shared selector
        # machinery; None when the label form isn't used
        label_selector=(EndpointSelector.from_dict(sel)
                        if sel is not None else None),
        selector_namespace=kss.get("namespace", "") or "",
    )


def _spec_to_rule(spec: Dict, labels: Tuple[str, ...],
                  clusterwide: bool = False) -> Rule:
    node_sel = spec.get("nodeSelector")
    if node_sel is not None:
        # host policy (reference: CCNP.Spec.NodeSelector → host
        # firewall): nodes only, CCNP only, and never both selectors
        if not clusterwide:
            raise SanitizeError(
                "nodeSelector requires CiliumClusterwideNetworkPolicy")
        if spec.get("endpointSelector") is not None:
            raise SanitizeError(
                "spec cannot have both endpointSelector and nodeSelector")
        subject = EndpointSelector.from_dict(node_sel)
    else:
        subject = EndpointSelector.from_dict(spec.get("endpointSelector"))
    return Rule(
        endpoint_selector=subject,
        ingress=tuple(_parse_ingress(i, False)
                      for i in (spec.get("ingress") or ())) +
        tuple(_parse_ingress(i, True)
              for i in (spec.get("ingressDeny") or ())),
        egress=tuple(_parse_egress(e, False)
                     for e in (spec.get("egress") or ())) +
        tuple(_parse_egress(e, True)
              for e in (spec.get("egressDeny") or ())),
        labels=labels,
        description=spec.get("description", "") or "",
        node_selector=node_sel is not None,
    )


def parse_cnp(doc: Dict) -> CiliumNetworkPolicy:
    kind = doc.get("kind", "")
    if kind not in ("CiliumNetworkPolicy", "CiliumClusterwideNetworkPolicy"):
        raise ValueError(f"not a CNP: kind={kind!r}")
    meta = doc.get("metadata") or {}
    name = meta.get("name", "unnamed")
    namespace = meta.get("namespace", "default")
    labels = (f"k8s:io.cilium.k8s.policy.derived-from={kind}",
              f"k8s:io.cilium.k8s.policy.name={name}",
              f"k8s:io.cilium.k8s.policy.namespace={namespace}")
    specs: List[Dict] = []
    if doc.get("spec"):
        specs.append(doc["spec"])
    specs.extend(doc.get("specs") or ())
    clusterwide = kind == "CiliumClusterwideNetworkPolicy"
    rules = tuple(_spec_to_rule(s, labels, clusterwide=clusterwide)
                  for s in specs)
    return CiliumNetworkPolicy(name=name, namespace=namespace, rules=rules,
                               kind=kind)


def load_cnp_yaml(path: str) -> List[CiliumNetworkPolicy]:
    """Load one YAML file (possibly multi-document) of CNPs."""
    with open(path) as f:
        return load_cnp_yaml_text(f.read())


def load_cnp_yaml_text(text: str) -> List[CiliumNetworkPolicy]:
    """Parse YAML text (possibly multi-document) of CNPs — the REST
    API's ``PUT /v1/policy`` body format."""
    out: List[CiliumNetworkPolicy] = []
    for doc in safe_load_all(text):
        if not doc:
            continue
        out.append(parse_cnp(doc))
    return out


def load_cnp_dir(path: str) -> List[CiliumNetworkPolicy]:
    """Load every ``*.yaml`` under ``path`` recursively (the
    ``examples/policies/`` corpus loader; BASELINE configs[3])."""
    out: List[CiliumNetworkPolicy] = []
    for p in sorted(_glob.glob(os.path.join(path, "**", "*.yaml"),
                               recursive=True)):
        out.extend(load_cnp_yaml(p))
    return out
