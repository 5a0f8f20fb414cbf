"""Policy trace: explain the verdict for a hypothetical flow.

Reference: ``cilium policy trace`` (cilium-dbg) — given SOURCE and
DESTINATION label sets (hypothetical endpoints; they need not exist)
plus L4 context, walk the repository rule-by-rule and report which
rules match, which deny, and the resulting verdict. Rule-level like
the reference (it resolves against rules, not realized maps), so it
answers "WHY would this flow be allowed/denied" with provenance.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from cilium_tpu_torch.core.flow import Protocol
from cilium_tpu_torch.core.labels import LabelSet


def _port_matches(pp, dport: int, proto: int, named_ports) -> Optional[bool]:
    """Does one PortProtocol cover (dport, proto)? None = unresolvable
    named port (no table supplied)."""
    if pp.protocol != Protocol.ANY and int(pp.protocol) != proto:
        return False
    if pp.name:
        if not named_ports:
            return None
        resolved = named_ports.get(pp.name)
        return resolved is not None and int(resolved) == dport
    if pp.end_port and pp.end_port > pp.port:
        return pp.port <= dport <= pp.end_port
    if pp.port == 0:
        return True
    return pp.port == dport


def _ports_match(to_ports, dport: int, proto: int,
                 named_ports) -> (bool, bool, bool):
    """(matches, has_l7, unresolved_named). Every PortRule is
    evaluated — no early return: the unresolved-named-port signal must
    survive even when another PortRule matches (the skipped rule may
    be the one that would really cover the flow), and ``has_l7`` is
    true when ANY covering PortRule carries L7 constraints."""
    if not to_ports:
        return True, False, False
    matches = False
    has_l7 = False
    unresolved = False
    for pr in to_ports:
        l7 = bool(pr.rules and not pr.rules.is_empty())
        covered = not pr.ports
        for pp in pr.ports:
            m = _port_matches(pp, dport, proto, named_ports)
            if m is None:
                unresolved = True
            elif m:
                covered = True
        if covered:
            matches = True
            has_l7 = has_l7 or l7
    return matches, has_l7, unresolved


def _peer_matches(direction_rule, peer_labels: LabelSet,
                  requires: List, cluster_name: str) -> bool:
    for sel in direction_rule.peer_selectors(cluster_name):
        if sel.matches(peer_labels):
            break
    else:
        # CIDR peers: a hypothetical peer carrying cidr: labels can
        # still match fromCIDR/toCIDRSet through its label set
        cidrs = list(getattr(direction_rule, "from_cidrs", ())
                     or getattr(direction_rule, "to_cidrs", ()))
        cidr_set = (getattr(direction_rule, "from_cidr_set", ())
                    or getattr(direction_rule, "to_cidr_set", ()))
        import ipaddress

        from cilium_tpu_torch.core.labels import Label

        def has_cidr(c: str) -> bool:
            try:
                key = str(ipaddress.ip_network(c, strict=False))
            except ValueError:
                return False
            return peer_labels.has(Label(key=key, source="cidr"))

        ok = any(has_cidr(c) for c in cidrs)
        for cr in cidr_set:
            if has_cidr(cr.cidr) and not any(
                    has_cidr(ex) for ex in cr.except_cidrs):
                ok = True
        if not ok:
            return False
    # requirements (fromRequires/toRequires aggregated by the caller)
    return all(sel.matches(peer_labels) for sel in requires)


def trace(repo, src_labels: LabelSet, dst_labels: LabelSet,
          dport: int = 0, proto: int = int(Protocol.TCP),
          ingress: bool = True, cluster_name: str = "default",
          named_ports: Optional[Dict[str, int]] = None) -> Dict:
    """Rule-level verdict explanation. Returns::

        {"verdict": "ALLOWED"|"DENIED",
         "enforced": bool,            # default-deny active?
         "matched_rules": [{"labels": [...], "deny": bool,
                            "l7": bool}],
         "notes": [...]}              # e.g. unresolved named ports
    """
    subject = dst_labels if ingress else src_labels
    peer = src_labels if ingress else dst_labels
    matching = list(repo.matching_rules(subject))

    requires = []
    for rule in matching:
        for dr in (rule.ingress if ingress else rule.egress):
            requires.extend(getattr(dr, "from_requires", ())
                            or getattr(dr, "to_requires", ()))

    enforced = False
    matched: List[Dict] = []
    notes: List[str] = []
    any_allow = False
    any_deny = False
    for rule in matching:
        for dr in (rule.ingress if ingress else rule.egress):
            enforced = True
            if not _peer_matches(dr, peer, requires, cluster_name):
                # FQDN/service/group peers resolve against RUNTIME
                # state (DNS answers, service backends, providers) the
                # rule-level trace doesn't have — say so instead of
                # silently reporting a bare default-deny. Only when
                # the rest of the rule COULD cover this flow: if its
                # ports don't match or requires reject the peer, no
                # runtime resolution could make the rule apply
                runtime_peers = [name for name, field in (
                    ("toFQDNs", "to_fqdns"),
                    ("toServices", "to_services"),
                    ("toGroups", "to_groups"),
                ) if getattr(dr, field, ())]
                if runtime_peers:
                    # the same L4 coverage check the matched path
                    # applies — with an UNRESOLVED named port counting
                    # as could-cover (silently suppressing the note
                    # there would hide both ambiguities at once)
                    if dr.icmps:
                        from cilium_tpu_torch.policy.mapstate import (
                            _ICMP_PROTOS,
                        )

                        could = proto in _ICMP_PROTOS and any(
                            int(ic.protocol) == proto
                            and ic.icmp_type == dport
                            for ic in dr.icmps)
                        unresolved = False
                    else:
                        could, _, unresolved = _ports_match(
                            dr.to_ports, dport, proto, named_ports)
                    reqs_ok = all(sel.matches(peer)
                                  for sel in requires)
                    if (could or unresolved) and reqs_ok:
                        notes.append(
                            f"rule {list(rule.labels)}: "
                            f"{'/'.join(runtime_peers)} peers resolve "
                            "against runtime state (DNS answers, "
                            "service backends, group providers) — not "
                            "evaluated by trace; the datapath may "
                            "allow this flow")
                continue
            if dr.icmps:
                from cilium_tpu_torch.policy.mapstate import _ICMP_PROTOS

                if proto not in _ICMP_PROTOS or not any(
                        int(ic.protocol) == proto
                        and ic.icmp_type == dport for ic in dr.icmps):
                    continue
                ports_ok, has_l7, unresolved = True, False, False
            else:
                ports_ok, has_l7, unresolved = _ports_match(
                    dr.to_ports, dport, proto, named_ports)
            if unresolved:
                notes.append(
                    f"rule {list(rule.labels)}: named port needs an "
                    "endpoint named-port table (pass named_ports)")
            if not ports_ok:
                continue
            matched.append({"labels": list(rule.labels),
                            "deny": dr.deny, "l7": has_l7,
                            "auth": dr.auth_mode or None})
            any_deny = any_deny or dr.deny
            any_allow = any_allow or not dr.deny
    if any_deny:
        verdict = "DENIED"
    elif any_allow:
        verdict = "ALLOWED"
    else:
        verdict = "DENIED" if enforced else "ALLOWED"
        if not enforced:
            notes.append("no rule selects the subject endpoint for "
                         "this direction: default allow")
    return {"verdict": verdict, "enforced": enforced,
            "matched_rules": matched, "notes": notes}
