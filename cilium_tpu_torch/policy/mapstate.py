"""MapState: the realized per-endpoint verdict table.

Reference: ``pkg/policy/mapstate.go`` / ``resolve.go`` (SURVEY.md §2.1) —
``EndpointPolicy.MapState: Key{Identity, DestPort, Nexthdr,
TrafficDirection} → Entry{ProxyPort, IsDeny, DerivedFromRules}``.

Precedence semantics reproduced (SURVEY.md §2.1 calls these out as
"reproduce exactly"; cilium's documented model):

* **deny > allow, at any breadth**: if any entry whose key *covers* the
  flow (identity/port/proto each equal or wildcard-0) is a deny, the flow
  is denied — a broad deny beats a narrow allow.
* among covering allows, the **most specific** wins (this picks the
  proxy-redirect/L7 behavior), specificity ordered identity > port >
  proto (matching the datapath's probe order in ``bpf/lib/policy.h``:
  exact → L4-only → L3-only → all-wildcard).
* **L7 wildcard-wins**: if any covering allow at the winning (id,port)
  carries no L7 rules, L7 filtering is bypassed for that flow; otherwise
  the union of contributed L7 rule sets applies (allow-list: request
  must match ≥1 rule).
* **default deny per direction**: enforcement is on for a direction iff
  ≥1 rule selecting the endpoint has a section for that direction; with
  enforcement off, no-match ⇒ allow.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from cilium_tpu_torch.core.flow import Protocol, TrafficDirection
from cilium_tpu_torch.core.identity import IDENTITY_WILDCARD
from cilium_tpu_torch.core.labels import LabelSet
from cilium_tpu_torch.policy.api.l7 import L7Rules
from cilium_tpu_torch.policy.repository import Repository
from cilium_tpu_torch.policy.selectorcache import SelectorCache

#: Wildcard port in map keys.
PORT_WILDCARD = 0


@dataclasses.dataclass(frozen=True)
class MapStateKey:
    identity: int            # peer identity; 0 = wildcard
    dport: int               # masked port prefix base; 0+plen 0 = wildcard
    proto: int               # Protocol; 0 = wildcard
    direction: int           # TrafficDirection
    #: port prefix length (reference: pkg/policy/mapstate.go keys port
    #: RANGES via prefix/mask entries, not per-port enumeration):
    #: 16 = exact port, 0 = wildcard, 1..15 = an aligned 2^(16-plen)
    #: block starting at ``dport``. None = infer from dport (0 →
    #: wildcard, else exact) so legacy 4-arg constructions keep their
    #: meaning.
    port_plen: Optional[int] = None

    def __post_init__(self):
        if self.port_plen is None:
            object.__setattr__(
                self, "port_plen",
                0 if self.dport == PORT_WILDCARD else 16)

    @property
    def port_mask(self) -> int:
        return 0 if self.port_plen == 0 else (
            (0xFFFF << (16 - self.port_plen)) & 0xFFFF)

    def covers(self, identity: int, dport: int, proto: int,
               direction: int) -> bool:
        if (self.proto == 0 and self.port_plen != 0
                and proto in _ICMP_PROTOS):
            # a proto-ANY port rule is an L4 (TCP/UDP/SCTP) construct
            # (reference toPorts semantics); it must not match ICMP
            # flows whose marked type happens to equal the port
            return False
        return (
            self.direction == direction
            and self.identity in (IDENTITY_WILDCARD, identity)
            and (dport & self.port_mask) == self.dport
            and self.proto in (0, proto)
        )

    @property
    def specificity(self) -> int:
        # peer > port (longer prefix > shorter) > proto; the peer
        # component (34) exceeds the max port+proto component (33) so
        # an L3-specific entry still beats any L4-only entry
        return (
            (34 if self.identity != IDENTITY_WILDCARD else 0)
            + 2 * self.port_plen
            + (1 if self.proto != 0 else 0)
        )


@dataclasses.dataclass
class MapStateEntry:
    is_deny: bool = False
    #: union of L7 rule sets contributed by allows at this key
    l7_rules: Tuple[L7Rules, ...] = ()
    #: True if some contributing allow had no L7 restriction
    l7_wildcard: bool = False
    #: the entry's AuthType slot (SURVEY §2.1): a contributing rule
    #: with authentication mode "required" marks matching traffic for
    #: the mutual-auth subsystem (surfaced as the engine's
    #: ``auth_required`` output lane)
    auth_required: bool = False
    #: True when a contributing rule set an explicit mode (required OR
    #: disabled) — explicit beats derived-from-covering-entries, which
    #: is how mode "disabled" overrides a broader required (the
    #: reference's authPreferredInsert precedence)
    auth_explicit: bool = False
    derived_from: Tuple[str, ...] = ()

    @property
    def is_redirect(self) -> bool:
        return bool(self.l7_rules) and not self.l7_wildcard and not self.is_deny

    def merge(self, other: "MapStateEntry") -> None:
        self.is_deny = self.is_deny or other.is_deny
        self.l7_wildcard = self.l7_wildcard or other.l7_wildcard
        # auth precedence on one key: explicit beats implicit; between
        # explicit contributors, required beats disabled (never
        # silently waive a handshake)
        if other.auth_explicit and not self.auth_explicit:
            self.auth_required = other.auth_required
        elif other.auth_explicit and self.auth_explicit:
            self.auth_required = self.auth_required or other.auth_required
        self.auth_explicit = self.auth_explicit or other.auth_explicit
        for lr in other.l7_rules:
            if lr not in self.l7_rules:
                self.l7_rules = self.l7_rules + (lr,)
        for d in other.derived_from:
            if d not in self.derived_from:
                self.derived_from = self.derived_from + (d,)


class MapState:
    """Key → Entry table + per-direction enforcement flags."""

    def __init__(self) -> None:
        self.entries: Dict[MapStateKey, MapStateEntry] = {}
        self.ingress_enforced = False
        self.egress_enforced = False
        #: per-endpoint policy-audit mode (reference: the endpoint
        #: option PolicyAuditMode, settable per endpoint while the
        #: fleet enforces): would-be denials for THIS endpoint's
        #: policy verdict AUDIT instead of DROPPED. The global
        #: ``Config.policy_audit_mode`` flag is the default-all.
        self.audit = False

    def insert(self, key: MapStateKey, entry: MapStateEntry) -> None:
        cur = self.entries.get(key)
        if cur is None:
            # ctlint: disable=unbounded-registry  # value object: lifetime is one resolved snapshot, size = its rule set
            self.entries[key] = entry
        else:
            cur.merge(entry)

    def lookup(
        self, identity: int, dport: int, proto: int, direction: int
    ) -> Tuple[bool, Optional[MapStateEntry]]:
        """Pure-Python golden model of the datapath lookup.

        Returns (allowed, winning_entry). ``winning_entry`` is None when
        the verdict came from default enforcement. L7 is NOT evaluated
        here — callers check ``entry.is_redirect``.
        """
        dport = effective_dport(dport, proto)
        covering = [
            (k, e) for k, e in self.entries.items()
            if k.covers(identity, dport, proto, direction)
        ]
        if any(e.is_deny for _, e in covering):
            denies = [(k, e) for k, e in covering if e.is_deny]
            k, e = max(denies, key=lambda ke: ke[0].specificity)
            return False, e
        allows = [(k, e) for k, e in covering if not e.is_deny]
        if allows:
            k, e = max(allows, key=lambda ke: ke[0].specificity)
            return True, e
        enforced = (
            self.ingress_enforced
            if direction == TrafficDirection.INGRESS
            else self.egress_enforced
        )
        return (not enforced), None

    def __len__(self) -> int:
        return len(self.entries)

#: ICMP type values live in the key's port slot OR'd with this bit:
#: without it, ICMP type 0 (EchoReply) would key as dport 0 ==
#: PORT_WILDCARD and an EchoReply-only allow would match ALL ICMP.
#: Flow-side lookups apply the same bit for ICMP protocols (see
#: :func:`effective_dport`). Proto-specific entries can't collide
#: cross-protocol (keys include the protocol); proto-WILDCARD port
#: entries could — `covers()` and the kernel therefore exclude ICMP
#: flows from proto-ANY port matches (L4 semantics, as the reference).
ICMP_TYPE_BIT = 1 << 15
_ICMP_PROTOS = (int(Protocol.ICMP), int(Protocol.ICMPV6))


def port_range_blocks(lo: int, hi: int) -> List[Tuple[int, int]]:
    """Decompose an inclusive port range into maximal aligned
    power-of-two blocks ``(base, prefix_len)`` — CIDR-style over the
    16-bit port space (reference: ``pkg/policy/mapstate.go`` keys port
    ranges via mask entries). ``1024-65535`` → 6 blocks."""
    out: List[Tuple[int, int]] = []
    while lo <= hi:
        size = (lo & -lo) or (1 << 16)
        while size > hi - lo + 1:
            size >>= 1
        out.append((lo, 16 - (size.bit_length() - 1)))
        lo += size
    return out


def effective_dport(dport: int, proto: int) -> int:
    """Flow-side key port: ICMP types get the marker bit (always, so
    type 0 matches a type-0 rule entry and never the port wildcard)."""
    return dport | ICMP_TYPE_BIT if proto in _ICMP_PROTOS else dport


def _collect_requirements(selectors) -> Tuple:
    """fromRequires/toRequires selectors → conjunctive MatchExpressions
    (reference converts each required matchLabel into an ``In``
    requirement merged into the direction's peer selectors)."""
    from cilium_tpu_torch.policy.api.selector import MatchExpression

    reqs = []
    for sel in selectors:
        for k, v in sel.match_labels:
            if v:
                reqs.append(MatchExpression(key=k, operator="In",
                                            values=(v,)))
            else:
                reqs.append(MatchExpression(key=k, operator="Exists"))
        reqs.extend(sel.match_expressions)
    return tuple(reqs)


def _require(peer_selectors, reqs):
    """AND the requirements into every label-based peer selector. A
    wildcard peer stops being the map-key wildcard: it becomes a real
    selector over the requirements (requirements constrain even
    all-peer rules; CIDR/FQDN/service-derived peers are unaffected,
    matching the reference where requires merge into fromEndpoints)."""
    from cilium_tpu_torch.policy.api.selector import EndpointSelector

    if not reqs:
        return peer_selectors
    return tuple(
        EndpointSelector(
            match_labels=sel.match_labels,
            match_expressions=tuple(sel.match_expressions) + reqs,
        )
        for sel in peer_selectors
    )


class PolicyResolver:
    """Builds MapState per endpoint identity (resolvePolicyLocked +
    EndpointPolicy analog, SURVEY.md §3.2)."""

    def __init__(self, repo: Repository, selector_cache: SelectorCache,
                 services=None, backend_identity=None,
                 cluster_name: str = "default",
                 named_ports_of=None):
        self.repo = repo
        self.cache = selector_cache
        #: local cluster name: the `cluster` entity's selectors bind to
        #: it (reference api.InitEntities — per-resolver here, not a
        #: process-global, so co-resident agents don't fight)
        self.cluster_name = cluster_name
        #: ``named_ports_of(identity) -> Mapping[str, int]`` — how a
        #: named toPorts entry resolves against PEER endpoints (egress:
        #: the remote endpoint owns the name, reference pkg/policy/l4.go
        #: named-port resolution over selected endpoints); None → named
        #: egress ports resolve to nothing
        self.named_ports_of = named_ports_of
        self._subject_named_ports: Dict[str, int] = {}
        #: ``group_cidrs(GroupsSpec) -> Iterable[str]`` — resolves a
        #: toGroups reference to CIDRs (agent provider registry); None
        #: → groups resolve to nothing. Queried at every resolve, so
        #: refreshed provider data lands on the next regeneration.
        self.group_cidrs = None
        #: ``cidr_group_cidrs(name) -> Iterable[str]`` — resolves a
        #: CIDRRule.group_ref (CiliumCIDRGroup, v2alpha1) to its
        #: member CIDRs; None / unknown name → the ref selects NOTHING
        #: (a dangling group must not widen the rule). Queried at
        #: every resolve, like group_cidrs.
        self.cidr_group_cidrs = None
        #: optional ServiceManager: `toServices` resolves against its
        #: k8s metadata (reference: pkg/k8s service cache feeding
        #: resolveEgressPolicy); None → toServices selects nothing
        self.services = services
        #: optional ip → NumericIdentity hook (the agent passes
        #: ipcache.lookup): how backend IPs become matchable identities
        self.backend_identity = backend_identity

    def resolve(self, endpoint_labels: LabelSet,
                named_ports=None) -> MapState:
        """``named_ports``: the SUBJECT endpoint's name→port table —
        ingress named toPorts resolve against it (the destination of
        ingress traffic is the endpoint itself); egress named ports
        resolve against peers via ``named_ports_of``."""
        ms = MapState()
        self._subject_named_ports = dict(named_ports or {})
        matching = list(self.repo.matching_rules(endpoint_labels))
        # fromRequires/toRequires (reference: api.IngressRule.FromRequires,
        # aggregated in rule.go ·GetSourceEndpointSelectorsWithRequirements):
        # requirements from ANY rule selecting this endpoint are ANDed
        # into EVERY label-based peer selector for the direction — they
        # grant nothing themselves, they only constrain.
        ingress_reqs = _collect_requirements(
            sel for rule in matching for ir in rule.ingress
            for sel in ir.from_requires)
        egress_reqs = _collect_requirements(
            sel for rule in matching for er in rule.egress
            for sel in er.to_requires)
        for rule in matching:
            rule_id = rule.key
            for ir in rule.ingress:
                ms.ingress_enforced = True
                self._apply_direction(
                    ms, TrafficDirection.INGRESS,
                    _require(ir.peer_selectors(self.cluster_name),
                             ingress_reqs),
                    ir.to_ports, ir.deny, rule_id, ir.from_cidrs, (),
                    icmps=ir.icmps, auth=ir.auth_mode,
                    cidr_set=ir.from_cidr_set,
                )
            for er in rule.egress:
                ms.egress_enforced = True
                self._apply_direction(
                    ms, TrafficDirection.EGRESS,
                    _require(er.peer_selectors(self.cluster_name),
                             egress_reqs),
                    er.to_ports, er.deny, rule_id, er.to_cidrs, er.to_fqdns,
                    services=er.to_services, icmps=er.icmps,
                    auth=er.auth_mode, cidr_set=er.to_cidr_set,
                    groups=er.to_groups,
                )
        self._propagate_auth(ms)
        return ms

    @staticmethod
    def _propagate_auth(ms: MapState) -> None:
        """authPreferredInsert (reference mapstate): a more-specific
        allow entry inherits auth_required from any covering allow
        entry that demands it, UNLESS an explicit mode was set on the
        narrow entry (that's how ``disabled`` carves an exception out
        of a broad ``required``). Without this, adding a narrower allow
        would silently waive the handshake for exactly the traffic the
        broad auth rule covers."""
        demanding = [(k, e) for k, e in ms.entries.items()
                     if e.auth_required and not e.is_deny]
        if not demanding:
            return
        for key, entry in ms.entries.items():
            if entry.is_deny or entry.auth_explicit or entry.auth_required:
                continue
            for ck, _ in demanding:
                if ck != key and ck.covers(key.identity, key.dport,
                                           key.proto, key.direction):
                    entry.auth_required = True
                    break

    def _apply_direction(
        self, ms: MapState, direction: int, peer_selectors, to_ports,
        deny: bool, rule_id: str, cidrs, fqdns, services=(), icmps=(),
        auth: str = "", cidr_set=(), groups=(),
    ) -> None:
        peer_ids: Set[int] = set()
        wildcard_peer = False
        for sel in peer_selectors:
            if sel.is_wildcard():
                wildcard_peer = True
            else:
                peer_ids.update(self.cache.get_selections(sel))
        for fsel in fqdns:
            peer_ids.update(self.cache.get_selections(fsel))
        for cidr in cidrs:
            peer_ids.update(self._cidr_identities(cidr))
        for cr in cidr_set:
            # CIDRRule.except: carve-outs SUBTRACT — an identity inside
            # an excepted sub-CIDR (it carries the except prefix among
            # its ancestor cidr: labels) gets no allow entry from this
            # rule and falls through to default-deny
            if cr.group_ref:
                # cidrGroupRef: each member CIDR inherits the rule's
                # excepts; unknown group/provider → selects nothing
                members = (tuple(self.cidr_group_cidrs(cr.group_ref)
                                 or ())
                           if self.cidr_group_cidrs is not None else ())
            else:
                members = (cr.cidr,)
            ids = set()
            for member in members:
                ids |= set(self._cidr_identities(member))
            for ex in cr.except_cidrs:
                ids -= self._cidr_identities(ex)
            peer_ids.update(ids)
        for svc_sel in services:
            peer_ids.update(self._service_identities(svc_sel))
        for g in groups:
            # toGroups → provider-resolved CIDRs → identities; an
            # unknown provider or empty result selects NOTHING (the
            # rule must not silently widen)
            if self.group_cidrs is None:
                continue
            for cidr in (self.group_cidrs(g) or ()):
                peer_ids.update(self._cidr_identities(cidr))
        if wildcard_peer:
            ids: Sequence[int] = (IDENTITY_WILDCARD,)
        else:
            ids = sorted(peer_ids)
            if not ids:
                return  # selector selects nothing (yet)

        # each PortRule contributes its own entries — entries at the same
        # key merge (union of L7 rule sets; wildcard-wins is preserved
        # because a no-L7 PortRule contributes l7_wildcard=True)
        # contribution = (port-base, port-plen, proto, l7)
        contributions: List[Tuple[int, int, int, Optional[L7Rules]]] = []
        if to_ports:
            for pr in to_ports:
                l7 = pr.rules if (pr.rules and not pr.rules.is_empty()) else None
                if not pr.ports:
                    contributions.append((PORT_WILDCARD, 0, 0, l7))
                for pp in pr.ports:
                    proto = int(pp.protocol)
                    if pp.name:
                        # NAMED port: resolve against endpoint
                        # named-port tables; unresolvable names
                        # contribute NOTHING (they must not widen to a
                        # port wildcard — reference drops them too)
                        for port in self._resolve_named_port(
                                pp.name, direction,
                                None if wildcard_peer else ids):
                            contributions.append((port, 16, proto, l7))
                    elif pp.end_port and pp.end_port > pp.port:
                        # a port RANGE becomes O(log) aligned prefix
                        # blocks, not per-port keys (reference:
                        # mapstate.go port-range entries) — 1024-65535
                        # is 6 rows, not 64512
                        for base, plen in port_range_blocks(
                                pp.port, pp.end_port):
                            contributions.append((base, plen, proto, l7))
                    elif pp.port == PORT_WILDCARD:
                        contributions.append((PORT_WILDCARD, 0, proto, l7))
                    else:
                        contributions.append((pp.port, 16, proto, l7))
        elif icmps:
            # ICMP keys as the datapath encodes them: the marked type
            # in the port slot (one encoding, shared with the flow
            # side) under the ICMP(v6) protocol
            for ic in icmps:
                contributions.append(
                    (effective_dport(int(ic.icmp_type),
                                     int(ic.protocol)),
                     16, int(ic.protocol), None))
        else:
            contributions.append((PORT_WILDCARD, 0, 0, None))

        for identity in ids:
            for port, plen, proto, l7 in contributions:
                entry = MapStateEntry(
                    is_deny=deny,
                    l7_rules=(l7,) if (l7 and not deny) else (),
                    l7_wildcard=(l7 is None) and not deny,
                    auth_required=(auth == "required") and not deny,
                    auth_explicit=bool(auth) and not deny,
                    derived_from=(rule_id,),
                )
                ms.insert(
                    MapStateKey(identity=identity, dport=port, proto=proto,
                                direction=direction, port_plen=plen),
                    entry,
                )

    def _resolve_named_port(self, name: str, direction: int,
                            peer_ids) -> List[int]:
        """Named port → numeric port(s). Ingress: the subject endpoint
        owns the name. Egress: the selected PEER endpoints own it —
        union over their tables (wildcard peer: every known identity),
        mirroring pkg/policy/l4.go resolution over selected endpoints."""
        if direction == TrafficDirection.INGRESS:
            p = self._subject_named_ports.get(name)
            return [int(p)] if p else []
        if self.named_ports_of is None:
            return []
        idents = (peer_ids if peer_ids is not None
                  else list(self.cache.identities()))
        out: Set[int] = set()
        for i in idents:
            table = self.named_ports_of(i) or {}
            p = table.get(name)
            if p:
                out.add(int(p))
        return sorted(out)

    def _service_identities(self, svc_sel) -> Set[int]:
        """``toServices`` → backend identities: match services by k8s
        name/namespace or label selector, then map each ACTIVE
        backend's IP to its identity (the reference resolves k8s
        Endpoints the same way — via the ipcache join point, §2.1)."""
        ids: Set[int] = set()
        if self.services is None or self.backend_identity is None:
            return ids
        for svc in self.services.list():
            if not svc_sel.matches(svc.name, svc.namespace,
                                   svc.labels or {}):
                continue
            # merged view: shared (global) services include backends
            # announced by remote clusters (pkg/clustermesh services
            # sync); their IPs resolve through the ipcache entries the
            # IP sync created
            for backend in self.services.active_backends(svc):
                nid = self.backend_identity(backend.ip)
                if nid is not None:
                    ids.add(int(nid))
        return ids

    def _cidr_identities(self, cidr: str) -> FrozenSet[int]:
        """CIDR → local identities. v0: CIDRs are registered with the
        selector cache as labels ``cidr:<prefix>`` by the ipcache
        (SURVEY.md §2.1 ipcache); resolve via label match. The rule's
        CIDR string is NORMALIZED (host bits masked) before matching —
        ipcache labels are normalized, and a verbatim mismatch on an
        ``except`` clause would silently fail open."""
        import ipaddress

        from cilium_tpu_torch.core.labels import Label

        try:
            key = str(ipaddress.ip_network(cidr, strict=False))
        except ValueError:
            return frozenset()  # unsanitized garbage selects nothing
        out = set()
        for nid, lbls in self.cache.identities().items():
            if lbls.has(Label(key=key, source="cidr")):
                out.add(nid)
        return frozenset(out)
