"""Oracle verdict engine — the CPU correctness reference (a copy of
the reference's ``policy/oracle.py``).

The always-available, authoritative matcher: the staged
``TorchVerdictEngine`` must agree with it bit-for-bit. The loader
serves it with the feature gate ``enable_tpu_offload`` set off, builds
it as ``fallback_engine`` on request, and stages it as the canary's
shadow. Pure Python + ``re`` — intentionally simple and readable;
correctness reference, not a fast path.
"""

from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

from cilium_tpu_torch.core.flow import Flow, TrafficDirection, Verdict
from cilium_tpu_torch.policy.api.l7 import (
    L7Rules,
    PortRuleDNS,
    PortRuleHTTP,
    PortRuleKafka,
)
from cilium_tpu_torch.policy.compiler import matchpattern
from cilium_tpu_torch.policy.mapstate import MapState
from cilium_tpu_torch.secrets import resolve_header_value


def _bytes_fullmatch(pattern: str, s: str, flags: int = 0) -> bool:
    """Byte-level full match: both sides UTF-8 — the engine's DFA scans
    UTF-8 bytes, so the oracle must match at the same level ('.' counts
    bytes, ASCII-only case folding)."""
    return bool(re.fullmatch(pattern.encode("utf-8"), s.encode("utf-8"),
                             flags))


def _header_present(name: str, value: str, headers) -> bool:
    """Any-instance semantics: some header instance satisfies the
    requirement (matches the engine's per-line contains-regex over the
    serialized header block, where duplicates each keep a line)."""
    name = name.strip().lower()
    value = value.strip()
    for k, v in headers:
        if k.strip().lower() == name and (not value or v.strip() == value):
            return True
    return False


def _http_rule_matches(rule: PortRuleHTTP, flow: Flow,
                       secret_lookup=None) -> bool:
    h = flow.http
    if h is None:
        return False
    if rule.path and not _bytes_fullmatch(rule.path, h.path):
        return False
    if rule.method and not _bytes_fullmatch(rule.method, h.method):
        return False
    if rule.host and not _bytes_fullmatch(rule.host, h.host, re.IGNORECASE):
        return False
    for spec in rule.headers:
        if ":" in spec:
            name, value = spec.split(":", 1)
        else:
            name, value = spec, ""
        if not _header_present(name, value, h.headers):
            return False
    for hm in rule.header_matches:
        if hm.mismatch_action != "":
            # LOG/ADD/DELETE/REPLACE never gate the verdict — the
            # mismatch consequence is a log lane or a proxy-side
            # header rewrite (api.MismatchAction semantics)
            continue
        value = resolve_header_value(hm, secret_lookup)
        if value is None:
            return False  # unresolvable secret on FAIL → fail closed
        if not _header_present(hm.name, value, h.headers):
            return False
    return True


def _http_log_mismatch(rule: PortRuleHTTP, flow: Flow,
                       secret_lookup=None) -> bool:
    """True when a LOG-action header match of ``rule`` mismatched (the
    rule still allows; the flow's l7_log lane raises)."""
    h = flow.http
    if h is None:
        return False
    for hm in rule.header_matches:
        if hm.mismatch_action != "LOG":
            continue
        value = resolve_header_value(hm, secret_lookup)
        if value is None:
            continue  # unresolvable secret: nothing to compare
        if not _header_present(hm.name, value, h.headers):
            return True
    return False


def has_proxy_actions(l7_rules: Tuple[L7Rules, ...]) -> bool:
    """True when any HTTP rule of the set carries a non-FAIL mismatch
    action — the cheap gate that lets the proxy bridge skip the
    per-request rule walk for the (common) policies with none. Callers
    on a hot path memoize per policy revision (PolicyBridge) — a
    module-level cache here would pin dead policy snapshots alive
    across regenerations."""
    return any(hm.mismatch_action
               for lr in l7_rules for r in lr.http
               for hm in r.header_matches)


def http_proxy_actions(l7_rules: Tuple[L7Rules, ...], flow: Flow,
                       secret_lookup=None):
    """``(rewrites, log)`` for an allowed HTTP flow, in ONE walk of the
    rule set: ``rewrites`` are the ADD/DELETE/REPLACE HeaderMatch ops
    of matching rules whose mismatch fires, ``log`` raises when a
    LOG-action match mismatched — the reference's ``cilium.l7policy``
    filter does both on the request path (``pkg/policy/api
    ·HeaderMatch MismatchAction``). Mismatch = no
    header instance satisfies (name, value); DELETE additionally
    requires SOME instance of the name to exist (deleting an absent
    header is a no-op not worth re-framing the request for). The
    verdict itself is unaffected: these actions never gate."""
    ops: list = []
    seen = set()
    log = False
    h = flow.http
    headers = h.headers if h is not None else ()
    present_names = {k.strip().lower() for k, _ in headers}
    for lr in l7_rules:
        for r in lr.http:
            if not _http_rule_matches(r, flow, secret_lookup):
                continue
            for hm in r.header_matches:
                action = hm.mismatch_action
                if action == "":
                    continue
                value = resolve_header_value(hm, secret_lookup)
                if value is None:
                    continue  # unresolvable secret: nothing to compare
                if _header_present(hm.name, value, headers):
                    continue  # no mismatch → no consequence
                if action == "LOG":
                    log = True
                    continue
                if action == "DELETE" \
                        and hm.name.strip().lower() not in present_names:
                    continue
                op = (action, hm.name, value)
                if op not in seen:
                    seen.add(op)
                    ops.append(op)
    return ops, log


def _kafka_rule_matches(rule: PortRuleKafka, flow: Flow) -> bool:
    k = flow.kafka
    if k is None:
        return False
    allowed_keys = rule.allowed_api_keys()
    if allowed_keys and k.api_key not in allowed_keys:
        return False
    if rule.api_version and k.api_version != int(rule.api_version):
        return False
    if rule.client_id and k.client_id != rule.client_id:
        return False
    if rule.topic and k.topic != rule.topic:
        return False
    return True


def _dns_rule_matches(rule: PortRuleDNS, flow: Flow) -> bool:
    d = flow.dns
    if d is None or not d.query:
        return False
    qname = matchpattern.sanitize_name(d.query)
    if rule.match_name:
        return bool(re.fullmatch(matchpattern.name_to_regex(rule.match_name),
                                 qname))
    return bool(re.fullmatch(matchpattern.to_regex(rule.match_pattern), qname))


def _generic_rule_matches(rule: Dict[str, str], flow: Flow) -> bool:
    """One ``l7`` key/value rule vs a generic parser record: every rule
    key must be present with the exact value; an empty rule value means
    "field present" (reference: proxylib policy matching of
    ``PortRuleL7`` maps)."""
    g = flow.generic
    if g is None:
        return False
    for k, v in rule.items():
        got = g.fields.get(k)
        if got is None:
            return False
        if v and got != v:
            return False
    return True


def l7_allowed(l7_rules: Tuple[L7Rules, ...], flow: Flow,
               secret_lookup=None) -> Tuple[bool, bool]:
    """Allow-list semantics: request must match ≥1 rule of the set.
    Returns ``(allowed, log)`` — ``log`` raises when a matching HTTP
    rule carried a LOG-action header match that mismatched."""
    allowed = False
    log = False
    for lr in l7_rules:
        for r in lr.http:
            if _http_rule_matches(r, flow, secret_lookup):
                allowed = True
                log = log or _http_log_mismatch(r, flow, secret_lookup)
        for r in lr.kafka:
            if _kafka_rule_matches(r, flow):
                return True, log
        for r in lr.dns:
            if _dns_rule_matches(r, flow):
                return True, log
        if lr.l7proto and flow.generic is not None \
                and flow.generic.proto == lr.l7proto:
            if not lr.l7:
                return True, log  # parser selected, no constraints
            for r in lr.l7:
                if _generic_rule_matches(r, flow):
                    return True, log
    return allowed, log


def owner_mapstate(per_identity: Dict[int, MapState], flow: Flow):
    """(owning endpoint's MapState or None, peer identity). The ONE
    place the ingress/egress endpoint-vs-peer identity selection
    lives — the oracle's decide path and the proxy bridge's rewrite
    walk must agree on it bit-for-bit."""
    ingress = flow.direction == TrafficDirection.INGRESS
    ep_id = flow.dst_identity if ingress else flow.src_identity
    peer_id = flow.src_identity if ingress else flow.dst_identity
    return per_identity.get(ep_id), peer_id


def lookup_entry(per_identity: Dict[int, MapState], flow: Flow):
    """The flow's winning MapState entry: ``(allowed, entry)``;
    ``(True, None)`` when the endpoint has no policy."""
    ms, peer_id = owner_mapstate(per_identity, flow)
    if ms is None:
        return True, None
    return ms.lookup(peer_id, flow.dport, int(flow.protocol),
                     int(flow.direction))


class OracleVerdictEngine:
    """Same contract as engine.VerdictEngine, pure CPU.

    ``secret_lookup(namespace, name) -> Optional[str]`` resolves
    secret-backed header-match values (SecretStore.lookup)."""

    def __init__(self, per_identity: Dict[int, MapState],
                 secret_lookup=None, audit: bool = False):
        self.per_identity = per_identity
        self.secret_lookup = secret_lookup
        #: policy_audit_mode (reference pkg/option): would-be denials
        #: forward with verdict AUDIT instead of DROPPED; nothing else
        #: about evaluation changes
        self.audit = audit

    def _audit_for(self, flow: Flow) -> bool:
        """Global audit flag OR the owning endpoint's per-endpoint
        audit bit (MapState.audit — reference PolicyAuditMode per
        endpoint)."""
        if self.audit:
            return True
        ms, _ = owner_mapstate(self.per_identity, flow)
        return ms is not None and getattr(ms, "audit", False)

    def _decide(self, flow: Flow):
        """One lookup → (verdict, winning_entry, allowed, l7_log)."""
        allowed, entry = lookup_entry(self.per_identity, flow)
        if allowed and entry is None:
            return Verdict.FORWARDED, None, True, False  # no policy
        if not allowed:
            return Verdict.DROPPED, entry, False, False
        if entry is not None and entry.is_redirect:
            ok, log = l7_allowed(entry.l7_rules, flow, self.secret_lookup)
            if ok:
                return Verdict.REDIRECTED, entry, True, log
            return Verdict.DROPPED, entry, True, False
        return Verdict.FORWARDED, entry, True, False

    def verdict_one(self, flow: Flow) -> Verdict:
        v = self._decide(flow)[0]
        if v == Verdict.DROPPED and self._audit_for(flow):
            return Verdict.AUDIT
        return v

    def verdict_flows(self, flows: Sequence[Flow], authed_pairs=None,
                      outputs=None):
        """``authed_pairs``: lex-sorted [P, 2] int32 (src, dst) table
        (AuthManager.pairs_array; sentinel rows ignored) — same
        contract as VerdictEngine.verdict_flows: ``None`` is
        fail-closed (auth-demanding flows drop), ``AUTH_UNENFORCED``
        leaves the demand as an output lane only. ``outputs`` subsets
        the returned lanes (interface parity with the device engine,
        where each lane is a device→host transfer)."""
        import numpy as np

        from cilium_tpu_torch.engine.verdict import AUTH_UNENFORCED

        if authed_pairs is AUTH_UNENFORCED:
            pairs = None
        elif authed_pairs is None:
            pairs = set()  # fail closed: no handshake recorded yet
        else:
            table = np.asarray(authed_pairs).reshape(-1, 2)
            pairs = {(int(s), int(d)) for s, d in table}
        verdicts = []
        auth = []
        logs = []
        for f in flows:
            verdict, entry, allowed, log = self._decide(f)
            demand = bool(allowed and entry is not None
                          and entry.auth_required)
            if (demand and pairs is not None
                    and (f.src_identity, f.dst_identity) not in pairs):
                verdict = Verdict.DROPPED  # drop until handshake
            if verdict == Verdict.DROPPED and self._audit_for(f):
                # audit mode disables enforcement wholesale — auth
                # drops included — but the would-be denial is reported
                verdict = Verdict.AUDIT
            verdicts.append(int(verdict))
            auth.append(demand)
            logs.append(log and verdict == Verdict.REDIRECTED)
        out = {
            "verdict": np.array(verdicts, dtype=np.int32),
            "auth_required": np.array(auth, dtype=bool),
            "l7_log": np.array(logs, dtype=bool),
        }
        if outputs is not None:
            out = {k: out[k] for k in outputs}
        return out

    def verdict_records(self, rec, authed_pairs=None):
        """Interface parity with VerdictEngine.verdict_records (the
        oracle has no columnar path; records round-trip through Flow)."""
        from cilium_tpu_torch.ingest.binary import records_to_flows

        return self.verdict_flows(records_to_flows(rec),
                                  authed_pairs=authed_pairs)

    def verdict_l7_records(self, rec, l7, offsets, blob,
                           authed_pairs=None, widths=None, gen=None):
        """Interface parity with VerdictEngine.verdict_l7_records
        (v2/v3 captures; the oracle reconstructs Flow objects with
        payloads — ``widths`` is a device-side shape hint with no
        oracle role)."""
        from cilium_tpu_torch.ingest.binary import records_to_flows_l7

        return self.verdict_flows(
            records_to_flows_l7(rec, l7, offsets, blob, gen=gen),
            authed_pairs=authed_pairs)
