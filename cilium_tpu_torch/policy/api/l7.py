"""L7 rule types: HTTP, Kafka, DNS.

Reference: ``pkg/policy/api/{l7.go,http.go,kafka.go,fqdn.go}`` (SURVEY.md
§2.1, unverified paths). Semantics reproduced:

* ``PortRuleHTTP``: ``Path``/``Method``/``Host`` are RE2-style regexes
  evaluated as **full matches** against the request field (the reference
  evaluates them inside Envoy with RE2 — no backreferences; SURVEY.md
  §2.2). ``Headers`` are exact ``"Name: Value"`` (or bare ``"Name"`` for
  presence) matches. A request matches the rule iff **all** present
  fields match (conjunction); a request is allowed iff **any** rule of
  the applicable L7 rule set matches (L7 rules are allow-lists; there are
  no L7 deny rules in the reference).
* ``PortRuleKafka``: ``Role`` (produce|consume) expands to API-key sets;
  ``APIKey``/``APIVersion`` numeric-or-named exact; ``ClientID``/``Topic``
  exact strings.
* ``PortRuleDNS``: ``MatchName`` exact (case-insensitive), ``MatchPattern``
  glob per ``pkg/fqdn/matchpattern``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


class SanitizeError(ValueError):
    """Raised on an invalid rule (parse or ``Rule.sanitize``).

    Lives here (the bottom of the policy/api import chain) so both the
    L7 types and rule.py can raise it; rule.py re-exports it as the
    public name."""


#: valid HeaderMatch mismatch actions (reference api.MismatchAction).
#: Verdict semantics: "" (FAIL) denies on mismatch; LOG allows and
#: raises the flow's ``l7_log`` lane; ADD/DELETE/REPLACE allow — the
#: rewrite is applied proxy-side (exposed as CompiledPolicy
#: header_rewrites for the shim/Envoy layer, which owns the bytes).
MISMATCH_ACTIONS = ("", "LOG", "ADD", "DELETE", "REPLACE")


def _header_value_str(value) -> str:
    """Header values are strings by contract. YAML 1.1 silently turns
    unquoted ``yes``/``on``/``true`` into bools — str() would compile a
    requirement for the literal 'True', denying exactly what the
    author wrote, so reject loudly instead."""
    if value is None:
        return ""
    if isinstance(value, bool):
        raise SanitizeError(
            "headerMatches value parsed as a YAML boolean — quote it "
            '(e.g. value: "yes")')
    return str(value)


@dataclasses.dataclass(frozen=True)
class HeaderMatch:
    """Reference HeaderMatch: name + expected value (inline or
    secret-backed) + mismatch action. ``secret`` is a (namespace, name)
    reference resolved against the agent's secret store at compile; an
    unresolvable secret on a FAIL match fails CLOSED (never matches),
    mirroring the reference's inaccessible-secret behavior."""

    name: str
    value: str = ""
    mismatch_action: str = ""  # "" = deny on mismatch (default)
    secret: Optional[Tuple[str, str]] = None  # (namespace, name)


@dataclasses.dataclass(frozen=True)
class PortRuleHTTP:
    path: str = ""
    method: str = ""
    host: str = ""
    headers: Tuple[str, ...] = ()
    header_matches: Tuple[HeaderMatch, ...] = ()

    @classmethod
    def from_dict(cls, d: Dict) -> "PortRuleHTTP":
        return cls(
            path=d.get("path", "") or "",
            method=d.get("method", "") or "",
            host=d.get("host", "") or "",
            headers=tuple(d.get("headers") or ()),
            header_matches=tuple(
                HeaderMatch(
                    name=str(h["name"]),
                    value=_header_value_str(h.get("value")),
                    mismatch_action=(h.get("mismatch", "") or "").upper(),
                    secret=((h["secret"].get("namespace", "default"),
                             h["secret"]["name"])
                            if h.get("secret") else None),
                )
                for h in (d.get("headerMatches") or ())
            ),
        )

    def is_empty(self) -> bool:
        return not (self.path or self.method or self.host or self.headers
                    or self.header_matches)


# Kafka API keys by name (reference: pkg/policy/api/kafka.go tables).
KAFKA_API_KEYS: Dict[str, int] = {
    "produce": 0,
    "fetch": 1,
    "offsets": 2,
    "metadata": 3,
    "leaderandisr": 4,
    "stopreplica": 5,
    "updatemetadata": 6,
    "controlledshutdown": 7,
    "offsetcommit": 8,
    "offsetfetch": 9,
    "findcoordinator": 10,
    "joingroup": 11,
    "heartbeat": 12,
    "leavegroup": 13,
    "syncgroup": 14,
    "describegroups": 15,
    "listgroups": 16,
    "saslhandshake": 17,
    "apiversions": 18,
    "createtopics": 19,
    "deletetopics": 20,
}

KAFKA_ROLE_PRODUCE = "produce"
KAFKA_ROLE_CONSUME = "consume"

#: Role → allowed API-key numbers (reference: kafka.go MapRoleToAPIKey).
KAFKA_ROLE_API_KEYS: Dict[str, Tuple[int, ...]] = {
    KAFKA_ROLE_PRODUCE: (
        KAFKA_API_KEYS["produce"],
        KAFKA_API_KEYS["metadata"],
        KAFKA_API_KEYS["apiversions"],
    ),
    KAFKA_ROLE_CONSUME: (
        KAFKA_API_KEYS["fetch"],
        KAFKA_API_KEYS["offsets"],
        KAFKA_API_KEYS["metadata"],
        KAFKA_API_KEYS["offsetcommit"],
        KAFKA_API_KEYS["offsetfetch"],
        KAFKA_API_KEYS["findcoordinator"],
        KAFKA_API_KEYS["joingroup"],
        KAFKA_API_KEYS["heartbeat"],
        KAFKA_API_KEYS["leavegroup"],
        KAFKA_API_KEYS["syncgroup"],
        KAFKA_API_KEYS["apiversions"],
    ),
}


@dataclasses.dataclass(frozen=True)
class PortRuleKafka:
    role: str = ""        # "produce" | "consume" | "" (use api_key)
    api_key: str = ""     # named API key, e.g. "produce"
    api_version: str = "" # exact version number as string, "" = any
    client_id: str = ""   # exact, "" = any
    topic: str = ""       # exact, "" = any

    @classmethod
    def from_dict(cls, d: Dict) -> "PortRuleKafka":
        return cls(
            role=str(d.get("role", "") or "").lower(),
            api_key=str(d.get("apiKey", "") or "").lower(),
            api_version=str(d.get("apiVersion", "") if d.get("apiVersion")
                            is not None else ""),
            client_id=d.get("clientID", "") or "",
            topic=d.get("topic", "") or "",
        )

    def allowed_api_keys(self) -> Tuple[int, ...]:
        """Expand role/apiKey to the set of allowed numeric API keys.
        Empty tuple means "any API key"."""
        if self.role:
            return KAFKA_ROLE_API_KEYS[self.role]
        if self.api_key:
            return (KAFKA_API_KEYS[self.api_key],)
        return ()


@dataclasses.dataclass(frozen=True)
class PortRuleDNS:
    match_name: str = ""
    match_pattern: str = ""

    @classmethod
    def from_dict(cls, d: Dict) -> "PortRuleDNS":
        return cls(
            match_name=d.get("matchName", "") or "",
            match_pattern=d.get("matchPattern", "") or "",
        )


@dataclasses.dataclass(frozen=True)
class PortRuleL7:
    """One generic key/value rule for an ``l7proto`` parser (reference:
    ``PortRuleL7 map[string]string``). A record matches when every rule
    key is present with the exact value; empty value = presence only."""

    fields: Tuple[Tuple[str, str], ...] = ()

    @classmethod
    def from_dict(cls, d: Dict[str, str]) -> "PortRuleL7":
        return cls(fields=tuple(sorted((str(k), str(v))
                                       for k, v in d.items())))

    def items(self) -> Tuple[Tuple[str, str], ...]:
        return self.fields


@dataclasses.dataclass(frozen=True)
class L7Rules:
    """The per-port L7 rule set (at most one protocol family non-empty)."""

    http: Tuple[PortRuleHTTP, ...] = ()
    kafka: Tuple[PortRuleKafka, ...] = ()
    dns: Tuple[PortRuleDNS, ...] = ()
    l7proto: str = ""                      # generic proxylib parser name
    l7: Tuple[PortRuleL7, ...] = ()        # generic key/value rules

    def is_empty(self) -> bool:
        return not (self.http or self.kafka or self.dns or self.l7proto
                    or self.l7)

    def n_protocols(self) -> int:
        return sum(
            1
            for fam in (self.http, self.kafka, self.dns, self.l7)
            if fam
        )

    @classmethod
    def from_dict(cls, d: Optional[Dict]) -> "L7Rules":
        d = d or {}
        return cls(
            http=tuple(PortRuleHTTP.from_dict(x) for x in (d.get("http") or ())),
            kafka=tuple(PortRuleKafka.from_dict(x) for x in (d.get("kafka") or ())),
            dns=tuple(PortRuleDNS.from_dict(x) for x in (d.get("dns") or ())),
            l7proto=d.get("l7proto", "") or "",
            l7=tuple(PortRuleL7.from_dict(x) if isinstance(x, dict)
                     else x for x in (d.get("l7") or ())),
        )
