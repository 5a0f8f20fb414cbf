"""The plain reference: Cilium's verdict for every record of a capture,
worked out again from the deployment's rules, identity map and records
alone, in Python (``re``) and NumPy.

Semantics, for a record with endpoint ``ep`` (the destination of an
ingress record, the source of an egress one) and peer ``peer``:

- a policy applies when its endpoint selector picks ``ep``, its peer
  selector picks ``peer`` (``matchLabels``), and its direction, port
  (0 = any) and protocol are the record's;
- deny before allow: an applying deny drops the record;
- an applying allow without L7 rules forwards it (FORWARDED);
- an applying allow with L7 rules (HTTP or Kafka, one family a policy)
  redirects it to the proxy: allowed (REDIRECTED) when an applying
  allow has no L7 rules, or when some rule of the record's own family
  in the applying allows matches it; otherwise dropped;
- an HTTP rule matches an HTTP record in all its parts: regex full
  match of method, path and host (host without case), and each
  required header present with its value (any value when none is
  given);
- a Kafka rule matches a Kafka record (one topic at most) as upstream
  ``proxylib/kafka`` ``MatchesRule`` decides: the API key is in the
  rule's set (its role's keys, :data:`KAFKA_ROLE_API_KEYS`, its one
  named key, or any), the API version and the client id are the rule's
  where it gives them, and the topic is the rule's where both the rule
  and the record give one: a record without a topic is judged on the
  rule's other parts;
- no applying policy: dropped when some policy of the record's direction
  selects ``ep`` (default deny), forwarded otherwise (default allow).

The control breaks one of these guarantees on request (``control=``):
``prefix_match`` matches regexes at the start only, ``deny_ignored``
drops deny policies, ``default_allow`` forwards what no policy covers,
``kafka_key_ignored`` matches Kafka rules whatever the API key.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from benchmark.deployment import (
    KAFKA_API_KEYS,
    Deployment,
    HTTPRule,
    KafkaRule,
    label_index,
    selected,
)
from benchmark.traffic import HTTP, KAFKA, Records

FORWARDED, DROPPED, REDIRECTED = 1, 2, 5
CONTROLS = ("prefix_match", "deny_ignored", "default_allow",
            "kafka_key_ignored")
#: the API keys each Kafka role allows (upstream ``pkg/policy/api``
#: ``kafka.go`` ``MapRoleToAPIKey``)
KAFKA_ROLE_API_KEYS = {
    "produce": (0, 3, 18),
    "consume": (1, 2, 3, 8, 9, 10, 11, 12, 13, 14, 18),
}
_META = set(".^$*+?{}[]\\|()")


@dataclasses.dataclass
class Expected:
    verdict: np.ndarray          # [N] int32
    l3l4_allowed: np.ndarray     # [N] bool
    redirect: np.ndarray         # [N] bool
    #: not compared; what the step's byte count reads: some policy
    #: applies ([N] bool), and the first applying allow with HTTP
    #: rules, and with Kafka rules, of a redirected record ([N] int64
    #: policy position, -1 for none)
    covered: np.ndarray
    http_policy: np.ndarray
    kafka_policy: np.ndarray

    def lanes(self) -> Dict[str, np.ndarray]:
        return {"verdict": self.verdict, "l3l4_allowed": self.l3l4_allowed,
                "redirect": self.redirect}


def literal_prefix(pattern: str) -> str:
    """The longest literal text every full match of ``pattern`` starts
    with ('' when unsure: an alternation, an escape, a class first)."""
    if "|" in pattern:
        return ""
    out = []
    for k, ch in enumerate(pattern):
        if ch in _META:
            if ch in "*?{" and out:
                out.pop()         # the last literal is optional
            break
        out.append(ch)
    return "".join(out)


class _RuleMatcher:
    """One HTTP rule over a record's string indices, with the verdicts
    of method, host and header block kept per distinct string."""

    def __init__(self, rule: HTTPRule, rec: Records, prefix_only: bool):
        def rx(pat: str, flags: int = 0) -> Optional[Callable]:
            if not pat:
                return None
            c = re.compile(pat.encode(), flags)
            return c.match if prefix_only else c.fullmatch

        self.path = rx(rule.path)
        self.method = rx(rule.method)
        self.host = rx(rule.host, re.IGNORECASE)
        self.headers = tuple((k.strip().lower().encode(), v.strip().encode())
                             for k, v in rule.headers)
        self.tables = {f: rec.strings[f][0] for f in
                       ("method", "host", "headers")}
        self._memo: Dict[Tuple[str, int], bool] = {}

    def _field_ok(self, field: str, i: int) -> bool:
        key = (field, i)
        ok = self._memo.get(key)
        if ok is None:
            value = self.tables[field][i]
            if field == "headers":
                ok = _headers_ok(self.headers, value)
            else:
                m = getattr(self, field)
                ok = m is None or m(value) is not None
            self._memo[key] = ok
        return ok

    def matches(self, path: bytes, method: int, host: int,
                headers: int) -> bool:
        if self.path is not None and self.path(path) is None:
            return False
        return (self._field_ok("method", method)
                and self._field_ok("host", host)
                and self._field_ok("headers", headers))


def _headers_ok(required, block: bytes) -> bool:
    have = []
    for line in block.split(b"\n"):
        if line:
            k, _, v = line.partition(b":")
            have.append((k.strip().lower(), v.strip()))
    for name, value in required:
        if not any(k == name and (not value or v == value)
                   for k, v in have):
            return False
    return True


def _http_allowed(rules: Tuple[HTTPRule, ...], rows: np.ndarray,
                  rec: Records, prefix_only: bool) -> np.ndarray:
    """[len(rows)] bool: some rule matches the record. Candidate rules
    of a record are those whose literal path prefix its path starts
    with; each candidate is then matched in full."""
    out = np.zeros(len(rows), dtype=bool)
    if len(rows) == 0 or not rules:
        return out
    ptable, pidx = rec.strings["path"]
    paths = [ptable[i] for i in pidx[rows].tolist()]
    midx = rec.strings["method"][1][rows].tolist()
    hidx = rec.strings["host"][1][rows].tolist()
    xidx = rec.strings["headers"][1][rows].tolist()
    matchers = [_RuleMatcher(r, rec, prefix_only) for r in rules]
    by_len: Dict[int, Dict[bytes, List[int]]] = {}
    for k, r in enumerate(rules):
        lp = literal_prefix(r.path).encode()
        by_len.setdefault(len(lp), {}).setdefault(lp, []).append(k)
    width = max(1, max(len(p) for p in paths))
    arr = np.array(paths, dtype=f"S{width}")
    plen = np.fromiter((len(p) for p in paths), dtype=np.int64,
                       count=len(paths))
    for length, table in sorted(by_len.items()):
        keys = sorted(table)
        karr = np.array(keys, dtype=f"S{max(1, length)}")
        trunc = arr.astype(f"S{length}") if length else \
            np.full(len(arr), b"", dtype="S1")
        pos = np.searchsorted(karr, trunc)
        pos_c = np.minimum(pos, len(keys) - 1)
        found = (pos < len(keys)) & (karr[pos_c] == trunc) & (plen >= length)
        for k in np.nonzero(found & ~out)[0].tolist():
            for ri in table[keys[pos_c[k]]]:
                if matchers[ri].matches(paths[k], midx[k], hidx[k], xidx[k]):
                    out[k] = True
                    break
    return out


def _kafka_match(rule: KafkaRule, key_ignored: bool) -> Callable:
    """(API key, API version, client id, topic) → the rule matches, the
    topic given only where both carry one."""
    keys = (KAFKA_ROLE_API_KEYS[rule.role] if rule.role
            else (KAFKA_API_KEYS[rule.api_key],) if rule.api_key else ())
    keys = frozenset(() if key_ignored else keys)
    version = int(rule.api_version) if rule.api_version else None
    client = rule.client_id.encode()
    topic = rule.topic.encode()

    def match(key: int, ver: int, cli: bytes, top: bytes) -> bool:
        return ((not keys or key in keys)
                and (version is None or ver == version)
                and (not client or cli == client)
                and (not topic or not top or top == topic))
    return match


def _kafka_allowed(rules: Tuple[KafkaRule, ...], rows: np.ndarray,
                   rec: Records, key_ignored: bool) -> np.ndarray:
    """[len(rows)] bool: some rule matches the record. Each distinct
    (key, version, client, topic) is judged once, against the rules
    without a topic and those of its own topic (all rules where the
    record has no topic)."""
    out = np.zeros(len(rows), dtype=bool)
    if len(rows) == 0 or not rules:
        return out
    ctable, cidx = rec.strings["kafka_client"]
    ttable, tidx = rec.strings["kafka_topic"]
    cols = np.stack([rec.kafka_api_key[rows].astype(np.int64),
                     rec.kafka_api_version[rows].astype(np.int64),
                     cidx[rows], tidx[rows]], axis=1)
    uniq, inv = np.unique(cols, axis=0, return_inverse=True)
    by_topic: Dict[bytes, List[Callable]] = {}
    for r in rules:
        by_topic.setdefault(r.topic.encode(), []).append(
            _kafka_match(r, key_ignored))
    every = [m for ms in by_topic.values() for m in ms]
    ok = np.zeros(len(uniq), dtype=bool)
    for u, (key, ver, c, t) in enumerate(uniq.tolist()):
        top = ttable[t]
        cands = by_topic.get(b"", []) + by_topic.get(top, []) if top \
            else every
        cli = ctable[c]
        ok[u] = any(m(key, ver, cli, top) for m in cands)
    return ok[inv.reshape(-1)]


def decide(dep: Deployment, rec: Records,
           control: Optional[str] = None) -> Expected:
    """The expected verdict lanes of every record (see the module's
    docstring); ``control`` names the guarantee to break."""
    if control is not None and control not in CONTROLS:
        raise ValueError(f"unknown control {control!r}")
    n = len(rec)
    E = len(dep.ids)
    order = np.argsort(dep.ids)
    sorted_ids = dep.ids[order]

    def position(x: np.ndarray) -> np.ndarray:
        p = np.searchsorted(sorted_ids, x.astype(np.int64))
        p_c = np.minimum(p, E - 1)
        return np.where(sorted_ids[p_c] == x, order[p_c], -1)

    ingress = rec.direction == 1
    ep = position(np.where(ingress, rec.dst, rec.src))
    peer = position(np.where(ingress, rec.src, rec.dst))

    policies = [p for p in dep.policies
                if not (control == "deny_ignored" and p.deny)]
    index = label_index(dep)
    P = len(policies)
    pair_pol: List[np.ndarray] = []
    pair_ep: List[np.ndarray] = []
    peer_codes: List[np.ndarray] = []
    enforced = np.zeros((2, E + 1), dtype=bool)   # column E: not an endpoint
    wildcard_peer = np.zeros(max(P, 1), dtype=bool)
    for k, p in enumerate(policies):
        eps = selected(p.select, dep, index)
        pair_pol.append(np.full(len(eps), k, dtype=np.int64))
        pair_ep.append(eps)
        enforced[p.direction, eps] = True
        peers = selected(p.peer, dep, index)
        peer_codes.append(k * (E + 1) + peers)
        wildcard_peer[k] = not p.peer
    pol = np.concatenate(pair_pol) if pair_pol else np.zeros(0, np.int64)
    pep = np.concatenate(pair_ep) if pair_ep else np.zeros(0, np.int64)
    codes = np.sort(np.concatenate(peer_codes)) if peer_codes else \
        np.zeros(0, np.int64)
    p_dir = np.array([p.direction for p in policies], dtype=np.int64)
    p_port = np.array([p.port for p in policies], dtype=np.int64)
    p_proto = np.array([p.proto for p in policies], dtype=np.int64)
    p_deny = np.array([p.deny for p in policies], dtype=bool)
    p_l7 = np.array([bool(p.http or p.kafka) for p in policies],
                    dtype=bool)
    p_http = np.array([bool(p.http) for p in policies], dtype=bool)

    # (endpoint, direction, port) → the policies on it, sorted
    def key(e, d, port):
        return (e.astype(np.int64) << 20) | (d.astype(np.int64) << 17) \
            | port.astype(np.int64)

    pkeys = key(pep, p_dir[pol], p_port[pol]) if len(pol) else pol
    korder = np.argsort(pkeys, kind="stable")
    pkeys, pol = pkeys[korder], pol[korder]

    any_deny = np.zeros(n, dtype=bool)
    allow_plain = np.zeros(n, dtype=bool)
    allow_l7 = np.zeros(n, dtype=bool)
    l7_pairs: List[Tuple[np.ndarray, np.ndarray]] = []
    first_l7 = {fam: np.full(n, -1, dtype=np.int64)
                for fam in ("http", "kafka")}
    direction = rec.direction.astype(np.int64)
    ep_ok = ep >= 0
    for port in (rec.dport.astype(np.int64), np.zeros(n, dtype=np.int64)):
        kk = key(np.where(ep_ok, ep, 0), direction, port)
        lo = np.searchsorted(pkeys, kk, side="left")
        hi = np.searchsorted(pkeys, kk, side="right")
        hi = np.where(ep_ok, hi, lo)
        width = int((hi - lo).max()) if n else 0
        for off in range(width):
            rows = np.nonzero(lo + off < hi)[0]
            k = pol[lo[rows] + off]
            member = wildcard_peer[k].copy()
            known = peer[rows] >= 0
            if len(codes):
                c = k[known] * (E + 1) + peer[rows][known]
                at = np.minimum(np.searchsorted(codes, c), len(codes) - 1)
                member[known] |= codes[at] == c
            ok = member & (p_proto[k] == rec.proto[rows])
            any_deny[rows] |= ok & p_deny[k]
            allow_plain[rows] |= ok & ~p_deny[k] & ~p_l7[k]
            h = ok & ~p_deny[k] & p_l7[k]
            allow_l7[rows] |= h
            if h.any():
                l7_pairs.append((rows[h], k[h]))
                for fam, is_fam in (("http", p_http[k]),
                                    ("kafka", ~p_http[k])):
                    r, kf = rows[h & is_fam], k[h & is_fam]
                    first = first_l7[fam][r] < 0
                    first_l7[fam][r[first]] = kf[first]

    allowed_l4 = (allow_plain | allow_l7) & ~any_deny
    redirect = allow_l7 & ~any_deny
    l7_ok = allow_plain.copy()
    prefix_only = control == "prefix_match"
    key_ignored = control == "kafka_key_ignored"
    if l7_pairs:
        rows_all = np.concatenate([r for r, _ in l7_pairs])
        pol_all = np.concatenate([k for _, k in l7_pairs])
        need = redirect[rows_all] & ~allow_plain[rows_all] \
            & np.where(p_http[pol_all], rec.l7[rows_all] == HTTP,
                       rec.l7[rows_all] == KAFKA)
        rows_all, pol_all = rows_all[need], pol_all[need]
        for k in np.unique(pol_all).tolist():
            rows = rows_all[pol_all == k]
            rows = rows[~l7_ok[rows]]
            if p_http[k]:
                l7_ok[rows] |= _http_allowed(policies[k].http, rows, rec,
                                             prefix_only)
            else:
                l7_ok[rows] |= _kafka_allowed(policies[k].kafka, rows, rec,
                                              key_ignored)

    ep_col = np.where(ep_ok, ep, E)
    default_drop = enforced[direction, ep_col]
    if control == "default_allow":
        default_drop = np.zeros(n, dtype=bool)
    covered = allow_plain | allow_l7 | any_deny
    verdict = np.where(
        any_deny, DROPPED,
        np.where(redirect, np.where(l7_ok, REDIRECTED, DROPPED),
                 np.where(allowed_l4, FORWARDED,
                          np.where(default_drop, DROPPED, FORWARDED))))
    l3l4 = np.where(covered, allowed_l4, ~default_drop)
    return Expected(verdict=verdict.astype(np.int32),
                    l3l4_allowed=l3l4.astype(bool),
                    redirect=redirect.astype(bool), covered=covered,
                    http_policy=np.where(redirect, first_l7["http"], -1),
                    kafka_policy=np.where(redirect, first_l7["kafka"], -1))
