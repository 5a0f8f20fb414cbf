"""Verdict provenance: the host-side half of the attribution lane
(counterpart of the reference's ``engine/attribution.py``).

The verdict step computes, per flow, which rule (or rule-signature
group) won (``l7_match``). This module maps that device code back to
something an operator can act on:

* :class:`AttributionMap` — built once per compiled policy, resolves
  ``(l7_type, l7_match)`` to rule ids, the rule content and the bank
  the match was read from;
* :func:`pack_word` / :func:`unpack_word` — the packed provenance word:
  winning code, family, memo-hit vs computed, the policy generation the
  verdict was computed under, the pack-cycle id and the kernel impl;
* :class:`ServedPack` — the per-row provenance bundle the serving paths
  (``IncrementalSession.serve_ids``, the verdict ring) hand back
  alongside verdicts.

Attribution is exact at GROUP granularity when the resolve plan is
staged (every member of a matched group shares the winning signature),
else in RULE space; the map knows which space its policy resolved in.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cilium_tpu_torch.core.flow import L7Type

#: provenance word layout (bit offsets / widths). Fits in 63 bits so
#: the word survives JSON and int64 columns unharmed.
_CODE_BITS = 20       # winning group/rule/lane code + 1 (0 = none)
_FAMILY_SHIFT = 20    # 3 bits: L7Type (0 = none/l4)
_MEMO_SHIFT = 23      # 1 bit: memo-hit (served) vs computed
_GEN_SHIFT = 24       # 24 bits: POLICY_GENERATION mod 2^24
_CYCLE_SHIFT = 48     # 10 bits: pack-cycle id mod 1024
_KERNEL_SHIFT = 58    # 3 bits: kernel impl code
_VERSION_SHIFT = 61   # 2 bits: word schema version
WORD_VERSION = 1

#: kernel impl labels ⇄ word codes (0 = unknown/absent)
KERNEL_CODES = {"": 0, "legacy": 1, "dfa-dense": 2, "nfa-bitset": 3,
                "mixed": 4, "oracle": 5}
KERNEL_NAMES = {v: k for k, v in KERNEL_CODES.items()}

FAMILY_NAMES = {int(L7Type.HTTP): "http", int(L7Type.KAFKA): "kafka",
                int(L7Type.DNS): "dns", int(L7Type.GENERIC): "generic",
                int(L7Type.CASSANDRA): "cassandra",
                int(L7Type.MEMCACHE): "memcache",
                int(L7Type.R2D2): "r2d2"}

#: frontend family ids share ONE decode table ("fe"): their l7_match
#: codes live in the common fe-group (or fe-rule) space
_FE_FAMILIES = frozenset((int(L7Type.CASSANDRA), int(L7Type.MEMCACHE),
                          int(L7Type.R2D2)))

#: the protocol-frontend ``l7proto`` names (their engine families are
#: cassandra / memcache / r2d2)
_FRONTEND_PROTOS = frozenset(("cassandra", "memcache", "r2d2"))

#: frontends are not ported yet
_FRONTENDS_SLICE = ("the protocol frontends' families (cassandra, "
                    "memcache, r2d2) come with the frontends (queue 1, Q5)")


def flow_family(flow) -> int:
    """The ENGINE family of a flow object — what the attribution lane's
    code is scoped to. Frontend records carry ``l7 == GENERIC`` on the
    wire and verdict on their frontend family, which needs the
    frontends: those raise."""
    l7 = int(flow.l7)
    g = getattr(flow, "generic", None)
    if l7 == int(L7Type.GENERIC) and g is not None \
            and g.proto in _FRONTEND_PROTOS:
        raise NotImplementedError(_FRONTENDS_SLICE)
    return l7


def kernel_label(engine) -> str:
    """One label for the engine's scan-impl plan: ``legacy`` (no
    fused plan), one arm's name when every field agrees, ``mixed``
    otherwise."""
    plan = getattr(engine, "impl_plan", None) or {}
    if not plan:
        return "legacy"
    impls = set(plan.values())
    if len(impls) == 1:
        return next(iter(impls))
    return "mixed"


def pack_word(code: int, family: int, memo_hit: bool, gen: int,
              pack_cycle: int = 0, kernel: str = "") -> int:
    """Pack one verdict's provenance into a single int word. ``code``
    is the device attribution lane value (-1 = no L7 winner — packs
    as 0 so "no provenance at all" and "attributed, no L7 match" stay
    distinguishable via the version bits)."""
    w = (min(max(int(code) + 1, 0), (1 << _CODE_BITS) - 1)
         | ((int(family) & 0x7) << _FAMILY_SHIFT)
         | ((1 if memo_hit else 0) << _MEMO_SHIFT)
         | ((max(int(gen), 0) & 0xFFFFFF) << _GEN_SHIFT)
         | ((max(int(pack_cycle), 0) & 0x3FF) << _CYCLE_SHIFT)
         | ((KERNEL_CODES.get(kernel, 0) & 0x7) << _KERNEL_SHIFT)
         | (WORD_VERSION << _VERSION_SHIFT))
    return int(w)


def unpack_word(word: int) -> Optional[Dict[str, object]]:
    """Inverse of :func:`pack_word`; None for 0/unversioned words
    (pre-provenance flows decode to nothing, never to garbage)."""
    word = int(word)
    if word <= 0 or (word >> _VERSION_SHIFT) != WORD_VERSION:
        return None
    return {
        "code": (word & ((1 << _CODE_BITS) - 1)) - 1,
        "family": (word >> _FAMILY_SHIFT) & 0x7,
        "memo_hit": bool((word >> _MEMO_SHIFT) & 1),
        "generation": (word >> _GEN_SHIFT) & 0xFFFFFF,
        "pack_cycle": (word >> _CYCLE_SHIFT) & 0x3FF,
        "kernel": KERNEL_NAMES.get((word >> _KERNEL_SHIFT) & 0x7, ""),
    }


def _rule_label(family: str, rid: int, rule) -> str:
    if family == "http":
        parts = [p for p in (
            f"path={rule.path!r}" if rule.path else "",
            f"method={rule.method!r}" if rule.method else "",
            f"host={rule.host!r}" if rule.host else "") if p]
        return f"http[{rid}] " + (" ".join(parts) or "<any>")
    if family == "dns":
        pat = rule.match_name or rule.match_pattern
        return f"dns[{rid}] {pat!r}"
    if family == "fe":
        proto, pairs = rule
        return f"{proto}[{rid}] l7={dict(pairs)!r}"
    if family == "kafka":
        parts = [p for p in (
            f"role={rule.role!r}" if rule.role else "",
            f"apiKey={rule.api_key!r}" if rule.api_key else "",
            f"topic={rule.topic!r}" if rule.topic else "") if p]
        return f"kafka[{rid}] " + (" ".join(parts) or "<any>")
    proto, pairs = rule
    return f"generic[{rid}] proto={proto!r} l7={dict(pairs)!r}"


class AttributionMap:
    """Host-side decoder of the ``l7_match`` lane for one compiled
    policy: code → member rule ids → rule content → bank key."""

    def __init__(self, space: str, members: Dict[str, List[Tuple[int, ...]]],
                 rules: Dict[str, list], bank_of: Dict[str, list],
                 bank_plan: Dict[str, Tuple[str, ...]]):
        #: "group" (fused resolve plan staged) or "rule"
        self.space = space
        #: family → code → member rule-id tuple
        self._members = members
        #: family → rule table (policy.http_rules etc.)
        self._rules = rules
        #: family → code → bank index within the family's field stack
        self._bank_of = bank_of
        #: field → serving content-addressed bank keys
        self._bank_plan = bank_plan

    # -- construction -----------------------------------------------------
    @classmethod
    def from_policy(cls, policy) -> "AttributionMap":
        a = policy.arrays
        meta = getattr(policy, "resolve_meta", None) or {}
        space = "group" if "rp_rule_group" in a else "rule"
        members: Dict[str, List[Tuple[int, ...]]] = {}
        bank_of: Dict[str, list] = {}

        n_http = len(policy.http_rules)
        path_lane = np.asarray(a.get("http_path_lane",
                                     np.full(max(1, n_http), -1)))
        pw = int(a["path_accept"].shape[2]) if "path_accept" in a else 1
        if space == "group":
            g_rules = meta.get("group_rules")
            if g_rules is None:
                rg = np.asarray(a["rp_rule_group"])
                n_g = int(rg.max()) + 1 if len(rg) and rg.max() >= 0 \
                    else 0
                g_rules = tuple(
                    tuple(int(r) for r in np.nonzero(rg == g)[0])
                    for g in range(n_g))
            members["http"] = [tuple(g) for g in g_rules]
        else:
            members["http"] = [(r,) for r in range(n_http)]
        bank_of["http"] = []
        for mem in members["http"]:
            lane = int(path_lane[mem[0]]) if mem and \
                mem[0] < len(path_lane) else -1
            bank_of["http"].append(lane // (32 * pw) if lane >= 0
                                   else -1)

        # DNS attribution is lane space in BOTH resolves
        n_dns = len(policy.dns_rules)
        dns_lane = np.asarray(a.get("dns_lane",
                                    np.full(max(1, n_dns), -1)))
        dw = int(a["dns_accept"].shape[2]) if "dns_accept" in a else 1
        n_lanes = int(dns_lane.max()) + 1 if len(dns_lane) and \
            dns_lane.max() >= 0 else 0
        members["dns"] = [
            tuple(int(r) for r in np.nonzero(dns_lane[:n_dns] == l)[0])
            for l in range(n_lanes)]
        bank_of["dns"] = [l // (32 * dw) for l in range(n_lanes)]

        n_kafka = len(policy.kafka_rules)
        if space == "group" and "rp_k_rule_group" in a:
            kg = meta.get("kafka_group_rules")
            if kg is None:
                rg = np.asarray(a["rp_k_rule_group"])[:n_kafka]
                n_g = int(rg.max()) + 1 if len(rg) and rg.max() >= 0 \
                    else 0
                kg = tuple(tuple(int(r)
                                 for r in np.nonzero(rg == g)[0])
                           for g in range(n_g))
            members["kafka"] = [tuple(g) for g in kg]
        else:
            members["kafka"] = [(r,) for r in range(n_kafka)]
        bank_of["kafka"] = [-1] * len(members["kafka"])  # columnar

        # protocol-frontend rules: one shared decode table for every
        # fe family (codes live in the common fe-group space); the
        # bank index derives from the rule's l7g automaton lane
        n_fe = len(getattr(policy, "fe_rules", ()) or ())
        fe_lane = np.asarray(a.get("fe_lane", np.full(max(1, n_fe),
                                                      -1)))
        lw = int(a["l7g_accept"].shape[2]) if "l7g_accept" in a else 1
        if space == "group" and "rp_fe_rule_group" in a:
            fg = meta.get("fe_group_rules")
            if fg is None:
                rg = np.asarray(a["rp_fe_rule_group"])[:n_fe]
                n_g = int(rg.max()) + 1 if len(rg) and rg.max() >= 0 \
                    else 0
                fg = tuple(tuple(int(r)
                                 for r in np.nonzero(rg == g)[0])
                           for g in range(n_g))
            members["fe"] = [tuple(g) for g in fg]
        else:
            members["fe"] = [(r,) for r in range(n_fe)]
        bank_of["fe"] = []
        for mem in members["fe"]:
            lane = int(fe_lane[mem[0]]) if mem and \
                mem[0] < len(fe_lane) else -1
            bank_of["fe"].append(lane // (32 * lw) if lane >= 0
                                 else -1)

        n_gen = len(getattr(policy, "gen_rules", ()) or ())
        if space == "group" and "rp_gen_rule_group" in a:
            gg = meta.get("gen_group_rules")
            if gg is None:
                rg = np.asarray(a["rp_gen_rule_group"])[:n_gen]
                n_g = int(rg.max()) + 1 if len(rg) and rg.max() >= 0 \
                    else 0
                gg = tuple(tuple(int(r)
                                 for r in np.nonzero(rg == g)[0])
                           for g in range(n_g))
            members["generic"] = [tuple(g) for g in gg]
        else:
            members["generic"] = [(r,) for r in range(n_gen)]
        bank_of["generic"] = [-1] * len(members["generic"])

        return cls(space, members,
                   {"http": policy.http_rules,
                    "kafka": policy.kafka_rules,
                    "dns": policy.dns_rules,
                    "generic": list(getattr(policy, "gen_rules", ())
                                    or ()),
                    "fe": list(getattr(policy, "fe_rules", ()) or ())},
                   bank_of, dict(getattr(policy, "bank_plan", {}) or {}))

    # -- resolution -------------------------------------------------------
    _FIELD_OF = {"http": "path", "dns": "dns", "fe": "l7g"}

    def resolve(self, l7_type: int, code: int
                ) -> Optional[Dict[str, object]]:
        """``(l7_type, l7_match code)`` → the explanation dict, or
        None when the code does not name a live rule (the
        "unexplainable" bucket the coverage gate counts). Frontend
        family codes (cassandra/memcache/r2d2) resolve through the
        shared "fe" table; the reported family stays the flow's own."""
        family = FAMILY_NAMES.get(int(l7_type))
        if family is None or code is None or int(code) < 0:
            return None
        report_family = family
        if int(l7_type) in _FE_FAMILIES:
            family = "fe"
        code = int(code)
        fam_members = self._members.get(family, [])
        if code >= len(fam_members) or not fam_members[code]:
            return None
        rule_ids = fam_members[code]
        rid = rule_ids[0]
        rules = self._rules.get(family, [])
        if rid >= len(rules):
            return None
        bank_idx = self._bank_of[family][code] \
            if code < len(self._bank_of.get(family, [])) else -1
        field = self._FIELD_OF.get(family, "")
        keys = self._bank_plan.get(field, ()) if field else ()
        bank_key = (keys[bank_idx]
                    if 0 <= bank_idx < len(keys) else "")
        return {
            "family": report_family,
            "space": self.space,
            "code": code,
            "rule_ids": list(rule_ids),
            "rule_index": rid,
            "rule": _rule_label(family, rid, rules[rid]),
            "bank_field": field,
            "bank_index": bank_idx,
            "bank_key": bank_key,
        }

    def rule_label(self, l7_type: int, code: int) -> str:
        """Compact label for flow records / logs:
        ``http:g3/r17`` (group space), ``dns:r2`` (rule/lane), or
        ``cassandra:g0/r1`` (frontend families, fe-group space)."""
        res = self.resolve(l7_type, code)
        if res is None:
            return ""
        tag = "g" if self.space == "group" else "r"
        if res["family"] == "dns":
            tag = "l"  # dns attribution is lane space in both arms
        return (f"{res['family']}:{tag}{res['code']}"
                f"/r{res['rule_index']}")


@dataclasses.dataclass
class ServedPack:
    """Per-row provenance bundle riding alongside served verdicts.
    ``verdict``/``l7_match``/``match_spec`` may be device tensors
    (sliced lazily); ``gens``/``memo_hit`` are host numpy."""

    verdict: object
    l7_match: object
    match_spec: object
    gens: np.ndarray            # cited POLICY_GENERATION per row
    memo_hit: np.ndarray        # served from memo vs computed
    generation: int             # the epoch current at dispatch
    kernel: str = ""
    pack_cycle: int = -1

    def slice(self, base: int, n: int) -> "ServedPack":
        return ServedPack(
            verdict=self.verdict[base:base + n],
            l7_match=self.l7_match[base:base + n],
            match_spec=self.match_spec[base:base + n],
            gens=self.gens[base:base + n],
            memo_hit=self.memo_hit[base:base + n],
            generation=self.generation,
            kernel=self.kernel,
            pack_cycle=self.pack_cycle)

    def host(self) -> "ServedPack":
        """Force the device lanes to host numpy in ONE readback (the
        three int32 lanes stacked, one copy); identity on lanes already
        on the host. ``gens``/``memo_hit`` are host numpy by
        construction."""
        lanes = (self.verdict, self.l7_match, self.match_spec)
        if isinstance(self.verdict, torch.Tensor):
            verdict, l7_match, match_spec = torch.stack(
                [t.to(torch.int32) for t in lanes]).cpu().numpy()
        else:
            verdict, l7_match, match_spec = (np.asarray(t) for t in lanes)
        return ServedPack(
            verdict=np.asarray(verdict).astype(np.int32),
            l7_match=np.asarray(l7_match).astype(np.int32),
            match_spec=np.asarray(match_spec).astype(np.int32),
            gens=np.asarray(self.gens),
            memo_hit=np.asarray(self.memo_hit),
            generation=self.generation,
            kernel=self.kernel,
            pack_cycle=self.pack_cycle)

    def words(self) -> np.ndarray:
        """Vectorized packed provenance words for every row."""
        h = self.host()
        out = np.empty(len(h.gens), dtype=np.int64)
        fam = np.zeros(len(h.gens), dtype=np.int64)
        # family rides the attribution lane's sign: the l7_match code
        # is family-scoped, so family itself comes from the caller's
        # l7_types column when available; packed words without it
        # carry 0 and the explain entry supplies the family
        for i in range(len(out)):
            out[i] = pack_word(int(h.l7_match[i]), int(fam[i]),
                               bool(h.memo_hit[i]), int(h.gens[i]),
                               self.pack_cycle, self.kernel)
        return out
