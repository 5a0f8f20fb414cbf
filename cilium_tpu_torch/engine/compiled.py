"""Host half of the verdict pipeline: compile policy → numpy tensors,
and featurize flows → numpy batches.

A copy of the numpy half of the reference's ``engine/verdict.py``
(``encode_strings`` … ``CompiledPolicy.build`` … ``encode_flows``,
``pack_batch``, ``flowbatch_to_host_dict``), on the positional
``compile_patterns`` path or, with a ``bank_registry``, on the
content-addressed partition of ``policy/compiler/bankplan.py`` (the
loader's default), plus the capture featurizers
(``encode_records``, ``encode_l7_records``, ``CaptureFeaturizer``)
and the single-blob transport's host half (``pack_blob_host``). Its
arrays are byte-equal to the reference's for the same resolved policy
(``tests/test_torch_compile.py``); ``weights.arrays_from_reference``
stages either package's arrays.

Not ported yet (queue 1, Q5): ``l7proto`` rules (generic pairs and
protocol frontends), generic flow records and the GENERIC section of
a v3 capture raise ``NotImplementedError``; the empty ``gen_*`` arrays
are still built exactly as the reference builds them, so the staged
shapes match.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cilium_tpu_torch.core.config import EngineConfig
from cilium_tpu_torch.core.flow import Flow, TrafficDirection
from cilium_tpu_torch.ingest.binary import capture_field_widths
from cilium_tpu_torch.policy.api.l7 import (
    L7Rules,
    PortRuleDNS,
    PortRuleHTTP,
    PortRuleKafka,
)
from cilium_tpu_torch.policy.compiler import matchpattern
from cilium_tpu_torch.policy.compiler.dfa import (
    BankedDFA,
    DFABank,
    compile_patterns,
)
from cilium_tpu_torch.policy.mapstate import MapState
from cilium_tpu_torch.secrets import resolve_header_value
from cilium_tpu_torch.engine.mapstate_kernel import (
    PackedMapState,
    pack_mapstate,
)

#: the slice that will port l7proto rules and generic records
_L7PROTO_SLICE = ("l7proto/frontend rules are not ported yet; they "
                  "arrive with the frontends/l7proto slice (queue 1, "
                  "Q5)")


# --------------------------------------------------------------- helpers --
def encode_strings(
    strings: Sequence[bytes], max_len: int, pad_multiple: int = 32
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode byte strings → (data [B, L] uint8, lengths [B] int32,
    valid [B] bool). Overlong strings are truncated and marked invalid —
    the engine zeroes their match words (no false accepts)."""
    B = len(strings)
    longest = max((len(s) for s in strings), default=1)
    L = min(max_len, max(pad_multiple, -(-max(longest, 1) // pad_multiple)
                         * pad_multiple))
    data = np.zeros((B, L), dtype=np.uint8)
    lengths = np.zeros((B,), dtype=np.int32)
    valid = np.ones((B,), dtype=bool)
    for i, s in enumerate(strings):
        if len(s) > L:
            valid[i] = False
            s = s[:L]
        data[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
        lengths[i] = len(s)
    return data, lengths, valid


def serialize_headers(headers: Sequence[Tuple[str, str]]) -> bytes:
    """Canonical header block: lowercase names, sorted, ``name:value``
    lines each newline-terminated. The header automatons match
    contains-regexes over this form."""
    lines = sorted(f"{k.strip().lower()}:{v.strip()}" for k, v in headers)
    return ("".join(line + "\n" for line in lines)).encode("utf-8")


def header_requirement_regex(name: str, value: str) -> str:
    """Regex (over the serialized header block) for one required header.
    Empty value = presence check."""
    import re as _re

    n = _re.escape(name.strip().lower())
    if value:
        v = _re.escape(value.strip())
        line = f"{n}:{v}"
    else:
        line = f"{n}:[^\\n]*"
    return f"(?:[^\\n]*\\n)*{line}\\n(?:[^\\n]*\\n)*"


def _empty_banked() -> BankedDFA:
    """A 1-bank, 0-pattern automaton (matches nothing) so tensor shapes
    stay non-degenerate when a protocol has no rules."""
    bank = DFABank(
        trans=np.zeros((2, 1), dtype=np.int32),
        byteclass=np.zeros(256, dtype=np.int32),
        accept=np.zeros((2, 1), dtype=np.uint32),
        start=1,
        n_patterns=0,
    )
    return BankedDFA(
        banks=[bank],
        pattern_bank=np.zeros(0, dtype=np.int32),
        pattern_lane=np.zeros(0, dtype=np.int32),
        patterns=(),
    )


@dataclasses.dataclass
class _FieldMatcher:
    """A deduped pattern universe for one string field + its stacked
    tensors; rules reference patterns by global lane."""

    banked: BankedDFA
    arrays: Dict[str, np.ndarray]
    pattern_index: Dict[str, int]
    #: bankplan.FieldBankStats when built through a BankRegistry (the
    #: content-addressed path); None on the positional path
    bank_stats: object = None

    @classmethod
    def build(cls, patterns: List[str], cfg: EngineConfig,
              case_insensitive: bool = False,
              bank_cache=None, bank_registry=None,
              field: str = "") -> "_FieldMatcher":
        uniq: List[str] = []
        index: Dict[str, int] = {}
        for p in patterns:
            if p not in index:
                index[p] = len(uniq)
                uniq.append(p)
        stats = None
        if not uniq:
            banked = _empty_banked()
        elif bank_registry is not None:
            # content-addressed banks: membership is a pure function of
            # the pattern set, so a rule add/delete recompiles only its
            # bank(s), and a failed bank quarantines instead of
            # aborting the build
            banked, stats = bank_registry.compile_field(
                field or "field", uniq, cfg,
                case_insensitive=case_insensitive)
        else:
            banked = compile_patterns(
                uniq,
                bank_size=cfg.bank_size,
                max_states=cfg.max_dfa_states,
                max_quantifier=cfg.max_quantifier,
                case_insensitive=case_insensitive,
                bank_cache=bank_cache,
            )
        return cls(banked=banked, arrays=banked.stacked(),
                   pattern_index=index, bank_stats=stats)

    def lane(self, pattern: str) -> int:
        """Global lane of ``pattern``; -1 for the empty pattern (=no
        constraint)."""
        if not pattern:
            return -1
        return int(self.arrays["lane_of"][self.pattern_index[pattern]])


def _masks_to_array(masks: List[List[int]], n_rules: int) -> np.ndarray:
    W = max(1, (max(n_rules, 1) + 31) // 32)
    out = np.zeros((max(1, len(masks)), W), dtype=np.uint32)
    for i, rule_ids in enumerate(masks):
        for r in rule_ids:
            out[i, r // 32] |= np.uint32(1 << (r % 32))
    return out


def _rbucket(n: int) -> int:
    """Rule-table row count: exact up to 64, then the next multiple of
    64 (shape-stable across small rule churn; padded rows are inert)."""
    return max(1, n) if n <= 64 else -(-n // 64) * 64


# ---------------------------------------------------------------- policy --
@dataclasses.dataclass
class CompiledPolicy:
    """Everything the device step needs, as host numpy arrays."""

    mapstate: PackedMapState
    arrays: Dict[str, np.ndarray]           # flat tensor dict
    http_rules: List[PortRuleHTTP]
    kafka_rules: List[PortRuleKafka]
    dns_rules: List[PortRuleDNS]
    kafka_interns: Dict[str, Dict]          # intern tables (kafka + generic)
    path_matcher: _FieldMatcher
    method_matcher: _FieldMatcher
    host_matcher: _FieldMatcher
    header_matcher: _FieldMatcher
    dns_matcher: _FieldMatcher
    revision: int = 0
    #: per-HTTP-rule proxy-side header rewrites from ADD/DELETE/REPLACE
    #: mismatch actions: [(action, header-name, value), ...]
    header_rewrites: List[List[Tuple[str, str, str]]] = \
        dataclasses.field(default_factory=list)
    #: content-addressed bank plan (field → serving bank-key tuple)
    #: when built through a BankRegistry — the loader diffs plans
    #: across commits to derive the bank-scoped invalidation delta
    bank_plan: Dict[str, Tuple[str, ...]] = \
        dataclasses.field(default_factory=dict)
    #: bank keys quarantined during this build (stale covers serving);
    #: non-empty marks the policy DEGRADED: never cached, never warm-
    #: snapshotted, commits a full invalidation delta
    bank_quarantined: Tuple[str, ...] = ()
    #: host-side metadata of the factored resolve plan
    #: (engine/megakernel.py); None when the grouping degenerated
    resolve_meta: Optional[Dict] = None
    #: field → scan-impl pick, written at engine staging
    kernel_plan: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: the frontend (l7g) automaton: never built in this slice, kept so
    #: ``plan_for_engine`` reads the same attribute as the reference's
    l7g_matcher: Optional[_FieldMatcher] = None

    @classmethod
    def build(
        cls,
        per_identity: Dict[int, MapState],
        cfg: Optional[EngineConfig] = None,
        revision: int = 0,
        secret_lookup=None,
        bank_cache=None,
        bank_registry=None,
        audit: bool = False,
    ) -> "CompiledPolicy":
        """``bank_cache`` (compiler.dfa.BankCache): reuse compiled DFA
        banks across builds. ``bank_registry``
        (compiler.bankplan.BankRegistry) supersedes it with the
        content-addressed partition + per-bank quarantine. ``audit`` =
        policy_audit_mode: would-be denials verdict AUDIT, not DROPPED
        (staged as a device scalar)."""
        cfg = cfg or EngineConfig()

        # -- collect the L7 rule universe (deduped) and rulesets --------
        http_rules: List[PortRuleHTTP] = []
        http_index: Dict[PortRuleHTTP, int] = {}
        kafka_rules: List[PortRuleKafka] = []
        kafka_index: Dict[PortRuleKafka, int] = {}
        dns_rules: List[PortRuleDNS] = []
        dns_index: Dict[PortRuleDNS, int] = {}

        ruleset_key_to_id: Dict[Tuple, int] = {}
        ruleset_http: List[List[int]] = []
        ruleset_kafka: List[List[int]] = []
        ruleset_dns: List[List[int]] = []

        def intern_rule(table, index, rule):
            if rule not in index:
                index[rule] = len(table)
                table.append(rule)
            return index[rule]

        def ruleset_of(l7_rules_tuple: Tuple[L7Rules, ...]) -> int:
            http_ids, kafka_ids, dns_ids = [], [], []
            for lr in l7_rules_tuple:
                for h in lr.http:
                    http_ids.append(intern_rule(http_rules, http_index, h))
                for k in lr.kafka:
                    kafka_ids.append(intern_rule(kafka_rules, kafka_index, k))
                for d in lr.dns:
                    dns_ids.append(intern_rule(dns_rules, dns_index, d))
                if lr.l7proto:
                    raise NotImplementedError(_L7PROTO_SLICE)
            if not (http_ids or kafka_ids or dns_ids):
                return -1
            # the reference keys rulesets by five families; the generic
            # and frontend members are always empty here
            key = (tuple(sorted(set(http_ids))),
                   tuple(sorted(set(kafka_ids))),
                   tuple(sorted(set(dns_ids))), (), ())
            rid = ruleset_key_to_id.get(key)
            if rid is None:
                rid = len(ruleset_http)
                ruleset_key_to_id[key] = rid
                ruleset_http.append(list(key[0]))
                ruleset_kafka.append(list(key[1]))
                ruleset_dns.append(list(key[2]))
            return rid

        # per-build memo keyed by the l7-rules tuple's OBJECT identity
        # (the tuples stay alive for the whole build, so id() keys
        # cannot be recycled)
        _ruleset_memo: Dict[int, int] = {}

        def ruleset_of_entry(ep, key, entry):
            rid = _ruleset_memo.get(id(entry.l7_rules))
            if rid is None:
                rid = ruleset_of(entry.l7_rules)
                _ruleset_memo[id(entry.l7_rules)] = rid
            return rid

        packed = pack_mapstate(
            per_identity,
            ruleset_of_entry=ruleset_of_entry,
        )

        # -- compile field matchers -------------------------------------
        banks = {"bank_cache": bank_cache, "bank_registry": bank_registry}
        path_matcher = _FieldMatcher.build(
            [h.path for h in http_rules if h.path], cfg,
            field="path", **banks)
        method_matcher = _FieldMatcher.build(
            [h.method for h in http_rules if h.method], cfg,
            field="method", **banks)
        host_matcher = _FieldMatcher.build(
            [h.host for h in http_rules if h.host], cfg,
            case_insensitive=True, field="host", **banks)

        header_pats: List[str] = []
        rule_header_lanes: List[List[str]] = []   # FAIL: gate the rule
        rule_log_lanes: List[List[str]] = []      # LOG: raise l7_log
        rule_dead: List[bool] = []   # FAIL w/ unresolvable secret
        header_rewrites: List[List[Tuple[str, str, str]]] = []
        for h in http_rules:
            pats = []
            log_pats = []
            rewrites: List[Tuple[str, str, str]] = []
            dead = False
            for hdr in h.headers:
                if ":" in hdr:
                    name, value = hdr.split(":", 1)
                else:
                    name, value = hdr, ""
                pats.append(header_requirement_regex(name, value))
            for hm in h.header_matches:
                action = hm.mismatch_action
                value = resolve_header_value(hm, secret_lookup)
                if action == "":
                    # FAIL: mismatch denies; an unresolvable secret
                    # kills the rule outright (fail closed)
                    if value is None:
                        dead = True
                    else:
                        pats.append(header_requirement_regex(
                            hm.name, value))
                elif action == "LOG":
                    if value is not None:
                        log_pats.append(header_requirement_regex(
                            hm.name, value))
                else:
                    # ADD/DELETE/REPLACE: never gate; the rewrite is
                    # proxy-side
                    rewrites.append((action, hm.name, value or ""))
            header_pats.extend(pats)
            header_pats.extend(log_pats)
            rule_header_lanes.append(pats)
            rule_log_lanes.append(log_pats)
            rule_dead.append(dead)
            header_rewrites.append(rewrites)
        header_matcher = _FieldMatcher.build(header_pats, cfg,
                                             field="hdr", **banks)

        dns_pats = []
        for d in dns_rules:
            if d.match_name:
                dns_pats.append(matchpattern.name_to_regex(d.match_name))
            else:
                dns_pats.append(matchpattern.to_regex(d.match_pattern))
        dns_matcher = _FieldMatcher.build(dns_pats, cfg, field="dns",
                                          **banks)

        # -- per-rule lane arrays (row counts bucketed past 64) ---------
        Rh = _rbucket(len(http_rules))
        max_hdrs = max([len(p) for p in rule_header_lanes] + [1])
        max_logs = max([len(p) for p in rule_log_lanes] + [1])
        http_path_lane = np.full(Rh, -1, dtype=np.int32)
        http_method_lane = np.full(Rh, -1, dtype=np.int32)
        http_host_lane = np.full(Rh, -1, dtype=np.int32)
        http_header_lanes = np.full((Rh, max_hdrs), -1, dtype=np.int32)
        http_log_lanes = np.full((Rh, max_logs), -1, dtype=np.int32)
        http_rule_dead = np.zeros(Rh, dtype=bool)
        for i, h in enumerate(http_rules):
            if h.path:
                http_path_lane[i] = path_matcher.lane(h.path)
            if h.method:
                http_method_lane[i] = method_matcher.lane(h.method)
            if h.host:
                http_host_lane[i] = host_matcher.lane(h.host)
            for j, pat in enumerate(rule_header_lanes[i]):
                http_header_lanes[i, j] = header_matcher.lane(pat)
            for j, pat in enumerate(rule_log_lanes[i]):
                http_log_lanes[i, j] = header_matcher.lane(pat)
            http_rule_dead[i] = rule_dead[i]
        http_rule_dead[len(http_rules):] = True   # padding is inert

        Rk = _rbucket(len(kafka_rules))
        kafka_apikey_mask = np.zeros(Rk, dtype=np.uint32)   # 0 = any
        kafka_version = np.full(Rk, -1, dtype=np.int32)
        kafka_client = np.full(Rk, -1, dtype=np.int32)
        kafka_topic = np.full(Rk, -1, dtype=np.int32)
        client_intern: Dict[str, int] = {}
        topic_intern: Dict[str, int] = {}
        for i, k in enumerate(kafka_rules):
            for ak in k.allowed_api_keys():
                kafka_apikey_mask[i] |= np.uint32(1 << ak)
            if k.api_version:
                kafka_version[i] = int(k.api_version)
            if k.client_id:
                kafka_client[i] = client_intern.setdefault(
                    k.client_id, len(client_intern))
            if k.topic:
                kafka_topic[i] = topic_intern.setdefault(
                    k.topic, len(topic_intern))

        Rd = _rbucket(len(dns_rules))
        dns_lane = np.full(Rd, -1, dtype=np.int32)
        for i in range(len(dns_rules)):
            dns_lane[i] = dns_matcher.lane(dns_pats[i])

        # -- generic l7proto rules: none in this slice, so the tables
        # are the reference's empty ones (one inert row) -------------
        Rg = _rbucket(0)
        gen_rule_proto = np.full(Rg, -1, dtype=np.int32)
        gen_rule_pairs = np.full((Rg, 1), -1, dtype=np.int32)

        arrays: Dict[str, np.ndarray] = {
            "audit_mode": np.array(audit, dtype=bool),
            "ms_key_w0": packed.key_w0,
            "ms_key_w1": packed.key_w1,
            "ms_key_w2": packed.key_w2,
            "ms_deny": packed.is_deny,
            "ms_ruleset": packed.ruleset_id,
            "ms_auth": packed.auth,
            "ms_enf_ids": packed.enf_ids,
            "ms_enf_flags": packed.enf_flags,
            "ms_plens": packed.port_plens,
            "ms_tmpl_ids": packed.tmpl_ids,
            "rs_http_mask": _masks_to_array(ruleset_http or [[]], Rh),
            "rs_kafka_mask": _masks_to_array(ruleset_kafka or [[]], Rk),
            "rs_dns_mask": _masks_to_array(ruleset_dns or [[]], Rd),
            "rs_gen_mask": _masks_to_array(
                [[] for _ in ruleset_http] or [[]], Rg),
            "gen_rule_proto": gen_rule_proto,
            "gen_rule_pairs": gen_rule_pairs,
            "http_path_lane": http_path_lane,
            "http_method_lane": http_method_lane,
            "http_host_lane": http_host_lane,
            "http_header_lanes": http_header_lanes,
            "http_log_lanes": http_log_lanes,
            "http_rule_dead": http_rule_dead,
            "kafka_apikey_mask": kafka_apikey_mask,
            "kafka_version": kafka_version,
            "kafka_client": kafka_client,
            "kafka_topic": kafka_topic,
            "dns_lane": dns_lane,
        }
        matcher_stacks = (("path", path_matcher),
                          ("method", method_matcher),
                          ("host", host_matcher),
                          ("hdr", header_matcher),
                          ("dns", dns_matcher))
        for prefix, m in matcher_stacks:
            for k, v in m.arrays.items():
                if k != "lane_of":
                    arrays[f"{prefix}_{k}"] = v

        bank_plan: Dict[str, Tuple[str, ...]] = {}
        bank_quarantined: List[str] = []
        for _prefix, m in matcher_stacks:
            st = m.bank_stats
            if st is not None:
                bank_plan[st.field] = st.bank_keys
                bank_quarantined.extend(st.quarantined)

        # factored resolve plan (engine/megakernel.py): rule-signature
        # groups + group-accept planes over the path automaton
        from cilium_tpu_torch.engine import megakernel as _mk

        resolve_meta = None
        plan = _mk.build_resolve_plan(arrays, len(http_rules),
                                      len(dns_rules),
                                      n_kafka=len(kafka_rules))
        if plan is not None:
            rp_arrays, resolve_meta = plan
            arrays.update(rp_arrays)

        return cls(
            mapstate=packed,
            arrays=arrays,
            http_rules=http_rules,
            kafka_rules=kafka_rules,
            dns_rules=dns_rules,
            # gen_fmax: the reference's max(4, min(#pairs, …)) with no
            # interned pairs
            kafka_interns={"client_id": client_intern, "topic": topic_intern,
                           "gen_protos": {}, "gen_pairs": {},
                           "gen_fmax": 4},
            path_matcher=path_matcher,
            method_matcher=method_matcher,
            host_matcher=host_matcher,
            header_matcher=header_matcher,
            dns_matcher=dns_matcher,
            revision=revision,
            header_rewrites=header_rewrites,
            bank_plan=bank_plan,
            bank_quarantined=tuple(bank_quarantined),
            resolve_meta=resolve_meta,
        )


# ------------------------------------------------------------- flow batch --
@dataclasses.dataclass
class FlowBatch:
    """Host-encoded flow tensors (all numpy; shapes static per bucket)."""

    ep_ids: np.ndarray
    peer_ids: np.ndarray
    dports: np.ndarray
    protos: np.ndarray
    directions: np.ndarray
    l7_types: np.ndarray
    path: Tuple[np.ndarray, np.ndarray, np.ndarray]
    method: Tuple[np.ndarray, np.ndarray, np.ndarray]
    host: Tuple[np.ndarray, np.ndarray, np.ndarray]
    headers: Tuple[np.ndarray, np.ndarray, np.ndarray]
    qname: Tuple[np.ndarray, np.ndarray, np.ndarray]
    kafka_api_key: np.ndarray
    kafka_api_version: np.ndarray
    kafka_client: np.ndarray
    kafka_topic: np.ndarray
    gen_proto: np.ndarray     # [B] interned l7proto id, -2 = none/unknown
    gen_pairs: np.ndarray     # [B, F] interned (proto,key,value) ids, -2 pad
    #: serialized frontend record bytes (always empty in this slice)
    l7g: Tuple[np.ndarray, np.ndarray, np.ndarray] = None

    @property
    def size(self) -> int:
        return len(self.ep_ids)


def encode_flows(
    flows: Sequence[Flow],
    interns: Dict[str, Dict[str, int]],
    cfg: Optional[EngineConfig] = None,
) -> FlowBatch:
    """Featurize flows → FlowBatch (the host half of ingest)."""
    cfg = cfg or EngineConfig()
    B = len(flows)
    ep = np.zeros(B, dtype=np.int32)
    peer = np.zeros(B, dtype=np.int32)
    dport = np.zeros(B, dtype=np.int32)
    proto = np.zeros(B, dtype=np.int32)
    dirs = np.zeros(B, dtype=np.int32)
    l7t = np.zeros(B, dtype=np.int32)
    paths: List[bytes] = []
    methods: List[bytes] = []
    hosts: List[bytes] = []
    headerblocks: List[bytes] = []
    qnames: List[bytes] = []
    k_api = np.zeros(B, dtype=np.int32)
    k_ver = np.zeros(B, dtype=np.int32)
    k_cli = np.full(B, -2, dtype=np.int32)
    k_top = np.full(B, -2, dtype=np.int32)
    cintern = interns.get("client_id", {})
    tintern = interns.get("topic", {})
    for i, f in enumerate(flows):
        if f.generic is not None:
            raise NotImplementedError(_L7PROTO_SLICE)
        ingress = f.direction == TrafficDirection.INGRESS
        ep[i] = f.dst_identity if ingress else f.src_identity
        peer[i] = f.src_identity if ingress else f.dst_identity
        dport[i] = f.dport
        proto[i] = int(f.protocol)
        dirs[i] = int(f.direction)
        l7t[i] = int(f.l7)
        h = f.http
        paths.append((h.path if h else "").encode("utf-8"))
        methods.append((h.method if h else "").encode("utf-8"))
        hosts.append((h.host.lower() if h else "").encode("utf-8"))
        headerblocks.append(serialize_headers(h.headers) if h else b"")
        d = f.dns
        qnames.append(
            matchpattern.sanitize_name(d.query).encode("utf-8")
            if d and d.query else b"")
        k = f.kafka
        if k:
            k_api[i] = k.api_key
            k_ver[i] = k.api_version
            k_cli[i] = cintern.get(k.client_id, -2)
            k_top[i] = tintern.get(k.topic, -2)
    Fmax = int(interns.get("gen_fmax", 4))
    bucket = max(cfg.http_path_buckets)
    return FlowBatch(
        ep_ids=ep, peer_ids=peer, dports=dport, protos=proto,
        directions=dirs, l7_types=l7t,
        path=encode_strings(paths, bucket),
        method=encode_strings(methods, cfg.http_method_len),
        host=encode_strings(hosts, cfg.http_host_len),
        headers=encode_strings(headerblocks, 1024),
        qname=encode_strings(qnames, cfg.dns_name_len),
        kafka_api_key=k_api, kafka_api_version=k_ver,
        kafka_client=k_cli, kafka_topic=k_top,
        gen_proto=np.full(B, -2, dtype=np.int32),
        gen_pairs=np.full((B, Fmax), -2, dtype=np.int32),
        l7g=encode_strings([b""] * B, cfg.l7g_len),
    )


#: per-flow scalar/flag columns packed into ONE int32 block (the five
#: byte buckets, l7g and gen_pairs stay separate arrays)
_SCALAR_COLS = (
    "ep_ids", "peer_ids", "dports", "protos", "directions", "l7_types",
    "kafka_api_key", "kafka_api_version", "kafka_client", "kafka_topic",
    "gen_proto",
    "path_len", "path_valid", "method_len", "method_valid",
    "host_len", "host_valid", "headers_len", "headers_valid",
    "qname_len", "qname_valid", "l7g_len", "l7g_valid",
)

#: the byte-bucket fields of a batch, in packed-layout order
BYTE_FIELDS = ("path", "method", "host", "headers", "qname", "l7g")


def pack_batch(d: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Flat layout → packed layout (host side): one int32 ``scalars``
    block plus the byte buckets and ``gen_pairs``."""
    scalars = np.stack(
        [d[c].astype(np.int32) for c in _SCALAR_COLS], axis=1)
    out = {"scalars": np.ascontiguousarray(scalars)}
    for name in BYTE_FIELDS:
        out[f"{name}_data"] = d[f"{name}_data"]
    out["gen_pairs"] = d["gen_pairs"]
    return out


def flowbatch_to_host_dict(fb: FlowBatch) -> Dict[str, np.ndarray]:
    """FlowBatch → packed dict of host numpy arrays (see
    :func:`pack_batch`)."""
    d: Dict[str, np.ndarray] = {
        "ep_ids": fb.ep_ids, "peer_ids": fb.peer_ids,
        "dports": fb.dports, "protos": fb.protos,
        "directions": fb.directions, "l7_types": fb.l7_types,
        "kafka_api_key": fb.kafka_api_key,
        "kafka_api_version": fb.kafka_api_version,
        "kafka_client": fb.kafka_client,
        "kafka_topic": fb.kafka_topic,
        "gen_proto": fb.gen_proto,
        "gen_pairs": fb.gen_pairs,
    }
    for name in BYTE_FIELDS:
        data, lengths, valid = getattr(fb, name)
        d[f"{name}_data"] = data
        d[f"{name}_len"] = lengths
        d[f"{name}_valid"] = valid
    return pack_batch(d)


# ---------------------------------------------------------- blob transport --
#: transfer order of the single-blob transport (:func:`pack_blob_host`,
#: ``verdict.unpack_blob``): every per-batch array, one host→device copy
_BLOB_KEYS = ("scalars", "path_data", "method_data", "host_data",
              "headers_data", "qname_data", "l7g_data", "gen_pairs")


def pack_blob_host(host: Dict[str, np.ndarray]):
    """Packed layout → ONE contiguous u8 blob ([B, W]) plus a static
    layout tuple of (key, "i32" | "u8", columns) for ``unpack_blob``."""
    parts, layout = [], []
    for k in _BLOB_KEYS:
        a = host[k]
        if a.dtype == np.int32:
            u8 = np.ascontiguousarray(a).view(np.uint8).reshape(
                len(a), -1)
            layout.append((k, "i32", int(a.shape[1])))
        else:
            u8 = np.ascontiguousarray(a, dtype=np.uint8)
            layout.append((k, "u8", int(a.shape[1])))
        parts.append(u8)
    return np.concatenate(parts, axis=1), tuple(layout)


# -------------------------------------------------------- capture records --
def encode_records(rec, cfg: Optional[EngineConfig] = None,
                   fmax: int = 4) -> FlowBatch:
    """FlowBatch straight from binary base records: L3/L4 tuples by
    format, so every string field encodes empty (one 32-byte pad
    block, the width an all-empty batch gets from encode_strings)."""
    cfg = cfg or EngineConfig()
    B = len(rec)
    ingress = rec["direction"] == int(TrafficDirection.INGRESS)
    ep = np.where(ingress, rec["dst_identity"],
                  rec["src_identity"]).astype(np.int32)
    peer = np.where(ingress, rec["src_identity"],
                    rec["dst_identity"]).astype(np.int32)

    def empty_field(width: int):
        width = min(width, 32)
        return (np.zeros((B, width), dtype=np.uint8),
                np.zeros(B, dtype=np.int32),
                np.ones(B, dtype=bool))

    return FlowBatch(
        ep_ids=ep, peer_ids=peer,
        dports=rec["dport"].astype(np.int32),
        protos=rec["proto"].astype(np.int32),
        directions=rec["direction"].astype(np.int32),
        l7_types=rec["l7_type"].astype(np.int32),
        path=empty_field(max(cfg.http_path_buckets)),
        method=empty_field(cfg.http_method_len),
        host=empty_field(cfg.http_host_len),
        headers=empty_field(1024),
        qname=empty_field(cfg.dns_name_len),
        kafka_api_key=np.zeros(B, dtype=np.int32),
        kafka_api_version=np.zeros(B, dtype=np.int32),
        kafka_client=np.full(B, -2, dtype=np.int32),
        kafka_topic=np.full(B, -2, dtype=np.int32),
        gen_proto=np.full(B, -2, dtype=np.int32),
        gen_pairs=np.full((B, fmax), -2, dtype=np.int32),
        l7g=empty_field(cfg.l7g_len),
    )


def _gather_table_field(blob: np.ndarray, offsets: np.ndarray,
                        idx: np.ndarray, max_len: int,
                        pad_multiple: int = 32,
                        fixed_len: Optional[int] = None):
    """Vectorized :func:`encode_strings` over a capture string table:
    ``idx`` [B] references strings in (offsets, blob) → the same
    (data [B, L] u8, lengths, valid) triple; ``fixed_len`` pins L."""
    uniq, inv = np.unique(idx, return_inverse=True)
    starts = offsets[uniq].astype(np.int64)
    lens = offsets[uniq + 1].astype(np.int64) - starts
    if fixed_len is not None:
        L = fixed_len
    else:
        longest = int(lens.max()) if len(lens) else 1
        L = min(max_len,
                max(pad_multiple, -(-max(longest, 1) // pad_multiple)
                    * pad_multiple))
    valid_u = lens <= L
    lens_u = np.minimum(lens, L)
    pos = np.arange(L, dtype=np.int64)
    gidx = starts[:, None] + pos[None, :]
    mask = pos[None, :] < lens_u[:, None]
    if blob.size:
        data_u = np.where(mask, blob[np.minimum(gidx, blob.size - 1)], 0)
    else:
        data_u = np.zeros((len(uniq), L), dtype=np.uint8)
    return (data_u.astype(np.uint8, copy=False)[inv],
            lens_u.astype(np.int32)[inv], valid_u[inv])


def _intern_lut(offsets: np.ndarray, blob: np.ndarray, idx: np.ndarray,
                intern: Dict[str, int]) -> np.ndarray:
    """String-table indices → engine intern ids (-2 = unknown),
    resolving each UNIQUE string once."""
    uniq, inv = np.unique(idx, return_inverse=True)
    lut = np.full(len(uniq), -2, dtype=np.int32)
    for j, u in enumerate(uniq):
        s = blob[int(offsets[u]):int(offsets[u + 1])].tobytes()
        lut[j] = intern.get(s.decode("utf-8", "replace"), -2)
    return lut[inv]


def _pad_rows_pow2(*arrays):
    """Pad each array's FIRST axis (same length across arrays) with
    zeros up to the next power of two. Padded rows must never be
    referenced (valid-masked or absent from every id stream)."""
    n = len(arrays[0])
    S_pad = 1 << max(0, (max(1, n) - 1)).bit_length()
    if S_pad == n:
        return arrays if len(arrays) > 1 else arrays[0]
    out = tuple(
        np.concatenate(
            [a, np.zeros((S_pad - n,) + a.shape[1:], dtype=a.dtype)])
        for a in arrays)
    return out if len(out) > 1 else out[0]


#: a v3 capture's GENERIC section needs the protocol frontends
_GENERIC_SECTION = ("replaying a v3 capture's GENERIC section needs the "
                    "protocol frontends (queue 1, Q5)")


def encode_l7_records(rec, l7, offsets, blob,
                      interns: Dict[str, Dict],
                      cfg: Optional[EngineConfig] = None,
                      widths: Optional[Dict[str, int]] = None,
                      gen=None) -> FlowBatch:
    """FlowBatch straight from a v2 capture (base records + L7
    sidecar): string fields gather from the capture's string table,
    kafka strings resolve to engine intern ids. Chunked callers pass
    whole-capture ``widths`` (:func:`capture_field_widths`)."""
    if gen is not None:
        raise NotImplementedError(_GENERIC_SECTION)
    cfg = cfg or EngineConfig()
    B = len(rec)
    ingress = rec["direction"] == int(TrafficDirection.INGRESS)
    ep = np.where(ingress, rec["dst_identity"],
                  rec["src_identity"]).astype(np.int32)
    peer = np.where(ingress, rec["src_identity"],
                    rec["dst_identity"]).astype(np.int32)
    fmax = int(interns.get("gen_fmax", 4))
    w = widths or {}

    def field(name: str, cap: int):
        return _gather_table_field(blob, offsets, l7[name], cap,
                                   fixed_len=w.get(name))

    return FlowBatch(
        ep_ids=ep, peer_ids=peer,
        dports=rec["dport"].astype(np.int32),
        protos=rec["proto"].astype(np.int32),
        directions=rec["direction"].astype(np.int32),
        l7_types=rec["l7_type"].astype(np.int32),
        path=field("path", max(cfg.http_path_buckets)),
        method=field("method", cfg.http_method_len),
        host=field("host", cfg.http_host_len),
        headers=field("headers", 1024),
        qname=field("qname", cfg.dns_name_len),
        kafka_api_key=l7["kafka_api_key"].astype(np.int32),
        kafka_api_version=l7["kafka_api_version"].astype(np.int32),
        kafka_client=_intern_lut(offsets, blob, l7["kafka_client"],
                                 interns.get("client_id", {})),
        kafka_topic=_intern_lut(offsets, blob, l7["kafka_topic"],
                                interns.get("topic", {})),
        gen_proto=np.full(B, -2, dtype=np.int32),
        gen_pairs=np.full((B, fmax), -2, dtype=np.int32),
        l7g=(np.zeros((B, 32), dtype=np.uint8),
             np.zeros(B, dtype=np.int32),
             np.ones(B, dtype=bool)),
    )


#: column order of the [B, 15] row block ``verdict_step_capture``
#: consumes (:meth:`CaptureFeaturizer.encode_rows`)
_ROW_COLS = (
    "ep_ids", "peer_ids", "dports", "protos", "directions", "l7_types",
    "kafka_api_key", "kafka_api_version", "kafka_client", "kafka_topic",
    "path_row", "method_row", "host_row", "headers_row", "qname_row",
)


class CaptureFeaturizer:
    """Chunked-replay featurizer over one v2 capture: the string work
    is paid ONCE per file, then each chunk is pure row gathers. Every
    string each field references is encoded into a padded per-field
    table ([S_used → pow2, L] u8 + lengths + valid), kafka strings
    resolve to engine intern ids, and a string-table → row LUT is
    built per field."""

    _FIELD_CAPS = (("path", "http_path_buckets"),
                   ("method", "http_method_len"),
                   ("host", "http_host_len"),
                   ("headers", None),      # fixed 1024 cap
                   ("qname", "dns_name_len"))

    def __init__(self, l7, offsets, blob, interns: Dict[str, Dict],
                 cfg: Optional[EngineConfig] = None, gen=None):
        if gen is not None:
            raise NotImplementedError(_GENERIC_SECTION)
        self.widths = capture_field_widths(l7, offsets, cfg)
        n_strings = len(offsets) - 1
        self.tables: Dict[str, tuple] = {}
        self.luts: Dict[str, np.ndarray] = {}
        for field, _ in self._FIELD_CAPS:
            used = np.unique(l7[field])
            data, lens, valid = _gather_table_field(
                blob, offsets, used, self.widths[field],
                fixed_len=self.widths[field])
            # string count bucketed to a power of two, as the
            # reference does; the padded rows are invalid and no LUT
            # entry points at them
            data, lens, valid = _pad_rows_pow2(data, lens, valid)
            lut = np.zeros(n_strings, dtype=np.int32)
            lut[used] = np.arange(len(used), dtype=np.int32)
            self.tables[field] = (data, lens, valid)
            self.luts[field] = lut
        for col, key in (("kafka_client", "client_id"),
                         ("kafka_topic", "topic")):
            used = np.unique(l7[col])
            ids = _intern_lut(offsets, blob, used, interns.get(key, {}))
            lut = np.full(n_strings, -2, dtype=np.int32)
            lut[used] = ids
            self.luts[col] = lut

    def encode_rows(self, rec, l7) -> np.ndarray:
        """Chunk → ONE [B, 15] int32 block: per-flow scalars plus
        per-field ROW indices into the staged table match words."""
        rec = np.asarray(rec)
        B = len(rec)
        out = np.empty((B, len(_ROW_COLS)), dtype=np.int32)
        col = {c: i for i, c in enumerate(_ROW_COLS)}
        ingress = rec["direction"] == int(TrafficDirection.INGRESS)
        out[:, col["ep_ids"]] = np.where(
            ingress, rec["dst_identity"], rec["src_identity"])
        out[:, col["peer_ids"]] = np.where(
            ingress, rec["src_identity"], rec["dst_identity"])
        out[:, col["dports"]] = rec["dport"]
        out[:, col["protos"]] = rec["proto"]
        out[:, col["directions"]] = rec["direction"]
        out[:, col["l7_types"]] = rec["l7_type"]
        out[:, col["kafka_api_key"]] = l7["kafka_api_key"]
        out[:, col["kafka_api_version"]] = l7["kafka_api_version"]
        out[:, col["kafka_client"]] = \
            self.luts["kafka_client"][l7["kafka_client"]]
        out[:, col["kafka_topic"]] = \
            self.luts["kafka_topic"][l7["kafka_topic"]]
        for name, _ in self._FIELD_CAPS:
            out[:, col[f"{name}_row"]] = self.luts[name][l7[name]]
        return out
