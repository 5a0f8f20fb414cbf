"""The fused verdict step (counterpart of the reference's
``engine/megakernel.py``).

One call per verdict batch: the L3/L4 mapstate lookup, the per-field
byte scans (five, and the protocol-frontend ``l7g`` field when the
policy has frontend rules), and the priority resolve in rule-signature GROUP
space. The host half — ``build_resolve_plan`` and its dedup helpers,
``plan_for_engine``'s per-field arm pick, ``_nfa_group_plane`` — is the
reference's code, copied, so the staged arrays are byte-equal. The
device half is PyTorch; the scans run on the hand-written kernels (KD,
K1, K2) and the group-space resolve on KR (``resolve_cuda``) for CUDA
tensors, and on their plain versions for CPU tensors.

A policy whose plan degenerated (no ``rp_*`` arrays) resolves per
rule through the shared ``verdict._verdict_core``, as the reference's
does. The ``autotune`` arm measures the dense scan against the bitset
NFA on each field's bank tensors at staging, as the reference does, and
caches one pick per shape key; on ``cuda`` it times with CUDA events.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cilium_tpu_torch.core.flow import L7Type
from cilium_tpu_torch.engine import nfa_kernel, resolve_cuda
from cilium_tpu_torch.runtime.metrics import (
    KERNEL_AUTOTUNE_PICKS,
    KERNEL_AUTOTUNE_SECONDS,
    METRICS,
)
from cilium_tpu_torch.runtime.tracing import PHASE_DEVICE, TRACER

#: scan implementations the plan picks between
IMPL_DENSE = "dfa-dense"
IMPL_NFA = "nfa-bitset"

#: past this many signature groups the factored resolve stops paying
#: and the plan is skipped (the per-rule resolve takes over)
GROUP_CAP = 2048

#: (prefix, batch-field) pairs of the five scanned string fields
SCAN_FIELDS = (("path", "path"), ("method", "method"),
               ("host", "host"), ("hdr", "headers"), ("dns", "qname"))

#: the l7g (protocol-frontend) field stack, present only on policies
#: with frontend rules — words slot 5 by convention
L7G_FIELD = ("l7g", "l7g")

def scan_fields(arrays) -> tuple:
    """The policy's scanned fields, in ``words``-tuple order: the five
    string fields, plus the l7g field when the policy staged a frontend
    automaton (``l7g_trans``)."""
    if "l7g_trans" in arrays:
        return SCAN_FIELDS + (L7G_FIELD,)
    return SCAN_FIELDS


# ------------------------------------------------------------ plan build --
def _mask_bits(mask: np.ndarray, n: int) -> np.ndarray:
    """[RS, W] uint32 bitmap → [RS, n] bool membership matrix."""
    RS, W = mask.shape
    shifts = np.arange(32, dtype=np.uint32)
    bits = ((mask[:, :, None] >> shifts[None, None, :]) & 1).astype(bool)
    return bits.reshape(RS, W * 32)[:, :n]


def _dedup_kafka_groups(arrays: Dict[str, np.ndarray],
                        n_kafka: int) -> Tuple[Dict, int]:
    """Kafka rules deduped to distinct-predicate groups: a kafka rule
    is a pure conjunction of exact matches (apikey mask / version /
    client / topic), so identical predicates across rules — the common
    case when many rulesets reference the same ACL — collapse to one
    group whose ruleset membership is the OR of its members'. Exact by
    boolean algebra: ruleset-any over rules == ruleset-any over
    distinct predicates with OR'd membership."""
    RS = arrays["rs_kafka_mask"].shape[0]
    member = _mask_bits(arrays["rs_kafka_mask"], max(1, n_kafka))
    groups: Dict[tuple, set] = {}
    rule_keys: Dict[int, tuple] = {}
    for r in range(n_kafka):
        rss = np.nonzero(member[:, r])[0]
        if not len(rss):
            continue  # unreferenced rule can never fire
        key = (int(arrays["kafka_apikey_mask"][r]),
               int(arrays["kafka_version"][r]),
               int(arrays["kafka_client"][r]),
               int(arrays["kafka_topic"][r]))
        rule_keys[r] = key
        groups.setdefault(key, set()).update(int(x) for x in rss)
    G = max(1, len(groups))
    Gw = (G + 31) // 32
    # the empty/dummy slot carries an impossible predicate spelled as
    # "never a member": zero membership words keep it inert
    k_mask = np.zeros(G, np.uint32)
    k_ver = np.full(G, -1, np.int32)
    k_cli = np.full(G, -1, np.int32)
    k_top = np.full(G, -1, np.int32)
    rs_kmask = np.zeros((RS, Gw), np.uint32)
    group_of_key: Dict[tuple, int] = {}
    for g, (key, rss) in enumerate(groups.items()):
        group_of_key[key] = g
        k_mask[g], k_ver[g], k_cli[g], k_top[g] = key
        gbit = np.uint32(1 << (g % 32))
        for rs in rss:
            rs_kmask[rs, g // 32] |= gbit
    # rule → group map: the attribution lane's bridge between the
    # legacy per-rule resolve and the fused group space (a matched
    # rule's group is matched and vice versa — exact, so the lane is
    # bit-equal across arms). Sized to the BUCKETED rule table (the
    # legacy conjunction runs over padded rule lanes); padding = -1.
    k_rule_group = np.full(
        max(1, int(arrays["kafka_apikey_mask"].shape[0])), -1,
        np.int32)
    for r, key in rule_keys.items():
        k_rule_group[r] = group_of_key[key]
    return {"rp_k_apikey_mask": k_mask, "rp_k_version": k_ver,
            "rp_k_client": k_cli, "rp_k_topic": k_top,
            "rp_rs_kmask": rs_kmask,
            "rp_k_rule_group": k_rule_group}, len(groups)


def _dedup_gen_groups(arrays: Dict[str, np.ndarray],
                      n_gen: int) -> Tuple[Dict, int]:
    """Generic (l7proto) rules deduped to distinct (proto, pair-id
    SET) groups — pair matching is subset semantics, so order and
    duplicates inside a rule's pair row are irrelevant to the
    predicate identity."""
    RS = arrays["rs_gen_mask"].shape[0]
    member = _mask_bits(arrays["rs_gen_mask"], max(1, n_gen))
    groups: Dict[tuple, set] = {}
    rule_keys: Dict[int, tuple] = {}
    for r in range(n_gen):
        if int(arrays["gen_rule_proto"][r]) < 0:
            continue  # proto-less rule is dead by construction
        rss = np.nonzero(member[:, r])[0]
        if not len(rss):
            continue
        pairs = tuple(sorted({int(p)
                              for p in arrays["gen_rule_pairs"][r]
                              if p >= 0}))
        key = (int(arrays["gen_rule_proto"][r]), pairs)
        rule_keys[r] = key
        groups.setdefault(key, set()).update(int(x) for x in rss)
    G = max(1, len(groups))
    Gw = (G + 31) // 32
    Km = max([len(k[1]) for k in groups] + [1])
    g_proto = np.full(G, -1, np.int32)
    g_pairs = np.full((G, Km), -1, np.int32)
    rs_gmask = np.zeros((RS, Gw), np.uint32)
    group_of_key: Dict[tuple, int] = {}
    for g, (key, rss) in enumerate(groups.items()):
        group_of_key[key] = g
        proto, pairs = key
        g_proto[g] = proto
        g_pairs[g, :len(pairs)] = pairs
        gbit = np.uint32(1 << (g % 32))
        for rs in rss:
            rs_gmask[rs, g // 32] |= gbit
    gen_rule_group = np.full(
        max(1, int(arrays["gen_rule_proto"].shape[0])), -1, np.int32)
    for r, key in rule_keys.items():
        gen_rule_group[r] = group_of_key[key]
    return {"rp_gen_proto": g_proto, "rp_gen_pairs": g_pairs,
            "rp_rs_genmask": rs_gmask,
            "rp_gen_rule_group": gen_rule_group}, len(groups)


def _dedup_fe_groups(arrays: Dict[str, np.ndarray],
                     n_fe: int) -> Tuple[Dict, int]:
    """Protocol-frontend rules deduped to distinct (family, scan
    lane, enum pair-id SET) predicate groups — pair matching is
    subset semantics (order/duplicates inside a rule's pair row are
    irrelevant), so identical predicates across rulesets collapse
    exactly like kafka's columnar groups. Dead rules (unsatisfiable
    scan constraints) never join a group."""
    if "fe_lane" not in arrays:
        return {}, 0
    RS = arrays["rs_fe_mask"].shape[0]
    member = _mask_bits(arrays["rs_fe_mask"], max(1, n_fe))
    groups: Dict[tuple, set] = {}
    rule_keys: Dict[int, tuple] = {}
    for r in range(n_fe):
        if bool(arrays["fe_dead"][r]):
            continue
        rss = np.nonzero(member[:, r])[0]
        if not len(rss):
            continue
        pairs = tuple(sorted({int(p) for p in arrays["fe_pairs"][r]
                              if p >= 0}))
        key = (int(arrays["fe_family"][r]),
               int(arrays["fe_lane"][r]), pairs)
        rule_keys[r] = key
        groups.setdefault(key, set()).update(int(x) for x in rss)
    G = max(1, len(groups))
    Gw = (G + 31) // 32
    Km = max([len(k[2]) for k in groups] + [1])
    g_family = np.full(G, -1, np.int32)
    g_lane = np.full(G, -1, np.int32)
    g_pairs = np.full((G, Km), -1, np.int32)
    rs_fmask = np.zeros((RS, Gw), np.uint32)
    group_of_key: Dict[tuple, int] = {}
    for g, (key, rss) in enumerate(groups.items()):
        group_of_key[key] = g
        g_family[g], g_lane[g] = key[0], key[1]
        g_pairs[g, :len(key[2])] = key[2]
        gbit = np.uint32(1 << (g % 32))
        for rs in rss:
            rs_fmask[rs, g // 32] |= gbit
    fe_rule_group = np.full(
        max(1, int(arrays["fe_lane"].shape[0])), -1, np.int32)
    for r, key in rule_keys.items():
        fe_rule_group[r] = group_of_key[key]
    return {"rp_fe_family": g_family, "rp_fe_lane": g_lane,
            "rp_fe_pairs": g_pairs, "rp_rs_femask": rs_fmask,
            "rp_fe_rule_group": fe_rule_group}, len(groups)


def build_resolve_plan(arrays: Dict[str, np.ndarray], n_http: int,
                       n_dns: int, n_kafka: int = 0,
                       n_gen: int = 0,
                       n_fe: int = 0) -> Optional[Tuple[Dict, Dict]]:
    """Factor the per-rule HTTP conjunction, the DNS lane checks, and
    the kafka/generic predicate tables into group space. Returns
    ``(rp_arrays, meta)`` — ``rp_arrays`` joins
    ``CompiledPolicy.arrays`` (staged to device), ``meta`` stays
    host-side (NFA group-plane construction, observability) — or None
    when the grouping degenerates past :data:`GROUP_CAP`."""
    RS = arrays["rs_http_mask"].shape[0]
    member = _mask_bits(arrays["rs_http_mask"], max(1, n_http))
    groups: Dict[tuple, List[int]] = {}
    for r in range(n_http):
        if arrays["http_rule_dead"][r]:
            continue  # a dead rule can never match (fail closed)
        rss = tuple(np.nonzero(member[:, r])[0].tolist())
        if not rss:
            continue  # not referenced by any ruleset
        hdr = tuple(int(x) for x in arrays["http_header_lanes"][r]
                    if x >= 0)
        log = tuple(int(x) for x in arrays["http_log_lanes"][r]
                    if x >= 0)
        key = (int(arrays["http_method_lane"][r]),
               int(arrays["http_host_lane"][r]),
               hdr, log, rss,
               int(arrays["http_path_lane"][r]) < 0)
        groups.setdefault(key, []).append(r)
    if len(groups) > GROUP_CAP:
        return None

    G = max(1, len(groups))
    Hm = max([len(k[2]) for k in groups] + [1])
    Lm = max([len(k[3]) for k in groups] + [1])
    Gw = (G + 31) // 32
    g_method = np.full(G, -1, np.int32)
    g_host = np.full(G, -1, np.int32)
    g_hdr = np.full((G, Hm), -1, np.int32)
    g_log = np.full((G, Lm), -1, np.int32)
    g_anypath = np.zeros(G, bool)
    g_haslog = np.zeros(G, bool)
    rs_gmask = np.zeros((RS, Gw), np.uint32)
    # global path lane → group bitmap (the group-accept planes of BOTH
    # scan arms derive from this one mapping)
    acc = arrays["path_accept"]                  # [NB, S, W] uint32
    NB, S, W = acc.shape
    NL = NB * 32 * W
    lane_groups = np.zeros((NL, Gw), np.uint32)
    # rule → group map (attribution lane): every live referenced rule
    # belongs to exactly one signature group. Sized to the BUCKETED
    # rule table (the legacy conjunction runs over padded lanes).
    rule_group = np.full(
        max(1, int(arrays["http_path_lane"].shape[0])), -1, np.int32)
    for g, (key, rules) in enumerate(groups.items()):
        meth, host, hdr, log, rss, anypath = key
        g_method[g] = meth
        g_host[g] = host
        g_hdr[g, :len(hdr)] = hdr
        g_log[g, :len(log)] = log
        g_anypath[g] = anypath
        g_haslog[g] = bool(log)
        gbit = np.uint32(1 << (g % 32))
        for rs in rss:
            rs_gmask[rs, g // 32] |= gbit
        for r in rules:
            rule_group[r] = g
        if not anypath:
            for r in rules:
                lane_groups[int(arrays["http_path_lane"][r]),
                            g // 32] |= gbit
    # group-accept plane over the dense path automaton: bit g at state
    # s iff any of g's member patterns accepts at s — an OR of lane
    # bits the subset construction already computed. Computed as ONE
    # batched boolean matmul (lane-hit [NB,S,L] x lane→group-bit
    # [NB,L,G] in float32 BLAS, then re-packed to words): the old
    # per-bank where+reduce allocated [S,L,Gw] temporaries per bank
    # and dominated the 5k-CNP plan rebuild (~2s of the per-update
    # critical path at fleet scale).
    lane_hit = _mask_bits(
        acc.reshape(NB * S, W).astype(np.uint32), 32 * W)  # [NB*S, 32W]
    L = 32 * W
    G_real = len(groups)
    if G_real:
        # lane_groups words → bool [NL, G_real] membership
        lg_bool = _mask_bits(lane_groups, G_real)       # [NL, G]
        hits3 = lane_hit.reshape(NB, S, L).astype(np.float32)
        lg3 = lg_bool.reshape(NB, L, G_real).astype(np.float32)
        gacc_bool = np.matmul(hits3, lg3) > 0.5         # [NB, S, G]
        # pack bit g into word g//32 at bit g%32 (little-endian)
        gb = np.pad(gacc_bool.reshape(NB * S, G_real),
                    ((0, 0), (0, Gw * 32 - G_real)))
        packed = np.packbits(gb.reshape(NB * S, Gw, 32),
                             axis=2, bitorder="little")
        gacc = packed.view(np.uint32).reshape(NB, S, Gw) \
            if packed.flags["C_CONTIGUOUS"] else \
            np.ascontiguousarray(packed).view(np.uint32).reshape(
                NB, S, Gw)
    else:
        gacc = np.zeros((NB, S, Gw), np.uint32)

    # DNS: the per-rule check is a single lane bit, so the whole
    # family collapses to a ruleset → lane-mask any
    dacc = arrays["dns_accept"]                  # [NBd, Sd, Wd]
    NWd = dacc.shape[0] * dacc.shape[2]
    dmem = _mask_bits(arrays["rs_dns_mask"], max(1, n_dns))
    dns_rsmask = np.zeros((arrays["rs_dns_mask"].shape[0], NWd),
                          np.uint32)
    dl = arrays["dns_lane"]
    for r in range(n_dns):
        if dl[r] < 0:
            continue
        lane = int(dl[r])
        for rs in np.nonzero(dmem[:, r])[0]:
            dns_rsmask[rs, lane // 32] |= np.uint32(1 << (lane % 32))

    # kafka/generic ride the same factored path (distinct-predicate
    # groups, no accept planes needed — their predicates are columnar
    # exact matches): one fused launch resolves EVERY protocol family
    # in group space
    k_arrays, k_groups = _dedup_kafka_groups(arrays, n_kafka)
    gen_arrays, gen_groups = _dedup_gen_groups(arrays, n_gen)
    fe_arrays, fe_groups = _dedup_fe_groups(arrays, n_fe)
    if len(groups) + k_groups + gen_groups + fe_groups > GROUP_CAP:
        return None

    rp = {
        "rp_g_method": g_method, "rp_g_host": g_host,
        "rp_g_hdr": g_hdr, "rp_g_log": g_log,
        "rp_g_anypath": g_anypath, "rp_g_haslog": g_haslog,
        "rp_rs_gmask": rs_gmask, "rp_path_gaccept": gacc,
        "rp_dns_rsmask": dns_rsmask,
        "rp_rule_group": rule_group,
    }
    rp.update(k_arrays)
    rp.update(gen_arrays)
    rp.update(fe_arrays)
    meta = {"groups": len(groups), "lane_groups": lane_groups,
            "kafka_groups": k_groups, "gen_groups": gen_groups,
            "fe_groups": fe_groups,
            # attribution: group → ordered member rule ids per family
            # (host-side; the explain plane maps a winning group back
            # to concrete rules through these)
            "group_rules": tuple(tuple(int(r) for r in rules)
                                 for rules in groups.values()),
            "kafka_group_rules": tuple(
                tuple(int(r) for r in range(n_kafka)
                      if int(k_arrays["rp_k_rule_group"][r]) == g)
                for g in range(k_groups)),
            "gen_group_rules": tuple(
                tuple(int(r) for r in range(n_gen)
                      if int(gen_arrays["rp_gen_rule_group"][r]) == g)
                for g in range(gen_groups)),
            "fe_group_rules": tuple(
                tuple(int(r) for r in range(n_fe)
                      if int(fe_arrays["rp_fe_rule_group"][r]) == g)
                for g in range(fe_groups)) if fe_groups else ()}
    return rp, meta

# --------------------------------------------------------- fused resolve --
def _fused_l7_http(arrays, ruleset, words, gwords, l7t):
    """Group-space HTTP conjunction: (http_ok, l7_log_http, win) —
    ``win`` is the lowest matched-and-in-ruleset group index (-1 when
    nothing matched)."""
    from cilium_tpu_torch.engine.verdict import (
        _bools_to_words,
        _first_lane,
        _rule_bit,
    )

    _path_w, method_w, host_w, hdr_w, _dns_w = words[:5]
    sig_ok = (_rule_bit(method_w, arrays["rp_g_method"])
              & _rule_bit(host_w, arrays["rp_g_host"]))
    sig_ok = sig_ok & _rule_bit(hdr_w, arrays["rp_g_hdr"]).all(dim=2)
    G = arrays["rp_g_method"].shape[0]
    gbit = _rule_bit(gwords, torch.arange(G, dtype=torch.int32,
                                          device=gwords.device))
    ok_g = sig_ok & (arrays["rp_g_anypath"][None, :] | gbit)
    Gw = arrays["rp_rs_gmask"].shape[1]
    ok_words = _bools_to_words(ok_g, Gw)
    gmask = arrays["rp_rs_gmask"][ruleset]
    http_ok = (((ok_words & gmask) != 0).any(dim=1)
               & (l7t == int(L7Type.HTTP)))
    win = _first_lane(ok_words & gmask)
    # LOG-action lanes ride the group signature: a matching group
    # whose LOG lane mismatched raises l7_log (allow + log)
    log_bits = _rule_bit(hdr_w, arrays["rp_g_log"])           # [B, G, Lm]
    log_fail = (~log_bits).any(dim=2) & arrays["rp_g_haslog"][None, :]
    logw = _bools_to_words(ok_g & log_fail, Gw)
    l7_log_http = ((logw & gmask) != 0).any(dim=1) & http_ok
    return http_ok, l7_log_http, win


def _fused_l7_dns(arrays, ruleset, dns_w, l7t):
    from cilium_tpu_torch.engine.verdict import _first_lane

    dmask = arrays["rp_dns_rsmask"][ruleset]
    ok = (((dns_w & dmask) != 0).any(dim=1)
          & (l7t == int(L7Type.DNS)))
    return ok, _first_lane(dns_w & dmask)


def _fused_l7_kafka(arrays, ruleset, kafka_cols, l7t):
    """Group-space kafka conjunction over the deduped predicate table
    (``rp_k_*``). Returns ``(ok, win)``."""
    from cilium_tpu_torch.engine.verdict import (
        _bools_to_words,
        _first_lane,
        _kafka_predicate,
    )

    g_ok = _kafka_predicate(
        arrays["rp_k_apikey_mask"], arrays["rp_k_version"],
        arrays["rp_k_client"], arrays["rp_k_topic"], kafka_cols)
    gmask = arrays["rp_rs_kmask"][ruleset]
    g_words = _bools_to_words(g_ok, gmask.shape[1])
    ok = (((g_words & gmask) != 0).any(dim=1)
          & (l7t == int(L7Type.KAFKA)))
    return ok, _first_lane(g_words & gmask)


def _fused_l7_generic(arrays, ruleset, gen_cols, l7t):
    """Group-space generic pair-subset matching over the deduped
    (proto, pair-set) predicate table (``rp_gen_*``)."""
    from cilium_tpu_torch.engine.verdict import (
        _bools_to_words,
        _first_lane,
        _pair_subset_ok,
    )

    gen_proto, gen_pairs = gen_cols
    proto = arrays["rp_gen_proto"]
    g_ok = (_pair_subset_ok(gen_pairs, arrays["rp_gen_pairs"])
            & (proto[None, :] == gen_proto[:, None])
            & (proto >= 0)[None, :])
    gmask = arrays["rp_rs_genmask"][ruleset]
    g_words = _bools_to_words(g_ok, gmask.shape[1])
    ok = (((g_words & gmask) != 0).any(dim=1)
          & (l7t == int(L7Type.GENERIC)))
    return ok, _first_lane(g_words & gmask)


def _fused_l7_frontend(arrays, ruleset, l7g_w, gen_pairs, l7t):
    """Group-space protocol-frontend matching over the deduped
    (family, scan lane, enum pair-set) predicate table (``rp_fe_*``):
    one scan-lane bit, one pair-subset check and one family equality
    per distinct predicate."""
    from cilium_tpu_torch.engine.verdict import (
        _bools_to_words,
        _first_lane,
        _pair_subset_ok,
        _rule_bit,
    )

    fam = arrays["rp_fe_family"]
    g_ok = (_rule_bit(l7g_w, arrays["rp_fe_lane"])
            & _pair_subset_ok(gen_pairs, arrays["rp_fe_pairs"])
            & (fam[None, :] == l7t[:, None])
            & (fam >= 0)[None, :])
    gmask = arrays["rp_rs_femask"][ruleset]
    g_words = _bools_to_words(g_ok, gmask.shape[1])
    ok = ((g_words & gmask) != 0).any(dim=1)
    return ok, _first_lane(g_words & gmask)


def fused_verdict_core(arrays, ms, l7t, words, gwords, kafka_cols,
                       auth_src_dst, batch, gen_cols=None):
    """The factored-resolve back half; shares the precedence/auth/audit
    assembly (``verdict._assemble_verdict``). The resolve is
    :func:`resolve_cuda.resolve_groups`: kernel KR on CUDA tensors, its
    plain version on CPU tensors; every family in its deduped predicate
    groups, as the plan always stages them. ``words[5]``, when present,
    is the l7g field's match words. The resolve is span
    ``step.resolve``, the assembly ``step.assemble``."""
    from cilium_tpu_torch.engine.verdict import _assemble_verdict

    # ctlint: disable=jit-purity  # a span: no-op when disarmed; reads no tensor, never waits on the card
    with TRACER.span("step.resolve", PHASE_DEVICE):
        l7_ok, l7_log_http, l7_match = resolve_cuda.resolve_groups(
            arrays, ms["ruleset"], l7t, words, gwords, kafka_cols,
            gen_cols=gen_cols)
    return _assemble_verdict(arrays, ms, l7_ok, l7_log_http,
                             auth_src_dst, batch, l7_match=l7_match)


# ------------------------------------------------------------ fused step --
def _nfa_stack(arrays, prefix: str) -> Dict[str, torch.Tensor]:
    return {k: arrays[f"{prefix}_{k}"]
            for k in ("nfa_follow", "nfa_acc_cls", "nfa_byteclass",
                      "nfa_start", "nfa_accept", "nfa_empty")
            if f"{prefix}_{k}" in arrays}


def fused_scan_field(arrays, prefix: str, data, lengths, valid,
                     impl: str = IMPL_DENSE, dfa_impl: str = "gather",
                     want_groups: bool = False):
    """One field's banked scan under the planned arm → flat match
    words [B, NW] (+ bank-ORed group words [B, Gw])."""
    from cilium_tpu_torch.engine.dfa_kernel import dfa_scan_banked

    if impl == IMPL_NFA:
        stacked = _nfa_stack(arrays, prefix)
        if want_groups:
            stacked["nfa_gaccept"] = arrays[f"{prefix}_nfa_gaccept"]
        out = nfa_kernel.nfa_scan_banked(stacked, data, lengths,
                                         extra_accept=want_groups)
    else:
        out = dfa_scan_banked(
            arrays[f"{prefix}_trans"], arrays[f"{prefix}_byteclass"],
            arrays[f"{prefix}_start"], arrays[f"{prefix}_accept"],
            data, lengths, impl=dfa_impl,
            extra_accept=(arrays["rp_path_gaccept"] if want_groups
                          else None))
    return field_words(out, valid, want_groups)


def field_words(out, valid, want_groups: bool = False):
    """A banked scan's accept words ``[B, NB, W]`` (with the group
    plane's ``[B, NB, Gw]`` as a tuple under ``want_groups``) → flat
    match words [B, NW] (+ bank-ORed group words [B, Gw]), zero on the
    rows whose field is not valid."""
    w3, g3 = out if want_groups else (out, None)
    zero = torch.zeros((), dtype=torch.int32, device=w3.device)
    gwords = None if g3 is None else torch.where(
        valid[:, None], nfa_kernel._or_reduce(g3, 1), zero)
    flat = w3.reshape(w3.shape[0], -1)
    return torch.where(valid[:, None], flat, zero), gwords


def policy_lookup(arrays, ep_ids, peer_ids, dports, protos, directions):
    """The L3/L4 mapstate lookup of one batch, and the (src, dst)
    identity columns the authed-pairs check reads (flows rebuild them
    from (ep, peer) by direction)."""
    from cilium_tpu_torch.core.flow import TrafficDirection
    from cilium_tpu_torch.engine.mapstate_kernel import mapstate_lookup

    ms = mapstate_lookup(
        arrays["ms_key_w0"], arrays["ms_key_w1"], arrays["ms_key_w2"],
        arrays["ms_deny"], arrays["ms_ruleset"],
        arrays["ms_enf_ids"], arrays["ms_enf_flags"],
        ep_ids, peer_ids, dports, protos, directions,
        auth=arrays.get("ms_auth"),
        port_plens=arrays.get("ms_plens"),
        tmpl_ids=arrays.get("ms_tmpl_ids"))
    ingress = directions == int(TrafficDirection.INGRESS)
    src = torch.where(ingress, peer_ids, ep_ids)
    dst = torch.where(ingress, ep_ids, peer_ids)
    return ms, (src, dst)


def kafka_columns(b):
    return (b["kafka_api_key"], b["kafka_api_version"],
            b["kafka_client"], b["kafka_topic"])


def fused_verdict_step(arrays, batch, *, impl_plan=(),
                       dfa_impl: str = "gather"):
    """Full verdict for one batch. ``impl_plan`` is a tuple of
    (field-prefix, impl) picks from :func:`plan_for_engine`; fields
    absent default to the dense arm. ``dfa_impl`` ("gather" /
    "oblivious") is the arm of the dense-planned fields. Without a
    staged plan the resolve runs per rule (``verdict._verdict_core``)."""
    from cilium_tpu_torch.engine.verdict import batch_field, unpack_batch

    b = unpack_batch(batch) if "scalars" in batch else batch
    ms, auth_src_dst = policy_lookup(
        arrays, b["ep_ids"], b["peer_ids"], b["dports"], b["protos"],
        b["directions"])
    plan_on = "rp_g_method" in arrays
    impls = dict(impl_plan)
    words = []
    gwords = None
    for prefix, field in scan_fields(arrays):
        w, gw = fused_scan_field(
            arrays, prefix, *batch_field(b, field),
            impl=impls.get(prefix, IMPL_DENSE), dfa_impl=dfa_impl,
            want_groups=(plan_on and prefix == "path"))
        words.append(w)
        if gw is not None:
            gwords = gw
    return resolve_words(arrays, b, ms, auth_src_dst, words, gwords)


def resolve_words(arrays, b, ms, auth_src_dst, words, gwords):
    """One batch's resolve from its mapstate and its fields' match
    words: factored when the plan is staged (``rp_g_method``), else per
    rule (``verdict._verdict_core``)."""
    from cilium_tpu_torch.engine.verdict import _verdict_core

    gen_cols = (b["gen_proto"], b["gen_pairs"])
    if "rp_g_method" not in arrays:
        return _verdict_core(arrays, ms, b["l7_types"], tuple(words),
                             kafka_columns(b), auth_src_dst, b,
                             gen_cols=gen_cols)
    return fused_verdict_core(arrays, ms, b["l7_types"], tuple(words),
                              gwords, kafka_columns(b), auth_src_dst, b,
                              gen_cols=gen_cols)


# ------------------------------------------------------------- autotune --
#: (shape key) → {"impl", "dense_ms", "nfa_ms"} — process-wide, and
#: carried through the loader's warm-restart snapshot, so a restarted
#: loader keeps its picks without measuring again
_AUTOTUNE_CACHE: Dict[tuple, Dict] = {}


def autotune_cache_snapshot() -> Dict:
    return {repr(k): dict(v) for k, v in _AUTOTUNE_CACHE.items()}


def autotune_cache_adopt(snap: Optional[Dict]) -> None:
    import ast

    if not snap:
        return
    for k, v in snap.items():
        try:
            key = ast.literal_eval(k)
        except (ValueError, SyntaxError):
            continue  # foreign snapshot entry: skip, never crash
        if isinstance(key, tuple):
            # ctlint: disable=unbounded-registry  # keyed by bucketed bank shape x backend (finite)
            _AUTOTUNE_CACHE.setdefault(key, dict(v))


def _shape_key(field: str, trans_shape, nfa_shape, L: int,
               device) -> tuple:
    """The reference's key with the torch device type in place of
    ``jax.default_backend()``: a pick measured on the CPU is never
    adopted for ``cuda``."""
    return (field, tuple(trans_shape), tuple(nfa_shape or ()), int(L),
            torch.device(device).type)


def _time_scan(fn, device, reps: int = 3) -> float:
    """Median seconds of ``reps`` calls after one untimed call: by CUDA
    events on ``cuda``, by the host clock on the CPU."""
    fn()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def autotune_field(field: str, arrays: Dict, prefix: str,
                   nfa_stacked: Optional[Dict], width: int, device,
                   probe_batch: int = 256) -> Dict:
    """Measure the dense arm against the bitset NFA on this field's
    real bank tensors (staged on ``device``) over a synthetic batch of
    the field's width; cached by shape key. The dense arm runs the
    kernel :func:`dfa_kernel.resolve_impl` picks (KD under ``gather``,
    K2 under ``oblivious``), the NFA arm K1."""
    from cilium_tpu_torch.engine.dfa_kernel import (
        dfa_scan_banked,
        resolve_impl,
    )
    from cilium_tpu_torch.weights import stage_array

    trans = arrays[f"{prefix}_trans"]
    key = _shape_key(
        field, np.shape(trans),
        np.shape(nfa_stacked["nfa_follow"]) if nfa_stacked else None,
        width, device)
    hit = _AUTOTUNE_CACHE.get(key)
    if hit is not None:
        return hit
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.integers(0, 128, size=(probe_batch, width),
                                         dtype=np.uint8)).to(device)
    lengths = torch.from_numpy(
        rng.integers(0, width + 1, size=(probe_batch,)).astype(np.int32)
    ).to(device)
    dense = [stage_array(arrays[f"{prefix}_{k}"], device)
             for k in ("trans", "byteclass", "start", "accept")]
    with warnings.catch_warnings():
        # the oblivious arm's fallback warning is the engine's to give
        warnings.simplefilter("ignore", RuntimeWarning)
        dense_ms = _time_scan(lambda: dfa_scan_banked(
            *dense, data, lengths, impl=resolve_impl()), device) * 1e3
    if nfa_stacked is None:
        result = {"impl": IMPL_DENSE, "dense_ms": round(dense_ms, 3),
                  "nfa_ms": None}
    else:
        stacked = {k: stage_array(v, device) for k, v in nfa_stacked.items()
                   if k != "nfa_gaccept"}
        nfa_ms = _time_scan(lambda: nfa_kernel.nfa_scan_banked(
            stacked, data, lengths), device) * 1e3
        result = {"impl": IMPL_NFA if nfa_ms < dense_ms else IMPL_DENSE,
                  "dense_ms": round(dense_ms, 3),
                  "nfa_ms": round(nfa_ms, 3)}
    _AUTOTUNE_CACHE[key] = result
    METRICS.observe(KERNEL_AUTOTUNE_SECONDS, time.perf_counter() - t0)
    METRICS.inc(KERNEL_AUTOTUNE_PICKS,
                labels={"impl": result["impl"], "field": field})
    return result


def _field_widths(cfg) -> Dict[str, int]:
    return {"path": max(cfg.http_path_buckets),
            "method": cfg.http_method_len, "host": cfg.http_host_len,
            "hdr": 1024, "dns": cfg.dns_name_len,
            "l7g": getattr(cfg, "l7g_len", 256)}


# ------------------------------------------------------------- arm plan --
def plan_for_engine(policy, cfg, device) -> Tuple[
        Dict[str, str], Dict[str, np.ndarray], Dict[str, Dict]]:
    """Pick a scan arm per field stack; build the NFA tensors the picks
    need. Returns ``(impl_plan, extra_arrays, report)`` as the
    reference does. ``auto`` treats ``cuda`` as the accelerator with
    the reference's TPU rule: the NFA arm only where the DFA busts the
    128-state budget and the positions fit; dense everywhere else.
    ``autotune`` measures both arms per field (:func:`autotune_field`)."""
    mode = getattr(cfg, "kernel_impl", "auto")
    if mode not in ("auto", "autotune", IMPL_DENSE, IMPL_NFA):
        raise ValueError(f"unknown kernel_impl {mode!r}")
    accel = torch.device(device).type == "cuda"
    degraded = bool(getattr(policy, "bank_quarantined", ()))
    matchers = {"path": policy.path_matcher,
                "method": policy.method_matcher,
                "host": policy.host_matcher,
                "hdr": policy.header_matcher,
                "dns": policy.dns_matcher}
    if getattr(policy, "l7g_matcher", None) is not None:
        # the protocol-frontend automaton: armed like any field
        matchers["l7g"] = policy.l7g_matcher
    widths = _field_widths(cfg)
    lane_groups = (policy.resolve_meta or {}).get("lane_groups") \
        if getattr(policy, "resolve_meta", None) is not None else None
    impl_plan: Dict[str, str] = {}
    extra: Dict[str, np.ndarray] = {}
    report: Dict[str, Dict] = {}

    for prefix, matcher in matchers.items():
        trans = policy.arrays[f"{prefix}_trans"]
        dense_kernel_ok = trans.shape[1] <= 128
        want_nfa = (mode in ("autotune", IMPL_NFA)
                    or (mode == "auto" and not dense_kernel_ok and accel))
        nfa_banks = None
        if not degraded and want_nfa:
            nfa_banks = nfa_kernel.banks_from_dfa(
                matcher.banked, cfg,
                case_insensitive=(prefix == "host"))
        nfa_stacked = None
        if nfa_banks is not None:
            gacc = None
            if prefix == "path" and lane_groups is not None:
                gacc = [_nfa_group_plane(b, i, trans.shape,
                                         policy.arrays, lane_groups)
                        for i, b in enumerate(nfa_banks)]
            nfa_stacked = nfa_kernel.stack_nfa_banks(
                nfa_banks, extra_accept=gacc)
        if mode == "autotune":
            pick = autotune_field(prefix, policy.arrays, prefix,
                                  nfa_stacked, widths[prefix], device)
        else:
            pick = {"impl": IMPL_NFA if want_nfa else IMPL_DENSE,
                    "dense_ms": None, "nfa_ms": None}
        impl = pick["impl"]
        if impl == IMPL_NFA and nfa_stacked is None:
            impl = IMPL_DENSE  # forced arm, ineligible bank → dense
        if impl == IMPL_NFA:
            for k, v in nfa_stacked.items():
                extra[f"{prefix}_{k}"] = v
        impl_plan[prefix] = impl
        report[prefix] = {**pick, "impl": impl,
                          "banks": int(trans.shape[0]),
                          "dfa_states": int(trans.shape[1]),
                          "nfa_positions": (
                              int(nfa_stacked["nfa_follow"].shape[1])
                              if nfa_stacked is not None else None)}
    return impl_plan, extra, report


def _nfa_group_plane(bank, bank_idx: int, trans_shape,
                     arrays, lane_groups: np.ndarray) -> np.ndarray:
    """Group-accept plane for one NFA bank: position → group bitmap,
    derived from the same lane→group mapping as the dense plane."""
    W = bank.accept.shape[1]
    Gw = lane_groups.shape[1]
    P = bank.n_positions
    if P == 0:
        return np.zeros((0, Gw), np.uint32)
    # the global lane space is laid out by the DENSE stack's word
    # width — recompute it from the policy's stacked accept tensor
    W_stack = arrays["path_accept"].shape[2]
    bits = _mask_bits(bank.accept.astype(np.uint32), 32 * W)
    out = np.zeros((P, Gw), np.uint32)
    base = bank_idx * 32 * W_stack
    for lane in range(32 * W):
        gl = base + lane
        if gl >= lane_groups.shape[0]:
            break
        row = lane_groups[gl]
        if not row.any():
            continue
        out |= np.where(bits[:, lane:lane + 1], row[None, :],
                        np.uint32(0))
    return out
