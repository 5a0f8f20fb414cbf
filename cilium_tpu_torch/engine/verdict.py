"""Device half of the verdict pipeline (counterpart of the reference's
``engine/verdict.py``): the bit helpers of the resolve, the per-rule
resolve (``_verdict_core``) and the precedence/auth/audit assembly, the
legacy (unfused) step ``verdict_step``, the packed-batch and single-blob
layouts, the capture-table staging and capture step
(``stage_capture_tables``, ``verdict_step_capture``), and
:class:`TorchVerdictEngine`, which stages a compiled policy on a device
and runs the fused step (``engine/megakernel.py``) or the legacy step
over flow batches. The capture-replay session is ``engine/replay.py``.

Every uint32 word of the reference (match words, ruleset masks, group
masks) is carried as an int32 bit pattern: torch's uint32 lacks most
operators. Bitwise and/or/compare-with-zero are the same on both
readings; the helpers below avoid the few places where they differ
(sums, right shifts of words with bit 31 set, argmax over bool).

The host half (``CompiledPolicy``, ``encode_flows``, ``pack_batch``)
is ``engine/compiled.py``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from cilium_tpu_torch.core.config import EngineConfig
from cilium_tpu_torch.core.device import DeviceLike, resolve_device
from cilium_tpu_torch.core.flow import Flow, L7Type, Verdict
from cilium_tpu_torch.engine.compiled import (
    BYTE_FIELDS,
    _ROW_COLS,
    _SCALAR_COLS,
    CaptureFeaturizer,
    CompiledPolicy,
    encode_flows,
    encode_l7_records,
    encode_records,
    flowbatch_to_host_dict,
    pack_blob_host,
)
from cilium_tpu_torch.engine.search import lower_bound
from cilium_tpu_torch.runtime import faults as _faults

#: the ten output lanes of a verdict batch
OUTPUT_LANES = ("verdict", "allowed", "l3l4_allowed", "redirect", "l7_ok",
                "l7_log", "match_spec", "ruleset", "auth_required",
                "l7_match")

#: ``authed_pairs`` value that opts out of drop-until-authed (the
#: reference's ``cilium_tpu.auth.AUTH_UNENFORCED``, its own object here)
AUTH_UNENFORCED = object()

#: masked-min sentinel for the attribution winners
_ATTR_NONE = 0x7FFFFFFF

#: fires at every device dispatch of the engine and of the serving
#: session (``IncrementalSession.serve_ids``)
DISPATCH_POINT = _faults.register_point(
    "engine.dispatch", "device dispatch in TorchVerdictEngine")


@functools.lru_cache(maxsize=None)
def _pow2_words(device: torch.device) -> torch.Tensor:
    """The 32 single-bit words as int32 bit patterns (bit 31 = -2^31),
    made once per device: a fresh host→device copy per call would
    stall the host on every batch."""
    one = torch.ones(32, dtype=torch.int32, device=device)
    return one << torch.arange(32, dtype=torch.int32, device=device)


# -------------------------------------------------------------- bit helpers
def _rule_bit(words: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """words [B, NW] int32 words, lanes [R, ...] int32 (-1 =
    unconstrained) → bool [B, R, ...]."""
    # lane -1 gives word -1: JAX clamps the gather, torch would index
    # from the end — clip explicitly
    word_idx = (lanes >> 5).clamp(0, words.shape[1] - 1).long()
    bit_idx = lanes & 31
    w = words[:, word_idx]                               # [B, R, ...]
    # arithmetic shift keeps bit 0 exact for words with bit 31 set
    bits = ((w >> bit_idx[None]) & 1) != 0
    return bits | (lanes < 0)[None]


def _bools_to_words(bools: torch.Tensor, n_words: int) -> torch.Tensor:
    """[B, R] bool → [B, n_words] int32 bitmap (R ≤ 32*n_words). The
    reference sums shifted bits in uint32; a torch sum of int32
    promotes to int64 and bit 31 would overflow, so OR the 32 planes."""
    B, R = bools.shape
    pad = n_words * 32 - R
    if pad:
        bools = torch.nn.functional.pad(bools, (0, pad))
    b = bools.reshape(B, n_words, 32)
    planes = torch.where(b, _pow2_words(bools.device),
                         torch.zeros((), dtype=torch.int32,
                                     device=bools.device))
    from cilium_tpu_torch.engine.nfa_kernel import _or_reduce

    return _or_reduce(planes, 2)


def _first_lane(words: torch.Tensor) -> torch.Tensor:
    """[B, W] int32 masked match words → the lowest set LANE index per
    row (int32; -1 when no bit is set)."""
    nz = words != 0
    any_ = nz.any(dim=1)
    # torch refuses argmax over bool: take it over int8 (first max wins)
    i0 = nz.to(torch.int8).argmax(dim=1)
    w = torch.gather(words, 1, i0[:, None])[:, 0]
    lsb = w & (~w + 1)
    # no population_count in torch: find the single set bit by
    # comparing with the 32 powers of two
    bit = (lsb[:, None] == _pow2_words(words.device)[None, :]) \
        .to(torch.int8).argmax(dim=1)
    return torch.where(any_, (i0 * 32 + bit).to(torch.int32),
                       torch.full_like(w, -1))


def _masked_min(matched: torch.Tensor, values: torch.Tensor
                ) -> torch.Tensor:
    """min over ``values[r]`` where ``matched[b, r]`` (and the value is
    non-negative) → [B] int32, -1 when nothing matched."""
    v = values[None, :].to(torch.int32)
    big = torch.where(matched & (v >= 0), v,
                      torch.full_like(v, _ATTR_NONE))
    m = big.min(dim=1).values
    return torch.where(m == _ATTR_NONE, torch.full_like(m, -1), m)


def _combine_l7_match(http, kafka, dns, gen=None) -> torch.Tensor:
    """Per-family (ok, win) pairs → ONE [B] int32 attribution lane
    (families are mutually exclusive per flow, so this is a select)."""
    http_ok, http_win = http
    kafka_ok, kafka_win = kafka
    dns_ok, dns_win = dns
    out = torch.where(http_ok, http_win,
                      torch.where(kafka_ok, kafka_win,
                                  torch.where(dns_ok, dns_win,
                                              torch.full_like(dns_win,
                                                              -1))))
    if gen is not None:
        gen_ok, gen_win = gen
        out = torch.where((out < 0) & gen_ok, gen_win, out)
    return out.to(torch.int32)


def _words_bit(words: torch.Tensor, r_idx: torch.Tensor) -> torch.Tensor:
    """words [B, W], rule indices [R] → bool [B, R] membership."""
    return ((words[:, r_idx >> 5] >> (r_idx & 31)) & 1) != 0


def _kafka_predicate(apikey_mask, version, client, topic, kafka_cols):
    """[B, R] kafka conjunction of exact matches (shared by the per-rule
    and the group-space resolves)."""
    k_api, k_ver, k_cli, k_top = kafka_cols
    ak = k_api.clamp(0, 31)
    am = apikey_mask[None, :]
    # api_key < 0 is the unknown-role sentinel: it matches only
    # api-key-unconstrained predicates
    return (((am == 0) | ((((am >> ak[:, None]) & 1) != 0)
                          & (k_api >= 0)[:, None]))
            & ((version[None, :] < 0) | (version[None, :] == k_ver[:, None]))
            & ((client[None, :] < 0) | (client[None, :] == k_cli[:, None]))
            & ((topic[None, :] < 0) | (topic[None, :] == k_top[:, None])))


def _pair_subset_ok(gen_pairs: torch.Tensor, grp: torch.Tensor
                    ) -> torch.Tensor:
    """gen_pairs [B, F], required pairs [R, Km] (-1 pad) → bool [B, R]:
    every required pair id is among the flow's."""
    have = (gen_pairs[:, None, None, :] == grp[None, :, :, None]).any(-1)
    return torch.where(grp[None] < 0, torch.ones_like(have), have).all(-1)


def _l7_kafka(arrays, ruleset, kafka_cols, l7t):
    """Per-rule kafka matching → (ruleset-any [B], winner [B] int32);
    the winner is in group space when the plan staged
    ``rp_k_rule_group``."""
    k_ok = _kafka_predicate(arrays["kafka_apikey_mask"],
                            arrays["kafka_version"], arrays["kafka_client"],
                            arrays["kafka_topic"], kafka_cols)
    kafka_mask = arrays["rs_kafka_mask"][ruleset]
    k_words = _bools_to_words(k_ok, kafka_mask.shape[1])
    ok = (((k_words & kafka_mask) != 0).any(dim=1)
          & (l7t == int(L7Type.KAFKA)))
    Rk = k_ok.shape[1]
    r_idx = torch.arange(Rk, device=k_ok.device)
    values = (arrays["rp_k_rule_group"] if "rp_k_rule_group" in arrays
              else r_idx.to(torch.int32))
    return ok, _masked_min(k_ok & _words_bit(kafka_mask, r_idx), values)


def _l7_generic(arrays, ruleset, gen_cols, l7t):
    """Per-rule generic pair-subset matching → (ruleset-any, winner)."""
    gen_proto, gen_pairs = gen_cols
    proto = arrays["gen_rule_proto"]
    g_ok = (_pair_subset_ok(gen_pairs, arrays["gen_rule_pairs"])
            & (proto[None, :] == gen_proto[:, None])
            & (proto >= 0)[None, :])
    gen_mask = arrays["rs_gen_mask"][ruleset]
    g_words = _bools_to_words(g_ok, gen_mask.shape[1])
    ok = (((g_words & gen_mask) != 0).any(dim=1)
          & (l7t == int(L7Type.GENERIC)))
    Rg = g_ok.shape[1]
    r_idx = torch.arange(Rg, device=g_ok.device)
    values = (arrays["rp_gen_rule_group"] if "rp_gen_rule_group" in arrays
              else r_idx.to(torch.int32))
    return ok, _masked_min(g_ok & _words_bit(gen_mask, r_idx), values)


def _assemble_verdict(arrays, ms, l7_ok, l7_log_http, auth_src_dst,
                      batch, l7_match=None):
    """Precedence + auth + audit assembly → the ten output lanes."""
    allowed = ms["allowed"] & (l7_ok | ~ms["redirect"])
    auth_required = ms["auth_required"]
    if "auth_pairs" in batch:
        # drop-until-authed: a winning allow that demands auth forwards
        # only if (src, dst) is in the lex-sorted [P, 2] authed table
        src, dst = auth_src_dst
        pairs = batch["auth_pairs"]
        _, authed = lower_bound((pairs[:, 0], pairs[:, 1]), (src, dst))
        allowed = allowed & (~auth_required | authed)
    audit = ms.get("audit", torch.zeros_like(ms["allowed"]))
    if "audit_mode" in arrays:
        audit = audit | arrays["audit_mode"]
    deny_code = torch.where(audit, int(Verdict.AUDIT), int(Verdict.DROPPED))
    verdict = torch.where(
        allowed,
        torch.where(ms["redirect"], int(Verdict.REDIRECTED),
                    int(Verdict.FORWARDED)),
        deny_code).to(torch.int32)
    if l7_match is None:
        l7_match = torch.full(l7_ok.shape, -1, dtype=torch.int32,
                              device=allowed.device)
    return {
        "verdict": verdict,
        "allowed": allowed,
        "l3l4_allowed": ms["allowed"],
        "redirect": ms["redirect"],
        "l7_ok": l7_ok,
        "l7_log": l7_log_http & allowed & ms["redirect"],
        "match_spec": ms["match_spec"],
        "ruleset": ms["ruleset"],
        "auth_required": ms["auth_required"],
        "l7_match": l7_match.to(torch.int32),
    }


def _verdict_core(arrays, ms, l7t, words, kafka_cols, auth_src_dst,
                  batch, gen_cols=None):
    """The per-rule resolve: per-family rule conjunctions →
    ruleset-any → the shared assembly. The back half of
    :func:`verdict_step`, of :func:`verdict_step_capture` without a
    staged plan, and of the fused step when its plan degenerated.

    ``words`` = (path_w, method_w, host_w, hdr_w, dns_w) match words;
    ``kafka_cols`` = (api_key, api_version, client, topic);
    ``auth_src_dst`` = (src, dst) for the authed-pairs check;
    ``gen_cols`` = (gen_proto, gen_pairs) or None when the caller's
    format carries no generic records (v2 captures)."""
    ruleset = ms["ruleset"].clamp(
        0, arrays["rs_http_mask"].shape[0] - 1).long()
    path_w, method_w, host_w, hdr_w, dns_w = words[:5]

    # HTTP: conjunction of per-field pattern bits per rule; the header
    # lanes [R, H] broadcast through _rule_bit to [B, R, H]
    rule_ok = (_rule_bit(path_w, arrays["http_path_lane"])
               & _rule_bit(method_w, arrays["http_method_lane"])
               & _rule_bit(host_w, arrays["http_host_lane"]))
    rule_ok = rule_ok & _rule_bit(hdr_w, arrays["http_header_lanes"]) \
        .all(dim=2)
    # a FAIL header match whose secret is unresolvable kills the rule
    if "http_rule_dead" in arrays:
        rule_ok = rule_ok & ~arrays["http_rule_dead"][None, :]
    http_mask = arrays["rs_http_mask"][ruleset]            # [B, Wh]
    rule_words = _bools_to_words(rule_ok, http_mask.shape[1])
    http_ok = (((rule_words & http_mask) != 0).any(dim=1)
               & (l7t == int(L7Type.HTTP)))
    r_idx = torch.arange(rule_ok.shape[1], device=rule_ok.device)
    in_set = _words_bit(http_mask, r_idx)
    # attribution winner: group space when the plan staged the
    # rule → group map, else the lowest matched rule index
    http_win = _masked_min(
        rule_ok & in_set,
        arrays["rp_rule_group"] if "rp_rule_group" in arrays
        else r_idx.to(torch.int32))

    # LOG-action header matches raise l7_log (padding lanes read True
    # through _rule_bit, so ~bits masks them)
    if "http_log_lanes" in arrays:
        log_bits = _rule_bit(hdr_w, arrays["http_log_lanes"])
        log_fail = (~log_bits).any(dim=2)                  # [B, R]
        l7_log_http = (rule_ok & in_set & log_fail).any(dim=1) & http_ok
    else:
        l7_log_http = torch.zeros_like(http_ok)

    kafka_ok, kafka_win = _l7_kafka(arrays, ruleset, kafka_cols, l7t)

    # DNS: one qname-automaton lane per rule; attribution in lane space
    dns_lane = arrays["dns_lane"]
    d_ok = _rule_bit(dns_w, dns_lane) & (dns_lane >= 0)[None, :]
    dns_mask = arrays["rs_dns_mask"][ruleset]
    d_words = _bools_to_words(d_ok, dns_mask.shape[1])
    dns_ok = (((d_words & dns_mask) != 0).any(dim=1)
              & (l7t == int(L7Type.DNS)))
    dr_idx = torch.arange(d_ok.shape[1], device=d_ok.device)
    dns_win = _masked_min(d_ok & _words_bit(dns_mask, dr_idx), dns_lane)

    l7_ok = http_ok | kafka_ok | dns_ok
    gen_pair = None
    if gen_cols is not None:
        gen_ok, gen_win = _l7_generic(arrays, ruleset, gen_cols, l7t)
        l7_ok = l7_ok | gen_ok
        gen_pair = (gen_ok, gen_win)
    l7_match = _combine_l7_match((http_ok, http_win),
                                 (kafka_ok, kafka_win),
                                 (dns_ok, dns_win), gen_pair)
    return _assemble_verdict(arrays, ms, l7_ok, l7_log_http,
                             auth_src_dst, batch, l7_match=l7_match)


# ------------------------------------------------------------ batch layout
def unpack_batch(packed: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Packed layout → flat names; ``*_valid`` columns come back bool."""
    scalars = packed["scalars"]
    out = {}
    for i, col in enumerate(_SCALAR_COLS):
        v = scalars[:, i]
        out[col] = (v != 0) if col.endswith("_valid") else v
    for name in BYTE_FIELDS:
        out[f"{name}_data"] = packed[f"{name}_data"]
    out["gen_pairs"] = packed["gen_pairs"]
    if "auth_pairs" in packed:
        out["auth_pairs"] = packed["auth_pairs"]
    return out


def batch_field(batch: Dict[str, torch.Tensor], name: str):
    return (batch[f"{name}_data"], batch[f"{name}_len"],
            batch[f"{name}_valid"])


def unpack_blob(blob: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    """Inverse of ``compiled.pack_blob_host`` on the device: column
    slices of the [B, W] u8 blob rebuild the packed dict. An int32
    part's slice is not contiguous; it is copied before it is re-read
    as int32."""
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for k, kind, ncols in layout:
        w = ncols * 4 if kind == "i32" else ncols
        part = blob[:, off:off + w]
        out[k] = part.contiguous().view(torch.int32) if kind == "i32" \
            else part
        off += w
    return out


def verdict_step(arrays: Dict[str, torch.Tensor],
                 batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The legacy (unfused) step: mapstate lookup, the five byte scans
    on the gather arm (kernel KD on the card), and the per-rule
    resolve, whatever plan or arm is staged — as the reference's
    ``verdict_step`` does."""
    from cilium_tpu_torch.engine.megakernel import (
        fused_scan_field,
        kafka_columns,
        policy_lookup,
        scan_fields,
    )

    b = unpack_batch(batch) if "scalars" in batch else batch
    ms, auth_src_dst = policy_lookup(
        arrays, b["ep_ids"], b["peer_ids"], b["dports"], b["protos"],
        b["directions"])
    words = tuple(fused_scan_field(arrays, prefix, *batch_field(b, field))[0]
                  for prefix, field in scan_fields(arrays))
    return _verdict_core(arrays, ms, b["l7_types"], words,
                         kafka_columns(b), auth_src_dst, b,
                         gen_cols=(b["gen_proto"], b["gen_pairs"]))


# ------------------------------------------------------- capture tables
#: (field, policy-array prefix) pairs of the staged string tables
_TABLE_FIELDS = (("path", "path"), ("method", "method"),
                 ("host", "host"), ("headers", "hdr"),
                 ("qname", "dns"))


def _stage_tables_step(arrays: Dict[str, torch.Tensor],
                       tables: Dict[str, tuple], impl: str = "gather"
                       ) -> Dict[str, torch.Tensor]:
    """The five per-field table scans on the ``impl`` arm (KD, or K2
    for the oblivious arm) → {field: match words [S, NW]} with invalid
    rows zeroed. With a resolve plan staged (``rp_path_gaccept``) the
    path table also yields bank-ORed GROUP words, ``"path_groups"``."""
    from cilium_tpu_torch.engine.megakernel import fused_scan_field

    tw: Dict[str, torch.Tensor] = {}
    for field, prefix in _TABLE_FIELDS:
        want_groups = field == "path" and "rp_path_gaccept" in arrays
        words, gwords = fused_scan_field(
            arrays, prefix, *tables[field], dfa_impl=impl,
            want_groups=want_groups)
        tw[field] = words
        if want_groups:
            tw["path_groups"] = gwords
    return tw


def stage_capture_tables(engine: "TorchVerdictEngine",
                         feat: CaptureFeaturizer
                         ) -> Dict[str, torch.Tensor]:
    """Scan each per-field string table through its banked DFA ONCE and
    keep the match words on the device; replay chunks then only GATHER
    words by row index (:func:`verdict_step_capture`), so the scan cost
    scales with unique strings, not flows."""
    tables = {}
    for field, _ in _TABLE_FIELDS:
        data, lens, valid = feat.tables[field]
        tables[field] = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(engine.device)
            for a in (data, lens, valid))
    return _stage_tables_step(engine._arrays, tables, impl=engine._dfa_impl)


def verdict_step_capture(arrays: Dict[str, torch.Tensor],
                         table_words: Dict[str, torch.Tensor],
                         batch: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """The verdict step of capture replay: match words come from the
    staged per-file tables, gathered by row index, then the fused
    group-space resolve (plan staged) or the per-rule resolve.

    ``batch["rows"]`` is a [B, 15] row block (``_ROW_COLS``); with
    ``batch["idx"]`` it is the capture's UNIQUE-row table and ``idx``
    the per-flow row ids, expanded here by a device gather."""
    from cilium_tpu_torch.engine import megakernel as _mk
    from cilium_tpu_torch.engine.memo import as_index

    rows = batch["rows"]
    idx = batch.get("idx")
    if idx is not None:
        rows = rows.index_select(0, as_index(idx))
    col = {c: i for i, c in enumerate(_ROW_COLS)}

    def c(name):
        return rows[:, col[name]]

    ms, auth_src_dst = _mk.policy_lookup(
        arrays, c("ep_ids"), c("peer_ids"), c("dports"), c("protos"),
        c("directions"))

    def words_of(table, name):
        return table_words[table].index_select(0, c(name).long())

    words = (words_of("path", "path_row"), words_of("method", "method_row"),
             words_of("host", "host_row"),
             words_of("headers", "headers_row"),
             words_of("qname", "qname_row"))
    kafka_cols = (c("kafka_api_key"), c("kafka_api_version"),
                  c("kafka_client"), c("kafka_topic"))
    if "rp_g_method" in arrays and "path_groups" in table_words:
        return _mk.fused_verdict_core(
            arrays, ms, c("l7_types"), words,
            words_of("path_groups", "path_row"), kafka_cols,
            auth_src_dst, batch)
    return _verdict_core(arrays, ms, c("l7_types"), words, kafka_cols,
                         auth_src_dst, batch)


def batch_to_device(host: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """Packed host dict (``flowbatch_to_host_dict``) → tensors."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host.items()}


# ------------------------------------------------------------------ engine
class TorchVerdictEngine:
    """A compiled policy staged on a device, with its verdict step: the
    fused step (``engine/megakernel.fused_verdict_step``) by default,
    the legacy :func:`verdict_step` under ``cfg.kernel_impl="legacy"``
    — bit-equal either way.

    ``device`` defaults to ``cuda`` and the constructor raises when
    CUDA is absent; pass ``device="cpu"`` to run the plain versions.
    The arm of the dense-planned fields and of the capture-table scans
    is read once, here, from ``CILIUM_TPU_DFA_IMPL`` as in the
    reference: ``pallas`` picks the oblivious arm (kernel K2), anything
    else the gather arm (kernel KD)."""

    def __init__(self, policy: CompiledPolicy, device: DeviceLike = None,
                 cfg: Optional[EngineConfig] = None):
        from cilium_tpu_torch.engine import megakernel as _mk
        from cilium_tpu_torch.engine.dfa_kernel import resolve_impl
        from cilium_tpu_torch.weights import arrays_from_reference

        self.policy = policy
        self.device = resolve_device(device)
        self.cfg = cfg or EngineConfig()
        self._dfa_impl = resolve_impl()
        #: True when some staged entry demands authentication
        self.needs_auth = bool(np.any(policy.arrays["ms_auth"]))
        #: field → scan impl of the staged step ({} on the legacy step)
        self.impl_plan: Dict[str, str] = {}
        self.kernel_report: Dict[str, Dict] = {}
        extra: Dict[str, np.ndarray] = {}
        if getattr(self.cfg, "kernel_impl", "auto") == "legacy":
            self._step = verdict_step
        else:
            impl_plan, extra, report = _mk.plan_for_engine(
                policy, self.cfg, self.device)
            self.impl_plan = impl_plan
            self.kernel_report = report
            policy.kernel_plan = dict(impl_plan)
            self._step = functools.partial(
                _mk.fused_verdict_step,
                impl_plan=tuple(sorted(impl_plan.items())),
                dfa_impl=self._dfa_impl)
        self._arrays = arrays_from_reference({**policy.arrays, **extra},
                                             self.device)
        self._attribution = None

    @property
    def attribution(self):
        """:class:`~cilium_tpu_torch.engine.attribution.AttributionMap`
        over this engine's policy, built once."""
        if self._attribution is None:
            from cilium_tpu_torch.engine.attribution import AttributionMap

            self._attribution = AttributionMap.from_policy(self.policy)
        return self._attribution

    def verdict_batch_arrays(self, batch: Dict[str, torch.Tensor]):
        _faults.maybe_fail(DISPATCH_POINT)
        return self._step(self._arrays, batch)

    def _stage_auth(self, batch: Dict[str, torch.Tensor],
                    authed_pairs) -> None:
        """Stage the authed-pairs table for drop-until-authed. Fail
        closed: when the policy demands auth and no table was given, an
        EMPTY sentinel table is staged so auth-demanding flows DROP;
        ``AUTH_UNENFORCED`` opts out explicitly."""
        if not self.needs_auth or authed_pairs is AUTH_UNENFORCED:
            return
        if authed_pairs is None:
            # sentinel row that never matches (identities are >= 0)
            authed_pairs = np.full((1, 2), -1, dtype=np.int32)
        batch["auth_pairs"] = torch.from_numpy(
            np.ascontiguousarray(authed_pairs, dtype=np.int32)
        ).to(self.device)

    def _run(self, batch: Dict[str, torch.Tensor], authed_pairs,
             outputs: Optional[Sequence[str]] = None
             ) -> Dict[str, np.ndarray]:
        """Stage auth, run the step, read the lanes back as numpy."""
        self._stage_auth(batch, authed_pairs)
        out = self.verdict_batch_arrays(batch)
        if outputs is not None:
            out = {k: out[k] for k in outputs}
        return {k: v.cpu().numpy() for k, v in out.items()}

    def verdict_flows(self, flows: Sequence[Flow],
                      cfg: Optional[EngineConfig] = None,
                      authed_pairs: Optional[np.ndarray] = None,
                      outputs: Optional[Sequence[str]] = None
                      ) -> Dict[str, np.ndarray]:
        """Featurize, stage, verdict and read back one batch of flows
        → {lane: numpy array}."""
        fb = encode_flows(flows, self.policy.kafka_interns, cfg)
        return self._run(batch_to_device(flowbatch_to_host_dict(fb),
                                         self.device), authed_pairs, outputs)

    def verdict_flows_blob(self, flows: Sequence[Flow],
                           cfg: Optional[EngineConfig] = None,
                           authed_pairs: Optional[np.ndarray] = None,
                           outputs: Optional[Sequence[str]] = None
                           ) -> Dict[str, np.ndarray]:
        """:meth:`verdict_flows` over the single-blob transport: ONE
        host→device copy per batch instead of seven
        (``compiled.pack_blob_host``), unpacked on the device."""
        fb = encode_flows(flows, self.policy.kafka_interns, cfg)
        blob, layout = pack_blob_host(flowbatch_to_host_dict(fb))
        batch = unpack_blob(torch.from_numpy(blob).to(self.device), layout)
        return self._run(batch, authed_pairs, outputs)

    def verdict_records(self, rec, cfg: Optional[EngineConfig] = None,
                        authed_pairs: Optional[np.ndarray] = None
                        ) -> Dict[str, np.ndarray]:
        """Binary capture base records → verdicts, no per-flow Python
        objects."""
        fmax = int(self.policy.kafka_interns.get("gen_fmax", 4))
        fb = encode_records(rec, cfg, fmax=fmax)
        return self._run(batch_to_device(flowbatch_to_host_dict(fb),
                                         self.device), authed_pairs)

    def verdict_l7_records(self, rec, l7, offsets, blob,
                           cfg: Optional[EngineConfig] = None,
                           authed_pairs: Optional[np.ndarray] = None,
                           widths: Optional[Dict[str, int]] = None,
                           gen=None) -> Dict[str, np.ndarray]:
        """A v2 capture's records (base records + L7 sidecar) → full
        HTTP/Kafka/DNS verdicts. Chunked callers pass whole-capture
        ``widths`` (``ingest.binary.capture_field_widths``)."""
        fb = encode_l7_records(rec, l7, offsets, blob,
                               self.policy.kafka_interns, cfg,
                               widths=widths, gen=gen)
        return self._run(batch_to_device(flowbatch_to_host_dict(fb),
                                         self.device), authed_pairs)
