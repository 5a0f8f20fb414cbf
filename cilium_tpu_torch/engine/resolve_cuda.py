"""KR: the group-space resolve of the fused verdict step as one CUDA
launch (``csrc/resolve_groups.cu``), and its plain PyTorch version.

The reference leaves the resolve of ``fused_verdict_core`` (the HTTP,
DNS, kafka, generic and frontend families in rule-signature group
space, down to ``_combine_l7_match``) to XLA, which fuses it; in plain
PyTorch it is some 190 launches a batch, so the port gives it a
hand-written kernel.

Both versions take the batch's raw ``ms["ruleset"]`` (clamped here as
the plain code clamps it), its l7-type lane, its fields' match words
``(path, method, host, headers, qname[, l7g])``, the path-group words,
the four kafka columns and the ``(gen_proto, gen_pairs)`` block or
None, and return ``(l7_ok, l7_log_http, l7_match)``: bool, bool and
int32 lanes of the batch. :func:`resolve_groups` dispatches on where
the tensors lie: CPU tensors go to :func:`resolve_groups_plain`, CUDA
tensors to :func:`resolve_groups_cuda`, which launches the kernel (a
row a thread) or raises.
"""

from __future__ import annotations

import array

import torch

from cilium_tpu_torch.core.flow import L7Type
from cilium_tpu_torch.engine import _build

KERNEL = _build.KERNELS["KR"]


def resolve_groups_plain(arrays, ruleset, l7t, words, gwords, kafka_cols,
                         gen_cols=None):
    """The resolve in plain PyTorch: ``fused_verdict_core``'s body down
    to ``_combine_l7_match``."""
    from cilium_tpu_torch.engine.megakernel import (
        _fused_l7_dns,
        _fused_l7_frontend,
        _fused_l7_generic,
        _fused_l7_http,
        _fused_l7_kafka,
    )
    from cilium_tpu_torch.engine.verdict import _combine_l7_match

    # ms["ruleset"] is -1 where no entry won: clip before gathering
    # (JAX clamps out-of-range gathers, torch faults on them)
    ruleset = ruleset.clamp(0, arrays["rs_http_mask"].shape[0] - 1).long()
    http_ok, l7_log_http, http_win = _fused_l7_http(
        arrays, ruleset, words, gwords, l7t)
    kafka_ok, kafka_win = _fused_l7_kafka(arrays, ruleset, kafka_cols, l7t)
    dns_ok, dns_win = _fused_l7_dns(arrays, ruleset, words[4], l7t)
    l7_ok = http_ok | kafka_ok | dns_ok
    gen_ok = gen_win = None
    if gen_cols is not None:
        gen_ok, gen_win = _fused_l7_generic(arrays, ruleset, gen_cols, l7t)
        l7_ok = l7_ok | gen_ok
    fe_ok = fe_win = None
    if len(words) > 5 and gen_cols is not None and "fe_lane" in arrays:
        fe_ok, fe_win = _fused_l7_frontend(arrays, ruleset, words[5],
                                           gen_cols[1], l7t)
        l7_ok = l7_ok | fe_ok
    l7_match = _combine_l7_match(
        (http_ok, http_win), (kafka_ok, kafka_win), (dns_ok, dns_win),
        (gen_ok, gen_win) if gen_ok is not None else None,
        fe=(fe_ok, fe_win) if fe_ok is not None else None)
    return l7_ok, l7_log_http, l7_match


def _column(t, B, what):
    """An int32 [B] lane, read in place at its stride."""
    _build.cuda_check(t, torch.int32, what)
    if t.dim() != 1 or t.shape[0] != B:
        raise _build.KernelArgumentError(f"resolve_groups: {what} must be "
                                         f"[{B}], got {tuple(t.shape)}")
    return [t.data_ptr(), t.stride(0)]


def resolve_groups_cuda(arrays, ruleset, l7t, words, gwords, kafka_cols,
                        gen_cols=None):
    """KR on the card; same contract as :func:`resolve_groups_plain`.
    Needs the staged plan's tables (``rp_*``). Reads no device value. The per-row
    lanes are read in place at their strides, and so are the words'
    rows where their columns are adjacent; a table or words of any
    other layout is copied, and the copy kept until the launch."""
    keep = []

    def words_arg(t, what):
        _build.cuda_check(t, torch.int32, what)
        if t.dim() != 2 or t.shape[0] != B or t.shape[1] < 1:
            raise _build.KernelArgumentError(
                f"resolve_groups: {what} must be [{B}, NW >= 1], got "
                f"{tuple(t.shape)}")
        if t.shape[1] > 1 and t.stride(1) != 1:
            t = t.contiguous()
            keep.append(t)
        return [t.data_ptr(), t.stride(0), t.shape[1]]

    def table(name, dtype=torch.int32):
        t = arrays[name]
        _build.cuda_check(t, dtype, name)
        if not t.is_contiguous():
            t = t.contiguous()
            keep.append(t)
        return t

    B = ruleset.shape[0] if ruleset.dim() == 1 else -1
    args = _column(ruleset, B, "ruleset") + _column(l7t, B, "l7t")
    for what, c in zip(("kafka_api_key", "kafka_api_version",
                        "kafka_client", "kafka_topic"), kafka_cols):
        args += _column(c, B, what)
    has_gen = gen_cols is not None
    has_fe = has_gen and len(words) > 5 and "fe_lane" in arrays
    if has_gen:
        args += _column(gen_cols[0], B, "gen_proto")
        args += words_arg(gen_cols[1], "gen_pairs")
    else:
        args += [0, 0, 0, 0, 0]
    _, method_w, host_w, hdr_w, dns_w = words[:5]
    for what, w in (("method", method_w), ("host", host_w),
                    ("headers", hdr_w), ("qname", dns_w),
                    ("path groups", gwords)):
        args += words_arg(w, what)
    args += words_arg(words[5], "l7g") if has_fe else [0, 0, 0]

    g_hdr, g_log, gmask = (table("rp_g_hdr"), table("rp_g_log"),
                           table("rp_rs_gmask"))
    args += [table("rp_g_method").data_ptr(), table("rp_g_host").data_ptr(),
             g_hdr.data_ptr(), g_log.data_ptr(), gmask.data_ptr(),
             table("rp_g_anypath", torch.bool).data_ptr(),
             table("rp_g_haslog", torch.bool).data_ptr(),
             *g_hdr.shape, g_log.shape[1], gmask.shape[1], gmask.shape[0]]
    dmask = table("rp_dns_rsmask")
    if dmask.shape[1] != dns_w.shape[1]:
        raise _build.KernelArgumentError(
            f"resolve_groups: qname words {tuple(dns_w.shape)} do not "
            f"match rp_dns_rsmask {tuple(dmask.shape)}")
    args += [dmask.data_ptr(), dmask.shape[1], dmask.shape[0]]
    k_api, kmask = table("rp_k_apikey_mask"), table("rp_rs_kmask")
    args += [k_api.data_ptr(), table("rp_k_version").data_ptr(),
             table("rp_k_client").data_ptr(), table("rp_k_topic").data_ptr(),
             kmask.data_ptr(), k_api.shape[0], kmask.shape[1],
             kmask.shape[0]]
    if has_gen:
        pairs, genmask = table("rp_gen_pairs"), table("rp_rs_genmask")
        args += [table("rp_gen_proto").data_ptr(), pairs.data_ptr(),
                 genmask.data_ptr(), *pairs.shape, genmask.shape[1],
                 genmask.shape[0]]
    else:
        args += [0] * 7
    if has_fe:
        pairs, femask = table("rp_fe_pairs"), table("rp_rs_femask")
        args += [table("rp_fe_family").data_ptr(),
                 table("rp_fe_lane").data_ptr(), pairs.data_ptr(),
                 femask.data_ptr(), *pairs.shape, femask.shape[1],
                 femask.shape[0]]
    else:
        args += [0] * 8

    dev = ruleset.device
    l7_ok = torch.empty(B, dtype=torch.bool, device=dev)
    l7_log = torch.empty(B, dtype=torch.bool, device=dev)
    l7_match = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        packed = array.array("q", (
            *args, B, arrays["rs_http_mask"].shape[0],
            int(L7Type.HTTP), int(L7Type.KAFKA), int(L7Type.DNS),
            int(L7Type.GENERIC),
            l7_ok.data_ptr(), l7_log.data_ptr(), l7_match.data_ptr(),
            _build.stream_ptr(ruleset.get_device())))
        KERNEL.launch(packed.buffer_info()[0])
    return l7_ok, l7_log, l7_match


def resolve_groups(arrays, ruleset, l7t, words, gwords, kafka_cols,
                   gen_cols=None):
    """Dispatch on the tensors' device: plain on CPU, KR on CUDA."""
    fn = resolve_groups_cuda if ruleset.is_cuda else resolve_groups_plain
    return fn(arrays, ruleset, l7t, words, gwords, kafka_cols,
              gen_cols=gen_cols)
