"""Batched L3/L4 policy-map lookup (counterpart of the reference's
``engine/mapstate_kernel.py``).

``pack_mapstate`` is the reference's host code, copied. The lookup is
plain PyTorch: in the reference it is XLA code, not a Pallas kernel,
so it has no hand-written counterpart here. Key layout and precedence
follow the reference (sorted 3-word keys, deny wins, most-specific
allow wins, default by enforcement).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from cilium_tpu_torch.core.flow import TrafficDirection
from cilium_tpu_torch.engine.search import lower_bound
from cilium_tpu_torch.policy.mapstate import MapState


@dataclasses.dataclass
class PackedMapState:
    """Sorted key/entry tensors (host-side numpy; loader stages to device)."""

    key_w0: np.ndarray      # [N] int32 policy TEMPLATE id (see tmpl_ids)
    key_w1: np.ndarray      # [N] int32 peer identity
    key_w2: np.ndarray      # [N] int32 dir|proto|plen|port
    is_deny: np.ndarray     # [N] bool
    ruleset_id: np.ndarray  # [N] int32, -1 = no L7 restriction
    auth: np.ndarray        # [N] bool — entry demands mutual auth
    # per-endpoint-identity enforcement: sorted ids + 3-bit flags
    enf_ids: np.ndarray     # [M] int32 sorted endpoint identities
    enf_flags: np.ndarray   # [M, 3] bool (ingress, egress, audit)
    #: [M] int32 policy-template id per enf_ids row: identities whose
    #: resolved entry sets are IDENTICAL share one template's table
    #: rows — the distillery dedup (pkg/policy/distillery.go) applied
    #: to the packed tensor. At clustermesh scale (10k identities ×
    #: ~1k entries) this shrinks the key table ~100× (10M → distinct
    #: templates), which is the difference between the probe's binary
    #: search walking a 40 MB random-access table and a cache-resident
    #: one. None = w0 holds raw endpoint identities (legacy direct
    #: construction in tests).
    tmpl_ids: np.ndarray = None
    #: [P] int32 DISTINCT port prefix lengths present, sorted
    #: descending (always contains 16 and 0) — the lookup's port
    #: probe set; its SHAPE is static per compile, so a ruleset that
    #: introduces a new prefix length recompiles once
    port_plens: np.ndarray = None

    def __post_init__(self):
        if self.port_plens is None:
            self.port_plens = np.array([16, 0], dtype=np.int32)

    @property
    def n_entries(self) -> int:
        return len(self.key_w0)


def _pack_w2(direction: int, proto: int, dport: int,
             plen: int = 16) -> int:
    return (direction << 29) | (proto << 21) | (plen << 16) | dport


def pack_mapstate(
    per_identity: Dict[int, MapState],
    ruleset_of_entry=None,
) -> PackedMapState:
    """Pack per-endpoint-identity MapStates into one sorted table.

    ``ruleset_of_entry(ep_id, key, entry) -> int`` maps an entry's L7
    rule set to a global ruleset id (assigned by the loader); None or a
    return of -1 means no L7 restriction.
    """
    rows: List[Tuple[int, int, int, bool, int, bool]] = []
    enf: List[Tuple[int, bool, bool, bool]] = []
    tmpl_of_identity: List[int] = []
    tmpl_index: Dict[tuple, int] = {}
    plens = {16, 0}
    #: per-call memo keyed by the MapState's OBJECT identity: at fleet
    #: scale many identities share one resolved state object, and
    #: rebuilding its row tuple per identity is the packing hot spot.
    #: The per_identity dict keeps every ms alive for the call, so
    #: id() keys cannot be recycled mid-pack.
    ms_memo: Dict[int, tuple] = {}
    for ep_id, ms in sorted(per_identity.items()):
        enf.append((ep_id, ms.ingress_enforced, ms.egress_enforced,
                    getattr(ms, "audit", False)))
        cached = ms_memo.get(id(ms))
        if cached is None:
            ep_rows = []
            ep_plens = set()
            for key, entry in ms.entries.items():
                rid = -1
                if ruleset_of_entry is not None and entry.is_redirect:
                    rid = ruleset_of_entry(ep_id, key, entry)
                plen = getattr(key, "port_plen", None)
                if plen is None:
                    plen = 0 if key.dport == 0 else 16
                ep_plens.add(plen)
                ep_rows.append((
                    key.identity,
                    _pack_w2(key.direction, key.proto, key.dport, plen),
                    entry.is_deny,
                    rid,
                    getattr(entry, "auth_required", False),
                ))
            cached = ms_memo[id(ms)] = (tuple(sorted(ep_rows)),
                                        frozenset(ep_plens))
        fp, ep_plens = cached
        plens |= ep_plens
        # distillery dedup: identities with identical verdict-relevant
        # entry sets share one TEMPLATE; the table stores each template
        # once and the lookup indirects identity → template. rid is
        # content-keyed by the caller (ruleset_of dedups rule-id
        # sets), so shared entries share rulesets too.
        tmpl = tmpl_index.get(fp)
        if tmpl is None:
            tmpl = tmpl_index[fp] = len(tmpl_index)
            for r in fp:
                rows.append((tmpl,) + r)
        tmpl_of_identity.append(tmpl)
    if not rows:
        # sentinel row that can never match (template ids are >= 0)
        rows.append((-1, -1, -1, False, -1, False))
    arr = np.array([r[:3] for r in rows], dtype=np.int64)
    order = np.lexsort((arr[:, 2], arr[:, 1], arr[:, 0]))
    arr = arr[order]
    deny = np.array([rows[i][3] for i in order], dtype=bool)
    rid = np.array([rows[i][4] for i in order], dtype=np.int32)
    auth = np.array([rows[i][5] for i in order], dtype=bool)
    if not enf:
        enf.append((-1, False, False, False))
        tmpl_of_identity.append(-1)
    # tmpl_ids must stay aligned with the SORTED enf table
    enf_order = sorted(range(len(enf)), key=lambda i: enf[i])
    enf = [enf[i] for i in enf_order]
    tmpl_of_identity = [tmpl_of_identity[i] for i in enf_order]
    return PackedMapState(
        key_w0=arr[:, 0].astype(np.int32),
        key_w1=arr[:, 1].astype(np.int32),
        key_w2=arr[:, 2].astype(np.int32),
        is_deny=deny,
        ruleset_id=rid,
        auth=auth,
        enf_ids=np.array([e[0] for e in enf], dtype=np.int32),
        enf_flags=np.array([[e[1], e[2], e[3]] for e in enf],
                           dtype=bool),
        port_plens=np.array(sorted(plens, reverse=True),
                            dtype=np.int32),
        tmpl_ids=np.array(tmpl_of_identity, dtype=np.int32),
    )


def _lower_bound3(
    k0: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
    p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lower bound over 3-word sorted keys (shared engine/search.py)."""
    return lower_bound((k0, k1, k2), (p0, p1, p2))


#: match_spec value reported for an explicit deny verdict (above the
#: maximum allow specificity 34+32+1=67)
DENY_SPEC = 68


def mapstate_lookup(
    key_w0: torch.Tensor, key_w1: torch.Tensor, key_w2: torch.Tensor,
    is_deny: torch.Tensor, ruleset_id: torch.Tensor,
    enf_ids: torch.Tensor, enf_flags: torch.Tensor,
    ep_ids: torch.Tensor,      # [B] endpoint identity (policy owner)
    peer_ids: torch.Tensor,    # [B]
    dports: torch.Tensor,      # [B]
    protos: torch.Tensor,      # [B]
    directions: torch.Tensor,  # [B]
    auth: torch.Tensor = None,  # [N] bool entry auth flags (optional)
    port_plens: torch.Tensor = None,  # [P] int32 desc (default [16, 0])
    tmpl_ids: torch.Tensor = None,  # [M] int32 identity→template
) -> Dict[str, torch.Tensor]:
    """Batched verdict lookup; the same output dict as the reference
    (``allowed``, ``denied``, ``redirect``, ``ruleset``, ``match_spec``,
    ``auth_required``, ``audit``), each [B]."""
    from cilium_tpu_torch.policy.mapstate import ICMP_TYPE_BIT

    dev = ep_ids.device
    i32 = torch.int32
    if port_plens is None:
        port_plens = torch.tensor([16, 0], dtype=i32, device=dev)
    B = ep_ids.shape[0]
    P = port_plens.shape[0]
    # probe grid, descending specificity: peer → port prefix → proto
    # ([1, 0] built on the device: a host tensor would cost a copy and
    # a stall per batch)
    one_zero = 1 - torch.arange(2, dtype=i32, device=dev)
    peer_sel = one_zero.repeat_interleave(P * 2)
    plen = port_plens.to(i32).repeat_interleave(2).repeat(2)
    proto_sel = one_zero.repeat(2 * P)
    pmask = torch.where(plen == 0, torch.zeros_like(plen),
                        (torch.full_like(plen, 0xFFFF) << (16 - plen))
                        & 0xFFFF)
    specs = peer_sel * 34 + plen * 2 + proto_sel

    is_icmp = (protos == 1) | (protos == 58)
    dports = torch.where(is_icmp, dports | ICMP_TYPE_BIT, dports)

    # identity → enforcement row; searchsorted can return M, which
    # JAX's gather clamps and torch's faults on — clip explicitly
    M = enf_ids.shape[0]
    eidx = torch.searchsorted(enf_ids, ep_ids.contiguous()).clamp(0, M - 1)
    eknown = enf_ids[eidx] == ep_ids
    if tmpl_ids is None:
        subject = ep_ids
    else:
        subject = torch.where(eknown, tmpl_ids[eidx],
                              torch.full_like(ep_ids, -1))

    p0 = subject[:, None].expand(B, plen.shape[0])
    p1 = peer_ids[:, None] * peer_sel[None, :]
    w2 = ((directions[:, None] << 29)
          | ((protos[:, None] * proto_sel[None, :]) << 21)
          | (plen[None, :] << 16)
          | (dports[:, None] & pmask[None, :]))
    idx, found = _lower_bound3(
        key_w0, key_w1, key_w2,
        p0.reshape(-1), p1.reshape(-1), w2.reshape(-1))
    idx = idx.reshape(B, -1)
    found = found.reshape(B, -1)
    l4_only_probe = (plen > 0) & (proto_sel == 0)
    found = found & ~(is_icmp[:, None] & l4_only_probe[None, :])

    deny_hit = found & is_deny[idx]
    denied = deny_hit.any(dim=1)
    allow_hit = found & ~is_deny[idx]
    any_allow = allow_hit.any(dim=1)
    # argmax over bool is refused by torch: take it over int8, which
    # returns the first maximal index like jnp.argmax
    first_allow = allow_hit.to(torch.int8).argmax(dim=1)
    win_idx = torch.gather(idx, 1, first_allow[:, None])[:, 0]
    minus1 = torch.full_like(ep_ids, -1)
    ruleset = torch.where(any_allow, ruleset_id[win_idx], minus1)
    match_spec = torch.where(
        denied, torch.full_like(ep_ids, DENY_SPEC),
        torch.where(any_allow, specs[first_allow], minus1))

    enforced = torch.where(
        directions == int(TrafficDirection.INGRESS),
        enf_flags[eidx, 0], enf_flags[eidx, 1]) & eknown
    allowed = ~denied & (any_allow | ~enforced)
    redirect = allowed & any_allow & (ruleset >= 0)
    if auth is None:
        auth_required = torch.zeros_like(allowed)
    else:
        auth_required = allowed & any_allow & auth[win_idx]
    return {
        "allowed": allowed,
        "denied": denied,
        "redirect": redirect,
        "ruleset": ruleset.to(i32),
        "match_spec": match_spec.to(i32),
        "auth_required": auth_required,
        "audit": enf_flags[eidx, 2] & eknown,
    }
