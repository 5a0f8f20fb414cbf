"""Batched backend selection on the device (counterpart of the
reference's ``loadbalancer/kernel.py``).

Analog of ``bpf/lib/lb.h ·lb4_lookup_service`` +
``lb4_select_backend`` (SURVEY.md §2.4): the per-packet lbmap hash
lookups become one batched binary search over the sorted service keys,
an FNV-1a 5-tuple hash, and a gather from the stacked Maglev slab. The
reference leaves these gathers to XLA; here they are plain PyTorch on
the caller's device (no hand-written kernel: a binary search, an
integer hash and three gathers).

The reference's uint32 columns (service and backend addresses, the l4
word, the hash) are int64 here holding the unsigned value
(``weights.lb_arrays_from_reference`` stages them so): staged as int32,
a VIP at or above 128.0.0.0 would turn negative and sort first. The
FNV step wraps at 2**32 in the reference; here it is masked, exact in
int64 since ``(h ^ w) * prime < 2**57``.

The hash recurrence must stay in lockstep with
``loadbalancer.maglev.fnv1a_words`` (the scalar oracle hashes the same
uint32 words); the differential tests drive both on random flows.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from cilium_tpu_torch.engine.search import lower_bound

_FNV_PRIME = 0x01000193
_FNV_BASIS = 0x811C9DC5
_U32 = 0xFFFFFFFF


def _u32(t: torch.Tensor) -> torch.Tensor:
    """Any integer tensor → int64 holding its uint32 value (an int32
    bit pattern and an int64 address both come out unsigned)."""
    return t.to(torch.int64) & _U32


def _fnv1a_words(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """FNV-1a over a list of [B] uint32-valued int64 tensors (one
    symbol per word)."""
    h = torch.full_like(words[0], _FNV_BASIS)
    for w in words:
        h = ((h ^ w) * _FNV_PRIME) & _U32
    return h


def _lower_bound2(k0: torch.Tensor, k1: torch.Tensor,
                  p0: torch.Tensor, p1: torch.Tensor):
    """Lower bound over 2-word sorted keys (shared engine/search.py)."""
    return lower_bound((k0, k1), (p0, p1))


def lb_lookup(
    svc_ip: torch.Tensor,        # [S] int64 (uint32 value), sorted with svc_l4
    svc_l4: torch.Tensor,        # [S] int64 (uint32 value)
    svc_affinity: torch.Tensor,  # [S] bool
    tables: torch.Tensor,        # [S, M] int32
    backend_ip: torch.Tensor,    # [G] int64 (uint32 value)
    backend_port: torch.Tensor,  # [G] int32
    src_ips: torch.Tensor,       # [B] IPv4 as an integer
    src_ports: torch.Tensor,     # [B]
    dst_ips: torch.Tensor,       # [B] IPv4 as an integer
    dst_ports: torch.Tensor,     # [B]
    protos: torch.Tensor,        # [B]
) -> Dict[str, torch.Tensor]:
    """Returns ``backend`` [B] int32 global backend id (-1 = no service
    or empty backend set), plus translated ``ip`` [B] int64 and
    ``port`` [B] int32 (0 when unmatched) — the DNAT the datapath would
    apply. Runs on the device the tensors live on."""
    p0 = _u32(dst_ips)
    dport = _u32(dst_ports)
    proto = _u32(protos)
    p1 = ((proto << 16) & _U32) | dport
    idx, found = _lower_bound2(svc_ip, svc_l4, p0, p1)

    affinity = svc_affinity[idx]
    src = _u32(src_ips)
    zero = torch.zeros_like(src)
    h = torch.where(
        affinity,  # ClientIP affinity hashes the source address only
        _fnv1a_words([src, zero, zero, zero, zero]),
        _fnv1a_words([src, _u32(src_ports), p0, dport, proto]),
    )
    m = tables.shape[1]
    slot = h % m
    backend = torch.where(found, tables[idx, slot], -1)
    valid = backend >= 0
    bidx = backend.clamp(0, backend_ip.shape[0] - 1).long()
    return {
        "backend": backend,
        "ip": torch.where(valid, backend_ip[bidx], 0),
        "port": torch.where(valid, backend_port[bidx], 0),
    }
