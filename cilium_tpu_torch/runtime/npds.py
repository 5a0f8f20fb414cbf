"""NPDS-style policy push-down: compiled L3/L4 MapState → proxy shim.

Reference: the agent pushes per-endpoint NetworkPolicy into Envoy over
NPDS (``pkg/envoy`` xDS server + the ``cilium.network`` filter, SURVEY
§2.2/§3.4), so flows with no L7 component verdict IN-PROXY with zero
agent round-trips. Round 4 inverted that (every verdict crossed the
service socket), which was fine for bulk replay but put a tunnel RTT
under every online verdict. This module is the other half: the
compiled L3/L4 table serialized into a flat blob the C++ shim
(``shim/cilium_shim.cpp``) loads and probes locally — only flows whose
WINNING entry demands L7 inspection or mutual auth still cross the
socket, exactly the split the reference runs.

Blob layout (little-endian; version bumps MAGIC):

  header  := <u32 magic 'NPD1'> <u32 revision> <u32 n_endpoints>
  per ep  := <u32 ep_identity> <u32 n_entries> <u8 ep_flags> <u8 x3 pad>
             then n_entries × entry
  entry   := <u32 peer_identity> <u16 dport> <u8 port_plen> <u8 proto>
             <u8 direction> <u8 entry_flags> <u16 pad>     (12 bytes)

  ep_flags:    bit0 ingress_enforced, bit1 egress_enforced, bit2 audit
               (per-endpoint audit OR the global policy_audit_mode —
               baked in so the shim needs no config channel)
  entry_flags: bit0 deny, bit1 redirect (winning ⇒ L7 path),
               bit2 auth_required (winning ⇒ auth path)

The probe semantics the shim implements are the golden model's
(``policy.mapstate.MapState.lookup``): covering = direction + peer ∈
{0, wildcard} + masked-port + proto ∈ {0, exact}, ICMP types carry the
1<<15 marker bit and never match proto-ANY port entries; any covering
deny denies; else the max-specificity allow wins; else default by the
direction's enforcement flag. The port's blob is held byte-equal to
the reference's (``tests/test_torch_service.py``).
"""

from __future__ import annotations

import struct
from typing import Dict

MAGIC = 0x4E504431  # 'NPD1'

EP_INGRESS_ENFORCED = 1
EP_EGRESS_ENFORCED = 2
EP_AUDIT = 4

E_DENY = 1
E_REDIRECT = 2
E_AUTH = 4

_HDR = struct.Struct("<III")
_EP = struct.Struct("<IIB3x")
_ENTRY = struct.Struct("<IHBBBBH")


def serialize_mapstates(per_identity: Dict, revision: int,
                        audit_global: bool = False) -> bytes:
    """The staged snapshot (identity → MapState) as one NPDS blob."""
    parts = [_HDR.pack(MAGIC, revision & 0xFFFFFFFF, len(per_identity))]
    for ep_id in sorted(per_identity):
        ms = per_identity[ep_id]
        ep_flags = (
            (EP_INGRESS_ENFORCED if ms.ingress_enforced else 0)
            | (EP_EGRESS_ENFORCED if ms.egress_enforced else 0)
            | (EP_AUDIT if (audit_global or getattr(ms, "audit", False))
               else 0))
        parts.append(_EP.pack(int(ep_id), len(ms.entries), ep_flags))
        for key, entry in ms.entries.items():
            eflags = ((E_DENY if entry.is_deny else 0)
                      | (E_REDIRECT if entry.is_redirect else 0)
                      | (E_AUTH if entry.auth_required else 0))
            parts.append(_ENTRY.pack(
                int(key.identity), int(key.dport) & 0xFFFF,
                int(key.port_plen), int(key.proto),
                int(key.direction), eflags, 0))
    return b"".join(parts)
