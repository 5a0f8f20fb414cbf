"""Verdict-engine configuration: the ``EngineConfig`` dataclass of the
reference's ``core/config.py``, field for field (the rest of that
configuration tree belongs to later slices)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class EngineConfig:
    """Verdict-engine (datapath) knobs."""

    # Automaton packing. 128 patterns per bank benches ~10% faster than
    # 64 on v5e at the 1k-rule shape (fewer, larger gathers). Fewer
    # banks also means EP sharding needs bank_count % expert_axis == 0
    # — sharding warns and replicates when it doesn't; shrink this to
    # restore EP for small rule sets.
    bank_size: int = 128           # patterns per DFA bank (EP shard unit)
    max_dfa_states: int = 8192     # per-bank subset-construction cap
    max_quantifier: int = 64       # {m,n} expansion cap (sanitize rejects above)
    # Input bucketing (variable-length strings → fixed buckets)
    dns_name_len: int = 256        # DNS names are ≤255 bytes + NUL
    http_path_buckets: Tuple[int, ...] = (32, 64, 128, 256)
    http_host_len: int = 128
    http_method_len: int = 16
    # (kafka topic/client-id length caps were removed by the ctlint
    # config-surface sweep: Kafka fields match by exact interned id,
    # never through a length-bucketed automaton, so the knobs were
    # dead the day they landed)
    #: generic (l7proto) records: max fields per record the engine
    #: encodes pair slots for (our parsers emit ≤4; truncation beyond
    #: this could only false-DENY, never false-allow)
    max_generic_fields: int = 16
    #: protocol-frontend records (policy/compiler/frontends/): byte
    #: cap on the canonical serialized record the ``l7g`` banked
    #: automaton scans. A record serializing past it is marked
    #: invalid — zero match words, so truncation can only false-DENY,
    #: never false-allow (same contract as every other byte bucket)
    l7g_len: int = 256
    #: replay/featurize chunk unit — the batch shape the jitted step
    #: compiles for (``cilium-tpu replay`` and the bench sweeps)
    batch_size: int = 8192
    #: capture-replay dedup heuristic: past this unique/total ratio
    #: the staged unique-row table is discarded (the id stream would
    #: move MORE bytes than plain rows, and the table ≈ a full copy of
    #: the capture in host memory) and replay streams full rows.
    #: 1.0 = always keep the table; see CaptureReplay.stage_unique.
    stage_unique_drop_ratio: float = 0.5
    #: device-resident verdict memo over the deduped replay rows
    #: (engine/memo.py): unique rows are verdicted once per policy
    #: revision, chunks then gather memoized outputs on device.
    #: Invalidated on every Loader revision commit — disable to force
    #: every chunk through the full verdict step.
    verdict_memo: bool = True
    #: verdict-step kernel selection (engine/megakernel.py):
    #: "auto" = fused megakernel, heuristic per-bank-shape scan pick;
    #: "autotune" = fused, dense vs bitset-NFA measured per bank shape
    #: at staging; "dfa-dense"/"nfa-bitset" = fused with the arm
    #: forced; "legacy" = the pre-megakernel three-family step. Every
    #: value is verdict-bit-equal — this knob only moves time.
    kernel_impl: str = "auto"
