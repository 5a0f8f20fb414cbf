"""The explain plane: verdict → (rule id, bank, generation), recorded
(the record side of the reference's ``runtime/explain.py``).

Every sampled verdict of a traced chunk records a bounded explain entry
keyed by its trace id: the decoded attribution (rule ids and content
via ``engine/attribution.AttributionMap``, the bank the match was read
from, the policy generation the verdict was computed under, memo-hit vs
computed, pack cycle, kernel impl) plus the flow itself. Entries live
in one process-global bounded store (:data:`EXPLAIN`): constant memory,
evictions counted. The query side, which re-verdicts each entry through
the loader's oracle, comes with the port's loader.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from cilium_tpu_torch.runtime import simclock
from cilium_tpu_torch.runtime.metrics import METRICS, PROVENANCE_RECORDS

#: default bounded capacity (trace ids retained) and per-chunk record
#: sample
DEFAULT_CAPACITY = 1024
DEFAULT_SAMPLE = 8


class ExplainStore:
    """Bounded trace-id → explain-entry store (LRU on insert)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, List[Dict]]" = OrderedDict()
        self.evictions = 0

    def configure(self, capacity: Optional[int] = None) -> None:
        with self._lock:
            if capacity is not None:
                self.capacity = max(1, int(capacity))

    def record(self, trace_id: str, entries: Sequence[Dict]) -> None:
        if not trace_id or not entries:
            return
        with self._lock:
            bucket = self._entries.get(trace_id)
            if bucket is None:
                bucket = self._entries[trace_id] = []
                while len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
                    self.evictions += 1
            bucket.extend(entries)

    def get(self, trace_id: str) -> List[Dict]:
        with self._lock:
            return list(self._entries.get(trace_id, ()))

    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._entries.keys())

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


#: the process-global store
EXPLAIN = ExplainStore()


def build_entries(trace_id: str, surface: str, flows: Sequence,
                  verdicts, l7_match, amap,
                  gens=None, memo_hit=None, match_spec=None,
                  kernel: str = "", pack_cycle: int = -1,
                  generation: int = -1, host_id: str = "",
                  sample: int = DEFAULT_SAMPLE,
                  tenant: str = "") -> List[Dict]:
    """Explain entries for (up to ``sample``) flows of one served
    chunk. Alignment contract: ``flows[i]`` ↔ row i of every array.
    Counts explained/unexplained on the provenance series — a verdict
    is *explainable* when its attribution decodes (an L7 winner that
    resolves to live rules, or an honest L3/L4-only attribution via
    ``match_spec``).

    ``host_id`` scopes the pack-cycle id (a per-ring counter) to the
    host that served it; ``tenant`` attributes the entry to the tenant
    whose stream it was served on ("" keeps the tenant-less shape)."""
    from cilium_tpu_torch.core.flow import Verdict
    from cilium_tpu_torch.engine.attribution import flow_family, pack_word
    from cilium_tpu_torch.ingest.hubble import flow_to_dict

    verdicts = np.asarray(verdicts)
    l7m = (np.asarray(l7_match) if l7_match is not None
           else np.full(len(verdicts), -1, dtype=np.int64))
    specs = (np.asarray(match_spec) if match_spec is not None
             else np.full(len(verdicts), -1, dtype=np.int64))
    n = min(len(flows), len(verdicts), max(0, int(sample)))
    out: List[Dict] = []
    for i in range(n):
        f = flows[i]
        code = int(l7m[i]) if i < len(l7m) else -1
        gen = int(gens[i]) if gens is not None and i < len(gens) \
            else int(generation)
        hit = bool(memo_hit[i]) if memo_hit is not None \
            and i < len(memo_hit) else False
        # frontend records carry l7 == GENERIC on the flow object
        # but verdict on their family lane (engine normalization)
        fam = flow_family(f)
        res = amap.resolve(fam, code) if amap is not None \
            else None
        spec = int(specs[i]) if i < len(specs) else -1
        explained = res is not None or (code < 0 and spec >= 0) \
            or (code < 0 and int(verdicts[i]) == int(Verdict.DROPPED))
        METRICS.inc(PROVENANCE_RECORDS,
                    labels={"result": "explained" if explained
                            else "unexplained"})
        prov: Dict[str, object] = {
            "word": pack_word(code, fam, hit, gen, pack_cycle,
                              kernel),
            "generation": gen,
            "memo_hit": hit,
            "kernel": kernel,
            "pack_cycle": pack_cycle,
            "match_spec": spec,
            "explained": bool(explained),
            "host": host_id,
        }
        if res is not None:
            prov.update(res)
            if res.get("bank_key"):
                from cilium_tpu_torch.engine.memo import POLICY_GENERATION

                prov["bank_epoch"] = POLICY_GENERATION.bank_epoch(
                    str(res["bank_key"]))
        entry = {
            "trace_id": trace_id,
            "surface": surface,
            "t": simclock.wall(),
            "index": i,
            "verdict": int(verdicts[i]),
            "verdict_name": Verdict(int(verdicts[i])).name,
            "flow": flow_to_dict(f),
            "provenance": prov,
        }
        if tenant:
            entry["tenant"] = tenant
        out.append(entry)
    return out
