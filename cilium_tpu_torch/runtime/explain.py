"""The explain plane: verdict → (rule id, bank, generation), recorded
(a copy of the reference's ``runtime/explain.py``).

Every sampled verdict of a traced chunk records a bounded explain entry
keyed by its trace id: the decoded attribution (rule ids and content
via ``engine/attribution.AttributionMap``, the bank the match was read
from, the policy generation the verdict was computed under, memo-hit vs
computed, pack cycle, kernel impl) plus the flow itself. Entries live
in one process-global bounded store (:data:`EXPLAIN`): constant memory,
evictions counted. The query side, :func:`resolve_explain`, re-verdicts
each entry through the loader's ``fallback_engine`` (the CPU oracle) at
the current committed revision.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from cilium_tpu_torch.runtime import simclock
from cilium_tpu_torch.runtime.metrics import (
    EXPLAIN_QUERIES,
    METRICS,
    PROVENANCE_RECORDS,
)

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


def resolve_explain(loader, trace_id: str,
                    store: Optional[ExplainStore] = None) -> Dict:
    """The query side: recorded entries for ``trace_id``, each
    re-resolved through the CPU oracle at the CURRENT committed
    revision → served-vs-fresh agreement. A disagreement on a
    non-degraded plane is a stale verdict, surfaced to the operator."""
    from cilium_tpu_torch.core.flow import Verdict
    from cilium_tpu_torch.ingest.hubble import flow_from_dict

    store = store if store is not None else EXPLAIN
    entries = store.get(trace_id)
    METRICS.inc(EXPLAIN_QUERIES,
                labels={"result": "hit" if entries else "miss"})
    if not entries:
        return {"trace_id": trace_id, "found": False, "records": []}
    oracle = loader.fallback_engine if loader is not None else None
    records: List[Dict] = []
    flows = [flow_from_dict(e["flow"]) for e in entries]
    fresh: Optional[List[int]] = None
    if oracle is not None:
        try:
            fresh = [int(v) for v in
                     oracle.verdict_flows(flows)["verdict"]]
        except Exception:  # noqa: BLE001 — a sick oracle degrades the
            fresh = None   # comparison, never the query
    degraded = bool(loader.bank_status().get("degraded")) \
        if loader is not None else False
    agree_all = True
    for k, e in enumerate(entries):
        rec = dict(e)
        if fresh is not None:
            rec["fresh_verdict"] = fresh[k]
            rec["fresh_verdict_name"] = Verdict(fresh[k]).name
            rec["agreement"] = fresh[k] == e["verdict"]
            agree_all &= rec["agreement"]
        records.append(rec)
    out = {"trace_id": trace_id, "found": True,
           "records": records, "degraded": degraded}
    if fresh is not None:
        out["served_equals_fresh"] = agree_all
    if loader is not None:
        out["revision"] = loader.revision
        from cilium_tpu_torch.engine.memo import policy_generation

        out["generation_now"] = policy_generation()
    # link to the stitched cross-host timeline: a verdict served after
    # a handoff explains on host B while its trace spans hosts A and B
    # — the summary joins the two planes on the id
    from cilium_tpu_torch.runtime.tracing import TRACER

    stitched = TRACER.stitch(trace_id)
    if stitched["records"]:
        out["trace"] = {"hosts": stitched["hosts"],
                        "epochs": stitched["epochs"],
                        "spans": len(stitched["records"]),
                        "stitched": stitched["stitched"]}
    return out
