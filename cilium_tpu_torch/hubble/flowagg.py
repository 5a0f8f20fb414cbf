"""Continuous Hubble flow export: the bounded per-host FlowAggregator
(a copy of the reference's ``hubble/flowagg.py``).

* **Ids, not bytes, on the hot path.** Every served record ticks one
  integer counter (``note_served`` →
  ``cilium_tpu_hubble_flow_records_total{host=...}``).
* **Sampled aggregation off the explain feed.** Traced chunks already
  pay bounded host reconstruction for the explain plane
  (``runtime/explain.build_entries``); the aggregator folds those same
  entries into a bounded table keyed by ``(src identity, dst identity,
  verdict, rule, bank, generation)``, with one representative flow
  dict per key.
* **Bounded, with honest overflow.** New keys past ``max_keys`` are
  dropped and counted (``cilium_tpu_hubble_flow_overflow_total``).

:func:`merge_snapshots` sums per-host snapshots by key.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from cilium_tpu_torch.runtime.metrics import (
    HUBBLE_FLOW_OVERFLOW,
    HUBBLE_FLOW_RECORDS,
    METRICS,
)

#: aggregation-key fields, in order (the snapshot echoes them so the
#: router merge and the CLI never re-derive the tuple layout)
KEY_FIELDS = ("src_identity", "dst_identity", "verdict", "rule",
              "bank", "generation")


class FlowAggregator:
    """Bounded per-host flow aggregation over the serve resolve path.
    Thread-safe: connection threads and the pack thread both feed
    it."""

    def __init__(self, host: str = "", max_keys: int = 4096):
        self.host = str(host)
        self.max_keys = max(1, int(max_keys))
        self._lock = threading.Lock()
        #: key tuple → [count, representative flow dict]
        self._agg: Dict[Tuple, List] = {}
        self._labels = {"host": self.host} if self.host else None
        #: every record served (the cheap hot-path total)
        self.records = 0
        #: sampled records folded into an aggregation key
        self.aggregated = 0
        #: sampled records dropped because the key table was full
        self.overflow = 0

    # -- the feed ---------------------------------------------------------
    def note_served(self, n: int) -> None:
        """The hot path: one integer add per resolved chunk."""
        if n <= 0:
            return
        with self._lock:
            self.records += n
        METRICS.inc(HUBBLE_FLOW_RECORDS, n, labels=self._labels)

    @staticmethod
    def _key_of(entry: Dict) -> Tuple:
        flow = entry.get("flow") or {}
        prov = entry.get("provenance") or {}
        return (
            int((flow.get("source") or {}).get("identity", 0) or 0),
            int((flow.get("destination") or {}).get("identity", 0)
                or 0),
            entry.get("verdict_name") or flow.get("verdict") or "",
            str(prov.get("rule") or ""),
            str(prov.get("bank_key") or ""),
            int(prov.get("generation", 0) or 0),
        )

    def observe_entries(self, entries) -> int:
        """Fold explain-plane entries (``build_entries`` output) into
        the aggregation table. Returns entries aggregated."""
        if not entries:
            return 0
        folded = dropped = 0
        with self._lock:
            for e in entries:
                key = self._key_of(e)
                row = self._agg.get(key)
                if row is not None:
                    row[0] += 1
                    folded += 1
                elif len(self._agg) < self.max_keys:
                    self._agg[key] = [1, e.get("flow") or {}]
                    folded += 1
                else:
                    dropped += 1
            self.aggregated += folded
            self.overflow += dropped
        if dropped:
            METRICS.inc(HUBBLE_FLOW_OVERFLOW, dropped,
                        labels=self._labels)
        return folded

    # -- read-out ---------------------------------------------------------
    def snapshot(self, limit: Optional[int] = None) -> Dict:
        """Counts plus the aggregated keys (largest first), each with
        its representative flow — the router-merge / API face."""
        with self._lock:
            rows = sorted(self._agg.items(), key=lambda kv: -kv[1][0])
            records, aggregated, overflow = (
                self.records, self.aggregated, self.overflow)
        if limit is not None and limit > 0:
            rows = rows[:limit]
        return {
            "host": self.host,
            "records": records,
            "aggregated": aggregated,
            "overflow": overflow,
            "keys": len(rows),
            "flows": [{
                **dict(zip(KEY_FIELDS, key)),
                "count": count,
                "flow": flow,
                **({"host": self.host} if self.host else {}),
            } for key, (count, flow) in rows],
        }

    def key_count(self) -> int:
        with self._lock:
            return len(self._agg)

    def clear(self) -> None:
        with self._lock:
            self._agg.clear()
            self.records = self.aggregated = self.overflow = 0


def merge_snapshots(snaps) -> Dict:
    """Router-side merge: sum per-host snapshots by aggregation key,
    keeping per-host attribution on each merged row."""
    totals = {"records": 0, "aggregated": 0, "overflow": 0}
    merged: Dict[Tuple, Dict] = {}
    hosts: List[str] = []
    for snap in snaps:
        if not snap:
            continue
        if snap.get("host"):
            hosts.append(snap["host"])
        for k in totals:
            totals[k] += int(snap.get(k, 0) or 0)
        for row in snap.get("flows", ()):
            key = tuple(row.get(f) for f in KEY_FIELDS)
            got = merged.get(key)
            if got is None:
                got = merged[key] = {
                    **{f: row.get(f) for f in KEY_FIELDS},
                    "count": 0, "flow": row.get("flow") or {},
                    "hosts": {},
                }
            got["count"] += int(row.get("count", 0) or 0)
            h = row.get("host") or snap.get("host") or ""
            if h:
                got["hosts"][h] = (got["hosts"].get(h, 0)
                                   + int(row.get("count", 0) or 0))
    rows = sorted(merged.values(), key=lambda r: -r["count"])
    return {
        "hosts": hosts,
        **totals,
        "keys": len(rows),
        "flows": rows,
    }
