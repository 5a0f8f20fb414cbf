"""Observer: verdicted flows in, filtered flow streams out.

Reference: ``pkg/hubble/observer`` — ``GetFlows(filter, follow)`` over
the ring; ``annotate_flows`` plays the parser role
(``parser/threefour`` + ``parser/seven``): it merges engine verdict
outputs back onto the Flow objects.
"""

from __future__ import annotations

import dataclasses
import re as _re_mod
import threading
import uuid
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from cilium_tpu_torch.runtime import simclock
from cilium_tpu_torch.core.flow import Flow, L7Type, PolicyMatchType, Verdict
from cilium_tpu_torch.hubble.ring import FlowRing
from cilium_tpu_torch.runtime.tracing import TRACER


def annotate_flows(flows: Sequence[Flow], outputs: Dict[str, np.ndarray],
                   stamp_time: bool = True, amap=None,
                   prov=None) -> Sequence[Flow]:
    """Merge engine outputs (verdict/match_spec/attribution arrays)
    onto flows.

    When a flight-recorder trace is active (service verdict op, CLI
    replay chunk), its id is stamped on each flow — the Hubble record
    then joins the trace spans and the JSONL log lines on one id.

    ``policy_match_type`` is filled HONESTLY from the attribution
    lane when the outputs carry it (``l7_match`` ≥ 0 ⇒ an L7 rule
    actually matched ⇒ ``L7``); pre-attribution outputs keep the old
    spec-derived mapping. ``amap`` (an
    ``engine/attribution.AttributionMap``) additionally stamps the
    provenance fields (packed word, rule label, bank key); ``prov``
    (a ``ServedPack``) refines the cited generation and memo-hit per
    row — without it, attributed flows cite the current policy
    generation as computed-now."""
    verdicts = np.asarray(outputs["verdict"])
    specs = np.asarray(outputs.get("match_spec",
                                   np.full(len(flows), -1)))
    l7m = (np.asarray(outputs["l7_match"])
           if "l7_match" in outputs else None)
    now = simclock.wall()
    trace_id = TRACER.current_trace_id()
    gen_now = -1
    if amap is not None:
        from cilium_tpu_torch.engine.memo import policy_generation

        gen_now = policy_generation()
    for i, f in enumerate(flows):
        f.verdict = Verdict(int(verdicts[i]))
        if stamp_time and not f.time:
            f.time = now
        if trace_id and not f.trace_id:
            f.trace_id = trace_id
        spec = int(specs[i]) if i < len(specs) else -1
        code = int(l7m[i]) if l7m is not None and i < len(l7m) else -1
        if code >= 0 or f.verdict == Verdict.REDIRECTED:
            # an L7 rule demonstrably matched (attribution lane), or
            # the legacy REDIRECTED signal on pre-attribution outputs
            f.policy_match_type = PolicyMatchType.L7
        elif spec >= 8:
            f.policy_match_type = PolicyMatchType.NONE  # denied
        elif spec == 7:
            f.policy_match_type = PolicyMatchType.L3_L4
        elif spec >= 4:
            f.policy_match_type = PolicyMatchType.L3_ONLY
        elif spec >= 0:
            f.policy_match_type = PolicyMatchType.L4_ONLY
        else:
            f.policy_match_type = PolicyMatchType.NONE
        if amap is not None and l7m is not None:
            from cilium_tpu_torch.engine.attribution import (
                flow_family,
                pack_word,
            )

            gen = (int(prov.gens[i]) if prov is not None
                   and i < len(prov.gens) else gen_now)
            hit = (bool(prov.memo_hit[i]) if prov is not None
                   and i < len(prov.memo_hit) else False)
            kernel = prov.kernel if prov is not None else ""
            cycle = prov.pack_cycle if prov is not None else 0
            # frontend records carry l7 == GENERIC on the flow but
            # verdict on their family lane — decode in that space
            fam = flow_family(f)
            f.prov_word = pack_word(code, fam, hit, gen,
                                    cycle, kernel)
            f.prov_generation = gen
            f.prov_memo = hit
            res = amap.resolve(fam, code) if code >= 0 else None
            if res is not None:
                f.prov_rule = amap.rule_label(fam, code)
                f.prov_bank = str(res.get("bank_key", "") or "")
    return flows


@dataclasses.dataclass
class FlowFilter:
    """flowpb FlowFilter for the fields our flows carry (reference
    ``hubble observe`` filter surface): identity/port/verdict/L7 type
    plus regex matches on HTTP method/path, DNS query, node name, and
    label substrings on either endpoint. Regex fields use un-anchored
    search semantics, matching the reference's filter behavior."""

    verdict: Optional[Verdict] = None
    l7_type: Optional[L7Type] = None
    src_identity: Optional[int] = None
    dst_identity: Optional[int] = None
    dport: Optional[int] = None
    protocol: Optional[int] = None
    http_method: Optional[str] = None   # regex
    http_path: Optional[str] = None     # regex
    dns_query: Optional[str] = None     # regex
    node_name: Optional[str] = None     # regex
    source_label: Optional[str] = None       # label string substring
    destination_label: Optional[str] = None  # label string substring

    def _re(self, pattern: str, value: str) -> bool:
        try:
            return _re_mod.search(pattern, value or "") is not None
        except _re_mod.error:
            return False  # bad client pattern matches nothing

    def matches(self, f: Flow) -> bool:
        if self.verdict is not None and f.verdict != self.verdict:
            return False
        if self.l7_type is not None and f.l7 != self.l7_type:
            return False
        if self.src_identity is not None and f.src_identity != self.src_identity:
            return False
        if self.dst_identity is not None and f.dst_identity != self.dst_identity:
            return False
        if self.dport is not None and f.dport != self.dport:
            return False
        if self.protocol is not None and int(f.protocol) != self.protocol:
            return False
        if self.http_method is not None and not (
                f.http and self._re(self.http_method, f.http.method)):
            return False
        if self.http_path is not None and not (
                f.http and self._re(self.http_path, f.http.path)):
            return False
        if self.dns_query is not None and not (
                f.dns and self._re(self.dns_query, f.dns.query)):
            return False
        if self.node_name is not None and not self._re(
                self.node_name, f.node_name):
            return False
        if self.source_label is not None and not any(
                self.source_label in s for s in f.src_labels):
            return False
        if self.destination_label is not None and not any(
                self.destination_label in s for s in f.dst_labels):
            return False
        return True


class Observer:
    def __init__(self, capacity: int = 4096, handlers: Sequence = ()):
        self.ring = FlowRing(capacity)
        self.handlers = list(handlers)
        self.seen = 0
        self.lost_reported = 0
        #: per-construction token: a consumer resuming by seq can tell
        #: "same observer, later" from "restarted observer, seqs reset"
        self.instance = uuid.uuid4().hex
        # observe() used to be single-writer (the agent pipeline); relay
        # followers made it multi-writer, so the counter += and handler
        # fan-out serialize here (the ring has its own lock)
        self._observe_lock = threading.Lock()

    def observe(self, flows: Sequence[Flow]) -> None:
        with self._observe_lock:
            self.ring.write_many(flows)
            self.seen += len(flows)
            for h in self.handlers:
                h.process(flows)

    def get_flows(self, flt: Optional[FlowFilter] = None,
                  since_seq: Optional[int] = None,
                  limit: Optional[int] = None,
                  follow: bool = False,
                  timeout: float = 1.0,
                  with_seq: bool = False) -> Iterator[Flow]:
        """Iterate flows from the ring; with ``follow`` blocks for new
        flows until ``timeout`` passes with none. ``with_seq`` yields
        ``(seq, flow)`` pairs so consumers can resume via
        ``since_seq=seq+1``."""
        seq = self.ring.oldest_seq if since_seq is None else since_seq
        emitted = 0
        while True:
            flow, lost = self.ring.read(seq)
            if lost:
                self.lost_reported += lost
                seq += lost
            if flow is None:
                if not follow:
                    return
                if not self.ring.wait_for(seq, timeout=timeout):
                    return
                continue
            seq += 1
            if flt is None or flt.matches(flow):
                yield (seq - 1, flow) if with_seq else flow
                emitted += 1
                if limit is not None and emitted >= limit:
                    return
