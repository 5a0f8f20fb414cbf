"""Flow-metrics handlers (reference: ``pkg/hubble/metrics``: flow /
drop / http / dns handlers feeding Prometheus)."""

from __future__ import annotations

from typing import Sequence

from cilium_tpu_torch.core.flow import Flow, L7Type, Verdict
from cilium_tpu_torch.runtime.metrics import METRICS, Metrics


class FlowMetrics:
    """Mirrors the key reference series: flows processed, drops,
    L7 requests by protocol/verdict, DNS queries."""

    def __init__(self, metrics: Metrics = METRICS):
        self.metrics = metrics

    def process(self, flows: Sequence[Flow]) -> None:
        m = self.metrics
        for f in flows:
            verdict = Verdict(f.verdict).name
            m.inc("hubble_flows_processed_total",
                  labels={"verdict": verdict})
            if f.verdict == Verdict.DROPPED:
                m.inc("cilium_tpu_drop_count_total",
                      labels={"reason": f.drop_reason or "policy"})
            if f.l7 != L7Type.NONE:
                m.inc("cilium_tpu_policy_l7_total",
                      labels={"proto": L7Type(f.l7).name.lower(),
                              "verdict": verdict})
            if f.l7 == L7Type.DNS and f.dns is not None:
                m.inc("hubble_dns_queries_total",
                      labels={"qtypes": ",".join(f.dns.qtypes)})
            if f.l7 == L7Type.HTTP and f.http is not None:
                m.inc("hubble_http_requests_total",
                      labels={"method": f.http.method or "-",
                              "verdict": verdict})
