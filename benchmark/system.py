"""The system under test, set up as a user of ``cilium_tpu_torch`` sets
it up for a bulk replay: the deployment's rules as CNP ``Rule``s, its
identities at their own numbers in a ``SelectorCache``, the policy
resolved and compiled through the ``Loader``, the capture file staged
by ``CaptureReplay``. The benchmark's only import of the program."""

from __future__ import annotations

import time
from typing import Dict

from benchmark.deployment import Deployment, Policy


def _rule(p: Policy):
    from cilium_tpu_torch.core.flow import Protocol
    from cilium_tpu_torch.policy.api import (
        EgressRule,
        EndpointSelector,
        IngressRule,
        L7Rules,
        PortProtocol,
        PortRule,
        PortRuleHTTP,
        PortRuleKafka,
        Rule,
    )

    l7 = None
    if p.http:
        l7 = L7Rules(http=tuple(
            PortRuleHTTP(method=h.method, path=h.path, host=h.host,
                         headers=tuple(f"{k}: {v}" if v else k
                                       for k, v in h.headers))
            for h in p.http))
    elif p.kafka:
        l7 = L7Rules(kafka=tuple(
            PortRuleKafka(role=k.role, api_key=k.api_key,
                          api_version=k.api_version, client_id=k.client_id,
                          topic=k.topic)
            for k in p.kafka))
    ports = (PortRule(ports=(PortProtocol(p.port, Protocol(p.proto)),),
                      rules=l7),)
    peer = (EndpointSelector(match_labels=p.peer),)
    if p.direction == 1:
        kw = {"ingress": (IngressRule(from_endpoints=peer, to_ports=ports,
                                      deny=p.deny),)}
    else:
        kw = {"egress": (EgressRule(to_endpoints=peer, to_ports=ports,
                                    deny=p.deny),)}
    return Rule(endpoint_selector=EndpointSelector(match_labels=p.select),
                labels=(f"benchmark={p.name}",), **kw)


class System:
    """The program, built for one deployment. ``spans`` holds the
    set-up's host-clock seconds by step."""

    def __init__(self, dep: Deployment, cache_dir: str, device: str):
        import torch

        from cilium_tpu_torch.core.config import Config
        from cilium_tpu_torch.core.labels import LabelSet
        from cilium_tpu_torch.policy.mapstate import PolicyResolver
        from cilium_tpu_torch.policy.repository import Repository
        from cilium_tpu_torch.policy.selectorcache import SelectorCache
        from cilium_tpu_torch.runtime.loader import Loader

        self.device = torch.device(device)
        self.spans: Dict[str, float] = {}
        t0 = time.perf_counter()
        labelsets = {int(nid): LabelSet.from_dict(lb)
                     for nid, lb in zip(dep.ids.tolist(), dep.labels)}
        cache = SelectorCache()
        cache.sync_identities(labelsets)
        repo = Repository()
        repo.add([_rule(p) for p in dep.policies], sanitize=False)
        per_identity = PolicyResolver(repo, cache).resolve_many(labelsets)
        self.spans["resolve_s"] = time.perf_counter() - t0

        cfg = Config()
        cfg.enable_tpu_offload = True
        cfg.engine.bank_size = int(dep.engine.get("bank_size", 128))
        cfg.engine.kernel_impl = str(dep.engine.get("kernel_impl", "auto"))
        cfg.loader.cache_dir = cache_dir
        self.cfg = cfg
        self.loader = Loader(cfg, device=self.device)
        t0 = time.perf_counter()
        self.engine = self.loader.regenerate(per_identity, revision=1)
        self.spans["regen_s"] = time.perf_counter() - t0
        self.replay = None
        self.rec = None

    def stage(self, path: str) -> Dict[str, float]:
        """Stage the capture at ``path`` as a replay session: the string
        tables scanned, the rows featurized, the dedup tried (and
        declined for captures of distinct records). Returns the
        replay's own staging split (``cilium_tpu_capture_stage_seconds``
        by phase)."""
        from cilium_tpu_torch.engine.replay import CaptureReplay
        from cilium_tpu_torch.ingest import binary
        from cilium_tpu_torch.runtime.metrics import (
            CAPTURE_STAGE_SECONDS,
            METRICS,
        )

        phases = ("tables", "featurize", "dedup", "table-h2d")

        def marks():
            return {ph: METRICS.histo_sum(CAPTURE_STAGE_SECONDS,
                                          {"phase": ph}) for ph in phases}

        before = marks()
        t0 = time.perf_counter()
        self.rec = binary.map_capture(path)
        self.l7, offsets, blob = binary.read_l7_sidecar(path)
        self.replay = CaptureReplay(self.engine, self.l7, offsets, blob,
                                    self.cfg.engine)
        self.replay.stage_rows(self.rec, self.l7)
        self.unique_ratio = self.replay.stage_unique(
            drop_if_ratio_at_least=self.cfg.engine.stage_unique_drop_ratio)
        self.spans["stage_s"] = time.perf_counter() - t0
        after = marks()
        return {ph: after[ph] - before[ph] for ph in phases}

    @property
    def deduped(self) -> bool:
        return self.replay.row_idx is not None

    def rows(self, start: int, n: int):
        """The staged row block of a chunk (what the step reads)."""
        return self.replay.rows_all[start:start + n]

    def verdict_chunk(self, start: int, n: int) -> Dict[str, object]:
        """The timed entry: one chunk of the capture through
        ``CaptureReplay.verdict_chunk``, host lanes back."""
        return self.replay.verdict_chunk(self.rec[start:start + n],
                                         self.l7[start:start + n],
                                         start=start)

    def close(self) -> None:
        self.replay = None
        self.engine = None
        if self.loader is not None:
            self.loader.close()
            self.loader = None
