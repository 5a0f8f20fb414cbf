"""Synthetic scenario generators — a copy of the reference's
``ingest/synth.py`` for the scenarios the port runs: ``fqdn`` (DNS
names × toFQDNs patterns), ``http`` (1k path/header regex rules × 10k
flows) and ``kafka`` (topic/API-key ACLs), with ``scenario_by_name``
and ``realize_scenario``. The ``generic`` and ``protocols`` scenarios
need ``l7proto`` rules, which arrive with the frontends slice.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Tuple

from cilium_tpu_torch.core.flow import (
    DNSInfo,
    Flow,
    HTTPInfo,
    KafkaInfo,
    L7Type,
    Protocol,
    TrafficDirection,
)
from cilium_tpu_torch.policy.api import (
    EgressRule,
    EndpointSelector,
    IngressRule,
    L7Rules,
    PortProtocol,
    PortRule,
    PortRuleDNS,
    PortRuleHTTP,
    PortRuleKafka,
    Rule,
)

ING = TrafficDirection.INGRESS
EG = TrafficDirection.EGRESS


@dataclasses.dataclass
class SynthScenario:
    name: str
    rules: List[Rule]
    endpoints: Dict[str, Dict[str, str]]   # name → label dict
    flows: List[Flow]
    # filled by the harness after identity allocation:
    ids: Optional[Dict[str, int]] = None


def _sel(**kv) -> EndpointSelector:
    return EndpointSelector.from_labels(**kv)


# ------------------------------------------------------- config 0: FQDN --
def synth_fqdn_scenario(n_names: int = 100, n_rules: int = 10,
                        n_flows: Optional[int] = None,
                        seed: int = 0) -> SynthScenario:
    rng = random.Random(seed)
    domains = ["cilium.io", "example.com", "k8s.local", "corp.internal",
               "cdn.net"]
    dns_rules = []
    for i in range(n_rules):
        base = domains[i % len(domains)]
        if i % 3 == 0:
            dns_rules.append(PortRuleDNS(match_name=f"svc{i}.{base}"))
        elif i % 3 == 1:
            dns_rules.append(PortRuleDNS(match_pattern=f"*.{base}"))
        else:
            dns_rules.append(PortRuleDNS(match_pattern=f"api-*.sub{i}.{base}"))
    rule = Rule(
        endpoint_selector=_sel(app="crawler"),
        egress=(EgressRule(to_ports=(PortRule(
            ports=(PortProtocol(53, Protocol.UDP),),
            rules=L7Rules(dns=tuple(dns_rules)),
        ),),),),
        labels=("synth=fqdn",),
    )
    names = []
    for i in range(n_names):
        base = domains[i % len(domains)]
        kind = rng.random()
        if kind < 0.3:
            names.append(f"svc{rng.randrange(n_rules)}.{base}")
        elif kind < 0.6:
            names.append(f"host{i}.{base}")
        elif kind < 0.8:
            names.append(f"api-{i}.sub{rng.randrange(n_rules)}.{base}")
        else:
            names.append(f"deep{i}.x.y.{base}")
    flows = []
    for i in range(n_flows or n_names):
        flows.append(Flow(
            src_identity=0, dst_identity=0, dport=53, protocol=Protocol.UDP,
            direction=EG, l7=L7Type.DNS,
            dns=DNSInfo(query=names[i % len(names)]),
        ))
    return SynthScenario(
        name="fqdn", rules=[rule],
        endpoints={"crawler": {"app": "crawler"},
                   "peer": {"app": "peer"}},
        flows=flows,
    )


# ------------------------------------------------------- config 1: HTTP --
def synth_http_scenario(n_rules: int = 1000, n_flows: int = 10000,
                        seed: int = 0) -> SynthScenario:
    rng = random.Random(seed)
    http_rules = []
    for i in range(n_rules):
        kind = i % 5
        if kind == 0:
            http_rules.append(PortRuleHTTP(
                method="GET", path=f"/api/v{i % 9}/svc{i}/[a-z0-9]+"))
        elif kind == 1:
            http_rules.append(PortRuleHTTP(
                method="POST", path=f"/api/v1/items/{i}(/.*)?"))
        elif kind == 2:
            http_rules.append(PortRuleHTTP(
                path=f"/public/{i}/.*", host=f"svc{i % 50}[.]local"))
        elif kind == 3:
            http_rules.append(PortRuleHTTP(
                method="GET|HEAD", path=f"/static/{i}/[0-9]+/[a-f0-9]+"))
        else:
            http_rules.append(PortRuleHTTP(
                method="PUT", path=f"/admin/{i}/config",
                headers=(f"X-Role: admin{i % 10}",)))
    rule = Rule(
        endpoint_selector=_sel(app="server"),
        ingress=(IngressRule(
            from_endpoints=(_sel(app="client"),),
            to_ports=(PortRule(
                ports=(PortProtocol(80, Protocol.TCP),),
                rules=L7Rules(http=tuple(http_rules)),
            ),),
        ),),
        labels=("synth=http",),
    )
    flows = []
    for _ in range(n_flows):
        i = rng.randrange(n_rules)
        hit = rng.random() < 0.5
        kind = i % 5
        if kind == 0:
            path = f"/api/v{i % 9}/svc{i}/x9y" if hit else f"/api/v{i % 9}/svc{i}/"
            method = "GET"
            headers: Tuple = ()
        elif kind == 1:
            path = f"/api/v1/items/{i}/sub" if hit else f"/api/v1/items/{i}x"
            method = "POST"
            headers = ()
        elif kind == 2:
            path = f"/public/{i}/a/b" if hit else f"/private/{i}/a"
            method = "GET"
            headers = ()
        elif kind == 3:
            path = (f"/static/{i}/123/abc9" if hit
                    else f"/static/{i}/123/XYZ")
            method = "HEAD"
            headers = ()
        else:
            path = f"/admin/{i}/config"
            method = "PUT"
            headers = ((("X-Role", f"admin{i % 10}"),) if hit
                       else (("X-Role", "nobody"),))
        flows.append(Flow(
            src_identity=0, dst_identity=0, dport=80, protocol=Protocol.TCP,
            direction=ING, l7=L7Type.HTTP,
            http=HTTPInfo(method=method, path=path,
                          host=f"svc{i % 50}.local", headers=headers),
        ))
    return SynthScenario(
        name="http", rules=[rule],
        endpoints={"server": {"app": "server"},
                   "client": {"app": "client"}},
        flows=flows,
    )


# ------------------------------------------------------ config 2: Kafka --
def synth_kafka_scenario(n_rules: int = 20, n_records: int = 100000,
                         seed: int = 0) -> SynthScenario:
    rng = random.Random(seed)
    kafka_rules = []
    for i in range(n_rules):
        if i % 2 == 0:
            kafka_rules.append(PortRuleKafka(role="produce",
                                             topic=f"topic-{i}"))
        else:
            kafka_rules.append(PortRuleKafka(role="consume",
                                             topic=f"topic-{i}",
                                             client_id=f"client-{i % 5}"))
    rule = Rule(
        endpoint_selector=_sel(app="kafka"),
        ingress=(IngressRule(
            from_endpoints=(_sel(app="producer"),),
            to_ports=(PortRule(
                ports=(PortProtocol(9092, Protocol.TCP),),
                rules=L7Rules(kafka=tuple(kafka_rules)),
            ),),
        ),),
        labels=("synth=kafka",),
    )
    flows = []
    for _ in range(n_records):
        i = rng.randrange(n_rules + 5)  # some topics unmatched
        produce = rng.random() < 0.5
        flows.append(Flow(
            src_identity=0, dst_identity=0, dport=9092,
            protocol=Protocol.TCP, direction=ING, l7=L7Type.KAFKA,
            kafka=KafkaInfo(
                api_key=0 if produce else 1,
                api_version=rng.randint(0, 5),
                client_id=f"client-{rng.randrange(8)}",
                topic=f"topic-{i}",
            ),
        ))
    return SynthScenario(
        name="kafka", rules=[rule],
        endpoints={"kafka": {"app": "kafka"},
                   "producer": {"app": "producer"}},
        flows=flows,
    )


# ----------------------------------------------------------- harness ----
def scenario_by_name(name: str, n_rules: int, n_flows: int,
                     seed: int = 0) -> "SynthScenario":
    """Scenario dispatch (the reference's, including fqdn's 100-name
    universe). ``generic`` and ``protocols`` raise: their ``l7proto``
    rules arrive with the frontends slice (queue 1, Q5)."""
    if n_rules < 1:
        raise ValueError("n_rules must be >= 1")
    if name == "http":
        return synth_http_scenario(n_rules=n_rules, n_flows=n_flows,
                                   seed=seed)
    if name == "fqdn":
        return synth_fqdn_scenario(n_names=100, n_rules=n_rules,
                                   n_flows=n_flows, seed=seed)
    if name == "kafka":
        return synth_kafka_scenario(n_rules=n_rules, n_records=n_flows,
                                    seed=seed)
    if name in ("generic", "protocols"):
        raise NotImplementedError(
            f"scenario {name!r} needs l7proto rules (queue 1, Q5)")
    raise ValueError(f"unknown scenario {name!r}")


def realize_scenario(scenario: SynthScenario, resolve: bool = True):
    """Allocate identities, resolve policies, fix up flow identities.
    Returns (per_identity_mapstates, scenario with ids filled);
    ``resolve=False`` skips policy resolution (capture writers only
    need the identity fixup) and returns ``None`` for the mapstates."""
    from cilium_tpu_torch.core.identity import IdentityAllocator
    from cilium_tpu_torch.core.labels import LabelSet
    from cilium_tpu_torch.policy.mapstate import PolicyResolver
    from cilium_tpu_torch.policy.repository import Repository
    from cilium_tpu_torch.policy.selectorcache import SelectorCache

    alloc = IdentityAllocator()
    ids: Dict[str, int] = {}
    labelsets: Dict[str, "LabelSet"] = {}
    for name, lbls in scenario.endpoints.items():
        ls = LabelSet.from_dict(lbls)
        ids[name] = alloc.allocate(ls)
        labelsets[name] = ls
    per_identity = None
    if resolve:
        cache = SelectorCache(alloc)
        repo = Repository()
        repo.add(scenario.rules, sanitize=False)  # well-formed by synth
        resolver = PolicyResolver(repo, cache)
        per_identity = {ids[n]: resolver.resolve(labelsets[n])
                        for n in scenario.endpoints}
    scenario.ids = ids
    # default src/dst for scenarios that use symbolic names
    for f in scenario.flows:
        src = getattr(f, "_src_name", None)
        dst = getattr(f, "_dst_name", None)
        if src is not None:
            f.src_identity = ids[src]
        if dst is not None:
            f.dst_identity = ids[dst]
    # single-policy scenarios: default identities
    if scenario.name == "http":
        for f in scenario.flows:
            f.src_identity = ids["client"]
            f.dst_identity = ids["server"]
    elif scenario.name == "kafka":
        for f in scenario.flows:
            f.src_identity = ids["producer"]
            f.dst_identity = ids["kafka"]
    elif scenario.name == "generic":
        for f in scenario.flows:
            f.src_identity = ids["droid"]
            f.dst_identity = ids["r2d2"]
    elif scenario.name == "protocols":
        for f in scenario.flows:
            f.src_identity = ids["client"]
            f.dst_identity = ids["polysvc"]
    elif scenario.name == "fqdn":
        for f in scenario.flows:
            f.src_identity = ids["crawler"]
            f.dst_identity = ids["peer"]
    return per_identity, scenario
