"""Synthetic scenario generators — a copy of the reference's
``ingest/synth.py`` for the scenarios the port runs: ``fqdn`` (DNS
names × toFQDNs patterns), ``http`` (1k path/header regex rules × 10k
flows), ``kafka`` (topic/API-key ACLs), ``generic`` (r2d2 key/value
ACLs), ``protocols`` (cassandra, memcache and r2d2 records against
per-protocol rule sets), ``mixed`` (the ``examples/policies`` corpus ×
synthetic identity/flow tuples, BASELINE configs[3]) and
``clustermesh`` (10k identities × 5k CNPs, configs[4]), with
``scenario_by_name``, ``realize_scenario`` and the capture writers
``scenario_capture_columns`` / ``write_scenario_capture``; and one of
the port's own, ``lineparser`` (``test.lineparser`` ACLs on the
generic pair path), which the reference has no scenario for. The port
also renders a scenario's HTTP rule as the ``cilium.io/v2`` object a
Kubernetes user applies (``http_rule_cnp``), so the rule can travel
through the apiserver and the watcher bridge.
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
    PortRuleL7,
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
def http_rule_cnp(rule, name: str, namespace: str = "default") -> Dict:
    """An HTTP scenario's ``Rule`` as a ``cilium.io/v2``
    CiliumNetworkPolicy object: ``parse_cnp`` of it gives back the rule
    with the policy's provenance labels in place of the scenario's.
    Covers what the scenario's rules use (match labels, ``fromEndpoints``,
    ports and HTTP rules) and raises on anything else rather than drop
    it."""
    def sel(s) -> Dict:
        if s.match_expressions:
            raise ValueError("matchExpressions are not rendered")
        return {"matchLabels": dict(s.match_labels)}

    if rule.egress:
        raise ValueError("egress rules are not rendered")
    ingress = []
    for i in rule.ingress:
        if (i.from_entities or i.from_cidrs or i.from_cidr_set
                or i.from_requires or i.icmps or i.auth_mode or i.deny):
            raise ValueError(f"ingress fields beyond fromEndpoints: {i}")
        ports = []
        for tp in i.to_ports:
            pr = {"ports": [{"port": str(pp.port),
                             "protocol": pp.protocol.name}
                            for pp in tp.ports]}
            l7 = tp.rules
            if l7 is not None and not l7.is_empty():
                if l7.kafka or l7.dns or l7.l7 or l7.l7proto:
                    raise ValueError("only HTTP rules are rendered")
                if any(h.header_matches for h in l7.http):
                    raise ValueError("headerMatches are not rendered")
                pr["rules"] = {"http": [
                    {k: v for k, v in (("method", h.method),
                                       ("path", h.path), ("host", h.host),
                                       ("headers", list(h.headers))) if v}
                    for h in l7.http]}
            ports.append(pr)
        ingress.append({"fromEndpoints": [sel(s) for s in i.from_endpoints],
                        "toPorts": ports})
    return {"apiVersion": "cilium.io/v2", "kind": "CiliumNetworkPolicy",
            "metadata": {"name": name, "namespace": namespace},
            "spec": {"endpointSelector": sel(rule.endpoint_selector),
                     "ingress": ingress}}


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


# ------------------------------------------------- generic l7proto lane --
def synth_generic_scenario(n_rules: int = 200, n_flows: int = 100000,
                           seed: int = 0) -> SynthScenario:
    """Generic ``l7proto`` ACLs (the proxylib r2d2 template shape):
    key/value field constraints matched by the engine's pair-subset
    path; ``r2d2`` has an engine frontend, so the rules compile onto
    the ``l7g`` field."""
    from cilium_tpu_torch.core.flow import GenericL7Info

    rng = random.Random(seed)
    gen_rules = []
    for i in range(n_rules):
        if i % 3 == 0:
            gen_rules.append({"cmd": "READ", "file": f"f{i}.txt"})
        elif i % 3 == 1:
            gen_rules.append({"cmd": "WRITE", "file": f"f{i}.txt"})
        else:
            gen_rules.append({"cmd": "HALT"})
    rule = Rule(
        endpoint_selector=_sel(app="r2d2"),
        ingress=(IngressRule(
            from_endpoints=(_sel(app="droid"),),
            to_ports=(PortRule(
                ports=(PortProtocol(4242, Protocol.TCP),),
                rules=L7Rules(l7proto="r2d2", l7=tuple(gen_rules)),
            ),),
        ),),
        labels=("synth=generic",),
    )
    flows = []
    for _ in range(n_flows):
        i = rng.randrange(n_rules + n_rules // 4 + 1)  # some unmatched
        cmd = ("READ", "WRITE", "HALT")[i % 3]
        fields = {"cmd": cmd}
        if cmd != "HALT":
            fields["file"] = f"f{i}.txt"
        flows.append(Flow(
            src_identity=0, dst_identity=0, dport=4242,
            protocol=Protocol.TCP, direction=ING, l7=L7Type.GENERIC,
            generic=GenericL7Info(proto="r2d2", fields=fields),
        ))
    return SynthScenario(
        name="generic", rules=[rule],
        endpoints={"r2d2": {"app": "r2d2"},
                   "droid": {"app": "droid"}},
        flows=flows,
    )


# ------------------------------------------- protocol-frontend lane --
#: per-protocol traffic shares of the mixed protocols scenario (and
#: the serve-soak load model's protocol-mix knob default)
PROTOCOL_MIX = (("cassandra", 0.4), ("memcache", 0.4), ("r2d2", 0.2))

#: dports per frontend protocol (the well-known service ports)
PROTOCOL_PORTS = {"cassandra": 9042, "memcache": 11211, "r2d2": 4040}


def synth_protocols_scenario(n_rules: int = 120, n_flows: int = 100000,
                             seed: int = 0,
                             mix=PROTOCOL_MIX) -> SynthScenario:
    """Mixed protocol-frontend traffic: cassandra,
    memcached, and r2d2 records against per-protocol rule sets on one
    endpoint — every record compiles through the frontend registry
    onto the l7g banked automaton and rides the same fused dispatch.
    ``mix`` weights the per-protocol traffic shares (the serve-soak
    protocol-mix knob reuses it)."""
    from cilium_tpu_torch.core.flow import GenericL7Info

    rng = random.Random(seed)
    protos = [p for p, _ in mix]
    weights = [w for _, w in mix]
    per = max(1, n_rules // max(1, len(protos)))
    rules_of: Dict[str, list] = {}
    for proto in protos:
        rr = []
        for i in range(per):
            if proto == "cassandra":
                rr.append({"query_action":
                           ("select", "insert", "update")[i % 3],
                           "query_table": f"ks.t{i}"})
            elif proto == "memcache":
                rr.append({"cmd": ("get", "set", "delete")[i % 3],
                           "key": f"k{i}"})
            else:
                rr.append({"cmd": ("READ", "WRITE")[i % 2],
                           "file": f"f{i}.dat"})
        rules_of[proto] = rr
    ports = tuple(
        PortRule(ports=(PortProtocol(PROTOCOL_PORTS[p], Protocol.TCP),),
                 rules=L7Rules(l7proto=p,
                               l7=tuple(PortRuleL7.from_dict(r)
                                        for r in rules_of[p])))
        for p in protos)
    rule = Rule(
        endpoint_selector=_sel(app="polysvc"),
        ingress=(IngressRule(from_endpoints=(_sel(app="client"),),
                             to_ports=ports),),
        labels=("synth=protocols",),
    )
    flows = []
    for _ in range(n_flows):
        proto = rng.choices(protos, weights=weights)[0]
        rr = rules_of[proto]
        i = rng.randrange(len(rr) + len(rr) // 4 + 1)  # some unmatched
        if i < len(rr):
            fields = dict(rr[i])
            if rng.random() < 0.25 and len(fields) > 1:
                # matched command, wrong second field → denied
                k = sorted(fields)[-1]
                fields[k] = fields[k] + ".nope"
        else:
            fields = ({"query_action": "drop",
                       "query_table": "forbidden"}
                      if proto == "cassandra" else
                      {"cmd": "flush_all"} if proto == "memcache"
                      else {"cmd": "HALT"})
        flows.append(Flow(
            src_identity=0, dst_identity=0,
            dport=PROTOCOL_PORTS[proto],
            protocol=Protocol.TCP, direction=ING, l7=L7Type.GENERIC,
            generic=GenericL7Info(proto=proto, fields=fields),
        ))
    return SynthScenario(
        name="protocols", rules=[rule],
        endpoints={"polysvc": {"app": "polysvc"},
                   "client": {"app": "client"}},
        flows=flows,
    )


# ------------------------------------------- generic pair-path lane --
#: ports of the lineparser scenario: exact lines, a presence rule, an
#: allow-all l7proto
LINE_PORT, PRESENCE_PORT, ANY_PORT = 7000, 7001, 7002


def synth_lineparser_scenario(n_rules: int = 40, n_flows: int = 20000,
                              seed: int = 0) -> SynthScenario:
    """``test.lineparser`` ACLs: a proxy-only ``l7proto`` (no engine
    frontend), so its records stay on the generic pair path and off
    ``l7g``. Exact lines on LINE_PORT, a presence rule on
    PRESENCE_PORT, an allow-all on ANY_PORT; a tenth of the records
    carry no line."""
    from cilium_tpu_torch.core.flow import GenericL7Info

    rng = random.Random(seed)
    lines = [f"cmd{i} arg" for i in range(n_rules)]

    def port(p, l7):
        return PortRule(ports=(PortProtocol(p, Protocol.TCP),),
                        rules=L7Rules(l7proto="test.lineparser", l7=l7))

    rule = Rule(
        endpoint_selector=_sel(app="liner"),
        ingress=(IngressRule(
            from_endpoints=(_sel(app="client"),),
            to_ports=(
                port(LINE_PORT, tuple(PortRuleL7.from_dict({"line": ln})
                                      for ln in lines)),
                port(PRESENCE_PORT, (PortRuleL7.from_dict({"line": ""}),)),
                port(ANY_PORT, ()))),),
        labels=("synth=lineparser",))
    flows = []
    for _ in range(n_flows):
        i = rng.randrange(n_rules + n_rules // 3 + 1)   # some unmatched
        fields = ({"line": lines[i]} if i < n_rules
                  else {"line": f"other{i}"})
        if rng.random() < 0.1:
            fields = {}
        flows.append(Flow(
            src_identity=0, dst_identity=0,
            dport=rng.choice((LINE_PORT, LINE_PORT, PRESENCE_PORT,
                              ANY_PORT)),
            protocol=Protocol.TCP, direction=ING, l7=L7Type.GENERIC,
            generic=GenericL7Info(proto="test.lineparser", fields=fields),
        ))
    return SynthScenario(
        name="lineparser", rules=[rule],
        endpoints={"liner": {"app": "liner"},
                   "client": {"app": "client"}},
        flows=flows,
    )


# ------------------------------------------------------ config 3: mixed --
def synth_mixed_scenario(corpus_dir: str, n_tuples: int = 1_000_000,
                         seed: int = 0) -> SynthScenario:
    """examples/policies corpus × synthetic identity/flow tuples."""
    from cilium_tpu_torch.policy.api import load_cnp_dir

    rng = random.Random(seed)
    cnps = load_cnp_dir(corpus_dir)
    rules: List[Rule] = []
    for c in cnps:
        rules.extend(c.rules)
    # endpoints covering the corpus selectors
    endpoints = {
        "frontend": {"app": "frontend"},
        "backend": {"app": "backend"},
        "db": {"app": "db"},
        "service": {"app": "service"},
        "kafka": {"app": "kafka"},
        "empire-hq": {"app": "empire-hq"},
        "crawler": {"app": "crawler"},
        "scraper": {"app": "scraper"},
        "exporters": {"app": "exporters"},
        "web": {"tier": "web", "env": "prod"},
        "cache": {"tier": "cache"},
        "bystander": {"app": "bystander"},
        # realistic/ corpus coverage (round 3): representative
        # endpoints per namespace so the 1M-tuple stream exercises the
        # production-shaped rules too
        "storefront": {"app": "storefront", "tier": "web",
                       "env": "prod"},
        "catalog": {"app": "catalog", "tier": "backend", "env": "prod"},
        "payments": {"app": "payments", "tier": "backend",
                     "env": "prod"},
        "orders-db": {"app": "orders-db"},
        "broker": {"app": "broker"},
        "orders-svc": {"app": "orders-svc"},
        "analytics": {"app": "analytics"},
        "apigw": {"app": "apigw"},
        "internal": {"zone": "internal"},
        "team-a": {"team": "a"},
        "team-b": {"team": "b"},
        "prom": {"app": "prom"},
        "ledger": {"app": "ledger", "ns": "fintech"},
        "transfer-svc": {"app": "transfer-svc", "ns": "fintech"},
        "registry": {"app": "registry"},
        "ci-runner": {"app": "ci-runner"},
        "webapp": {"app": "webapp", "ns": "saas"},
        "api-paid": {"app": "api", "plan": "paid"},
        "worker": {"role": "worker"},
        "tenant-db": {"app": "tenant-db"},
    }
    names = list(endpoints)
    ports = [80, 443, 5432, 9092, 53, 9100, 9105, 8080,
             8443, 7443, 5000, 6379, 9080, 5672, 50051]
    flows = []
    for _ in range(n_tuples):
        src, dst = rng.choice(names), rng.choice(names)
        port = rng.choice(ports)
        proto = Protocol.UDP if port == 53 else Protocol.TCP
        f = Flow(src_identity=0, dst_identity=0, dport=port, protocol=proto,
                 direction=ING)
        if port == 80 and rng.random() < 0.5:
            f.l7 = L7Type.HTTP
            f.http = HTTPInfo(
                method=rng.choice(["GET", "PUT", "POST"]),
                path=rng.choice(["/api/v1/x", "/api/v1/config",
                                 "/other", "/api/v9/y"]),
                headers=((("X-Admin", "true"),) if rng.random() < 0.5
                         else ()),
            )
        elif port == 9092 and rng.random() < 0.5:
            f.l7 = L7Type.KAFKA
            f.kafka = KafkaInfo(
                api_key=rng.choice([0, 1, 3]),
                topic=rng.choice(["deathstar-plans", "empire-announce",
                                  "other"]),
                client_id="c")
        elif port == 53 and rng.random() < 0.5:
            f.l7 = L7Type.DNS
            f.dns = DNSInfo(query=rng.choice(
                ["www.cilium.io", "example.com", "evil.io"]))
        f._src_name = src  # filled to identities by the harness
        f._dst_name = dst
        flows.append(f)
    return SynthScenario(name="mixed", rules=rules, endpoints=endpoints,
                        flows=flows)


# ------------------------------------------------ config 4: clustermesh --
def synth_clustermesh_scenario(n_identities: int = 10000,
                               n_policies: int = 5000,
                               n_flows: int = 100000,
                               seed: int = 0) -> SynthScenario:
    """10k identities × 5k CNPs. Policies select label shards; peers
    select other shards; sprinkled L7."""
    rng = random.Random(seed)
    n_apps = 500
    endpoints = {
        f"ep{i}": {"app": f"app{i % n_apps}",
                   "shard": f"s{i % 64}",
                   "cluster": f"c{i % 4}"}
        for i in range(n_identities)
    }
    rules: List[Rule] = []
    for i in range(n_policies):
        app = f"app{i % n_apps}"
        peer_shard = f"s{(i * 7) % 64}"
        port = 1000 + (i % 200)
        l7 = None
        if i % 10 == 0:
            l7 = L7Rules(http=(
                PortRuleHTTP(method="GET", path=f"/p{i}/.*"),))
        rules.append(Rule(
            endpoint_selector=_sel(app=app),
            ingress=(IngressRule(
                from_endpoints=(_sel(shard=peer_shard),),
                to_ports=(PortRule(
                    ports=(PortProtocol(port, Protocol.TCP),),
                    rules=l7,
                ),),
                deny=(i % 17 == 0) and l7 is None,
            ),),
            labels=(f"synth=mesh{i}",),
        ))
    names = list(endpoints)
    flows = []
    for _ in range(n_flows):
        src, dst = rng.choice(names), rng.choice(names)
        port = 1000 + rng.randrange(220)
        f = Flow(src_identity=0, dst_identity=0, dport=port,
                 protocol=Protocol.TCP, direction=ING)
        if rng.random() < 0.1:
            f.l7 = L7Type.HTTP
            f.http = HTTPInfo(method="GET",
                              path=f"/p{rng.randrange(n_policies)}/x")
        f._src_name = src
        f._dst_name = dst
        flows.append(f)
    return SynthScenario(name="clustermesh", rules=rules,
                        endpoints=endpoints, flows=flows)


# ----------------------------------------------------------- harness ----
def scenario_by_name(name: str, n_rules: int, n_flows: int,
                     seed: int = 0) -> "SynthScenario":
    """Scenario dispatch (the reference's, including fqdn's 100-name
    universe)."""
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
    if name == "generic":
        return synth_generic_scenario(n_rules=n_rules, n_flows=n_flows,
                                      seed=seed)
    if name == "protocols":
        return synth_protocols_scenario(n_rules=n_rules,
                                        n_flows=n_flows, seed=seed)
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
        # one resolve a distinct rule set (the reference resolves every
        # endpoint; the contents are the same)
        by_name = resolver.resolve_many(labelsets)
        per_identity = {ids[n]: by_name[n] for n in scenario.endpoints}
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
    elif scenario.name == "lineparser":
        for f in scenario.flows:
            f.src_identity = ids["client"]
            f.dst_identity = ids["liner"]
    return per_identity, scenario


def scenario_capture_columns(scenario, n_records: int):
    """A realized scenario's flows, replicated to ``n_records`` and
    encoded straight into capture columns (``ingest.columnar``): the
    capture-writing face shared by ``tools/bench.py``'s capture lane
    and ``tools/bench_stage.py``, so both write the same traffic the
    same columnar way."""
    from cilium_tpu_torch.ingest.columnar import flows_to_columns

    flows = scenario.flows
    reps = -(-n_records // len(flows))
    return flows_to_columns((flows * reps)[:n_records])


def write_scenario_capture(path: str, scenario, n_records: int) -> int:
    """``scenario_capture_columns`` → the streaming record-batch
    writer; returns the record count."""
    from cilium_tpu_torch.ingest.binary import write_capture_columns

    return write_capture_columns(
        path, scenario_capture_columns(scenario, n_records))
