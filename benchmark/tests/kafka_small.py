"""A small Kafka deployment and its traffic, for the CPU tests: one
broker behind 20 ``PortRuleKafka`` rules of both roles on TCP/9092,
allowed from one client, and a generator of produce/fetch records drawn
from those rules.

The generator is found by name as the benchmark's own are: a test puts
this module in ``sys.modules`` under :data:`MODULE`, so a mix naming
``generator: kafka-small`` draws from it through
``benchmark.traffic.generate``.

``base`` flows, each a rule of policy ``policy`` drawn uniformly and its
``hit`` request with probability ``hit_share``, its ``miss`` request
otherwise; the capture repeats them up to ``records``. ``requests``
holds a (hit, miss) pair of request templates in the rule index ``j``
for each Kafka shape of the policy: ``apiKey`` (a name), ``apiVersion``,
``clientID`` and ``topic``, each optional.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from benchmark.deployment import (
    KAFKA_API_KEYS,
    Deployment,
    expand,
    label_index,
    selected,
)
from benchmark.traffic import KAFKA, Records, intern

MODULE = "benchmark.traffic.kafka_small"

CONFIG = {
    "name": "kafka-small",
    "deployment": "One broker on TCP/9092 behind 20 Kafka rules of both "
                  "roles, allowed from one client; every request proxied.",
    "control": "kafka_key_ignored",
    "engine": {"bank_size": 128, "kernel_impl": "auto"},
    "identities": [
        {"count": 1, "labels": {"app": "client"},
         "id": {"cluster": "1", "local": "{i+256}"}},
        {"count": 1, "labels": {"app": "broker"},
         "id": {"cluster": "1", "local": "{i+257}"}},
    ],
    "policies": [{
        "count": 1, "name": "kafka-rules", "select": {"app": "broker"},
        "direction": "ingress", "peer": {"app": "client"},
        "port": "9092", "protocol": "TCP",
        "kafka": {"every": 1, "count": 20, "shapes": [
            {"rule": {"role": "produce", "topic": "orders-{j}"}},
            {"rule": {"role": "consume", "clientID": "reader-{j%3}",
                      "topic": "events-{j}"}},
            {"rule": {"apiKey": "offsetcommit", "apiVersion": "2",
                      "topic": "audit-{j}"}},
            {"rule": {"role": "consume", "topic": "logs-{j}"}},
            {"rule": {"role": "produce", "clientID": "ingest-{j%2}"}},
        ]},
    }],
}

MIX = {
    "generator": "kafka-small", "records": 4096, "chunk": 1024,
    "policy": 0, "base": 300, "hit_share": 0.5,
    "requests": [
        [{"apiKey": "produce", "apiVersion": "{j%8}",
          "clientID": "app-{j%4}", "topic": "orders-{j}"},
         {"apiKey": "fetch", "apiVersion": "{j%8}",
          "clientID": "app-{j%4}", "topic": "orders-{j}"}],
        [{"apiKey": "fetch", "apiVersion": "11", "clientID": "reader-{j%3}",
          "topic": "events-{j}"},
         {"apiKey": "fetch", "apiVersion": "11", "clientID": "reader-9",
          "topic": "events-{j}"}],
        [{"apiKey": "offsetcommit", "apiVersion": "2", "topic": "audit-{j}"},
         {"apiKey": "offsetcommit", "apiVersion": "3", "topic": "audit-{j}"}],
        [{"apiKey": "joingroup", "apiVersion": "5", "topic": "logs-{j}"},
         {"apiKey": "produce", "apiVersion": "5", "topic": "logs-{j}"}],
        [{"apiKey": "produce", "apiVersion": "9", "clientID": "ingest-{j%2}",
          "topic": "metrics-{j}"},
         {"apiKey": "produce", "apiVersion": "9", "clientID": "other",
          "topic": "metrics-{j}"}],
    ],
}


def request(tmpl: Dict, **var):
    """(API key, API version, client id, topic) of a request template."""
    return (KAFKA_API_KEYS[expand(tmpl["apiKey"], **var)],
            int(expand(tmpl.get("apiVersion", "0"), **var)),
            expand(tmpl.get("clientID", ""), **var).encode(),
            expand(tmpl.get("topic", ""), **var).encode())


def generate(dep: Deployment, mix: Dict[str, object],
             rng: np.random.Generator) -> Records:
    n = int(mix["records"])
    pol = dep.policies[int(mix["policy"])]
    if not pol.kafka:
        raise ValueError(f"policy {pol.name} has no Kafka rules to draw")
    shapes = mix["requests"]
    index = label_index(dep)
    base = int(mix["base"])
    rule = rng.integers(0, len(pol.kafka), base)
    hit = rng.random(base) < float(mix["hit_share"])
    peers = selected(pol.peer, dep, index)
    eps = selected(pol.select, dep, index)
    src_b = dep.ids[peers[rng.integers(0, len(peers), base)]]
    dst_b = dep.ids[eps[rng.integers(0, len(eps), base)]]
    reqs = [request(shapes[j % len(shapes)][0 if h else 1], j=int(j))
            for j, h in zip(rule, hit)]
    pick = np.arange(n) % base
    if pol.direction == 1:
        src, dst = src_b[pick], dst_b[pick]
    else:
        src, dst = dst_b[pick], src_b[pick]
    key, ver, client, topic = zip(*reqs)
    strings = {}
    for f, col in (("kafka_client", client), ("kafka_topic", topic)):
        table, idx = intern(list(col))
        strings[f] = (table, idx[pick])
    return Records(src=src.astype(np.uint32), dst=dst.astype(np.uint32),
                   dport=np.full(n, pol.port, dtype=np.uint16),
                   proto=np.full(n, pol.proto, dtype=np.uint8),
                   direction=np.full(n, pol.direction, dtype=np.uint8),
                   l7=np.full(n, KAFKA, dtype=np.uint8), strings=strings,
                   kafka_api_key=np.asarray(key, dtype=np.int16)[pick],
                   kafka_api_version=np.asarray(ver, dtype=np.int16)[pick])
