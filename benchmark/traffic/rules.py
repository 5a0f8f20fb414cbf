"""A replayed capture of requests drawn from the rules of one policy.

``base`` flows, each one HTTP request of a rule of policy ``policy``
drawn uniformly, its ``hit`` request with probability ``hit_share`` and
its ``miss`` request otherwise, from an identity the policy's peer
selector picks to one its endpoint selector picks; the capture repeats
the base flows in order up to ``records``.

``requests`` holds a (hit, miss) pair of request templates in the rule
index ``j`` for each HTTP shape of the policy, in the configuration's
order (rule ``j`` has shape ``j % len(requests)``). ``distinct_header``,
a header name and a value template in the record index ``n`` (as
``["x-request-id", "{n}"]``), is added to every record, so every
record is distinct while no rule's verdict on it changes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from benchmark.deployment import Deployment, label_index, selected
from benchmark.traffic import (
    HTTP,
    HTTP_FIELDS,
    Records,
    add_header,
    intern,
    request,
)


def generate(dep: Deployment, mix: Dict[str, object],
             rng: np.random.Generator) -> Records:
    n = int(mix["records"])
    pol = dep.policies[int(mix["policy"])]
    if not pol.http:
        raise ValueError(f"policy {pol.name} has no HTTP rules to draw")
    shapes = mix["requests"]
    index = label_index(dep)
    base = int(mix["base"])
    rule = rng.integers(0, len(pol.http), base)
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
    strings = {}
    for f, col in zip(HTTP_FIELDS, zip(*reqs)):
        table, idx = intern(list(col))
        strings[f] = (table, idx[pick])
    extra = mix.get("distinct_header")
    if extra:
        add_header(strings, np.arange(n), str(extra[0]), str(extra[1]))
    return Records(src=src.astype(np.uint32), dst=dst.astype(np.uint32),
                   dport=np.full(n, pol.port, dtype=np.uint16),
                   proto=np.full(n, pol.proto, dtype=np.uint8),
                   direction=np.full(n, pol.direction, dtype=np.uint8),
                   l7=np.full(n, HTTP, dtype=np.uint8), strings=strings)
