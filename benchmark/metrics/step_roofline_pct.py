"""The capture step's share of its roofline: the least time the card
could take to move the bytes a chunk needs (bytes / 3.35 TB/s, the
H100's HBM rate at the full 700 W), over the step's device time.

The bytes are counted here from the chunk's and the deployment's
shapes, whatever kernels implement the step, each input byte read once
and each output byte written once:

- the chunk's rows as the replay hands them to the step;
- a row of match words for each distinct string a field of the chunk's
  HTTP records holds: one bit a distinct pattern of that field in the
  deployment's rules (method, path, host regexes; header requirements),
  in 32-bit words;
- a 16-byte mapstate entry for each distinct (endpoint, peer, port,
  protocol, direction) key of the chunk that some policy covers;
- four 32-bit rule words (path, method, host, headers) for each rule of
  each distinct HTTP rule set the chunk's redirected HTTP records need;
- four 32-bit rule words (API-key mask, version, client, topic) for each
  rule of each distinct Kafka rule set the chunk's redirected Kafka
  records need. A Kafka record's client id and topic are exact ids,
  interned on the host once a file, so no match words are counted for
  them: they are in the row;
- every output lane the replay returns, at its dtype.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from benchmark.peaks import H100_HBM_BYTES_PER_S
from benchmark.traffic import HTTP, KAFKA

ENTRY_BYTES = 16
RULE_FIELDS = 4


def step_bytes(rows: int, row_bytes: int,
               field_words: Dict[str, Tuple[int, int]], entries: int,
               rules: int, lane_bytes: int) -> int:
    """``field_words`` maps a field to (distinct strings, 32-bit words a
    string); ``rules`` is the rules of the rule sets needed."""
    words = sum(n * w for n, w in field_words.values())
    return (rows * row_bytes + 4 * words + ENTRY_BYTES * entries
            + 4 * RULE_FIELDS * rules + rows * lane_bytes)


def pattern_words(dep) -> Dict[str, int]:
    """32-bit words a string of each field needs: one bit a distinct
    pattern of the field in the deployment's HTTP rules."""
    pats = {"method": set(), "path": set(), "host": set(), "headers": set()}
    for p in dep.policies:
        for r in p.http:
            for f in ("method", "path", "host"):
                if getattr(r, f):
                    pats[f].add(getattr(r, f))
            pats["headers"].update(r.headers)
    return {f: -(-len(v) // 32) for f, v in pats.items()}


def chunk_bytes(dep, rec, expected, start: int, n: int, row_bytes: int,
                lane_bytes: int, words: Dict[str, int]) -> int:
    sl = slice(start, start + n)
    http = rec.l7[sl] == HTTP
    field_words = {}
    for f, w in words.items():
        idx = rec.strings[f][1][sl][http]
        field_words[f] = (int(len(np.unique(idx[idx > 0]))), w)
    cov = expected.covered[sl]
    keys = np.stack([rec.src[sl], rec.dst[sl], rec.dport[sl],
                     rec.proto[sl], rec.direction[sl]], axis=1)[cov]
    entries = int(len(np.unique(keys, axis=0))) if len(keys) else 0
    rules = 0
    for fam, of_fam, need in (
            ("http", http, expected.http_policy[sl]),
            ("kafka", rec.l7[sl] == KAFKA, expected.kafka_policy[sl])):
        need = need[of_fam]
        rules += sum(len(getattr(dep.policies[k], fam))
                     for k in np.unique(need[need >= 0]))
    return step_bytes(n, row_bytes, field_words, entries, rules, lane_bytes)


def read(ctx):
    r = ctx.get("trace")
    b = ctx.get("step_bytes")
    if r is None or r.kernels == 0 or not b:
        return None
    least_s = (sum(b) / len(b)) / H100_HBM_BYTES_PER_S
    return 100.0 * least_s / (r.kernel_s / r.chunks)
