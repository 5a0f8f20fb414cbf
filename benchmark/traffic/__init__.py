"""Traffic: a mix (``benchmark/traffic/<name>.json``) drawn from the
seed by the generator it names (``benchmark/traffic/<generator>.py``,
a module with ``generate(dep, mix, rng) -> Records``, a name's ``.``
and ``-`` becoming ``_``).

A mix gives ``generator``, ``records`` (the capture's length), ``chunk``
(the records a replay call takes) and its generator's parameters. So a
new mix of an existing generator is a data file alone, and a new kind
of draw is one module beside it; nothing here changes.

Strings are kept as one table a field (``[S] bytes``, string 0 empty)
and an index a record, as the capture stores them; header blocks are
written as the capture carries them: ``name:value`` lines, names lower
case, sorted, each ending in a newline. A Kafka record carries its API
key and version as numbers and its client id and topic as strings
(string 0: none). A record carries zeros and string 0 in the columns
of the other family, and a generator may leave out the columns of a
family it does not draw.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from benchmark.deployment import _OP, _TEMPLATE, Deployment, expand
from benchmark.registry import BenchmarkError, check_name, module_name

HTTP = 1           # Hubble's L7 types: an HTTP record,
KAFKA = 2          # a Kafka record
HTTP_FIELDS = ("method", "path", "host", "headers")
KAFKA_FIELDS = ("kafka_client", "kafka_topic")
STRING_FIELDS = HTTP_FIELDS + KAFKA_FIELDS


@dataclasses.dataclass
class Records:
    src: np.ndarray          # [N] uint32 identity numbers
    dst: np.ndarray          # [N] uint32
    dport: np.ndarray        # [N] uint16
    proto: np.ndarray        # [N] uint8
    direction: np.ndarray    # [N] uint8 (0 egress, 1 ingress)
    l7: np.ndarray           # [N] uint8 (0 none, 1 HTTP, 2 Kafka)
    #: field → (table [S] of bytes with table[0] == b"", index [N] int64)
    strings: Dict[str, Tuple[List[bytes], np.ndarray]]
    kafka_api_key: Optional[np.ndarray] = None      # [N] int16
    kafka_api_version: Optional[np.ndarray] = None  # [N] int16

    def __post_init__(self):
        n = len(self.src)
        for col in ("kafka_api_key", "kafka_api_version"):
            if getattr(self, col) is None:
                setattr(self, col, np.zeros(n, dtype=np.int16))
        for f in STRING_FIELDS:
            self.strings.setdefault(f, ([b""], np.zeros(n, dtype=np.int64)))

    def __len__(self) -> int:
        return len(self.src)


def load_traffic(path: str) -> Dict[str, object]:
    with open(path) as fh:
        t = json.load(fh)
    check_name(t.get("generator"), "generator")
    if int(t["records"]) <= 0 or int(t["chunk"]) <= 0:
        raise ValueError(f"{path}: records and chunk must be positive")
    if int(t["records"]) % int(t["chunk"]):
        raise ValueError(f"{path}: records must be a multiple of chunk")
    return t


def rng_of(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) % (1 << 64))


def generate(dep: Deployment, mix: Dict[str, object], seed: int,
             package: str = "benchmark.traffic") -> Records:
    """The mix's records for ``seed``, by the generator it names."""
    name = module_name(mix.get("generator"), "generator")
    try:
        mod = importlib.import_module(f"{package}.{name}")
    except ModuleNotFoundError as e:
        raise BenchmarkError(f"no traffic generator {name!r}") from e
    return mod.generate(dep, mix, rng_of(seed))


def header_block(headers: Sequence) -> bytes:
    lines = sorted(f"{str(k).strip().lower()}:{str(v).strip()}"
                   for k, v in headers)
    return "".join(line + "\n" for line in lines).encode()


def intern(values: List[bytes]) -> Tuple[List[bytes], np.ndarray]:
    """values → (table with b"" first, index per value)."""
    table: List[bytes] = [b""]
    where: Dict[bytes, int] = {b"": 0}
    idx = np.empty(len(values), dtype=np.int64)
    for k, v in enumerate(values):
        p = where.get(v)
        if p is None:
            p = where[v] = len(table)
            table.append(v)
        idx[k] = p
    return table, idx


def request(tmpl: Dict, **var) -> Tuple[bytes, bytes, bytes, bytes]:
    """(method, path, host, header block) of a request template."""
    return (expand(tmpl.get("method", ""), **var).encode(),
            expand(tmpl.get("path", ""), **var).encode(),
            expand(tmpl.get("host", ""), **var).lower().encode(),
            header_block([(expand(k, **var), expand(v, **var))
                          for k, v in tmpl.get("headers", ())]))


def expand_rows(template: str, rows: np.ndarray) -> List[str]:
    """``template`` expanded for each record index in ``rows`` (one
    template in ``n`` at most: the text around it is joined once)."""
    m = _TEMPLATE.search(template)
    if m is None:
        return [template] * len(rows)
    if m.group(1) != "n" or _TEMPLATE.search(template, m.end()):
        raise ValueError(f"{template!r}: one template in n")
    pre, post = template[:m.start()], template[m.end():]
    vals = np.asarray(rows, dtype=np.int64)
    for op, num in _OP.findall(m.group(2)):
        k = int(num)
        vals = (vals * k if op == "*" else vals % k if op == "%"
                else vals // k if op == "//" else vals + k)
    return [f"{pre}{v}{post}" for v in vals.tolist()]


def add_header(strings: Dict[str, Tuple[List[bytes], np.ndarray]],
               rows: np.ndarray, name: str, value: str) -> None:
    """Add the header ``name: value`` (``value`` a template in the
    record index ``n``) to the header block of each record in ``rows``,
    in its sorted place."""
    name = name.strip().lower()
    key = f"{name}:".encode()
    table, idx = strings["headers"]
    vals = expand_rows(value, rows)
    new = np.zeros(len(idx), dtype=np.int64)
    blocks: List[bytes] = [b""]
    base = idx[rows]
    for b in np.unique(base).tolist():
        lines = [ln + b"\n" for ln in table[b].split(b"\n") if ln]
        if any(ln.startswith(key) for ln in lines):
            raise ValueError(f"header {name!r} is in the request already")
        pre = b"".join(ln for ln in lines if ln[:len(key)] < key).decode()
        post = b"".join(ln for ln in lines if ln[:len(key)] > key).decode()
        at = np.nonzero(base == b)[0]
        new[rows[at]] = np.arange(len(blocks), len(blocks) + len(at))
        blocks.extend(f"{pre}{name}:{vals[k].strip()}\n{post}".encode()
                      for k in at.tolist())
    strings["headers"] = dedup(blocks, new)


def dedup(table: List[bytes], idx: np.ndarray
          ) -> Tuple[List[bytes], np.ndarray]:
    """A table whose entries may repeat → one with each string once."""
    if len(set(table)) == len(table):
        return table, idx
    new, pos = intern(table)
    return new, pos[idx]
