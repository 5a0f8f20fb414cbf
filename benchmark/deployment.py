"""A deployment, read from ``benchmark/configs/<name>.json``: its
identities (label sets and the numbers a Hubble export carries) and its
CiliumNetworkPolicy rules. The traffic its users send is a mix of its
own (``benchmark/traffic/<name>.json``). A policy's L7 rules are one
family, as one upstream port rule holds: an ``"http"`` group of
``PortRuleHTTP`` rules or a ``"kafka"`` group of ``PortRuleKafka``
rules.

Plain Python and NumPy. The reference, the traffic generator and the
adapter into the program all read this one description, so nothing
here imports the program.

Counts are given as groups that expand by index. Strings and numbers in
a group may hold templates ``{i}``, ``{j}``, ``{r}`` or ``{n}`` followed
by integer operations applied left to right: ``{i*7%64}`` is
``(i * 7) % 64``, ``{i//2500+1}`` is ``i // 2500 + 1``.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

_TEMPLATE = re.compile(r"\{([ijrn])((?:\*\d+|%\d+|//\d+|\+\d+)*)\}")
_OP = re.compile(r"(\*|%|//|\+)(\d+)")

PROTOCOLS = {"TCP": 6, "UDP": 17}
DIRECTIONS = {"egress": 0, "ingress": 1}

#: Kafka API keys by the names ``apiKey`` takes (upstream
#: ``pkg/policy/api/kafka.go`` ``KafkaAPIKeyMap``)
KAFKA_API_KEYS = {
    "produce": 0, "fetch": 1, "offsets": 2, "metadata": 3,
    "leaderandisr": 4, "stopreplica": 5, "updatemetadata": 6,
    "controlledshutdown": 7, "offsetcommit": 8, "offsetfetch": 9,
    "findcoordinator": 10, "joingroup": 11, "heartbeat": 12,
    "leavegroup": 13, "syncgroup": 14, "describegroups": 15,
    "listgroups": 16, "saslhandshake": 17, "apiversions": 18,
    "createtopics": 19, "deletetopics": 20, "deleterecords": 21,
    "initproducerid": 22, "offsetforleaderepoch": 23,
    "addpartitionstotxn": 24, "addoffsetstotxn": 25, "endtxn": 26,
    "writetxnmarkers": 27, "txnoffsetcommit": 28, "describeacls": 29,
    "createacls": 30, "deleteacls": 31, "describeconfigs": 32,
    "alterconfigs": 33,
}
KAFKA_ROLES = ("produce", "consume")
_KAFKA_TOPIC = re.compile(r"[a-zA-Z0-9._\-]{1,255}")


def _apply(v: int, ops: str) -> int:
    for op, num in _OP.findall(ops):
        k = int(num)
        if op == "*":
            v *= k
        elif op == "%":
            v %= k
        elif op == "//":
            v //= k
        else:
            v += k
    return v


def expand(text: str, **var: int) -> str:
    """``text`` with every template replaced by its value."""
    def sub(m):
        return str(_apply(var[m.group(1)], m.group(2)))
    return _TEMPLATE.sub(sub, text)


def expand_int(text, **var: int) -> int:
    return int(expand(str(text), **var))


def expand_map(d: Dict[str, str], **var: int) -> Dict[str, str]:
    return {expand(k, **var): expand(v, **var) for k, v in d.items()}


@dataclasses.dataclass(frozen=True)
class HTTPRule:
    """One ``PortRuleHTTP``: regexes on method, path and host (empty =
    any) and required headers as ``(name, value)`` (empty value = the
    header present with any value)."""

    method: str = ""
    path: str = ""
    host: str = ""
    headers: Tuple[Tuple[str, str], ...] = ()


@dataclasses.dataclass(frozen=True)
class KafkaRule:
    """One ``PortRuleKafka``: ``role`` (produce or consume) or a named
    ``api_key``, an exact ``api_version``, ``client_id`` and ``topic``;
    empty = any. Role and API key are never both given (upstream's
    ``Sanitize`` refuses it); neither given = any API key."""

    role: str = ""
    api_key: str = ""
    api_version: str = ""
    client_id: str = ""
    topic: str = ""

    def __post_init__(self):
        if self.role and self.api_key:
            raise ValueError("a Kafka rule gives a role or an apiKey, "
                             "not both")
        if self.role and self.role not in KAFKA_ROLES:
            raise ValueError(f"unknown Kafka role {self.role!r}")
        if self.api_key and self.api_key not in KAFKA_API_KEYS:
            raise ValueError(f"unknown Kafka apiKey {self.api_key!r}")
        if self.api_version and not -(1 << 15) <= int(self.api_version) \
                < (1 << 15):
            raise ValueError(f"Kafka apiVersion {self.api_version!r} "
                             "is not a 16-bit number")
        if self.topic and _KAFKA_TOPIC.fullmatch(self.topic) is None:
            raise ValueError(f"invalid Kafka topic {self.topic!r}")


@dataclasses.dataclass(frozen=True)
class Policy:
    """One CNP with one rule: endpoints selected by ``select`` take
    traffic in ``direction`` from (ingress) or to (egress) the
    identities ``peer`` selects, on ``port``/``proto`` (port 0 = any),
    as a deny, an allow, or an allow restricted to ``http`` or to
    ``kafka`` (one family at most)."""

    name: str
    select: Tuple[Tuple[str, str], ...]
    direction: int
    peer: Tuple[Tuple[str, str], ...]
    port: int
    proto: int
    deny: bool
    http: Tuple[HTTPRule, ...]
    kafka: Tuple[KafkaRule, ...] = ()

    def __post_init__(self):
        if self.http and self.kafka:
            raise ValueError(f"policy {self.name}: HTTP and Kafka rules "
                             "in one port rule")


@dataclasses.dataclass
class Deployment:
    name: str
    ids: np.ndarray                      # [E] int64 identity numbers
    labels: List[Dict[str, str]]         # [E] label sets
    policies: List[Policy]
    engine: Dict[str, object]


def _headers(spec: Sequence) -> Tuple[Tuple[str, str], ...]:
    out = []
    for h in spec:
        if isinstance(h, str):
            name, _, value = h.partition(":")
            out.append((name.strip(), value.strip()))
        else:
            out.append((str(h[0]), str(h[1])))
    return tuple(out)


def _identities(groups) -> Tuple[np.ndarray, List[Dict[str, str]]]:
    ids: List[int] = []
    labels: List[Dict[str, str]] = []
    for g in groups:
        for i in range(int(g["count"])):
            labels.append(expand_map(g["labels"], i=i))
            cluster = expand_int(g["id"]["cluster"], i=i)
            local = expand_int(g["id"]["local"], i=i)
            ids.append((cluster << 16) | local)
    arr = np.asarray(ids, dtype=np.int64)
    if len(np.unique(arr)) != len(arr):
        raise ValueError("two endpoints share an identity number")
    if len({tuple(sorted(d.items())) for d in labels}) != len(labels):
        raise ValueError("two identities share a label set")
    return arr, labels


def _http_rule(s: Dict, i: int, j: int) -> HTTPRule:
    return HTTPRule(
        method=expand(s.get("method", ""), i=i, j=j),
        path=expand(s.get("path", ""), i=i, j=j),
        host=expand(s.get("host", ""), i=i, j=j),
        headers=_headers([expand(h, i=i, j=j)
                          for h in s.get("headers", ())]))


def _kafka_rule(s: Dict, i: int, j: int) -> KafkaRule:
    def get(key: str) -> str:
        return expand(str(s.get(key, "")), i=i, j=j)
    return KafkaRule(role=get("role").lower(), api_key=get("apiKey").lower(),
                     api_version=get("apiVersion"), client_id=get("clientID"),
                     topic=get("topic"))


_FAMILIES = (("http", _http_rule), ("kafka", _kafka_rule))


def _l7_rules(g: Dict, i: int) -> Dict[str, tuple]:
    """The policy's rules by family: a group's ``every``-th policy takes
    ``count`` rules, rule ``j`` of shape ``j % len(shapes)``."""
    out: Dict[str, tuple] = {}
    for family, build in _FAMILIES:
        spec = g.get(family)
        if spec is None or i % int(spec.get("every", 1)):
            continue
        shapes = spec["shapes"]
        out[family] = tuple(build(shapes[j % len(shapes)]["rule"], i, j)
                            for j in range(int(spec.get("count", 1))))
    return out


def _policies(groups) -> List[Policy]:
    out: List[Policy] = []
    for g in groups:
        deny_every = int(g.get("deny_every", 0))
        for i in range(int(g["count"])):
            rules = _l7_rules(g, i)
            deny = (deny_every > 0 and i % deny_every == 0
                    and not any(rules.values()))
            peer = g["deny_peer"] if deny and "deny_peer" in g \
                else g["peer"]
            out.append(Policy(
                name=expand(g.get("name", "cnp{i}"), i=i),
                select=tuple(sorted(expand_map(g["select"], i=i).items())),
                direction=DIRECTIONS[g.get("direction", "ingress")],
                peer=tuple(sorted(expand_map(peer, i=i).items())),
                port=expand_int(g.get("port", 0), i=i),
                proto=PROTOCOLS[g.get("protocol", "TCP")],
                deny=deny, http=rules.get("http", ()),
                kafka=rules.get("kafka", ())))
    return out


def from_dict(raw: Dict[str, object]) -> Deployment:
    ids, labels = _identities(raw["identities"])
    return Deployment(name=str(raw["name"]), ids=ids, labels=labels,
                      policies=_policies(raw["policies"]),
                      engine=dict(raw.get("engine", {})))


def load(path: str) -> Deployment:
    with open(path) as fh:
        return from_dict(json.load(fh))


def selected(selector: Tuple[Tuple[str, str], ...], dep: Deployment,
             index: Dict[Tuple[str, str], frozenset]) -> np.ndarray:
    """Positions (into ``dep.ids``) of the identities ``selector``
    picks by ``matchLabels`` (every pair held; an empty value = the key
    held), through :func:`label_index`."""
    if not selector:
        return np.arange(len(dep.ids), dtype=np.int64)
    sets = [index.get(kv, frozenset()) for kv in selector]
    hit = frozenset.intersection(*sets) if sets else frozenset()
    return np.asarray(sorted(hit), dtype=np.int64)


def label_index(dep: Deployment) -> Dict[Tuple[str, str], frozenset]:
    """(key, value) → positions holding that label; (key, "") → those
    holding the key."""
    idx: Dict[Tuple[str, str], set] = {}
    for e, lb in enumerate(dep.labels):
        for k, v in lb.items():
            idx.setdefault((k, v), set()).add(e)
            idx.setdefault((k, ""), set()).add(e)
    return {k: frozenset(v) for k, v in idx.items()}
