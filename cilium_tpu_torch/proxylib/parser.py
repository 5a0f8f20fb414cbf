"""Parser ABI: connections, verdict ops, registry.

Reference semantics (``proxylib/proxylib/parserfactories.go``,
``proxylib/libcilium.go`` — unverified paths per SURVEY.md):

* A **Connection** is created per proxied connection with the L3/L4
  metadata (src/dst identity, ingress flag, addresses, selected parser
  name from the policy's ``l7proto``).
* The proxy feeds payload chunks to ``on_data(reply, end_stream,
  data)``; the parser returns a sequence of ops ``(OpType, n_bytes)``:
  PASS n (frame allowed), DROP n (frame denied), MORE n (need n more
  bytes before a decision), INJECT (emit synthetic bytes, e.g. an error
  response), ERROR.
* Frame-by-frame streaming with bounded buffering — the SP/sequence
  dimension of the reference (SURVEY.md §2.6): payloads are never
  materialized whole.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional, Tuple


class OpType(enum.IntEnum):
    MORE = 0
    PASS = 1
    DROP = 2
    INJECT = 3
    ERROR = 4


class Verdict(enum.IntEnum):
    """Per-record policy verdict inside a parser."""

    ALLOW = 1
    DENY = 2


Op = Tuple[OpType, int]


@dataclasses.dataclass
class Connection:
    proto: str
    connection_id: int
    ingress: bool
    src_identity: int
    dst_identity: int
    src_addr: str = ""
    dst_addr: str = ""
    policy_name: str = ""     # endpoint/policy scope
    dport: int = 0
    parser: Optional["Parser"] = None
    #: (reply, bytes) queued by INJECT ops, drained per DIRECTION by
    #: the proxy/shim in order — reply=True is client-bound (error
    #: responses), reply=False is upstream-bound (rewritten request
    #: frames). Mirrors proxylib's ``Inject(reply, data)``: one queue
    #: per stream direction, never mixed.
    pending_inject: List[Tuple[bool, bytes]] = \
        dataclasses.field(default_factory=list)
    #: header-rewrite ops ``(action, name, value)`` the policy layer
    #: attached to the LAST allowed record (HeaderMatch ADD/DELETE/
    #: REPLACE mismatch actions) — the HTTP parser consumes them to
    #: rewrite the frame before passing it (cilium.l7policy analog)
    pending_rewrites: List[Tuple[str, str, str]] = \
        dataclasses.field(default_factory=list)

    def on_data(self, reply: bool, end_stream: bool,
                data: bytes) -> List[Op]:
        assert self.parser is not None
        return self.parser.on_data(reply, end_stream, data)

    def inject(self, payload: bytes, reply: bool = True) -> Op:
        """Queue payload for injection into the ``reply`` direction's
        stream; returns the matching INJECT op."""
        self.pending_inject.append((reply, payload))
        return (OpType.INJECT, len(payload))

    def take_inject(self, reply: bool = True) -> bytes:
        """Drain queued inject bytes for ONE direction (client-bound
        by default — the deny-response path)."""
        out = b"".join(p for r, p in self.pending_inject if r == reply)
        self.pending_inject = [
            (r, p) for r, p in self.pending_inject if r != reply]
        return out


class Parser:
    """Base parser: subclass and implement :meth:`on_data`.

    ``policy_check(record) -> bool`` is injected at construction — the
    gate point where either the CPU oracle or the TPU verdict service
    answers (mirrors proxylib's policy map lookup in ``policymap.go``).
    """

    def __init__(self, connection: Connection,
                 policy_check: Callable[[object], bool]):
        self.connection = connection
        self.policy_check = policy_check

    def on_data(self, reply: bool, end_stream: bool,
                data: bytes) -> List[Op]:
        raise NotImplementedError


_REGISTRY: Dict[str, Callable[..., Parser]] = {}


#: the reference's parsers whose records are ``GenericL7Info`` (they
#: need the ``l7g`` field and the frontend compiler, queue 1's Q5)
UNPORTED_PARSERS = ("cassandra", "memcache", "r2d2", "test.blockparser",
                    "test.lineparser", "test.passer")


def register_parser(name: str, factory: Callable[..., Parser]) -> None:
    _REGISTRY[name] = factory


def create_parser(name: str, connection: Connection,
                  policy_check: Callable[[object], bool]) -> Parser:
    if name not in _REGISTRY:
        if name in UNPORTED_PARSERS:
            raise NotImplementedError(
                f"the {name!r} parser yields generic L7 records, which "
                f"arrive with the frontends/l7proto slice (queue 1, Q5)")
        raise KeyError(f"no parser registered for l7proto {name!r}")
    p = _REGISTRY[name](connection, policy_check)
    connection.parser = p
    return p


def registered_parsers() -> List[str]:
    return sorted(_REGISTRY)
