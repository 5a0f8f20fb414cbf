"""Cassandra CQL parser.

Reference: ``proxylib/cassandra`` (SURVEY.md §2.2). Frames follow the
public CQL binary protocol v3/v4: 9-byte header ``version(1) flags(1)
stream(2) opcode(1) length(4)`` then a body; QUERY/PREPARE bodies start
with a ``[long string]`` CQL query.

Records are :class:`GenericL7Info` with proto ``"cassandra"``:
``{"query_action": ..., "query_table": ...}`` extracted from the query
text (select/insert/update/delete + keyspace-qualified table), matched
against generic ``l7`` rules. Handshake/control opcodes (STARTUP,
OPTIONS, AUTH_RESPONSE, REGISTER) always pass — the connection cannot
be established without them, mirroring the reference's behavior of only
enforcing on data-carrying requests. Denied queries drop the frame and
inject a protocol ERROR response (opcode 0x00, code 0x2100
"unauthorized") with the request's stream id so drivers fail the right
request.
"""

from __future__ import annotations

import re
import struct
from typing import List, Optional

from cilium_tpu_torch.core.flow import GenericL7Info
from cilium_tpu_torch.proxylib.parser import (
    Connection,
    Op,
    OpType,
    Parser,
    register_parser,
)

OP_ERROR = 0x00
OP_STARTUP = 0x01
OP_OPTIONS = 0x05
OP_QUERY = 0x07
OP_PREPARE = 0x09
OP_EXECUTE = 0x0A
OP_REGISTER = 0x0B
OP_BATCH = 0x0D
OP_AUTH_RESPONSE = 0x0F

_HANDSHAKE = {OP_STARTUP, OP_OPTIONS, OP_REGISTER, OP_AUTH_RESPONSE}

#: refuse frames larger than this instead of buffering them (native
#: protocol limit is 256MB; enforcing a proxy-side cap bounds per-
#: connection memory against malicious length fields)
MAX_FRAME = 16 * 1024 * 1024

_ACTION_TABLE_RE = re.compile(
    r"^\s*(select)\b.*?\bfrom\s+([\w.\"]+)"
    r"|^\s*(insert)\s+into\s+([\w.\"]+)"
    r"|^\s*(update)\s+([\w.\"]+)"
    r"|^\s*(delete)\b.*?\bfrom\s+([\w.\"]+)"
    r"|^\s*(use)\s+([\w.\"]+)"
    r"|^\s*(create|drop|alter|truncate)\s+(?:table|keyspace|index|type)?"
    r"\s*(?:if\s+(?:not\s+)?exists\s+)?([\w.\"]+)?",
    re.IGNORECASE | re.DOTALL)


def parse_query(query: str) -> GenericL7Info:
    fields = {"query_action": "", "query_table": ""}
    m = _ACTION_TABLE_RE.match(query)
    if m:
        groups = [g for g in m.groups() if g]
        if groups:
            fields["query_action"] = groups[0].lower()
        if len(groups) > 1:
            fields["query_table"] = groups[1].strip('"').lower()
    return GenericL7Info(proto="cassandra", fields=fields)


def _error_response(stream: int, version: int) -> bytes:
    msg = b"Request unauthorized by policy"
    body = struct.pack(">i", 0x2100) + struct.pack(">H", len(msg)) + msg
    # echo the request's protocol version with the response bit set so
    # strict drivers accept the frame and fail only this request
    return struct.pack(">BBhBI", 0x80 | version, 0, stream, OP_ERROR,
                       len(body)) + body


class CassandraParser(Parser):
    def __init__(self, connection: Connection, policy_check):
        super().__init__(connection, policy_check)
        self._buf = b""

    def on_data(self, reply: bool, end_stream: bool,
                data: bytes) -> List[Op]:
        if reply:
            return [(OpType.PASS, len(data))] if data else []
        self._buf += data
        ops: List[Op] = []
        while self._buf:
            if len(self._buf) < 9:
                ops.append((OpType.MORE, 9 - len(self._buf)))
                break
            version, _flags, stream, opcode, length = struct.unpack_from(
                ">BBhBI", self._buf, 0)
            if version & 0x80:          # a response on the request path
                ops.append((OpType.ERROR, 0))
                break
            if length > MAX_FRAME:
                ops.append((OpType.ERROR, 0))
                break
            frame_len = 9 + length
            if len(self._buf) < frame_len:
                ops.append((OpType.MORE, frame_len - len(self._buf)))
                break
            record = self._record_for(opcode, self._buf[9:frame_len])
            allowed = record is None or self.policy_check(record)
            if allowed:
                ops.append((OpType.PASS, frame_len))
            else:
                ops.append((OpType.DROP, frame_len))
                ops.append(self.connection.inject(
                    _error_response(stream, version)))
            self._buf = self._buf[frame_len:]
        return ops

    def _record_for(self, opcode: int,
                    body: bytes) -> Optional[GenericL7Info]:
        """None = always allowed (handshake/control)."""
        if opcode in _HANDSHAKE:
            return None
        if opcode in (OP_QUERY, OP_PREPARE):
            if len(body) < 4:
                return GenericL7Info(proto="cassandra",
                                     fields={"query_action": "",
                                             "query_table": ""})
            (n,) = struct.unpack_from(">i", body, 0)
            if n < 0 or 4 + n > len(body):
                n = max(0, len(body) - 4)
            query = body[4:4 + n].decode("utf-8", "replace")
            return parse_query(query)
        # EXECUTE/BATCH carry prepared ids we do not track; match them
        # as opcode-only records so rules can allow/deny them wholesale
        name = {OP_EXECUTE: "execute", OP_BATCH: "batch"}.get(
            opcode, f"op{opcode:#x}")
        return GenericL7Info(proto="cassandra",
                             fields={"query_action": name,
                                     "query_table": ""})


register_parser("cassandra", CassandraParser)
