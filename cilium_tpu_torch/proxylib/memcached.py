"""Memcached parser (text + binary protocols).

Reference: ``proxylib/memcached`` (SURVEY.md §2.2). Both public wire
protocols are framed and each command becomes one or more
:class:`GenericL7Info` records with proto ``"memcache"`` and fields
``{"cmd": ..., "key": ...}`` — one record per key for multi-key reads,
so a request is allowed only if every key it touches is allowed.

Text protocol (public spec): storage commands
``set|add|replace|append|prepend|cas <key> <flags> <exptime> <bytes>
[noreply]\r\n<data>\r\n``; retrieval ``get|gets <key>+\r\n``; plus
``delete|incr|decr|touch <key> ...`` and keyless admin commands
(``stats``, ``flush_all``, ``version``, ``verbosity``, ``quit``).

Binary protocol: 24-byte header ``magic(0x80) opcode keylen(2)
extlen(1) datatype(1) vbucket(2) bodylen(4) opaque(4) cas(8)``; the key
sits after the extras. Opcodes are mapped to the text command names so
one rule set covers both framings.

Denied text requests drop the frame and inject ``SERVER_ERROR access
denied\r\n``; denied binary requests just drop (a status-only response
would need the opaque echo, which the shim layer owns).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from cilium_tpu_torch.core.flow import GenericL7Info
from cilium_tpu_torch.proxylib.parser import (
    Connection,
    Op,
    OpType,
    Parser,
    register_parser,
)

_DENY_RESPONSE = b"SERVER_ERROR access denied\r\n"
MAX_LINE = 8192
#: cap on a single value/body size the proxy will buffer (memcached's
#: own default item limit is 1MB; malicious length fields must not
#: drive unbounded buffering)
MAX_BODY = 8 * 1024 * 1024

#: commands followed by a data block of <bytes> + CRLF
_STORAGE = {"set", "add", "replace", "append", "prepend", "cas"}
_MULTI_KEY = {"get", "gets", "gat", "gats"}
_SINGLE_KEY = {"delete", "incr", "decr", "touch"}
_KEYLESS = {"stats", "flush_all", "version", "verbosity", "quit"}

#: binary opcode → text command name (public protocol tables)
_BINARY_OPS = {
    0x00: "get", 0x01: "set", 0x02: "add", 0x03: "replace",
    0x04: "delete", 0x05: "incr", 0x06: "decr", 0x07: "quit",
    0x08: "flush_all", 0x09: "get", 0x0A: "noop", 0x0B: "version",
    0x0C: "get", 0x0D: "get", 0x0E: "append", 0x0F: "prepend",
    0x10: "stats", 0x11: "set", 0x12: "add", 0x13: "replace",
    0x14: "delete", 0x15: "incr", 0x16: "decr", 0x17: "quit",
    0x18: "flush_all", 0x19: "append", 0x1A: "prepend", 0x1C: "touch",
    0x1D: "gat", 0x1E: "gat",
}


def _records_for(cmd: str, keys: List[str]) -> List[GenericL7Info]:
    if not keys:
        return [GenericL7Info(proto="memcache", fields={"cmd": cmd})]
    return [GenericL7Info(proto="memcache",
                          fields={"cmd": cmd, "key": k})
            for k in keys]


def parse_text_command(line: bytes) -> Tuple[Optional[List[GenericL7Info]],
                                             int]:
    """One text command line (no CRLF) → (records, data_block_bytes).
    ``None`` records = unparseable."""
    parts = line.decode("utf-8", "replace").split()
    if not parts:
        return None, 0
    cmd = parts[0].lower()
    if cmd in _STORAGE:
        # set <key> <flags> <exptime> <bytes> [noreply]; cas has an
        # extra cas-id before noreply
        need = 5 if cmd != "cas" else 6
        if len(parts) < need:
            return None, 0
        try:
            nbytes = int(parts[4])
        except ValueError:
            return None, 0
        if nbytes < 0 or nbytes > MAX_BODY:
            return None, 0
        return _records_for(cmd, [parts[1]]), nbytes + 2   # data + CRLF
    if cmd in _MULTI_KEY:
        keys = parts[1:]
        if cmd in ("gat", "gats"):   # gat <exptime> <key>+
            keys = parts[2:]
        if not keys:
            return None, 0
        return _records_for(cmd, keys), 0
    if cmd in _SINGLE_KEY:
        if len(parts) < 2:
            return None, 0
        return _records_for(cmd, [parts[1]]), 0
    if cmd in _KEYLESS:
        return _records_for(cmd, []), 0
    return None, 0


class MemcachedParser(Parser):
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
            if self._buf[0] == 0x80:
                if not self._binary_frame(ops):
                    break
            else:
                if not self._text_frame(ops, end_stream):
                    break
        return ops

    # returns True to continue framing, False when ops ended with
    # MORE/ERROR (or the buffer is drained)
    def _text_frame(self, ops: List[Op], end_stream: bool) -> bool:
        nl = self._buf.find(b"\r\n")
        if nl < 0:
            if len(self._buf) > MAX_LINE:
                ops.append((OpType.ERROR, 0))
            elif not end_stream:
                ops.append((OpType.MORE, 1))
            return False
        records, extra = parse_text_command(self._buf[:nl])
        if records is None:
            ops.append((OpType.ERROR, 0))
            return False
        frame_len = nl + 2 + extra
        if len(self._buf) < frame_len:
            ops.append((OpType.MORE, frame_len - len(self._buf)))
            return False
        if all(self.policy_check(r) for r in records):
            ops.append((OpType.PASS, frame_len))
        else:
            ops.append((OpType.DROP, frame_len))
            ops.append(self.connection.inject(_DENY_RESPONSE))
        self._buf = self._buf[frame_len:]
        return bool(self._buf)

    def _binary_frame(self, ops: List[Op]) -> bool:
        if len(self._buf) < 24:
            ops.append((OpType.MORE, 24 - len(self._buf)))
            return False
        (_magic, opcode, keylen, extlen, _dt, _vb,
         bodylen) = struct.unpack_from(">BBHBBHI", self._buf, 0)
        frame_len = 24 + bodylen
        if keylen + extlen > bodylen or bodylen > MAX_BODY:
            ops.append((OpType.ERROR, 0))
            return False
        if len(self._buf) < frame_len:
            ops.append((OpType.MORE, frame_len - len(self._buf)))
            return False
        cmd = _BINARY_OPS.get(opcode, f"op{opcode:#x}")
        key = self._buf[24 + extlen:24 + extlen + keylen].decode(
            "utf-8", "replace")
        records = _records_for(cmd, [key] if key else [])
        if all(self.policy_check(r) for r in records):
            ops.append((OpType.PASS, frame_len))
        else:
            ops.append((OpType.DROP, frame_len))
        self._buf = self._buf[frame_len:]
        return bool(self._buf)


register_parser("memcache", MemcachedParser)
