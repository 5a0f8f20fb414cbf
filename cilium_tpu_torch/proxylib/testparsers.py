"""Test parsers — framing/verdict fixtures for the plugin interface.

Reference: ``proxylib/testparsers`` (SURVEY.md §2.2): tiny parsers used
by the framework's own tests to exercise the OnData contract (MORE
accounting across chunk boundaries, PASS/DROP framing, injection)
without a real protocol.

* ``test.passer`` — passes every byte in both directions.
* ``test.lineparser`` — newline-framed; each line is a record
  ``{"line": <text>}`` checked against policy.
* ``test.blockparser`` — length-prefixed blocks ``<decimal-len>:<body>``
  where len counts the whole block including the prefix; the first
  word of the body is the record: ``{"prefix": <word>}``. Malformed
  prefixes yield ERROR.
"""

from __future__ import annotations

from typing import List

from cilium_tpu_torch.core.flow import GenericL7Info
from cilium_tpu_torch.proxylib.parser import (
    Connection,
    Op,
    OpType,
    Parser,
    register_parser,
)


class PasserParser(Parser):
    def on_data(self, reply: bool, end_stream: bool,
                data: bytes) -> List[Op]:
        return [(OpType.PASS, len(data))] if data else []


class LineParser(Parser):
    def __init__(self, connection: Connection, policy_check):
        super().__init__(connection, policy_check)
        self._buf = b""

    def on_data(self, reply: bool, end_stream: bool,
                data: bytes) -> List[Op]:
        if reply:
            return [(OpType.PASS, len(data))] if data else []
        self._buf += data
        ops: List[Op] = []
        while True:
            nl = self._buf.find(b"\n")
            if nl < 0:
                if self._buf and end_stream:
                    # trailing unterminated line at stream end: verdict
                    # the whole remaining buffer (no newline to strip)
                    nl = frame_len = len(self._buf)
                else:
                    if not end_stream:
                        ops.append((OpType.MORE, 1))
                    break
            else:
                frame_len = nl + 1
            text = self._buf[:nl].decode("utf-8", "replace").rstrip("\r")
            record = GenericL7Info(proto="test.lineparser",
                                   fields={"line": text})
            op = (OpType.PASS if self.policy_check(record) else OpType.DROP)
            ops.append((op, frame_len))
            self._buf = self._buf[frame_len:]
            if not self._buf:
                break
        return ops


class BlockParser(Parser):
    def __init__(self, connection: Connection, policy_check):
        super().__init__(connection, policy_check)
        self._buf = b""

    def on_data(self, reply: bool, end_stream: bool,
                data: bytes) -> List[Op]:
        self._buf += data
        ops: List[Op] = []
        while self._buf:
            colon = self._buf.find(b":")
            if colon < 0:
                if len(self._buf) > 10:   # a length prefix is ≤10 digits
                    ops.append((OpType.ERROR, 0))
                else:
                    ops.append((OpType.MORE, 1))
                break
            try:
                block_len = int(self._buf[:colon])
            except ValueError:
                ops.append((OpType.ERROR, 0))
                break
            if block_len < colon + 1:
                ops.append((OpType.ERROR, 0))
                break
            if len(self._buf) < block_len:
                ops.append((OpType.MORE, block_len - len(self._buf)))
                break
            body = self._buf[colon + 1:block_len]
            word = body.split(None, 1)[0].decode("utf-8", "replace") \
                if body.split() else ""
            record = GenericL7Info(proto="test.blockparser",
                                   fields={"prefix": word})
            op = (OpType.PASS if self.policy_check(record) else OpType.DROP)
            ops.append((op, block_len))
            self._buf = self._buf[block_len:]
        return ops


# proxy-only names: no engine frontend, so their records (if any) stay
# on the generic pair path
register_parser("test.passer", PasserParser)  # framing fixture: no records
register_parser("test.lineparser", LineParser)
register_parser("test.blockparser", BlockParser)
