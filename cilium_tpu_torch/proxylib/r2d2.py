"""r2d2 parser — the didactic line-protocol template.

Reference: ``proxylib/r2d2`` (SURVEY.md §2.2 "r2d2/testparsers are the
didactic templates for writing a parser"). The toy protocol is
CRLF-terminated request lines:

    READ <filename>\r\n      WRITE <filename>\r\n
    HALT\r\n                  RESET\r\n

Each request becomes one :class:`GenericL7Info` record with proto
``"r2d2"`` and fields ``{"cmd": ..., "file": ...}`` (``file`` only for
READ/WRITE), matched against the policy's generic ``l7`` rules, e.g.::

    rules:
      l7proto: r2d2
      l7:
        - cmd: READ
          file: public.txt
        - cmd: HALT

Denied requests are dropped and an ``ERROR\r\n`` line is injected as
the response. Responses pass through unparsed (the toy protocol has no
response framing to enforce).
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

_COMMANDS = {"READ", "WRITE", "HALT", "RESET"}
_ERROR_RESPONSE = b"ERROR\r\n"
#: a line longer than this with no CRLF is unparseable garbage
MAX_LINE = 4096


def parse_request_line(line: bytes) -> GenericL7Info:
    text = line.decode("utf-8", "replace").strip()
    parts = text.split(None, 1)
    cmd = parts[0].upper() if parts else ""
    fields = {"cmd": cmd}
    if cmd in ("READ", "WRITE") and len(parts) > 1:
        fields["file"] = parts[1]
    return GenericL7Info(proto="r2d2", fields=fields)


class R2D2Parser(Parser):
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
            nl = self._buf.find(b"\r\n")
            if nl < 0:
                if len(self._buf) > MAX_LINE:
                    ops.append((OpType.ERROR, 0))
                elif not end_stream:
                    ops.append((OpType.MORE, 1))
                elif self._buf:
                    # trailing unterminated line at stream end still
                    # needs a verdict — bytes must never go unaccounted
                    nl = len(self._buf)
                    line, frame_len = self._buf, len(self._buf)
                    record = parse_request_line(line)
                    if record.fields["cmd"] not in _COMMANDS:
                        ops.append((OpType.ERROR, 0))
                    elif self.policy_check(record):
                        ops.append((OpType.PASS, frame_len))
                    else:
                        ops.append((OpType.DROP, frame_len))
                        ops.append(self.connection.inject(_ERROR_RESPONSE))
                    self._buf = b""
                break
            line, frame_len = self._buf[:nl], nl + 2
            record = parse_request_line(line)
            if record.fields["cmd"] not in _COMMANDS:
                ops.append((OpType.ERROR, 0))
                break
            if self.policy_check(record):
                ops.append((OpType.PASS, frame_len))
            else:
                ops.append((OpType.DROP, frame_len))
                ops.append(self.connection.inject(_ERROR_RESPONSE))
            self._buf = self._buf[frame_len:]
            if not self._buf:
                break
        return ops


register_parser("r2d2", R2D2Parser)
