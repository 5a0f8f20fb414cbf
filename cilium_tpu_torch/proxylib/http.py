"""Minimal HTTP/1.x request parser.

The reference enforces HTTP inside Envoy's C++ ``cilium.l7policy``
filter (SURVEY.md §2.2) — proxylib carries no HTTP parser. Ours exists
so the same plugin interface can demonstrate the HTTP path end-to-end
without Envoy: request line + headers are parsed into an
``HTTPInfo``-shaped record, verdicted via ``policy_check``, and the
frame (headers + Content-Length body) is passed or dropped whole.
"""

from __future__ import annotations

from typing import List, Optional

from cilium_tpu_torch.core.flow import HTTPInfo
from cilium_tpu_torch.proxylib.parser import (
    Connection,
    Op,
    OpType,
    Parser,
    register_parser,
)

_DENY_RESPONSE = (b"HTTP/1.1 403 Forbidden\r\n"
                  b"content-length: 15\r\n\r\nAccess denied\r\n")


def apply_header_rewrites(head: bytes, rewrites) -> bytes:
    """Apply ``(action, name, value)`` HeaderMatch mismatch ops to a
    request head (request line + header lines, no trailing CRLFCRLF) —
    the byte-mutation half of the reference's ``cilium.l7policy``
    filter. ADD appends another instance; REPLACE drops every instance
    and writes one; DELETE drops every instance."""
    lines = head.split(b"\r\n")
    request_line, header_lines = lines[0], lines[1:]
    for action, name, value in rewrites:
        lname = name.strip().lower().encode("utf-8")

        def keeps(line: bytes) -> bool:
            k = line.split(b":", 1)[0].strip().lower()
            return k != lname

        if action in ("REPLACE", "DELETE"):
            header_lines = [ln for ln in header_lines if keeps(ln)]
        if action in ("ADD", "REPLACE"):
            header_lines.append(name.encode("utf-8") + b": "
                                + value.encode("utf-8"))
    return b"\r\n".join([request_line] + header_lines)


def parse_request_head(head: bytes) -> Optional[HTTPInfo]:
    try:
        text = head.decode("utf-8", "replace")
        lines = text.split("\r\n")
        method, path, proto = lines[0].split(" ", 2)
        headers = []
        host = ""
        for line in lines[1:]:
            if not line or ":" not in line:
                continue
            k, v = line.split(":", 1)
            headers.append((k.strip(), v.strip()))
            if k.strip().lower() == "host":
                host = v.strip()
        return HTTPInfo(method=method, path=path, host=host,
                        headers=tuple(headers), protocol=proto)
    except Exception:
        return None


class HTTPParser(Parser):
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
            sep = self._buf.find(b"\r\n\r\n")
            if sep < 0:
                ops.append((OpType.MORE, 1))
                break
            head = self._buf[:sep]
            info = parse_request_head(head)
            if info is None:
                ops.append((OpType.ERROR, 0))
                break
            clen = 0
            for k, v in info.headers:
                if k.lower() == "content-length":
                    try:
                        clen = max(0, int(v))  # negative would stall the
                    except ValueError:         # frame loop forever
                        clen = 0
            frame_len = sep + 4 + clen
            if len(self._buf) < frame_len:
                ops.append((OpType.MORE, frame_len - len(self._buf)))
                break
            if self.policy_check(info):
                rewrites = self.connection.pending_rewrites
                self.connection.pending_rewrites = []
                if rewrites:
                    # the rewrite rides the op stream: DROP the original
                    # frame, INJECT the mutated one (same machinery any
                    # proxylib frame rewrite uses — the shim/proxy owns
                    # splicing the bytes)
                    body = self._buf[sep + 4:frame_len]
                    mutated = (apply_header_rewrites(head, rewrites)
                               + b"\r\n\r\n" + body)
                    ops.append((OpType.DROP, frame_len))
                    # upstream-bound: the mutated frame replaces the
                    # request, so it rides the request direction
                    ops.append(self.connection.inject(mutated,
                                                      reply=False))
                else:
                    ops.append((OpType.PASS, frame_len))
            else:
                ops.append((OpType.DROP, frame_len))
                # queue the 403 body so the proxy/shim can retrieve it
                ops.append(self.connection.inject(_DENY_RESPONSE))
            self._buf = self._buf[frame_len:]
            if not self._buf:
                break
        return ops

    @staticmethod
    def deny_response() -> bytes:
        return _DENY_RESPONSE


register_parser("http", HTTPParser)  # ctlint: disable=frontend-registry  # engine speaks HTTP natively (dedicated family + field automatons)
