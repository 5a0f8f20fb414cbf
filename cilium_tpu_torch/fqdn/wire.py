"""Minimal DNS wire-format codec, stdlib only (counterpart of the
reference's ``fqdn/wire.py``, copied: byte-identical encode and decode).

Just enough of RFC 1035 for the transparent proxy: header decode and
encode, QNAME (with compression pointers on decode), the question
section, and A/AAAA/CNAME answer extraction.
"""

from __future__ import annotations

import dataclasses
import ipaddress
import struct
from typing import List, Optional, Tuple

QTYPE_A = 1
QTYPE_CNAME = 5
QTYPE_AAAA = 28

RCODE_NOERROR = 0
RCODE_SERVFAIL = 2
RCODE_NXDOMAIN = 3
RCODE_REFUSED = 5


class DNSDecodeError(ValueError):
    pass


@dataclasses.dataclass
class Question:
    qname: str          # presentation form, no trailing dot
    qtype: int
    qclass: int = 1     # IN


@dataclasses.dataclass
class Answer:
    name: str
    rtype: int
    ttl: int
    rdata: bytes

    @property
    def ip(self) -> Optional[str]:
        if self.rtype == QTYPE_A and len(self.rdata) == 4:
            return str(ipaddress.IPv4Address(self.rdata))
        if self.rtype == QTYPE_AAAA and len(self.rdata) == 16:
            return str(ipaddress.IPv6Address(self.rdata))
        return None


@dataclasses.dataclass
class Message:
    txid: int
    flags: int
    questions: List[Question]
    answers: List[Answer]

    @property
    def is_response(self) -> bool:
        return bool(self.flags & 0x8000)

    @property
    def rcode(self) -> int:
        return self.flags & 0xF

    @property
    def qname(self) -> str:
        return self.questions[0].qname if self.questions else ""


def _decode_name(data: bytes, off: int) -> Tuple[str, int]:
    """Decode a (possibly compressed) name; returns (name, next offset)."""
    labels: List[str] = []
    jumps = 0
    end: Optional[int] = None
    while True:
        if off >= len(data):
            raise DNSDecodeError("name runs past message end")
        length = data[off]
        if length & 0xC0 == 0xC0:  # compression pointer
            if off + 1 >= len(data):
                raise DNSDecodeError("truncated compression pointer")
            if end is None:
                end = off + 2
            off = ((length & 0x3F) << 8) | data[off + 1]
            jumps += 1
            if jumps > 63:  # loop guard
                raise DNSDecodeError("compression pointer loop")
            continue
        if length & 0xC0:
            raise DNSDecodeError(f"bad label length byte {length:#x}")
        off += 1
        if length == 0:
            break
        if off + length > len(data):
            raise DNSDecodeError("label runs past message end")
        labels.append(data[off:off + length].decode("ascii", "replace"))
        off += length
    return ".".join(labels), (end if end is not None else off)


def encode_name(name: str) -> bytes:
    out = bytearray()
    for label in name.rstrip(".").split("."):
        if not label:
            continue
        try:
            raw = label.encode("ascii")
        except UnicodeEncodeError as e:
            # names decoded with replacement chars (non-ASCII labels on
            # the wire) must fail as a DNS error the caller handles, not
            # as a stray UnicodeEncodeError killing a handler thread
            raise DNSDecodeError(f"non-ASCII label {label!r}") from e
        if len(raw) > 63:
            raise DNSDecodeError(f"label too long: {label!r}")
        out.append(len(raw))
        out += raw
    out.append(0)
    return bytes(out)


def decode(data: bytes) -> Message:
    if len(data) < 12:
        raise DNSDecodeError("message shorter than header")
    txid, flags, qd, an, ns, ar = struct.unpack("!6H", data[:12])
    off = 12
    questions: List[Question] = []
    for _ in range(qd):
        qname, off = _decode_name(data, off)
        if off + 4 > len(data):
            raise DNSDecodeError("truncated question")
        qtype, qclass = struct.unpack("!HH", data[off:off + 4])
        off += 4
        questions.append(Question(qname, qtype, qclass))
    answers: List[Answer] = []
    for _ in range(an):
        name, off = _decode_name(data, off)
        if off + 10 > len(data):
            raise DNSDecodeError("truncated answer")
        rtype, rclass, ttl, rdlen = struct.unpack(
            "!HHIH", data[off:off + 10])
        off += 10
        if off + rdlen > len(data):
            raise DNSDecodeError("answer rdata past message end")
        answers.append(Answer(name, rtype, ttl, data[off:off + rdlen]))
        off += rdlen
    # authority/additional sections are not needed by the proxy
    return Message(txid, flags, questions, answers)


def encode_query(txid: int, qname: str, qtype: int = QTYPE_A) -> bytes:
    header = struct.pack("!6H", txid, 0x0100, 1, 0, 0, 0)  # RD set
    return header + encode_name(qname) + struct.pack("!HH", qtype, 1)


def _question_section_end(data: bytes, qd: int) -> int:
    """Offset one past the last question (reuses the decode walker)."""
    off = 12
    for _ in range(qd):
        _, off = _decode_name(data, off)
        off += 4  # qtype + qclass
        if off > len(data):
            raise DNSDecodeError("truncated question")
    return off


def encode_response(query: bytes, rcode: int,
                    answers: Optional[List[Tuple[str, int, int, bytes]]] =
                    None) -> bytes:
    """Build a response reusing the query's header id + question bytes.

    The question section is echoed VERBATIM (non-ASCII labels survive
    round-trip, as real servers do). ``answers``: (name, rtype, ttl,
    rdata) tuples, names encoded uncompressed.
    """
    if len(query) < 12:
        raise DNSDecodeError("query shorter than header")
    txid, _flags, qd = struct.unpack("!3H", query[:6])[0:3]
    qend = _question_section_end(query, qd)
    flags = 0x8180 | (rcode & 0xF)  # QR|RD|RA + rcode
    answers = answers or []
    out = bytearray(struct.pack("!6H", txid, flags, qd, len(answers), 0, 0))
    out += query[12:qend]
    for name, rtype, ttl, rdata in answers:
        out += encode_name(name) + struct.pack(
            "!HHIH", rtype, 1, ttl, len(rdata)) + rdata
    return bytes(out)
