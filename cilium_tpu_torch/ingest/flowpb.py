"""Protobuf wire-format codec for the Hubble ``flowpb.Flow`` subset
the verdict engine consumes — no protoc/generated code, just the wire
grammar (varint, 64-bit, length-delimited, 32-bit) with unknown fields
skipped, so REAL pb captures replay without a schema compile step.

Reference: ``api/v1/flow/flow.proto`` (SURVEY.md §2.5). Field numbers
follow the upstream layout; per the SURVEY provenance note they are
unverified against the upstream proto — they are kept in one table
(the ``_F_*`` / ``_E_*`` / ... constants) so re-anchoring against the
real proto is a constant-table edit. The encoder writes the same
numbers, giving self-consistent fixtures and exporter parity either
way. The port's codec is the JAX package's byte for byte
(``tests/test_torch_flowpb.py``).

Captures are streams of varint-length-prefixed Flow messages (the
standard protobuf stream framing; Hubble's gRPC messages are delimited
the same way once off the wire).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

from cilium_tpu_torch.core.flow import (
    DNSInfo,
    Flow,
    HTTPInfo,
    KafkaInfo,
    L7Type,
    Protocol,
    TrafficDirection,
    Verdict,
)
from cilium_tpu_torch.ingest.binary import CaptureError

# -- wire primitives -------------------------------------------------------

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


class PBError(CaptureError):
    """Wire-grammar failure. Subclasses CaptureError so the cursor /
    CLI paths that degrade cleanly on a corrupt CTCAP degrade the same
    way on a corrupt pb stream."""


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise PBError("truncated varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 63:
            raise PBError("varint too long")


def _write_varint(out: bytearray, v: int) -> None:
    if v < 0:
        # a negative Python int never reaches 0 under >>= 7; protobuf
        # negative ints are a 10-byte two's-complement encoding we
        # deliberately don't emit (no field needs it) — error loudly
        # instead of hanging the encoder
        raise PBError(f"negative varint {v}")
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _fields(data: memoryview) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value); LEN values come back as
    memoryviews, unknown-but-valid wire types are decoded so callers
    can skip them for free."""
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wt = tag >> 3, tag & 7
        if wt == _VARINT:
            v, pos = _read_varint(data, pos)
        elif wt == _I64:
            if pos + 8 > len(data):
                raise PBError("truncated i64")
            v = bytes(data[pos:pos + 8])
            pos += 8
        elif wt == _LEN:
            n, pos = _read_varint(data, pos)
            if pos + n > len(data):
                raise PBError("truncated length-delimited field")
            v = data[pos:pos + n]
            pos += n
        elif wt == _I32:
            if pos + 4 > len(data):
                raise PBError("truncated i32")
            v = bytes(data[pos:pos + 4])
            pos += 4
        else:
            raise PBError(f"unsupported wire type {wt}")
        yield field, wt, v


def _tag(out: bytearray, field: int, wt: int) -> None:
    _write_varint(out, (field << 3) | wt)


def _put_len(out: bytearray, field: int, payload: bytes) -> None:
    _tag(out, field, _LEN)
    _write_varint(out, len(payload))
    out += payload


def _put_varint(out: bytearray, field: int, v: int) -> None:
    if v:
        _tag(out, field, _VARINT)
        _write_varint(out, v)


def _put_str(out: bytearray, field: int, s: str) -> None:
    if s:
        _put_len(out, field, s.encode("utf-8"))


# -- flow.proto field tables (upstream layout, UNVERIFIED — see module
#    docstring; keep every number here, nowhere else) ----------------------

#: Flow message
_F_TIME, _F_VERDICT, _F_L4, _F_SOURCE, _F_DEST = 1, 2, 6, 8, 9
_F_NODE_NAME, _F_L7, _F_TRAFFIC_DIR, _F_MATCH_TYPE = 11, 15, 22, 23
#: Endpoint message
_E_IDENTITY, _E_NAMESPACE, _E_LABELS, _E_POD = 2, 3, 4, 5
#: Layer4 oneof
_L4_TCP, _L4_UDP, _L4_ICMP4, _L4_ICMP6, _L4_SCTP = 1, 2, 3, 4, 5
#: TCP/UDP/SCTP port messages
_P_SPORT, _P_DPORT = 1, 2
#: ICMP message
_ICMP_TYPE = 1
#: Layer7 message (oneof record uses high field numbers upstream)
_L7_TYPE, _L7_DNS, _L7_HTTP, _L7_KAFKA = 1, 100, 101, 102
#: HTTP message
_H_CODE, _H_METHOD, _H_URL, _H_PROTOCOL, _H_HEADERS = 1, 2, 3, 4, 5
_HDR_KEY, _HDR_VALUE = 1, 2
#: DNS message (query=1 … observation_source=5, rcode=6 per the
#: upstream flow.proto ordering)
_D_QUERY, _D_RCODE = 1, 6
#: Kafka message
_K_ERROR, _K_VERSION, _K_APIKEY, _K_CORRELATION, _K_TOPIC = 1, 2, 3, 4, 5

#: flowpb L7FlowType REQUEST
_L7_REQUEST = 1

#: Kafka.api_key rides the wire as the ROLE STRING upstream
#: ("produce"/"fetch"/...); numeric api keys map both ways. DERIVED
#: from the port's one canonical table (``policy/api/l7.py
#: ·KAFKA_API_KEYS``, mirroring upstream ``pkg/policy/api/kafka.go``)
#: so the wire codec and the ACL matcher cannot diverge (an unknown
#: name must NOT collapse to 0/produce, which would falsely match
#: produce-scoped ACLs).
from cilium_tpu_torch.policy.api.l7 import (  # noqa: E402
    KAFKA_API_KEYS as _KAFKA_APIKEY_NUMS,
)

_KAFKA_APIKEY_NAMES = {v: k for k, v in _KAFKA_APIKEY_NUMS.items()}
#: unknown-role sentinel: matches only api-key-unconstrained rules
KAFKA_APIKEY_UNKNOWN = -1


# -- decode ----------------------------------------------------------------

def _dec_endpoint(data: memoryview) -> Tuple[int, Tuple[str, ...]]:
    identity = 0
    labels: List[str] = []
    for field, wt, v in _fields(data):
        if field == _E_IDENTITY and wt == _VARINT:
            identity = int(v)
        elif field == _E_LABELS and wt == _LEN:
            labels.append(bytes(v).decode("utf-8", "replace"))
    return identity, tuple(labels)


def _dec_ports(data: memoryview) -> Tuple[int, int]:
    sport = dport = 0
    for field, wt, v in _fields(data):
        if field == _P_SPORT and wt == _VARINT:
            sport = int(v)
        elif field == _P_DPORT and wt == _VARINT:
            dport = int(v)
    return sport, dport


def _dec_http(data: memoryview) -> HTTPInfo:
    h = HTTPInfo()
    headers: List[Tuple[str, str]] = []
    for field, wt, v in _fields(data):
        if field == _H_METHOD and wt == _LEN:
            h.method = bytes(v).decode("utf-8", "replace")
        elif field == _H_URL and wt == _LEN:
            from cilium_tpu_torch.ingest.hubble import split_http_url

            path, url_host = split_http_url(
                bytes(v).decode("utf-8", "replace"))
            h.path = path
            if url_host and not h.host:
                h.host = url_host
        elif field == _H_PROTOCOL and wt == _LEN:
            h.protocol = bytes(v).decode("utf-8", "replace")
        elif field == _H_CODE and wt == _VARINT:
            h.code = int(v)
        elif field == _H_HEADERS and wt == _LEN:
            k = val = ""
            for hf, hwt, hv in _fields(v):
                if hf == _HDR_KEY and hwt == _LEN:
                    k = bytes(hv).decode("utf-8", "replace")
                elif hf == _HDR_VALUE and hwt == _LEN:
                    val = bytes(hv).decode("utf-8", "replace")
            headers.append((k, val))
    h.headers = tuple(headers)
    return h


def _dec_dns(data: memoryview) -> DNSInfo:
    d = DNSInfo(qtypes=())
    for field, wt, v in _fields(data):
        if field == _D_QUERY and wt == _LEN:
            d.query = bytes(v).decode("utf-8", "replace")
        elif field == _D_RCODE and wt == _VARINT:
            d.rcode = int(v)
    return d


def _dec_kafka(data: memoryview) -> KafkaInfo:
    k = KafkaInfo()
    for field, wt, v in _fields(data):
        if field == _K_VERSION and wt == _VARINT:
            k.api_version = int(v)
        elif field == _K_APIKEY and wt == _LEN:
            name = bytes(v).decode("utf-8", "replace")
            if name in _KAFKA_APIKEY_NUMS:
                k.api_key = _KAFKA_APIKEY_NUMS[name]
            elif name.isdigit():
                # our encoder (and any numeric exporter) writes the
                # raw api key for roles without a name — mapping those
                # to 0/produce would rewrite the ACL being checked
                k.api_key = int(name)
            else:
                # unknown role string: sentinel, never 0/produce
                k.api_key = KAFKA_APIKEY_UNKNOWN
        elif field == _K_CORRELATION and wt == _VARINT:
            k.correlation_id = int(v)
        elif field == _K_TOPIC and wt == _LEN:
            k.topic = bytes(v).decode("utf-8", "replace")
    return k


def _dec_l7(data: memoryview, f: Flow) -> None:
    for field, wt, v in _fields(data):
        if field == _L7_HTTP and wt == _LEN:
            f.l7 = L7Type.HTTP
            f.http = _dec_http(v)
        elif field == _L7_DNS and wt == _LEN:
            f.l7 = L7Type.DNS
            f.dns = _dec_dns(v)
        elif field == _L7_KAFKA and wt == _LEN:
            f.l7 = L7Type.KAFKA
            f.kafka = _dec_kafka(v)


def _dec_l4(data: memoryview, f: Flow) -> None:
    for field, wt, v in _fields(data):
        if wt != _LEN:
            continue
        if field == _L4_TCP:
            f.protocol = Protocol.TCP
            f.sport, f.dport = _dec_ports(v)
        elif field == _L4_UDP:
            f.protocol = Protocol.UDP
            f.sport, f.dport = _dec_ports(v)
        elif field == _L4_SCTP:
            f.protocol = Protocol.SCTP
            f.sport, f.dport = _dec_ports(v)
        elif field in (_L4_ICMP4, _L4_ICMP6):
            f.protocol = (Protocol.ICMP if field == _L4_ICMP4
                          else Protocol.ICMPV6)
            for pf, pwt, pv in _fields(v):
                if pf == _ICMP_TYPE and pwt == _VARINT:
                    f.dport = int(pv)  # type rides the port slot


def decode_flow(data: bytes) -> Flow:
    f = Flow()
    for field, wt, v in _fields(memoryview(data)):
        if field == _F_VERDICT and wt == _VARINT:
            try:
                f.verdict = Verdict(int(v))
            except ValueError:
                pass
        elif field == _F_L4 and wt == _LEN:
            _dec_l4(v, f)
        elif field == _F_SOURCE and wt == _LEN:
            f.src_identity, f.src_labels = _dec_endpoint(v)
        elif field == _F_DEST and wt == _LEN:
            f.dst_identity, f.dst_labels = _dec_endpoint(v)
        elif field == _F_NODE_NAME and wt == _LEN:
            f.node_name = bytes(v).decode("utf-8", "replace")
        elif field == _F_L7 and wt == _LEN:
            _dec_l7(v, f)
        elif field == _F_TRAFFIC_DIR and wt == _VARINT:
            # flowpb: 1=INGRESS 2=EGRESS (0 unknown → default ingress)
            f.direction = (TrafficDirection.EGRESS if int(v) == 2
                           else TrafficDirection.INGRESS)
        elif field == _F_TIME and wt == _LEN:
            secs = nanos = 0
            for tf, twt, tv in _fields(v):
                if tf == 1 and twt == _VARINT:
                    secs = int(tv)
                elif tf == 2 and twt == _VARINT:
                    nanos = int(tv)
            f.time = secs + nanos / 1e9
    return f


# -- encode (fixture/exporter parity) --------------------------------------

def _enc_endpoint(identity: int, labels: Tuple[str, ...]) -> bytes:
    out = bytearray()
    _put_varint(out, _E_IDENTITY, identity)
    for lbl in labels or ():
        _put_str(out, _E_LABELS, lbl)
    return bytes(out)


def encode_flow(f: Flow) -> bytes:
    out = bytearray()
    if f.time:
        ts = bytearray()
        _put_varint(ts, 1, int(f.time))
        _put_varint(ts, 2, int((f.time % 1) * 1e9))
        _put_len(out, _F_TIME, bytes(ts))
    _put_varint(out, _F_VERDICT, int(f.verdict))
    l4 = bytearray()
    ports = bytearray()
    if f.protocol in (Protocol.ICMP, Protocol.ICMPV6):
        _put_varint(ports, _ICMP_TYPE, f.dport)
        _put_len(l4, _L4_ICMP4 if f.protocol == Protocol.ICMP
                 else _L4_ICMP6, bytes(ports))
    else:
        _put_varint(ports, _P_SPORT, f.sport)
        _put_varint(ports, _P_DPORT, f.dport)
        oneof = {Protocol.TCP: _L4_TCP, Protocol.UDP: _L4_UDP,
                 Protocol.SCTP: _L4_SCTP}.get(f.protocol, _L4_TCP)
        _put_len(l4, oneof, bytes(ports))
    _put_len(out, _F_L4, bytes(l4))
    _put_len(out, _F_SOURCE,
             _enc_endpoint(f.src_identity, getattr(f, "src_labels", ())))
    _put_len(out, _F_DEST,
             _enc_endpoint(f.dst_identity, getattr(f, "dst_labels", ())))
    _put_str(out, _F_NODE_NAME, getattr(f, "node_name", ""))
    if f.l7 != L7Type.NONE:
        l7 = bytearray()
        _put_varint(l7, _L7_TYPE, _L7_REQUEST)
        if f.l7 == L7Type.HTTP and f.http:
            h = bytearray()
            _put_varint(h, _H_CODE, f.http.code)
            _put_str(h, _H_METHOD, f.http.method)
            _put_str(h, _H_URL, f.http.path)
            _put_str(h, _H_PROTOCOL, f.http.protocol)
            for k, v in f.http.headers or ():
                hdr = bytearray()
                _put_str(hdr, _HDR_KEY, k)
                _put_str(hdr, _HDR_VALUE, v)
                _put_len(h, _H_HEADERS, bytes(hdr))
            _put_len(l7, _L7_HTTP, bytes(h))
        elif f.l7 == L7Type.DNS and f.dns:
            d = bytearray()
            _put_str(d, _D_QUERY, f.dns.query)
            _put_varint(d, _D_RCODE, f.dns.rcode)
            _put_len(l7, _L7_DNS, bytes(d))
        elif f.l7 == L7Type.KAFKA and f.kafka:
            k = bytearray()
            _put_varint(k, _K_VERSION, f.kafka.api_version)
            _put_str(k, _K_APIKEY,
                     _KAFKA_APIKEY_NAMES.get(f.kafka.api_key,
                                             str(f.kafka.api_key)))
            _put_varint(k, _K_CORRELATION, f.kafka.correlation_id)
            _put_str(k, _K_TOPIC, f.kafka.topic)
            _put_len(l7, _L7_KAFKA, bytes(k))
        _put_len(out, _F_L7, bytes(l7))
    _put_varint(out, _F_TRAFFIC_DIR,
                2 if f.direction == TrafficDirection.EGRESS else 1)
    return bytes(out)


# -- stream framing --------------------------------------------------------

def write_pb_capture(path: str, flows) -> int:
    """Varint-length-prefixed Flow stream (protobuf stream framing)."""
    n = 0
    with open(path, "wb") as fp:
        for f in flows:
            msg = encode_flow(f)
            pre = bytearray()
            _write_varint(pre, len(msg))
            fp.write(pre)
            fp.write(msg)
            n += 1
    return n


def read_pb_capture(path: str, start: int = 0,
                    limit: Optional[int] = None) -> List[Flow]:
    return list(iter_pb_capture(path, start=start, limit=limit))


def iter_pb_capture(path: str, start: int = 0,
                    limit: Optional[int] = None) -> Iterator[Flow]:
    import mmap

    with open(path, "rb") as fp:
        if not fp.read(1):
            return  # empty capture
        fp.seek(0)
        # mmap keeps memory flat on multi-GB captures (same discipline
        # as the CTCAP path's memmap); skipped messages before `start`
        # cost a varint read each, never a decode
        with mmap.mmap(fp.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            data = memoryview(mm)
            try:
                pos = 0
                idx = 0
                emitted = 0
                while pos < len(data):
                    n, pos = _read_varint(data, pos)
                    if pos + n > len(data):
                        raise PBError("truncated message")
                    if idx >= start:
                        if limit is not None and emitted >= limit:
                            return
                        yield decode_flow(bytes(data[pos:pos + n]))
                        emitted += 1
                    idx += 1
                    pos += n
            finally:
                data.release()  # else mmap.close() raises BufferError


def looks_like_pb_capture(path: str) -> bool:
    """Sniff: not our CTCAP binary, not JSONL — and the FIRST full
    message must actually decode as a Flow (a leading varint alone
    accepts ~any binary garbage and would route corrupt files into the
    pb replay path)."""
    with open(path, "rb") as fp:
        head = fp.read(16)
        if not head or head[:1] in (b"{", b"[", b" ", b"\n"):
            return False
        from cilium_tpu_torch.ingest.binary import MAGIC

        if head.startswith(MAGIC):
            return False
        try:
            n, pos = _read_varint(memoryview(head), 0)
            if not 0 < n < 1 << 24:
                return False
            fp.seek(pos)
            msg = fp.read(n)
            if len(msg) < n:
                return False
            decode_flow(msg)
            return True
        except ValueError:
            # PBError, but also e.g. urlsplit errors from a bogus URL
            # field — any first-message decode failure means "not ours"
            return False
