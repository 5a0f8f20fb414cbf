"""Kafka wire-protocol parser.

Reference: ``proxylib/kafka`` + the public Kafka protocol spec: a
request frame is

    int32 size | int16 api_key | int16 api_version | int32 correlation
    | string client_id | [flexible: tagged fields] | <api body>

Topic extraction implemented for the record-carrying APIs the rules
target (BASELINE config[2] "topic/API-key ACL rules × produce/fetch
records"), across the format's generations:

* **produce** v0–v2 (acks,timeout then classic topic array), v3–v8
  (leading transactional_id), v9–v11 FLEXIBLE (KIP-482: header
  tagged fields, compact strings/arrays, per-partition compact
  record batches + tagged fields);
* **fetch** v0–v2 (replica,max_wait,min_bytes), v3–v6 (+max_bytes,
  isolation), v7–v11 (+session id/epoch, per-partition
  log_start_offset, v9+ current_leader_epoch), v12 FLEXIBLE
  (+last_fetched_epoch, compact layout). v13+ replaced topic NAMES
  with topic-id uuids (KIP-516) — decoding them as names would let a
  crafted frame present a fake allowed name, so they fail CLOSED by
  version gate;
* **metadata** v0–v8 classic topic array (v9+ is flexible with
  topic-id structs — not decoded; fails CLOSED below).

Other APIs yield a single record with an empty topic (matched on
api_key alone). ANY walk failure — truncated data, a version newer
than the layouts above, compact/tagged garbage — produces the
unmatchable ``\\x00unparseable`` topic sentinel, so topic-constrained
rules fail CLOSED rather than ever matching a guessed topic. Requests
are verdicted per frame: every parsed record must be allowed, else
the frame is DROPPED and a Kafka error response
(TOPIC_AUTHORIZATION_FAILED, v0-era response shapes only) is INJECTed
back to the client — matching the reference, where a denied produce
still gets a well-formed broker error instead of a hung request.
Responses pass through.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from cilium_tpu_torch.core.flow import KafkaInfo
from cilium_tpu_torch.proxylib.parser import (
    Connection,
    Op,
    OpType,
    Parser,
    register_parser,
)

API_PRODUCE = 0
API_FETCH = 1
API_METADATA = 3


def _read_string(buf: bytes, off: int) -> Tuple[Optional[str], int]:
    if off + 2 > len(buf):
        return None, off
    (n,) = struct.unpack_from(">h", buf, off)
    off += 2
    if n < 0:
        return "", off
    if off + n > len(buf):
        return None, off
    return buf[off:off + n].decode("utf-8", "replace"), off + n


class _WalkError(Exception):
    """Body-walk failure → the unparseable (fail-closed) record."""


# -- flexible-version (KIP-482) primitives ---------------------------------

def _read_uvarint(buf: bytes, off: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        if off >= len(buf) or shift > 28:
            raise _WalkError("truncated/oversized uvarint")
        b = buf[off]
        off += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, off
        shift += 7


def _skip_tagged(buf: bytes, off: int) -> int:
    """Skip a tagged-fields block (uvarint count, then per field a
    uvarint tag + uvarint size + size bytes)."""
    n, off = _read_uvarint(buf, off)
    if n > 64:
        raise _WalkError("implausible tagged-field count")
    for _ in range(n):
        _, off = _read_uvarint(buf, off)       # tag
        size, off = _read_uvarint(buf, off)    # value size
        off += size
        if off > len(buf):
            raise _WalkError("truncated tagged field")
    return off


def _read_compact_str(buf: bytes, off: int) -> Tuple[Optional[str], int]:
    """Compact (nullable) string: uvarint length+1; 0 = null."""
    n1, off = _read_uvarint(buf, off)
    if n1 == 0:
        return None, off
    n = n1 - 1
    if off + n > len(buf):
        raise _WalkError("truncated compact string")
    return buf[off:off + n].decode("utf-8", "replace"), off + n


def _skip_compact_bytes(buf: bytes, off: int) -> int:
    """Compact nullable bytes: uvarint length+1; 0 = null."""
    n1, off = _read_uvarint(buf, off)
    if n1 == 0:
        return off
    off += n1 - 1
    if off > len(buf):
        raise _WalkError("truncated compact bytes")
    return off


def parse_request_records(frame: bytes) -> List[KafkaInfo]:
    """Parse one complete request frame (without the 4-byte size prefix)
    into policy-checkable records."""
    if len(frame) < 8:
        # too short for a request header — fail closed, like any other
        # unparseable frame (an empty record list would PASS). api_key
        # 31 is unassigned, so key- and topic-constrained rules both
        # refuse it; only an unconstrained allow-all rule admits it.
        return [KafkaInfo(api_key=31, topic="\x00unparseable")]
    api_key, api_version, correlation = struct.unpack_from(">hhi", frame, 0)
    client_id, off = _read_string(frame, 8)
    if client_id is None:
        client_id, off = "", 8
    base = dict(api_key=api_key, api_version=api_version,
                client_id=client_id, correlation_id=correlation)

    topics: Optional[List[str]] = []
    v = api_version
    try:
        if api_key == API_PRODUCE:
            if v > 11:
                # beyond the layouts verified byte-exactly: fail
                # closed, never walk with a guessed layout (a wrong
                # walk can extract an attacker-chosen fake topic)
                raise _WalkError(f"produce v{v} not decoded")
            if v >= 9:  # flexible (v9-v11 share the topic layout)
                off = _skip_tagged(frame, off)  # header tagged fields
                _, off = _read_compact_str(frame, off)  # transactional_id
                off += 6  # acks int16 + timeout int32
                topics = _read_compact_topic_array(
                    frame, off, _skip_produce_partitions_flex)
            else:
                if v >= 3:  # transactional_id (nullable classic string)
                    tx, off = _read_string(frame, off)
                    if tx is None:
                        raise _WalkError("truncated transactional_id")
                off += 6  # acks int16 + timeout int32
                topics = _read_topic_array(frame, off,
                                           _skip_produce_partitions)
        elif api_key == API_FETCH:
            if v > 12:
                # v13+ replaced topic names with topic-id uuids
                # (KIP-516): walking them as names would let a crafted
                # frame present a fake allowed name for a forbidden
                # topic — fail closed
                raise _WalkError(f"fetch v{v} not decoded")
            if v == 12:  # flexible, name-based
                off = _skip_tagged(frame, off)
                off += 25  # replica,max_wait,min_bytes,max_bytes i32s
                #          + isolation i8 + session id/epoch i32s
                topics = _read_compact_topic_array(
                    frame, off, _skip_fetch_partitions_flex)
            else:
                # classic header grows with the version:
                # v0-2: replica+max_wait+min_bytes; v3: +max_bytes;
                # v4-6: +isolation; v7-11: +session id/epoch
                off += (12 if v <= 2 else 16 if v == 3
                        else 17 if v <= 6 else 25)
                per_part = 16 if v <= 4 else 24 if v <= 8 else 28
                topics = _read_topic_array(
                    frame, off,
                    lambda f, o: _skip_fetch_partitions(f, o, per_part))
        elif api_key == API_METADATA:
            if v >= 9:
                # flexible metadata carries topic-id structs we don't
                # decode — fail CLOSED, never guess
                raise _WalkError("flexible metadata not decoded")
            topics = _read_topic_array(frame, off, None)
    except Exception:  # incl. _WalkError: any walk failure is the
        topics = None  # fail-closed sentinel below
    if topics is None:
        # unparseable topic data: return an unmatchable record so
        # topic-constrained rules DENY (conservative; never bypass)
        return [KafkaInfo(topic="\x00unparseable", **base)]
    if not topics:
        return [KafkaInfo(topic="", **base)]
    return [KafkaInfo(topic=t, **base) for t in topics]


def _skip_produce_partitions(frame: bytes, off: int) -> Optional[int]:
    """produce v0 per-topic payload: array<partition int32,
    message_set_size int32, bytes[message_set_size]>."""
    if off + 4 > len(frame):
        return None
    (n,) = struct.unpack_from(">i", frame, off)
    off += 4
    if n < 0 or n > 4096:
        return None  # refuse rather than desync (fail closed)
    for _ in range(n):
        if off + 8 > len(frame):
            return None
        (_, size) = struct.unpack_from(">ii", frame, off)
        if size < 0 or off + 8 + size > len(frame):
            return None
        off += 8 + size
    return off


def _skip_fetch_partitions(frame: bytes, off: int,
                           per_part: int = 16) -> Optional[int]:
    """fetch classic per-topic payload: array of fixed-size partition
    entries (16B v0-4: partition i32 + offset i64 + max_bytes i32;
    24B v5-8: + log_start_offset i64; 28B v9-11: + leader_epoch)."""
    if off + 4 > len(frame):
        return None
    (n,) = struct.unpack_from(">i", frame, off)
    off += 4
    need = per_part * max(0, n)
    if n < 0 or off + need > len(frame):
        return None
    return off + need


def _skip_produce_partitions_flex(frame: bytes, off: int) -> int:
    """flexible produce per-topic payload: compact array of
    {index i32, records compact-bytes, tagged}, then topic tagged."""
    n1, off = _read_uvarint(frame, off)
    n = max(0, n1 - 1)
    if n > 4096:
        raise _WalkError("implausible partition count")
    for _ in range(n):
        off += 4  # partition index
        if off > len(frame):
            raise _WalkError("truncated partition")
        off = _skip_compact_bytes(frame, off)   # record batch
        off = _skip_tagged(frame, off)          # partition tagged
    return _skip_tagged(frame, off)             # topic tagged


def _skip_fetch_partitions_flex(frame: bytes, off: int) -> int:
    """flexible fetch per-topic payload: compact array of
    {partition i32, current_leader_epoch i32, fetch_offset i64,
    last_fetched_epoch i32, log_start_offset i64, max_bytes i32,
    tagged} (32B fixed + tagged each), then topic tagged."""
    n1, off = _read_uvarint(frame, off)
    n = max(0, n1 - 1)
    if n > 4096:
        raise _WalkError("implausible partition count")
    for _ in range(n):
        off += 32
        if off > len(frame):
            raise _WalkError("truncated partition")
        off = _skip_tagged(frame, off)
    return _skip_tagged(frame, off)


def _read_compact_topic_array(frame: bytes, off: int,
                              skip_payload) -> List[str]:
    """Flexible (compact) topic array: every topic name is extracted
    and policy-checked, like the classic walk."""
    n1, off = _read_uvarint(frame, off)
    n = max(0, n1 - 1)
    if n > 1024:
        raise _WalkError("implausible topic count")
    out: List[str] = []
    for _ in range(n):
        t, off = _read_compact_str(frame, off)
        if t is None:
            raise _WalkError("null topic name")
        out.append(t)
        off = skip_payload(frame, off)
    return out


def _read_topic_array(frame: bytes, off: int,
                      skip_payload) -> Optional[List[str]]:
    """Parse EVERY topic in the array (each one is policy-checked; a
    multi-topic frame is only passed if all topics are allowed).
    Returns None if the layout cannot be fully walked."""
    if off + 4 > len(frame):
        return None
    (n,) = struct.unpack_from(">i", frame, off)
    off += 4
    if n < 0 or n > 1024:
        return None
    out: List[str] = []
    for _ in range(n):
        t, off = _read_string(frame, off)
        if t is None:
            return None
        out.append(t)
        if skip_payload is not None:
            nxt = skip_payload(frame, off)
            if nxt is None:
                return None
            off = nxt
    return out


def encode_request(api_key: int, api_version: int, correlation: int,
                   client_id: str, topic: str = "") -> bytes:
    """Synthetic encoder (test/replay harness; the reference's unit
    tests build frames the same way)."""
    body = struct.pack(">hhi", api_key, api_version, correlation)
    cid = client_id.encode()
    body += struct.pack(">h", len(cid)) + cid
    topics = ([topic] if isinstance(topic, str) and topic
              else list(topic) if not isinstance(topic, str) else [])
    if api_key == API_PRODUCE:
        body += struct.pack(">hi", 1, 1000)
        body += _topic_array(topics, _produce_payload)
    elif api_key == API_FETCH:
        body += struct.pack(">iii", -1, 100, 1)
        body += _topic_array(topics, _fetch_payload)
    elif api_key == API_METADATA:
        body += _topic_array(topics, None)
    return struct.pack(">i", len(body)) + body


def _produce_payload() -> bytes:
    msgset = b"\x00" * 12
    return struct.pack(">i", 1) + struct.pack(">ii", 0, len(msgset)) + msgset


def _fetch_payload() -> bytes:
    return struct.pack(">i", 1) + struct.pack(">iqi", 0, 0, 1 << 20)


def _topic_array(topics, payload_fn) -> bytes:
    out = struct.pack(">i", len(topics))
    for t in topics:
        tb = t.encode()
        out += struct.pack(">h", len(tb)) + tb
        if payload_fn is not None:
            out += payload_fn()
    return out


#: Kafka error code injected for policy denials (reference
#: proxylib/kafka: the broker-side authorization failure).
ERR_TOPIC_AUTHORIZATION_FAILED = 29


def produce_acks(frame: bytes) -> int:
    """The acks field of a produce request (first int16 after the
    client id); -1 when unreadable. acks=0 produces expect NO response
    — injecting one would be consumed as the reply to the client's
    NEXT request and desync the connection."""
    if len(frame) < 8:
        return -1
    _, off = _read_string(frame, 8)
    if off + 2 > len(frame):
        return -1
    (acks,) = struct.unpack_from(">h", frame, off)
    return acks


def _string(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def encode_error_response(records: List[KafkaInfo]) -> bytes:
    """A well-formed error response frame for a denied request:
    correlation id echoed, every topic/partition carrying
    TOPIC_AUTHORIZATION_FAILED. Version-aware within the layouts that
    are stable (produce/fetch v0-v2 request layout; v1+ responses gain
    a throttle_time_ms field — appended for produce, leading for
    fetch). Anything newer/unknown returns b"" — the caller falls back
    to a bare DROP (a guessed-wrong frame would desync the client
    worse than silence)."""
    if not records:
        return b""
    r0 = records[0]
    v = r0.api_version
    topics = [r.topic for r in records if r.topic
              and not r.topic.startswith("\x00")]
    err = ERR_TOPIC_AUTHORIZATION_FAILED
    if r0.api_key == API_PRODUCE and 0 <= v <= 2:
        # array<topic, array<partition i32, error i16, offset i64>>
        # (+ v2: per-partition log_append_time i64; v1+: trailing
        # throttle_time_ms)
        body = struct.pack(">i", len(topics))
        for t in topics:
            body += _string(t) + struct.pack(">i", 1)
            body += struct.pack(">ihq", 0, err, -1)
            if v >= 2:
                body += struct.pack(">q", -1)  # log_append_time
        if v >= 1:
            body += struct.pack(">i", 0)       # throttle_time_ms
    elif r0.api_key == API_FETCH and 0 <= v <= 2:
        # (v1+: leading throttle_time_ms) array<topic,
        #  array<partition i32, error i16, high_watermark i64,
        #        message_set_size i32 (empty)>>
        body = b"" if v == 0 else struct.pack(">i", 0)
        body += struct.pack(">i", len(topics))
        for t in topics:
            body += _string(t) + struct.pack(">i", 1)
            body += struct.pack(">ihqi", 0, err, -1, 0)
    elif r0.api_key == API_METADATA and v == 0:
        # v0: brokers array (empty) + array<topic_metadata:
        #      error i16, topic, partitions array (empty)>
        body = struct.pack(">i", 0)
        body += struct.pack(">i", len(topics))
        for t in topics:
            body += struct.pack(">h", err) + _string(t)
            body += struct.pack(">i", 0)
    else:
        return b""
    payload = struct.pack(">i", r0.correlation_id) + body
    return struct.pack(">i", len(payload)) + payload


class KafkaParser(Parser):
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
            if len(self._buf) < 4:
                ops.append((OpType.MORE, 4 - len(self._buf)))
                break
            (size,) = struct.unpack_from(">i", self._buf, 0)
            if size < 0 or size > 1 << 24:
                ops.append((OpType.ERROR, 0))
                break
            frame_len = 4 + size
            if len(self._buf) < frame_len:
                ops.append((OpType.MORE, frame_len - len(self._buf)))
                break
            frame = self._buf[4:frame_len]
            records = parse_request_records(frame)
            allowed = all(self.policy_check(r) for r in records)
            if allowed:
                ops.append((OpType.PASS, frame_len))
            else:
                # deny: drop the request AND answer the client with a
                # broker-shaped authorization error (reference
                # proxylib/kafka behavior); unparseable frames have no
                # valid correlation id to echo, and acks=0 produces
                # expect no response at all → bare drop for those
                # encode_error_response is version-gated (returns b""
                # outside the layouts it can encode correctly); the
                # acks guard is valid for the same produce versions
                # (acks position is stable v0-v2, shifted by
                # transactional_id in v3+)
                err = encode_error_response(records)
                if err and not (records[0].api_key == API_PRODUCE
                                and produce_acks(frame) == 0):
                    ops.append(self.connection.inject(err))
                ops.append((OpType.DROP, frame_len))
            self._buf = self._buf[frame_len:]
            if not self._buf:
                break
        return ops


register_parser("kafka", KafkaParser)  # ctlint: disable=frontend-registry  # engine speaks Kafka natively (columnar predicate family)
