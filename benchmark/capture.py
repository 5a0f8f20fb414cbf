"""The capture file the replay reads: version 2 of the capture layout
(little-endian), written from :class:`benchmark.traffic.Records` with
NumPy alone.

A 16-byte header (magic ``CTCAP1``, version, count); one 32-byte record
a flow (source and destination identity, ports, protocol, direction,
L7 type, verdict, time); a 16-byte L7 header (string count, 0, blob
bytes); the shared string table (``count + 1`` u32 offsets and one
blob, string 0 empty: the HTTP fields' strings, then the Kafka client
ids' and topics'); one 32-byte L7 record a flow of string indices and
the Kafka API key and version.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from benchmark.traffic import STRING_FIELDS, Records

MAGIC = b"CTCAP1\x00\x00"
VERSION_L7 = 2
HEADER = np.dtype([("magic", "S8"), ("version", "<u4"), ("count", "<u4")])
L7HEADER = np.dtype([("n_strings", "<u4"), ("reserved", "<u4"),
                     ("blob_bytes", "<u8")])
RECORD = np.dtype([
    ("src_identity", "<u4"), ("dst_identity", "<u4"),
    ("dport", "<u2"), ("sport", "<u2"),
    ("proto", "u1"), ("direction", "u1"), ("l7_type", "u1"),
    ("verdict", "u1"),
    ("time", "<f8"),
    ("reserved0", "<u4"), ("reserved1", "<u4"),
])
L7REC = np.dtype([
    ("path", "<u4"), ("method", "<u4"), ("host", "<u4"),
    ("headers", "<u4"), ("qname", "<u4"),
    ("kafka_client", "<u4"), ("kafka_topic", "<u4"),
    ("kafka_api_key", "<i2"), ("kafka_api_version", "<i2"),
])


def sections(rec: Records):
    """(records, l7 records, offsets, blob) of the capture."""
    n = len(rec)
    out = np.zeros(n, dtype=RECORD)
    out["src_identity"] = rec.src
    out["dst_identity"] = rec.dst
    out["dport"] = rec.dport
    out["sport"] = 32768 + np.arange(n) % 28232
    out["proto"] = rec.proto
    out["direction"] = rec.direction
    out["l7_type"] = rec.l7
    out["time"] = np.arange(n) * 1e-6
    strings: List[bytes] = [b""]
    l7 = np.zeros(n, dtype=L7REC)
    for field in STRING_FIELDS:
        table, idx = rec.strings[field]
        base = len(strings) - 1          # the field's table[1:] follows
        strings.extend(table[1:])
        col = np.where(idx > 0, idx + base, 0)
        l7[field] = col.astype(np.uint32)
    l7["kafka_api_key"] = rec.kafka_api_key
    l7["kafka_api_version"] = rec.kafka_api_version
    lens = np.fromiter((len(s) for s in strings), dtype=np.uint64,
                       count=len(strings))
    offsets = np.zeros(len(strings) + 1, dtype=np.uint32)
    offsets[1:] = np.cumsum(lens)
    blob = np.frombuffer(b"".join(strings), dtype=np.uint8)
    return out, l7, offsets, blob


def write(path: str, rec: Records) -> Dict[str, int]:
    out, l7, offsets, blob = sections(rec)
    header = np.zeros(1, dtype=HEADER)
    header[0] = (MAGIC, VERSION_L7, len(out))
    l7h = np.zeros(1, dtype=L7HEADER)
    l7h[0] = (len(offsets) - 1, 0, blob.size)
    with open(path, "wb") as fp:
        for part in (header, out, l7h, offsets, blob, l7):
            fp.write(part.tobytes())
    return {"records": len(out), "strings": len(offsets) - 1,
            "blob_bytes": int(blob.size)}
