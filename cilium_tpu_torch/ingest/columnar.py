"""Columnar capture encoding (counterpart of the reference's
``ingest/columnar.py``): flows → :class:`CaptureColumns`, the v2/v3
capture sections as plain numpy arrays, with one batch intern per
string column. Strings are normalized here, at write time (host
lowered, qname sanitized, headers canonically serialized, generic
pairs key-sorted), so replay featurizes with numpy gathers only.

The JSONL and protobuf readers of the reference are not part of the
port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from cilium_tpu_torch.ingest.binary import L7REC, RECORD, gen_dtype

#: the flat per-record column tuple :func:`flow_to_column_tuple`
#: emits, in order. ``gpairs`` is a tuple of (key bytes, value bytes)
#: pairs, already key-sorted.
COLUMN_FIELDS = (
    "time", "verdict", "direction", "src_identity", "dst_identity",
    "sport", "dport", "proto", "l7_type",
    "path", "method", "host", "headers", "qname",
    "kafka_client", "kafka_topic", "kafka_api_key",
    "kafka_api_version", "gen_proto", "gpairs",
)

_STRING_COLS = ("path", "method", "host", "headers", "qname",
                "kafka_client", "kafka_topic")


@dataclasses.dataclass
class CaptureColumns:
    """One capture as struct-of-arrays: exactly the v2/v3 binary
    sections. ``gen`` is None (and ``fmax`` 0) when no record carries
    a generic payload — the capture stays v2."""

    rec: np.ndarray                 # [N] RECORD
    l7: np.ndarray                  # [N] L7REC (string-table indices)
    offsets: np.ndarray             # [S+1] u32
    blob: np.ndarray                # [blob_bytes] u8
    gen: Optional[np.ndarray] = None
    fmax: int = 0
    #: GENERIC records flattened to their L4 tuple (no proto)
    gen_dropped: int = 0


class StringInterner:
    """First-occurrence string interner producing the shared capture
    string table (string 0 = b"")."""

    def __init__(self) -> None:
        self._index: Dict[bytes, int] = {b"": 0}
        self._strings: List[bytes] = [b""]

    def intern(self, s: bytes) -> int:
        i = self._index.get(s)
        if i is None:
            i = self._index[s] = len(self._strings)
            self._strings.append(s)
        return i

    def ids(self, column: Iterable[bytes]) -> np.ndarray:
        index = self._index
        strings = self._strings
        out = np.empty(len(column), dtype=np.uint32)
        for i, s in enumerate(column):
            j = index.get(s)
            if j is None:
                j = index[s] = len(strings)
                strings.append(s)
            out[i] = j
        return out

    def table(self) -> Tuple[np.ndarray, np.ndarray]:
        """(offsets, blob) of the interned table."""
        from cilium_tpu_torch.ingest.binary import CaptureError

        lens = np.array([len(s) for s in self._strings],
                        dtype=np.uint64)
        total = int(lens.sum())
        if total > 0xFFFFFFFF:
            raise CaptureError(
                f"string table too large ({total} bytes)")
        offsets = np.zeros(len(self._strings) + 1, dtype=np.uint32)
        offsets[1:] = np.cumsum(lens)
        blob = np.frombuffer(b"".join(self._strings), dtype=np.uint8)
        return offsets, blob


def flow_to_column_tuple(f) -> tuple:
    """One ``Flow`` → the COLUMN_FIELDS tuple, normalized."""
    from cilium_tpu_torch.core.flow import L7Type
    from cilium_tpu_torch.engine.compiled import serialize_headers
    from cilium_tpu_torch.policy.compiler import matchpattern

    path = method = host = headers = qname = b""
    kclient = ktopic = b""
    kapi = kver = 0
    gproto = b""
    gpairs: tuple = ()
    h = f.http
    if h is not None:
        path = h.path.encode("utf-8")
        method = h.method.encode("utf-8")
        host = h.host.lower().encode("utf-8")
        headers = serialize_headers(h.headers)
    d = f.dns
    if d is not None and d.query:
        qname = matchpattern.sanitize_name(d.query).encode("utf-8")
    k = f.kafka
    if k is not None:
        kclient = k.client_id.encode("utf-8")
        ktopic = k.topic.encode("utf-8")
        kapi = k.api_key
        kver = k.api_version
    g = f.generic
    # frontend-family flows (l7 > GENERIC) carry like GENERIC: the
    # capture's canonical l7_type stays GENERIC
    l7t_out = int(f.l7)
    if f.l7 >= L7Type.GENERIC and g is not None:
        gproto = g.proto.encode("utf-8")
        gpairs = tuple((kk.encode("utf-8"), vv.encode("utf-8"))
                       for kk, vv in sorted(g.fields.items()) if kk)
        l7t_out = int(L7Type.GENERIC)
    return (f.time, int(f.verdict), int(f.direction),
            f.src_identity, f.dst_identity, f.sport, f.dport,
            int(f.protocol), l7t_out,
            path, method, host, headers, qname,
            kclient, ktopic, kapi, kver, gproto, gpairs)


def tuples_to_columns(rows: List[tuple]) -> CaptureColumns:
    """COLUMN_FIELDS tuples → :class:`CaptureColumns`: one batch intern
    per string column. A GENERIC record with no proto is flattened to
    its L3/L4 tuple; a carriable one forces the GENERIC section even
    with zero field pairs."""
    from cilium_tpu_torch.core.flow import L7Type

    n = len(rows)
    col = {name: i for i, name in enumerate(COLUMN_FIELDS)}

    def c(name: str) -> list:
        i = col[name]
        return [r[i] for r in rows]

    l7t = np.array(c("l7_type"), dtype=np.int64)
    gproto_col = c("gen_proto")
    carriable = np.array(
        [bool(p) for p in gproto_col], dtype=bool) \
        & (l7t >= int(L7Type.GENERIC))
    l7t = np.where((l7t >= int(L7Type.GENERIC)) & ~carriable,
                   int(L7Type.NONE), l7t)
    l7t = np.where(carriable, int(L7Type.GENERIC), l7t)

    rec = np.zeros(n, dtype=RECORD)
    rec["src_identity"] = c("src_identity")
    rec["dst_identity"] = c("dst_identity")
    rec["dport"] = c("dport")
    rec["sport"] = c("sport")
    rec["proto"] = c("proto")
    rec["direction"] = c("direction")
    rec["l7_type"] = l7t
    rec["verdict"] = c("verdict")
    rec["time"] = c("time")

    interner = StringInterner()
    l7 = np.zeros(n, dtype=L7REC)
    for name in _STRING_COLS:
        l7[name] = interner.ids(c(name))
    l7["kafka_api_key"] = c("kafka_api_key")
    l7["kafka_api_version"] = c("kafka_api_version")

    gen = None
    fmax = 0
    if carriable.any():
        gpairs_col = c("gpairs")
        fmax = max(max((len(p) for p in gpairs_col), default=0), 1)
        gen = np.zeros(n, dtype=gen_dtype(fmax))
        gen["proto"] = interner.ids(
            [p if carr else b""
             for p, carr in zip(gproto_col, carriable)])
        for i in np.nonzero(carriable)[0]:
            for j, (kk, vv) in enumerate(gpairs_col[i]):
                gen[i]["pairs"][j] = (interner.intern(kk),
                                      interner.intern(vv))
    offsets, blob = interner.table()
    return CaptureColumns(
        rec=rec, l7=l7, offsets=offsets, blob=blob, gen=gen,
        fmax=fmax,
        gen_dropped=int(
            ((np.array(c("l7_type")) >= int(L7Type.GENERIC))
             & ~carriable).sum()))


def flows_to_columns(flows: Iterable) -> CaptureColumns:
    """Flows → :class:`CaptureColumns` (column-major intern order)."""
    return tuples_to_columns([flow_to_column_tuple(f) for f in flows])
