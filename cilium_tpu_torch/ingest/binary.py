"""Binary flow captures, pure numpy (counterpart of the reference's
``ingest/binary.py`` without its native codec).

Layout (little-endian): a 16-byte header (magic, version, count), the
32-byte base records, then for version 2 an L7 sidecar — a 16-byte L7
header (string count, reserved, blob bytes), the shared string table
(u32 offsets + one blob, string 0 = ""), and one 32-byte L7 record per
flow holding string-table indices. Version 3 appends a GENERIC section
(``gen_dtype(fmax)`` per flow; fmax in the L7 header's reserved word).
The reference pairs a native codec with a numpy fallback that writes
the identical bytes; this module is that fallback, so a file written
here is byte-identical to the reference's for the same flows.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional

import numpy as np

from cilium_tpu_torch.core.flow import (
    DNSInfo,
    Flow,
    GenericL7Info,
    HTTPInfo,
    KafkaInfo,
    L7Type,
    Protocol,
    TrafficDirection,
    Verdict,
)

MAGIC = b"CTCAP1\x00\x00"
VERSION = 1
VERSION_L7 = 2
#: version 3 = v2 + a GENERIC section (one record per flow: the
#: ``l7proto`` name and up to fmax (key, value) string-index pairs)
VERSION_L7G = 3
HEADER = np.dtype([("magic", "S8"), ("version", "<u4"),
                   ("count", "<u4")])
L7HEADER = np.dtype([("n_strings", "<u4"), ("reserved", "<u4"),
                     ("blob_bytes", "<u8")])


def gen_dtype(fmax: int) -> np.dtype:
    """Per-flow generic record: l7proto string index + fmax (key,
    value) string-index pairs (index 0 = "" = unused slot)."""
    return np.dtype([("proto", "<u4"), ("pairs", "<u4", (fmax, 2))])


#: the 32-byte base record
RECORD = np.dtype([
    ("src_identity", "<u4"), ("dst_identity", "<u4"),
    ("dport", "<u2"), ("sport", "<u2"),
    ("proto", "u1"), ("direction", "u1"), ("l7_type", "u1"),
    ("verdict", "u1"),
    ("time", "<f8"),
    ("reserved0", "<u4"), ("reserved1", "<u4"),
])
assert RECORD.itemsize == 32

#: the 32-byte L7 record (v2 sidecar): indices into the shared string
#: table; index 0 is always the empty string
L7REC = np.dtype([
    ("path", "<u4"), ("method", "<u4"), ("host", "<u4"),
    ("headers", "<u4"), ("qname", "<u4"),
    ("kafka_client", "<u4"), ("kafka_topic", "<u4"),
    ("kafka_api_key", "<i2"), ("kafka_api_version", "<i2"),
])
assert L7REC.itemsize == 32


class CaptureError(ValueError):
    pass


def flows_to_records(flows: Iterable[Flow]) -> np.ndarray:
    """Flows → base records. l7_type is recorded as NONE: a v1 record
    carries no payload, so it must replay as the L3/L4 tuple it is."""
    flows = list(flows)
    rec = np.zeros(len(flows), dtype=RECORD)
    for i, f in enumerate(flows):
        rec[i] = (f.src_identity, f.dst_identity, f.dport, f.sport,
                  int(f.protocol), int(f.direction), int(L7Type.NONE),
                  int(f.verdict), f.time, 0, 0)
    return rec


def records_to_flows(rec: np.ndarray) -> List[Flow]:
    return [
        Flow(src_identity=int(r["src_identity"]),
             dst_identity=int(r["dst_identity"]),
             dport=int(r["dport"]), sport=int(r["sport"]),
             protocol=Protocol(int(r["proto"])),
             direction=TrafficDirection(int(r["direction"])),
             l7=L7Type(int(r["l7_type"])),
             verdict=Verdict(int(r["verdict"])),
             time=float(r["time"]))
        for r in rec
    ]


def capture_count(path: str) -> int:
    """Validate the whole layout (magic, version, section sizes) and
    return the record count."""
    with open(path, "rb") as fp:
        raw = fp.read(HEADER.itemsize)
        if len(raw) < HEADER.itemsize:
            raise CaptureError("truncated capture")
        h = np.frombuffer(raw, dtype=HEADER)[0]
        if bytes(h["magic"]).ljust(8, b"\x00") != MAGIC:
            raise CaptureError("bad magic")
        version, count = int(h["version"]), int(h["count"])
        if version not in (VERSION, VERSION_L7, VERSION_L7G):
            raise CaptureError("unsupported version")
        want = HEADER.itemsize + count * RECORD.itemsize
        if version in (VERSION_L7, VERSION_L7G):
            fp.seek(want)
            lraw = fp.read(L7HEADER.itemsize)
            if len(lraw) < L7HEADER.itemsize:
                raise CaptureError("truncated capture")
            lh = np.frombuffer(lraw, dtype=L7HEADER)[0]
            want += (L7HEADER.itemsize
                     + (int(lh["n_strings"]) + 1) * 4
                     + int(lh["blob_bytes"])
                     + count * L7REC.itemsize)
            if version == VERSION_L7G:
                fmax = int(lh["reserved"])
                if fmax <= 0:
                    raise CaptureError("truncated capture")
                want += count * gen_dtype(fmax).itemsize
        fp.seek(0, os.SEEK_END)
        if fp.tell() != want:
            raise CaptureError("truncated capture")
        return count


def map_capture(path: str):
    """Validate once, then expose the base records as a read-only
    memmap (they follow the header in every version)."""
    total = capture_count(path)
    if total == 0:
        return np.zeros(0, dtype=RECORD)
    return np.memmap(path, dtype=RECORD, mode="r",
                     offset=HEADER.itemsize, shape=(total,))


def capture_version(path: str) -> int:
    with open(path, "rb") as fp:
        raw = fp.read(HEADER.itemsize)
    if len(raw) < HEADER.itemsize:
        raise CaptureError("truncated capture")
    return int(np.frombuffer(raw, dtype=HEADER)[0]["version"])


def write_capture_records(path: str, rec: np.ndarray) -> int:
    """Write a v1 capture straight from a RECORD array (the columnar
    tooling path — no Flow objects)."""
    header = np.zeros(1, dtype=HEADER)
    header[0] = (MAGIC, VERSION, len(rec))
    with open(path, "wb") as fp:
        fp.write(header.tobytes())
        fp.write(np.ascontiguousarray(rec).tobytes())
    return len(rec)


def write_capture(path: str, flows: Iterable[Flow]) -> int:
    """Write a v1 capture (base records only) of ``flows``."""
    return write_capture_records(path, flows_to_records(flows))


class CaptureWriter:
    """Record-batch writer: ``write_batch`` per batch of base records +
    aligned L7 rows (+ aligned GENERIC rows when ``fmax > 0``), then
    ``finish`` with the shared string table writes the file."""

    def __init__(self, path: str, fmax: int = 0):
        self.path = path
        self.fmax = int(fmax)
        self._batches: List[tuple] = []

    def write_batch(self, rec: np.ndarray, l7: np.ndarray,
                    gen: Optional[np.ndarray] = None) -> None:
        if len(rec) != len(l7) or (
                self.fmax > 0 and (gen is None or len(gen) != len(rec))):
            raise CaptureError("batch sections misaligned")
        self._batches.append(
            (np.asarray(rec).copy(), np.asarray(l7).copy(),
             None if gen is None else np.asarray(gen).copy()))

    def finish(self, offsets: np.ndarray, blob: np.ndarray) -> int:
        offsets = np.ascontiguousarray(offsets, dtype=np.uint32)
        blob = np.ascontiguousarray(blob, dtype=np.uint8)
        rec = (np.concatenate([b[0] for b in self._batches])
               if self._batches else np.zeros(0, dtype=RECORD))
        l7 = (np.concatenate([b[1] for b in self._batches])
              if self._batches else np.zeros(0, dtype=L7REC))
        gen = (np.concatenate([b[2] for b in self._batches])
               if self.fmax > 0 else None)
        header = np.zeros(1, dtype=HEADER)
        version = VERSION_L7 if self.fmax == 0 else VERSION_L7G
        header[0] = (MAGIC, version, len(rec))
        l7h = np.zeros(1, dtype=L7HEADER)
        l7h[0] = (len(offsets) - 1, self.fmax, int(blob.size))
        with open(self.path, "wb") as fp:
            fp.write(header.tobytes())
            fp.write(rec.tobytes())
            fp.write(l7h.tobytes())
            fp.write(offsets.tobytes())
            fp.write(blob.tobytes())
            fp.write(l7.tobytes())
            if gen is not None:
                fp.write(gen.tobytes())
        self._batches = []
        return len(rec)


def write_capture_columns(path: str, cols,
                          batch_size: int = 1 << 16) -> int:
    """Write :class:`~cilium_tpu_torch.ingest.columnar.CaptureColumns`
    through the record-batch writer, ``batch_size`` records a batch."""
    w = CaptureWriter(path, fmax=cols.fmax)
    for s in range(0, len(cols.rec), batch_size):
        w.write_batch(
            cols.rec[s:s + batch_size], cols.l7[s:s + batch_size],
            (cols.gen[s:s + batch_size] if cols.gen is not None
             else None))
    return w.finish(cols.offsets, cols.blob)


def write_capture_l7(path: str, flows: Iterable[Flow]) -> int:
    """Write a version-2 capture (version 3 when any flow carries a
    generic ``l7proto`` payload), column-encoded
    (``ingest.columnar.flows_to_columns``)."""
    from cilium_tpu_torch.ingest.columnar import flows_to_columns

    return write_capture_columns(path, flows_to_columns(flows))


def capture_field_widths(l7, offsets, cfg=None,
                         pad_multiple: int = 32) -> Dict[str, int]:
    """Per-field padded widths over a WHOLE capture, so every chunk of
    a chunked replay encodes to the same shapes."""
    from cilium_tpu_torch.core.config import EngineConfig

    cfg = cfg or EngineConfig()
    caps = {"path": max(cfg.http_path_buckets),
            "method": cfg.http_method_len, "host": cfg.http_host_len,
            "headers": 1024, "qname": cfg.dns_name_len}
    widths = {}
    for field, cap in caps.items():
        idx = l7[field]
        lens = (offsets[idx + 1].astype(np.int64)
                - offsets[idx].astype(np.int64))
        longest = int(lens.max()) if len(lens) else 1
        widths[field] = min(
            cap, max(pad_multiple,
                     -(-max(longest, 1) // pad_multiple) * pad_multiple))
    return widths


def l7_info(path: str):
    """O(1) sidecar geometry: (n_strings, blob_bytes) from the 16-byte
    L7 header ((0, 0) for a v1 capture)."""
    total = capture_count(path)  # full-layout validation
    if capture_version(path) not in (VERSION_L7, VERSION_L7G):
        return 0, 0
    with open(path, "rb") as fp:
        fp.seek(HEADER.itemsize + total * RECORD.itemsize)
        lh = np.frombuffer(fp.read(L7HEADER.itemsize), dtype=L7HEADER)[0]
    return int(lh["n_strings"]), int(lh["blob_bytes"])


def read_l7_sidecar(path: str):
    """(l7_records, offsets, blob) of a v2/v3 capture — one sequential
    read per section."""
    total = capture_count(path)
    if capture_version(path) not in (VERSION_L7, VERSION_L7G):
        raise CaptureError("capture has no L7 sidecar (v1)")
    with open(path, "rb") as fp:
        fp.seek(HEADER.itemsize + total * RECORD.itemsize)
        lh = np.frombuffer(fp.read(L7HEADER.itemsize), dtype=L7HEADER)[0]
        n_strings = int(lh["n_strings"])
        blob_bytes = int(lh["blob_bytes"])
        offsets = np.fromfile(fp, dtype="<u4", count=n_strings + 1)
        blob = np.fromfile(fp, dtype=np.uint8, count=blob_bytes)
        l7 = np.fromfile(fp, dtype=L7REC, count=total)
    return l7, offsets, blob


def read_gen_sidecar(path: str):
    """The v3 GENERIC section as a ``gen_dtype(fmax)`` array, or None
    for v1/v2 captures."""
    total = capture_count(path)
    if capture_version(path) != VERSION_L7G:
        return None
    with open(path, "rb") as fp:
        fp.seek(HEADER.itemsize + total * RECORD.itemsize)
        lh = np.frombuffer(fp.read(L7HEADER.itemsize), dtype=L7HEADER)[0]
        fmax = int(lh["reserved"])
        fp.seek((int(lh["n_strings"]) + 1) * 4 + int(lh["blob_bytes"])
                + total * L7REC.itemsize, os.SEEK_CUR)
        return np.fromfile(fp, dtype=gen_dtype(fmax), count=total)


def sections_to_bytes(rec, l7, offsets, blob,
                      gen: Optional[np.ndarray] = None,
                      fmax: int = 0) -> bytes:
    """Capture sections → one in-memory v2/v3 capture image, byte-
    identical to what :func:`write_capture_l7` puts on disk (the unit
    a stream chunk travels as)."""
    header = np.zeros(1, dtype=HEADER)
    version = VERSION_L7 if gen is None else VERSION_L7G
    header[0] = (MAGIC, version, len(rec))
    l7h = np.zeros(1, dtype=L7HEADER)
    l7h[0] = (len(offsets) - 1, fmax, int(blob.size))
    parts = [header.tobytes(), np.ascontiguousarray(rec).tobytes(),
             l7h.tobytes(), np.ascontiguousarray(offsets).tobytes(),
             np.ascontiguousarray(blob).tobytes(),
             np.ascontiguousarray(l7).tobytes()]
    if gen is not None:
        parts.append(np.ascontiguousarray(gen).tobytes())
    return b"".join(parts)


def capture_to_bytes(flows: Iterable[Flow]) -> bytes:
    """Flows → in-memory v2/v3 capture image, column-encoded like
    :func:`write_capture_l7`."""
    from cilium_tpu_torch.ingest.columnar import flows_to_columns

    c = flows_to_columns(flows)
    return sections_to_bytes(c.rec, c.l7, c.offsets, c.blob, c.gen, c.fmax)


def capture_from_bytes(buf: bytes):
    """Capture image → (rec, l7, offsets, blob, gen) views. Validates
    the whole layout (magic, version, section sizes) and raises
    :class:`CaptureError` on anything short, long or misversioned."""
    if len(buf) < HEADER.itemsize:
        raise CaptureError("truncated capture image")
    h = np.frombuffer(buf[:HEADER.itemsize], dtype=HEADER)[0]
    if bytes(h["magic"]).ljust(8, b"\x00") != MAGIC:
        raise CaptureError("bad magic")
    version, count = int(h["version"]), int(h["count"])
    if version not in (VERSION_L7, VERSION_L7G):
        raise CaptureError(f"unsupported stream version {version}")
    off = HEADER.itemsize
    want = off + count * RECORD.itemsize + L7HEADER.itemsize
    if len(buf) < want:
        raise CaptureError("truncated capture image")
    rec = np.frombuffer(buf, dtype=RECORD, count=count, offset=off)
    off += count * RECORD.itemsize
    lh = np.frombuffer(buf, dtype=L7HEADER, count=1, offset=off)[0]
    off += L7HEADER.itemsize
    n_strings = int(lh["n_strings"])
    blob_bytes = int(lh["blob_bytes"])
    fmax = int(lh["reserved"])
    want = (off + (n_strings + 1) * 4 + blob_bytes
            + count * L7REC.itemsize)
    if version == VERSION_L7G:
        if fmax <= 0:
            raise CaptureError("truncated capture image")
        want += count * gen_dtype(fmax).itemsize
    if len(buf) != want:
        raise CaptureError(
            f"capture image size {len(buf)} != expected {want}")
    offsets = np.frombuffer(buf, dtype="<u4", count=n_strings + 1,
                            offset=off)
    off += (n_strings + 1) * 4
    blob = np.frombuffer(buf, dtype=np.uint8, count=blob_bytes,
                         offset=off)
    off += blob_bytes
    l7 = np.frombuffer(buf, dtype=L7REC, count=count, offset=off)
    off += count * L7REC.itemsize
    gen = None
    if version == VERSION_L7G:
        gen = np.frombuffer(buf, dtype=gen_dtype(fmax), count=count,
                            offset=off)
    return rec, l7, offsets, blob, gen


def _table_get(offsets: np.ndarray, blob: np.ndarray, idx: int) -> bytes:
    return blob[int(offsets[idx]):int(offsets[idx + 1])].tobytes()


def records_to_flows_l7(rec: np.ndarray, l7: np.ndarray,
                        offsets: np.ndarray, blob: np.ndarray,
                        gen: Optional[np.ndarray] = None
                        ) -> List[Flow]:
    """Object-path reconstruction of v2/v3 capture records (the serve
    loop's explain sample)."""
    flows = []
    for i, (r, s) in enumerate(zip(rec, l7)):
        f = Flow(src_identity=int(r["src_identity"]),
                 dst_identity=int(r["dst_identity"]),
                 dport=int(r["dport"]), sport=int(r["sport"]),
                 protocol=Protocol(int(r["proto"])),
                 direction=TrafficDirection(int(r["direction"])),
                 l7=L7Type(int(r["l7_type"])),
                 verdict=Verdict(int(r["verdict"])),
                 time=float(r["time"]))
        if f.l7 == L7Type.HTTP:
            hdr_block = _table_get(offsets, blob, int(s["headers"]))
            headers = tuple(
                tuple(line.split(":", 1))
                for line in hdr_block.decode("utf-8").splitlines() if line)
            f.http = HTTPInfo(
                method=_table_get(offsets, blob,
                                  int(s["method"])).decode("utf-8"),
                path=_table_get(offsets, blob,
                                int(s["path"])).decode("utf-8"),
                host=_table_get(offsets, blob,
                                int(s["host"])).decode("utf-8"),
                headers=headers)
        elif f.l7 == L7Type.DNS:
            f.dns = DNSInfo(query=_table_get(
                offsets, blob, int(s["qname"])).decode("utf-8"))
        elif f.l7 == L7Type.KAFKA:
            f.kafka = KafkaInfo(
                api_key=int(s["kafka_api_key"]),
                api_version=int(s["kafka_api_version"]),
                client_id=_table_get(offsets, blob,
                                     int(s["kafka_client"])).decode("utf-8"),
                topic=_table_get(offsets, blob,
                                 int(s["kafka_topic"])).decode("utf-8"))
        elif f.l7 == L7Type.GENERIC and gen is not None:
            g = gen[i]
            fields = {}
            for k_idx, v_idx in g["pairs"]:
                if k_idx:  # index 0 = "" = unused slot
                    fields[_table_get(offsets, blob,
                                      int(k_idx)).decode("utf-8")] = \
                        _table_get(offsets, blob,
                                   int(v_idx)).decode("utf-8")
            f.generic = GenericL7Info(
                proto=_table_get(offsets, blob,
                                 int(g["proto"])).decode("utf-8"),
                fields=fields)
        flows.append(f)
    return flows
