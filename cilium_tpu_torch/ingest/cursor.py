"""Replay cursor: durable progress through a flow capture.

Reference discipline: SURVEY.md §5.4 ("flow-replay cursor
checkpointing") / §5.3 ("replay harness supports kill/resume
mid-stream") — a replay killed at any point resumes where it left off
instead of re-verdicting (and double-counting in metrics/observers)
everything before the kill. The cursor is a tiny JSON file updated
atomically (tmp + rename) after every committed chunk, the same
write-then-rename pattern the agent's checkpoint files use.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


@dataclasses.dataclass
class RawChunk:
    """One ``decode=False`` chunk of a binary capture: the record
    slice plus whole-capture context (sidecar sections, widths, the
    full L7 array) so columnar consumers never re-read the file.
    ``l7``/``offsets``/``blob``/``widths``/``l7_all`` are None for v1
    (L3/L4-only) captures; ``gen``/``gen_all`` (the v3 GENERIC
    section slice / whole array) are None below v3. ``start`` is the
    chunk's global record index — CaptureReplay uses it to slice its
    row-aligned generic columns."""

    records: object
    l7: object = None
    offsets: object = None
    blob: object = None
    widths: object = None
    l7_all: object = None
    gen: object = None
    gen_all: object = None
    start: int = 0
    #: the whole capture's record array (memmap) — lets a replay
    #: session featurize the file ONCE (CaptureReplay.stage_rows)
    records_all: object = None

    def __len__(self) -> int:  # noqa: D105 — chunk length = records
        return len(self.records)


class ReplayCursor:
    """Durable index into a capture file, keyed to that capture."""

    def __init__(self, path: str, capture: str):
        self.path = path
        self.capture = os.path.abspath(capture)

    def load(self) -> int:
        """Resume index, or 0 when absent/corrupt/for another capture
        (a cursor from a different capture must not skip flows)."""
        try:
            with open(self.path) as f:
                data = json.load(f)
            if data.get("capture") != self.capture:
                return 0
            return max(0, int(data["index"]))
        except (OSError, ValueError, KeyError, TypeError,
                AttributeError):  # valid JSON of the wrong shape too
            return 0

    def commit(self, index: int) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"capture": self.capture, "index": int(index)}, f)
        os.replace(tmp, self.path)

    def clear(self) -> None:
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


def replay_chunks(capture: str, chunk_size: int = 8192,
                  cursor: Optional[ReplayCursor] = None,
                  start: int = 0, limit: Optional[int] = None,
                  decode: bool = True):
    """Yield ``(commit_index, flows)`` chunks, resuming from the cursor
    when one is given. ``commit_index`` is the LINE index just past the
    chunk — commit it verbatim after fully processing the chunk
    (commit-after-process: a kill re-runs at most one chunk, never
    skips one). Line-indexed, not flow-indexed, so blank lines can
    neither double-deliver nor silently truncate a resume. One open
    file handle for the whole pass (a per-chunk reopen-and-skip would
    be quadratic in capture size). ``limit`` counts flows.
    ``decode=False`` (binary captures only) yields raw record arrays
    instead of Flow lists — the columnar fast path — under the SAME
    cursor protocol, so kill/resume semantics live in one place."""
    from cilium_tpu_torch.ingest.accesslog import parse_capture_line

    index = max(start, cursor.load() if cursor is not None else 0)
    emitted = 0
    from cilium_tpu_torch.ingest.binary import MAGIC

    with open(capture, "rb") as probe:
        is_binary = probe.read(len(MAGIC)) == MAGIC
    if is_binary:
        # binary captures (ingest/binary.py): the cursor indexes
        # records — fixed-size, so no blank-line concerns; validated
        # once and memmapped, so chunking costs one open total. A v2
        # capture's L7 sidecar is loaded once; decode=True rebuilds
        # Flow objects WITH payloads, decode=False yields
        # (records, l7_records) so the columnar path can gather
        # against the (whole-capture) string table.
        from cilium_tpu_torch.ingest.binary import (
            VERSION_L7,
            VERSION_L7G,
            capture_field_widths,
            capture_version,
            map_capture,
            read_gen_sidecar,
            read_l7_sidecar,
            records_to_flows,
            records_to_flows_l7,
        )

        records = map_capture(capture)
        version = capture_version(capture)
        side = (read_l7_sidecar(capture)
                if version in (VERSION_L7, VERSION_L7G) else None)
        gen_all = read_gen_sidecar(capture)  # None below v3
        # whole-capture field widths ride along so the columnar
        # consumer encodes every chunk to identical shapes (one set of
        # launch shapes for the stream) without re-reading the sidecar
        widths = (capture_field_widths(side[0], side[1])
                  if side is not None and not decode else None)
        while index < len(records):
            take = chunk_size if limit is None else min(
                chunk_size, limit - emitted)
            if take <= 0:
                return
            raw = records[index:index + take]
            if side is not None:
                l7, offsets, blob = side
                l7raw = l7[index:index + len(raw)]
                genraw = (gen_all[index:index + len(raw)]
                          if gen_all is not None else None)
                chunk = (records_to_flows_l7(raw, l7raw, offsets, blob,
                                             gen=genraw)
                         if decode else RawChunk(
                             raw, l7raw, offsets, blob, widths, l7,
                             genraw, gen_all, index, records))
            else:
                chunk = (records_to_flows(raw) if decode
                         else RawChunk(raw))
            yield index + len(raw), chunk
            index += len(raw)
            emitted += len(raw)
        return
    from cilium_tpu_torch.ingest.flowpb import looks_like_pb_capture

    if looks_like_pb_capture(capture):
        # protobuf flow stream (api/v1/flow framing): cursor indexes
        # MESSAGES; decode is per-flow by nature (object path only)
        if not decode:
            from cilium_tpu_torch.ingest.binary import CaptureError

            raise CaptureError("bad magic")  # columnar needs CTCAP
        from cilium_tpu_torch.ingest.flowpb import iter_pb_capture

        flows = []
        for f in iter_pb_capture(capture, start=index, limit=limit):
            flows.append(f)
            index += 1
            if len(flows) >= chunk_size:
                yield index, flows
                flows = []
        if flows:
            yield index, flows
        return
    if not decode:
        from cilium_tpu_torch.ingest.binary import CaptureError

        raise CaptureError("bad magic")  # raw mode is binary-only
    with open(capture) as fp:
        for _ in range(index):
            if not fp.readline():
                return  # cursor beyond EOF: nothing left
        line_no = index
        flows = []
        for line in fp:
            line_no += 1
            s = line.strip()
            if s:
                flows.append(parse_capture_line(json.loads(s)))
                emitted += 1
            done = limit is not None and emitted >= limit
            if len(flows) >= chunk_size or done:
                yield line_no, flows
                flows = []
                if done:
                    return
        if flows:
            yield line_no, flows
