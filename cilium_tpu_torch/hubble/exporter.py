"""JSONL flow exporter (reference: ``pkg/hubble/exporter`` — the files
the north star's "Hubble capture replay" replays)."""

from __future__ import annotations

import json
import os
import threading
from typing import Sequence

from cilium_tpu_torch.core.flow import Flow
from cilium_tpu_torch.ingest.hubble import flow_to_dict


class FlowExporter:
    """Appends flows as JSONL; rotates at ``max_bytes``."""

    def __init__(self, path: str, max_bytes: int = 64 << 20):
        self.path = path
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fp = open(path, "a")

    def process(self, flows: Sequence[Flow]) -> None:
        with self._lock:
            for f in flows:
                self._fp.write(json.dumps(flow_to_dict(f)) + "\n")
            self._fp.flush()
            if self._fp.tell() > self.max_bytes:
                self._rotate()

    def _rotate(self) -> None:
        self._fp.close()
        os.replace(self.path, self.path + ".1")
        self._fp = open(self.path, "a")

    def close(self) -> None:
        with self._lock:
            self._fp.close()
