"""Fixed-size flow ring buffer (reference: ``pkg/hubble/container/ring``).

Single-writer, many-reader; readers address flows by monotonically
increasing sequence number, so a slow reader detects loss (the
reference reports ``lost_events`` the same way).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from cilium_tpu_torch.core.flow import Flow


class FlowRing:
    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._buf: List[Optional[Flow]] = [None] * capacity
        self._next_seq = 0  # next sequence number to write
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)

    def write(self, flow: Flow) -> int:
        with self._cond:
            seq = self._next_seq
            self._buf[seq % self.capacity] = flow
            self._next_seq = seq + 1
            self._cond.notify_all()
            return seq

    def write_many(self, flows) -> None:
        with self._cond:
            for flow in flows:
                self._buf[self._next_seq % self.capacity] = flow
                self._next_seq += 1
            self._cond.notify_all()

    @property
    def next_seq(self) -> int:
        with self._lock:
            return self._next_seq

    @property
    def oldest_seq(self) -> int:
        with self._lock:
            return max(0, self._next_seq - self.capacity)

    def read(self, seq: int) -> Tuple[Optional[Flow], int]:
        """Read flow at ``seq``. Returns (flow, lost) where lost>0 means
        the reader fell behind and ``lost`` flows were overwritten (the
        returned flow is then the oldest available)."""
        with self._lock:
            oldest = max(0, self._next_seq - self.capacity)
            if seq >= self._next_seq:
                return None, 0
            if seq < oldest:
                return self._buf[oldest % self.capacity], oldest - seq
            return self._buf[seq % self.capacity], 0

    def wait_for(self, seq: int, timeout: Optional[float] = None) -> bool:
        """Block until ``seq`` is written."""
        with self._cond:
            return self._cond.wait_for(lambda: self._next_seq > seq,
                                       timeout=timeout)
