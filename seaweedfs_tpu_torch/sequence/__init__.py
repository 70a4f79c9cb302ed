"""Needle-id sequencers (counterpart of seaweedfs_tpu/sequence/; SeaweedFS
weed/sequence/).

`MemorySequencer` mirrors sequencer.go's monotonic block allocator;
`SnowflakeSequencer` mirrors snowflake_sequencer.go (41-bit ms timestamp,
10-bit node id, 12-bit counter).
"""

from __future__ import annotations

import threading
import time


class MemorySequencer:
    """Monotonic in-memory id allocator (sequencer.go:21-53)."""

    def __init__(self, start: int = 1):
        self._counter = start
        self._lock = threading.Lock()

    def next_file_id(self, count: int) -> int:
        with self._lock:
            start = self._counter
            self._counter += count
            return start

    def set_max(self, seen: int) -> None:
        with self._lock:
            if self._counter <= seen:
                self._counter = seen + 1

    def peek(self) -> int:
        with self._lock:
            return self._counter


class SnowflakeSequencer:
    """Time-ordered 63-bit ids: 41b ms | 10b node | 12b seq."""

    EPOCH_MS = 1_577_836_800_000  # 2020-01-01

    def __init__(self, node_id: int):
        if not 0 <= node_id < 1024:
            raise ValueError("snowflake node id must fit in 10 bits")
        self.node_id = node_id
        self._lock = threading.Lock()
        self._last_ms = 0
        self._seq = 0

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            now = int(time.time() * 1000) - self.EPOCH_MS
            if now == self._last_ms:
                self._seq += 1
                if self._seq >= 4096:
                    while now <= self._last_ms:
                        now = int(time.time() * 1000) - self.EPOCH_MS
                    self._seq = 0
            else:
                self._seq = 0
            self._last_ms = now
            return (now << 22) | (self.node_id << 12) | self._seq

    def set_max(self, seen: int) -> None:
        pass  # time-ordered; nothing to bump

    def peek(self) -> int:
        return self.next_file_id(0)


def new_sequencer(kind: str = "memory", node_id: int = 1):
    if kind == "snowflake":
        return SnowflakeSequencer(node_id)
    return MemorySequencer()
