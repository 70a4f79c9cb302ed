"""Chunk cache: the memory tier of the reference's tiered cache.

Counterpart of seaweedfs_tpu/utils/chunk_cache.py (SeaweedFS
weed/util/chunk_cache/: chunk_cache.go routes small chunks to an in-memory
cache and larger ones to disk-backed caches). The filer runs it with no
disk tier, as the reference's filer does by default; the disk tier comes
with the mount slice (ROADMAP.md A2d).
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class MemoryCache:
    def __init__(self, capacity_bytes: int = 64 * 1024 * 1024):
        self.capacity = capacity_bytes
        self._used = 0
        self._data: OrderedDict[str, bytes] = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: str) -> bytes | None:
        with self._lock:
            v = self._data.get(key)
            if v is not None:
                self._data.move_to_end(key)
            return v

    def put(self, key: str, value: bytes) -> None:
        if len(value) > self.capacity:
            return
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._used -= len(old)
            self._data[key] = value
            self._used += len(value)
            while self._used > self.capacity:
                _, evicted = self._data.popitem(last=False)
                self._used -= len(evicted)

    def delete(self, key: str) -> bool:
        with self._lock:
            old = self._data.pop(key, None)
            if old is None:
                return False
            self._used -= len(old)
            return True


class TieredChunkCache:
    """A memory LRU; `mem_threshold` is the size below which the filer
    writes a chunk through on upload (chunk_cache.go thresholds)."""

    def __init__(self, mem_bytes: int = 64 * 1024 * 1024,
                 mem_threshold: int = 1024 * 1024):
        self.mem = MemoryCache(mem_bytes)
        self.mem_threshold = mem_threshold

    def get(self, fid: str) -> bytes | None:
        return self.mem.get(fid)

    def put(self, fid: str, value: bytes) -> None:
        self.mem.put(fid, value)

    def delete(self, fid: str) -> bool:
        return self.mem.delete(fid)
