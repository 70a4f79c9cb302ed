"""In-memory filer store (counterpart of
seaweedfs_tpu/filer/stores/memory.py: maps in the shape of SeaweedFS
weed/filer/leveldb/leveldb_store.go)."""

from __future__ import annotations

from typing import Iterator

from ...utils import locks
from ..entry import Entry
from ..filerstore import register_store


class MemoryStore:
    name = "memory"

    def __init__(self, **_):
        self._entries: dict[str, Entry] = {}
        self._children: dict[str, set[str]] = {}
        self._kv: dict[bytes, bytes] = {}
        # leaf rank 500: a filer store never calls back out under its
        # mutate lock (all stores share the name — same order contract)
        self._lock = locks.wrlock("filer.store.mu", rank=500)

    def insert_entry(self, entry: Entry) -> None:
        with self._lock:
            self._entries[entry.full_path] = entry
            if entry.full_path != "/":
                self._children.setdefault(entry.parent, set()).add(entry.name)

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        with self._lock:
            return self._entries.get(full_path)

    def delete_entry(self, full_path: str) -> None:
        with self._lock:
            e = self._entries.pop(full_path, None)
            if e is not None and full_path != "/":
                kids = self._children.get(e.parent)
                if kids:
                    kids.discard(e.name)

    def delete_folder_children(self, full_path: str) -> None:
        with self._lock:
            base = full_path.rstrip("/")
            for name in list(self._children.get(base or "/", ())):
                child = f"{base}/{name}"
                self.delete_folder_children(child)
                self.delete_entry(child)

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False, limit: int = 1024,
                               prefix: str = "") -> Iterator[Entry]:
        with self._lock:
            names = sorted(self._children.get(dir_path.rstrip("/") or "/", ()))
        base = dir_path.rstrip("/")
        n = 0
        for name in names:
            if prefix and not name.startswith(prefix):
                continue
            if start_file_name:
                if name < start_file_name:
                    continue
                if name == start_file_name and not include_start:
                    continue
            e = self.find_entry(f"{base}/{name}")
            if e is None:
                continue
            yield e
            n += 1
            if n >= limit:
                return

    def kv_get(self, key: bytes) -> bytes | None:
        return self._kv.get(key)

    def kv_put(self, key: bytes, value: bytes) -> None:
        self._kv[key] = value

    def close(self) -> None:
        pass


register_store("memory", MemoryStore)
