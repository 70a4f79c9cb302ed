"""Log-structured on-disk filer store.

Counterpart of seaweedfs_tpu/filer/stores/leveldb.py (SeaweedFS
weed/filer/leveldb{,2,3}/, the reference's default on-disk metadata
backend). No LevelDB binding is used: this is a pure-Python equivalent with the same shape: an append-only
record log + in-memory directory index, compacted when garbage
accumulates. Registered as `leveldb` (and `leveldb2`/`leveldb3`, which in
the reference only change key layout/sharding).
"""

from __future__ import annotations

import bisect
import os
import struct

from ...pb import filer_pb2
from ...utils import locks
from ..entry import Entry
from ..filerstore import register_store

_PUT, _DEL, _KV = 1, 2, 3


class LevelDbStore:
    name = "leveldb"

    def __init__(self, directory: str = "./filerldb", **_ignored):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = locks.wrlock("filer.store.mu", rank=500)
        self._path = os.path.join(directory, "filer.log")
        # dir -> sorted [names]; (dir, name) -> log offset of latest record
        self._dirs: dict[str, list[str]] = {}
        self._offsets: dict[str, int] = {}
        self._kv: dict[bytes, bytes] = {}
        self._garbage = 0
        self._log = open(self._path, "a+b")
        self._replay()

    # -- log format: [1B op][4B klen][4B vlen][key][value] -----------------

    def _append(self, op: int, key: bytes, value: bytes) -> int:
        self._log.seek(0, 2)
        off = self._log.tell()
        self._log.write(struct.pack("<BII", op, len(key), len(value)))
        self._log.write(key)
        self._log.write(value)
        self._log.flush()
        return off

    def _read_at(self, off: int) -> tuple[int, bytes, bytes]:
        hdr = os.pread(self._log.fileno(), 9, off)
        op, klen, vlen = struct.unpack("<BII", hdr)
        blob = os.pread(self._log.fileno(), klen + vlen, off + 9)
        return op, blob[:klen], blob[klen:]

    def _replay(self) -> None:
        self._log.seek(0, 2)
        size = self._log.tell()
        off = 0
        while off + 9 <= size:
            hdr = os.pread(self._log.fileno(), 9, off)
            op, klen, vlen = struct.unpack("<BII", hdr)
            # a crash mid-append can leave a torn tail: truncate it off,
            # the same repair the volume startup integrity check does
            if op not in (_PUT, _DEL, _KV) or off + 9 + klen + vlen > size:
                self._log.truncate(off)
                break
            blob = os.pread(self._log.fileno(), klen + vlen, off + 9)
            key, value = blob[:klen], blob[klen:]
            try:
                if op == _PUT:
                    self._index_put(key.decode(), off, replay=True)
                elif op == _DEL:
                    self._index_del(key.decode())
                elif op == _KV:
                    self._kv[key] = value
            except (UnicodeDecodeError, ValueError):
                self._log.truncate(off)
                break
            off += 9 + klen + vlen

    def _index_put(self, path: str, off: int, replay: bool = False) -> None:
        d, name = path.rsplit("/", 1)
        d = d or "/"
        names = self._dirs.setdefault(d, [])
        i = bisect.bisect_left(names, name)
        if i >= len(names) or names[i] != name:
            names.insert(i, name)
        else:
            self._garbage += 1
        self._offsets[path] = off

    def _index_del(self, path: str) -> None:
        d, name = path.rsplit("/", 1)
        d = d or "/"
        names = self._dirs.get(d)
        if names:
            i = bisect.bisect_left(names, name)
            if i < len(names) and names[i] == name:
                names.pop(i)
        self._offsets.pop(path, None)
        self._garbage += 1

    def _maybe_compact(self) -> None:
        if self._garbage < 4096 or \
                self._garbage < len(self._offsets):
            return
        tmp = self._path + ".tmp"
        with open(tmp, "wb") as out:
            new_offsets = {}
            for path, off in self._offsets.items():
                op, key, value = self._read_at(off)
                new_off = out.tell()
                out.write(struct.pack("<BII", _PUT, len(key), len(value)))
                out.write(key)
                out.write(value)
                new_offsets[path] = new_off
            for k, v in self._kv.items():
                out.write(struct.pack("<BII", _KV, len(k), len(v)))
                out.write(k)
                out.write(v)
        self._log.close()
        os.replace(tmp, self._path)
        self._log = open(self._path, "a+b")
        self._offsets = new_offsets
        self._garbage = 0

    # -- FilerStore SPI ----------------------------------------------------

    def insert_entry(self, entry: Entry) -> None:
        with self._lock:
            blob = filer_pb2.FullEntry(
                dir=entry.parent, entry=entry.to_pb()).SerializeToString()
            off = self._append(_PUT, entry.full_path.encode(), blob)
            self._index_put(entry.full_path, off)
            self._maybe_compact()

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        with self._lock:
            off = self._offsets.get(full_path)
            if off is None:
                return None
            _op, _key, value = self._read_at(off)
            fe = filer_pb2.FullEntry.FromString(value)
            return Entry.from_pb(fe.dir, fe.entry)

    def delete_entry(self, full_path: str) -> None:
        with self._lock:
            if full_path in self._offsets:
                self._append(_DEL, full_path.encode(), b"")
                self._index_del(full_path)
                self._maybe_compact()

    def delete_folder_children(self, full_path: str) -> None:
        with self._lock:
            prefix = full_path.rstrip("/")
            doomed = [p for p in self._offsets
                      if p.startswith(prefix + "/")]
            for p in doomed:
                self._append(_DEL, p.encode(), b"")
                self._index_del(p)
            dirs = [d for d in self._dirs
                    if d == prefix or d.startswith(prefix + "/")]
            for d in dirs:
                if d != prefix:
                    self._dirs.pop(d, None)
            self._maybe_compact()

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024, prefix: str = ""):
        with self._lock:
            d = dir_path.rstrip("/") or "/"
            names = list(self._dirs.get(d, ()))
        count = 0
        for name in names:
            if prefix and not name.startswith(prefix):
                continue
            if start_file_name:
                if name < start_file_name:
                    continue
                if name == start_file_name and not include_start:
                    continue
            e = self.find_entry((d.rstrip("/") or "") + "/" + name)
            if e is None:
                continue
            yield e
            count += 1
            if count >= limit:
                return

    def kv_get(self, key: bytes) -> bytes | None:
        with self._lock:
            return self._kv.get(key)

    def kv_put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._kv[key] = value
            self._append(_KV, key, value)

    def close(self) -> None:
        with self._lock:
            self._log.close()


class LevelDb2Store(LevelDbStore):
    name = "leveldb2"


class LevelDb3Store(LevelDbStore):
    name = "leveldb3"


register_store("leveldb", LevelDbStore)
register_store("leveldb2", LevelDb2Store)
register_store("leveldb3", LevelDb3Store)
