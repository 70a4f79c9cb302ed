"""In-memory needle map (id -> offset,size) with sorted ascending visits.

Plays the role of the reference's needle_map.MemDb
(SeaweedFS weed/storage/needle_map/memdb.go) as used by the EC encoder:
readNeedleMap replays the .idx log (later entries win; tombstones delete,
ec_encoder.go:289-306), AscendingVisit writes the sorted .ecx. Instead of a
btree we replay into a dict and sort once on visit — same observable
behavior, O(n log n) once.
"""

from __future__ import annotations

import os

import numpy as np

from . import idx, types


class MemDb:
    def __init__(self) -> None:
        self._m: dict[int, tuple[int, int]] = {}

    def set(self, needle_id: int, stored_offset: int, size: int) -> None:
        self._m[needle_id] = (stored_offset, size)

    def delete(self, needle_id: int) -> None:
        self._m.pop(needle_id, None)

    def get(self, needle_id: int) -> tuple[int, int] | None:
        return self._m.get(needle_id)

    def __len__(self) -> int:
        return len(self._m)

    def ascending_visit(self, fn) -> None:
        for nid in sorted(self._m):
            off, size = self._m[nid]
            fn(nid, off, size)

    def sorted_entries(self) -> list[tuple[int, int, int]]:
        return [(nid, *self._m[nid]) for nid in sorted(self._m)]

    def to_sorted_bytes(self) -> bytes:
        """Serialize as sorted 16B entries — the .ecx file payload
        (WriteSortedFileFromIdx, ec_encoder.go:27-54)."""
        entries = self.sorted_entries()
        if not entries:
            return b""
        ids = np.array([e[0] for e in entries], dtype=np.uint64)
        offs = np.array([e[1] for e in entries], dtype=np.uint64)
        sizes = np.array([e[2] for e in entries], dtype=np.int32)
        return idx.pack_index_arrays(ids, offs, sizes)


def read_needle_map(idx_path: str | os.PathLike) -> MemDb:
    """Replay a .idx file: live entries set, zero-offset or tombstone delete
    (ec_encoder.go readNeedleMap semantics)."""
    db = MemDb()
    ids, offs, sizes = idx.read_index_file(idx_path)
    for i in range(len(ids)):
        nid, off, size = int(ids[i]), int(offs[i]), int(sizes[i])
        if off != 0 and size != types.TOMBSTONE_FILE_SIZE:
            db.set(nid, off, size)
        else:
            db.delete(nid)
    return db


def write_sorted_file_from_idx(base_file_name: str, ext: str = ".ecx") -> None:
    """Generate the sorted .ecx from <base>.idx (ec_encoder.go:27-54)."""
    db = read_needle_map(str(base_file_name) + ".idx")
    with open(str(base_file_name) + ext, "wb") as f:
        f.write(db.to_sorted_bytes())
