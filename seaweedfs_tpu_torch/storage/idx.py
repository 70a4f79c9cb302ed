""".idx index-file walking and parsing, vectorized with numpy.

Equivalent surface to SeaweedFS weed/storage/idx/walk.go
(WalkIndexFile, IdxFileEntry) — but instead of a streaming callback over
16-byte records we parse the whole file into columnar numpy arrays in one
shot; billions-of-needles scale still fits (16B/entry).
"""

from __future__ import annotations

import io
import os
from typing import Callable, Iterator

import numpy as np

from . import types


def parse_index_bytes(buf: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse raw .idx bytes -> (ids u64, stored_offsets u64, sizes i32).
    Entry stride follows the active offset width (16B with 4-byte offsets,
    17B in large-disk mode — the 5th, high-order offset byte sits after
    the big-endian lower four, offset_5bytes.go BytesToOffset)."""
    stride = types.NEEDLE_MAP_ENTRY_SIZE
    n = len(buf) // stride
    arr = np.frombuffer(buf, dtype=np.uint8, count=n * stride).reshape(n, stride)
    ids = arr[:, 0:8].copy().view(">u8").reshape(n).astype(np.uint64)
    offsets = arr[:, 8:12].copy().view(">u4").reshape(n).astype(np.uint64)
    if types.OFFSET_SIZE == 5:
        offsets |= arr[:, 12].astype(np.uint64) << 32
    so = 8 + types.OFFSET_SIZE
    sizes = arr[:, so:so + 4].copy().view(">i4").reshape(n).astype(np.int32)
    return ids, offsets, sizes


def read_index_file(path: str | os.PathLike) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        return parse_index_bytes(f.read())


def walk_index_file(
    path: str | os.PathLike,
    fn: Callable[[int, int, int], None],
    start_from: int = 0,
) -> None:
    """Visit every entry in file order: fn(needle_id, stored_offset, size)."""
    ids, offs, sizes = read_index_file(path)
    for i in range(start_from, len(ids)):
        fn(int(ids[i]), int(offs[i]), int(sizes[i]))


def iter_index_entries(path: str | os.PathLike) -> Iterator[tuple[int, int, int]]:
    ids, offs, sizes = read_index_file(path)
    for i in range(len(ids)):
        yield int(ids[i]), int(offs[i]), int(sizes[i])


def pack_index_arrays(
    ids: np.ndarray, stored_offsets: np.ndarray, sizes: np.ndarray
) -> bytes:
    """Columnar arrays -> raw big-endian .idx bytes (stride follows the
    active offset width; see parse_index_bytes)."""
    n = len(ids)
    stride = types.NEEDLE_MAP_ENTRY_SIZE
    offs64 = np.ascontiguousarray(stored_offsets.astype(np.uint64))
    out = np.empty((n, stride), dtype=np.uint8)
    out[:, 0:8] = np.ascontiguousarray(ids.astype(np.uint64)).view(np.uint8).reshape(n, 8)[:, ::-1]
    out[:, 8:12] = (offs64 & 0xFFFFFFFF).astype(np.uint32).view(np.uint8).reshape(n, 4)[:, ::-1]
    so = 8 + types.OFFSET_SIZE
    if types.OFFSET_SIZE == 5:
        out[:, 12] = (offs64 >> 32).astype(np.uint8)
    out[:, so:so + 4] = np.ascontiguousarray(sizes.astype(np.int32)).view(np.uint8).reshape(n, 4)[:, ::-1]
    return out.tobytes()


def first_invalid_index(
    ids: np.ndarray, offsets: np.ndarray, sizes: np.ndarray, dat_size: int
) -> int:
    """Index of the first entry whose needle extends past dat_size
    (binary-search semantics of idx/binary_search.go FirstInvalidIndex);
    entries are offset-ordered for appended volumes."""
    if len(ids) == 0:
        return 0
    ends = offsets.astype(np.int64) * types.NEEDLE_PADDING_SIZE + np.where(
        sizes >= 0,
        np.vectorize(types.actual_size)(np.maximum(sizes, 0)),
        0,
    )
    valid = ends <= dat_size
    # find first False
    bad = np.nonzero(~valid)[0]
    return int(bad[0]) if len(bad) else len(ids)
