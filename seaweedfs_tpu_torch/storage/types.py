"""Core storage types: NeedleId / Offset / Size / Cookie and their codecs.

Wire-compatible with the reference's on-disk formats
(SeaweedFS weed/storage/types/needle_types.go,
offset_4bytes.go, offset_5bytes.go, needle_id_type.go; all integers
big-endian per weed/util/bytes.go). Offsets are stored in units of
NEEDLE_PADDING_SIZE (8) bytes, 4 bytes wide by default (32GB volume cap).

The reference's ``5BytesOffset`` build tag (offset_5bytes.go: a 5th
high-order byte appended after the big-endian lower four, lifting the cap
to 8TB) is a process-wide mode here too: enable with set_large_disk(True)
or SEAWEEDFS_TPU_LARGE_DISK=1 before any volume is opened. The .idx/.ecx
entry stride becomes 17; like the reference, 4-byte and 5-byte index
files are not interchangeable.
"""

from __future__ import annotations

import os as _os
import struct

NEEDLE_ID_SIZE = 8
OFFSET_SIZE = 4
SIZE_SIZE = 4
COOKIE_SIZE = 4
DATA_SIZE_SIZE = 4
TIMESTAMP_SIZE = 8
NEEDLE_HEADER_SIZE = COOKIE_SIZE + NEEDLE_ID_SIZE + SIZE_SIZE  # 16
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE  # 16
NEEDLE_PADDING_SIZE = 8
TOMBSTONE_FILE_SIZE = -1  # Size(-1) tombstone marker
NEEDLE_ID_EMPTY = 0
MAX_POSSIBLE_VOLUME_SIZE = 4 * 1024 * 1024 * 1024 * 8  # 32GB

_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")


def set_large_disk(on: bool) -> None:
    """Switch the process between 4-byte (32GB) and 5-byte (8TB) offsets —
    the runtime analogue of the reference's 5BytesOffset build tag
    (offset_5bytes.go:14-16). Must be flipped before volumes are opened;
    existing index files keep whichever stride they were written with."""
    global OFFSET_SIZE, NEEDLE_MAP_ENTRY_SIZE, MAX_POSSIBLE_VOLUME_SIZE
    OFFSET_SIZE = 5 if on else 4
    NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE
    MAX_POSSIBLE_VOLUME_SIZE = 4 * 1024 * 1024 * 1024 * 8 * (256 if on else 1)


def large_disk() -> bool:
    return OFFSET_SIZE == 5


def write_stride_marker(base_file_name: str) -> None:
    """Sync the `.lrg` stride marker to the process's active offset
    width. Every code path that materializes a volume's .dat/.idx/.ecx
    (create, copy, backup, ec-generate, ec-decode) must call this so the
    open-time stride guards (storage/volume.py, storage/ec_volume.py)
    recognize the files' offset width. In 4-byte mode a STALE marker
    from an earlier large-disk tenancy of the same base is removed —
    leaving it would falsely refuse the freshly-written 4-byte files."""
    if large_disk():
        with open(base_file_name + ".lrg", "wb"):
            pass
    else:
        try:
            _os.remove(base_file_name + ".lrg")
        except FileNotFoundError:
            pass


if _os.environ.get("SEAWEEDFS_TPU_LARGE_DISK", "").lower() in (
        "1", "true", "yes", "on"):
    set_large_disk(True)


def size_is_deleted(size: int) -> bool:
    return size < 0 or size == TOMBSTONE_FILE_SIZE


def size_is_valid(size: int) -> bool:
    return size > 0 and size != TOMBSTONE_FILE_SIZE


def offset_to_stored(actual_offset: int) -> int:
    """Byte offset -> stored offset integer (units of 8 bytes), masked to
    the active offset width (ToOffset, offset_4bytes.go / offset_5bytes.go)."""
    return (actual_offset // NEEDLE_PADDING_SIZE) & ((1 << (8 * OFFSET_SIZE)) - 1)


def stored_to_actual_offset(stored: int) -> int:
    return stored * NEEDLE_PADDING_SIZE


def size_to_u32(size: int) -> int:
    """int32 Size -> uint32 wire value (two's complement)."""
    return size & 0xFFFFFFFF


def u32_to_size(v: int) -> int:
    """uint32 wire value -> signed int32 Size."""
    return v - (1 << 32) if v & 0x80000000 else v


def pack_needle_map_entry(needle_id: int, stored_offset: int, size: int) -> bytes:
    """.idx/.ecx entry: id(8) + offset(4|5) + size(4). The offset is the
    big-endian lower 4 bytes, with the 5th HIGH-order byte appended after
    them in large-disk mode (OffsetToBytes, offset_5bytes.go:19-25)."""
    off = _U32.pack(stored_offset & 0xFFFFFFFF)
    if OFFSET_SIZE == 5:
        off += bytes(((stored_offset >> 32) & 0xFF,))
    return _U64.pack(needle_id) + off + _U32.pack(size_to_u32(size))


def unpack_needle_map_entry(b: bytes) -> tuple[int, int, int]:
    """-> (needle_id, stored_offset, signed size)."""
    (nid,) = _U64.unpack_from(b, 0)
    (off,) = _U32.unpack_from(b, 8)
    if OFFSET_SIZE == 5:
        off |= b[12] << 32
    (sz,) = _U32.unpack_from(b, 8 + OFFSET_SIZE)
    return nid, off, u32_to_size(sz)


NEEDLE_CHECKSUM_SIZE = 4
VERSION1, VERSION2, VERSION3 = 1, 2, 3
CURRENT_VERSION = VERSION3


def padding_length(size: int, version: int = CURRENT_VERSION) -> int:
    """Needle padding is always 1..8 bytes — when the record is already
    8-aligned the reference still appends a full 8
    (needle_read.go PaddingLength:197-203)."""
    body = NEEDLE_HEADER_SIZE + size + NEEDLE_CHECKSUM_SIZE
    if version == VERSION3:
        body += TIMESTAMP_SIZE
    return NEEDLE_PADDING_SIZE - (body % NEEDLE_PADDING_SIZE)


def actual_size(size: int, version: int = CURRENT_VERSION) -> int:
    """Total bytes a needle occupies in the .dat file
    (needle_read.go GetActualSize:300 = header + body + checksum
    [+ timestamp for v3] + padding)."""
    body = NEEDLE_HEADER_SIZE + size + NEEDLE_CHECKSUM_SIZE
    if version == VERSION3:
        body += TIMESTAMP_SIZE
    return body + padding_length(size, version)
