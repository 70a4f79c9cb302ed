"""Needle record codec: the on-disk unit of file storage.

Wire-compatible with the reference's needle format
(SeaweedFS weed/storage/needle/needle.go:25-45,
needle_write.go:20-113 prepareWriteBuffer, needle_read.go:52-180):

  header   : cookie(4) id(8) size(4), big-endian          [all versions]
  body v1  : data[size]
  body v2/3: dataSize(4) data flags(1)
             [hasName: nameSize(1) name] [hasMime: mimeSize(1) mime]
             [hasLastModified: 5B unix-seconds] [hasTtl: 2B]
             [hasPairs: pairsSize(2) pairs]
             — `size` covers this whole body section
  tail     : crc32c(4) [v3: appendAtNs(8)] padding to 8B (always 1..8 bytes)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from . import types
from .crc import crc32c, crc_value_legacy
from .ttl import EMPTY_TTL, TTL

FLAG_IS_COMPRESSED = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20
FLAG_IS_CHUNK_MANIFEST = 0x80
LAST_MODIFIED_BYTES = 5
TTL_BYTES = 2


class CrcError(IOError):
    pass


class SizeMismatchError(IOError):
    pass


@dataclass
class Needle:
    cookie: int = 0
    id: int = 0
    size: int = 0  # v2/v3: length of the body section; v1: len(data)
    data: bytes = b""
    flags: int = 0
    name: bytes = b""
    mime: bytes = b""
    pairs: bytes = b""
    last_modified: int = 0  # unix seconds, 5 bytes stored
    ttl: TTL = field(default_factory=lambda: EMPTY_TTL)
    checksum: int = 0
    append_at_ns: int = 0

    # -- flags ------------------------------------------------------------

    def _flag(self, mask: int) -> bool:
        return bool(self.flags & mask)

    is_compressed = property(lambda self: self._flag(FLAG_IS_COMPRESSED))
    has_name = property(lambda self: self._flag(FLAG_HAS_NAME))
    has_mime = property(lambda self: self._flag(FLAG_HAS_MIME))
    has_last_modified = property(lambda self: self._flag(FLAG_HAS_LAST_MODIFIED))
    has_ttl = property(lambda self: self._flag(FLAG_HAS_TTL))
    has_pairs = property(lambda self: self._flag(FLAG_HAS_PAIRS))
    is_chunk_manifest = property(lambda self: self._flag(FLAG_IS_CHUNK_MANIFEST))

    def set_flag(self, mask: int, on: bool = True) -> None:
        self.flags = (self.flags | mask) if on else (self.flags & ~mask)

    # -- construction ------------------------------------------------------

    @classmethod
    def create(
        cls,
        needle_id: int,
        cookie: int,
        data: bytes,
        *,
        name: bytes = b"",
        mime: bytes = b"",
        pairs: bytes = b"",
        last_modified: int | None = None,
        ttl: TTL = EMPTY_TTL,
        is_compressed: bool = False,
        is_chunk_manifest: bool = False,
    ) -> "Needle":
        """Build a write-ready needle (CreateNeedleFromRequest semantics,
        needle.go:53-115: flags from present fields, crc over data)."""
        n = cls(cookie=cookie, id=needle_id, data=data)
        if name and len(name) < 256:
            n.name = name
            n.set_flag(FLAG_HAS_NAME)
        if mime and len(mime) < 256:
            n.mime = mime
            n.set_flag(FLAG_HAS_MIME)
        if pairs and len(pairs) < 65536:
            n.pairs = pairs
            n.set_flag(FLAG_HAS_PAIRS)
        n.last_modified = int(time.time()) if last_modified is None else last_modified
        n.set_flag(FLAG_HAS_LAST_MODIFIED)
        if ttl is not EMPTY_TTL and ttl.count:
            n.ttl = ttl
            n.set_flag(FLAG_HAS_TTL)
        if is_compressed:
            n.set_flag(FLAG_IS_COMPRESSED)
        if is_chunk_manifest:
            n.set_flag(FLAG_IS_CHUNK_MANIFEST)
        n.checksum = crc32c(data)
        return n

    # -- write ------------------------------------------------------------

    def _body_size_v2(self) -> int:
        """The `Size` field for v2/v3 (needle_write.go:48-66)."""
        if not self.data:
            return 0
        size = 4 + len(self.data) + 1
        if self.has_name:
            size += 1 + min(len(self.name), 255)
        if self.has_mime:
            size += 1 + len(self.mime)
        if self.has_last_modified:
            size += LAST_MODIFIED_BYTES
        if self.has_ttl:
            size += TTL_BYTES
        if self.has_pairs:
            size += 2 + len(self.pairs)
        return size

    def to_bytes(self, version: int = types.CURRENT_VERSION) -> bytes:
        """Full on-disk record incl. checksum/timestamp/padding
        (prepareWriteBuffer, needle_write.go:20-113)."""
        out = bytearray()
        if version == types.VERSION1:
            self.size = len(self.data)
            out += self.cookie.to_bytes(4, "big")
            out += self.id.to_bytes(8, "big")
            out += self.size.to_bytes(4, "big")
            out += self.data
        elif version in (types.VERSION2, types.VERSION3):
            self.size = self._body_size_v2()
            out += self.cookie.to_bytes(4, "big")
            out += self.id.to_bytes(8, "big")
            out += self.size.to_bytes(4, "big")
            if self.data:
                out += len(self.data).to_bytes(4, "big")
                out += self.data
                out += bytes([self.flags])
                if self.has_name:
                    name = self.name[:255]
                    out += bytes([len(name)]) + name
                if self.has_mime:
                    out += bytes([len(self.mime)]) + self.mime
                if self.has_last_modified:
                    out += self.last_modified.to_bytes(8, "big")[8 - LAST_MODIFIED_BYTES:]
                if self.has_ttl:
                    out += self.ttl.to_bytes()
                if self.has_pairs:
                    out += len(self.pairs).to_bytes(2, "big") + self.pairs
        else:
            raise ValueError(f"unsupported needle version {version}")
        out += (self.checksum & 0xFFFFFFFF).to_bytes(4, "big")
        if version == types.VERSION3:
            out += self.append_at_ns.to_bytes(8, "big")
        out += b"\0" * types.padding_length(self.size, version)
        return bytes(out)

    # -- read --------------------------------------------------------------

    @classmethod
    def parse_header(cls, b: bytes) -> "Needle":
        n = cls()
        n.cookie = int.from_bytes(b[0:4], "big")
        n.id = int.from_bytes(b[4:12], "big")
        n.size = types.u32_to_size(int.from_bytes(b[12:16], "big"))
        return n

    @classmethod
    def from_bytes(
        cls,
        blob: bytes,
        version: int = types.CURRENT_VERSION,
        expected_size: int | None = None,
        check_crc: bool = True,
    ) -> "Needle":
        """Hydrate from a full record blob (ReadBytes, needle_read.go:52-91)."""
        n = cls.parse_header(blob)
        if expected_size is not None and n.size != expected_size:
            raise SizeMismatchError(
                f"needle {n.id:x}: size {n.size} != expected {expected_size}"
            )
        size = n.size
        hdr = types.NEEDLE_HEADER_SIZE
        if version == types.VERSION1:
            n.data = blob[hdr : hdr + size]
        elif version in (types.VERSION2, types.VERSION3):
            n._parse_body_v2(blob[hdr : hdr + size])
        else:
            raise ValueError(f"unsupported needle version {version}")
        if size > 0:
            stored = int.from_bytes(blob[hdr + size : hdr + size + 4], "big")
            n.checksum = stored  # preserved verbatim for rewrites (vacuum)
            if check_crc:
                actual = crc32c(n.data)
                if stored != actual and stored != crc_value_legacy(actual):
                    raise CrcError("CRC error! Data On Disk Corrupted")
                n.checksum = actual
        if version == types.VERSION3:
            ts = hdr + size + types.NEEDLE_CHECKSUM_SIZE
            n.append_at_ns = int.from_bytes(blob[ts : ts + 8], "big")
        return n

    def crc_ok(self) -> bool:
        """Does the held checksum match the held data? Meaningful after a
        check_crc=False parse (where `checksum` is the stored-on-disk
        value verbatim): the scrub-aware vacuum re-verifies every record
        it copies through exactly the check from_bytes would apply."""
        if self.size <= 0 or not self.data:
            return True
        actual = crc32c(self.data)
        return self.checksum in (actual, crc_value_legacy(actual))

    def _parse_body_v2(self, b: bytes) -> None:
        i, ln = 0, len(b)
        if i < ln:
            data_size = int.from_bytes(b[i : i + 4], "big")
            i += 4
            if data_size + i > ln:
                raise IOError("needle body: data out of range")
            self.data = b[i : i + data_size]
            i += data_size
        if i < ln:
            self.flags = b[i]
            i += 1
        if i < ln and self.has_name:
            nsz = b[i]
            i += 1
            self.name = b[i : i + nsz]
            i += nsz
        if i < ln and self.has_mime:
            msz = b[i]
            i += 1
            self.mime = b[i : i + msz]
            i += msz
        if i < ln and self.has_last_modified:
            self.last_modified = int.from_bytes(b[i : i + LAST_MODIFIED_BYTES], "big")
            i += LAST_MODIFIED_BYTES
        if i < ln and self.has_ttl:
            self.ttl = TTL.from_bytes(b[i : i + TTL_BYTES])
            i += TTL_BYTES
        if i < ln and self.has_pairs:
            psz = int.from_bytes(b[i : i + 2], "big")
            i += 2
            self.pairs = b[i : i + psz]
            i += psz

    # -- replica-epoch causality tag ----------------------------

    def replica_epoch(self) -> tuple[int, int, int] | None:
        """(incarnation, sequence, server_crc) stamped at write time, or
        None for a pre-epoch record. Rides the END of the pairs
        extension (storage/epoch.py) so it survives vacuum, replication
        and EC conversion with zero format changes."""
        from .epoch import decode_pairs

        return decode_pairs(self.pairs)

    def set_replica_epoch_tag(self, tag: bytes) -> None:
        """Attach (or replace) the epoch tag. Only meaningful for
        records with data — v2/v3 serialization emits no body sections
        for empty needles, so deletion markers stay untagged (tombstone-
        wins needs no causality)."""
        from .epoch import strip_pairs

        self.pairs = strip_pairs(self.pairs) + tag
        self.set_flag(FLAG_HAS_PAIRS)

    # -- timestamps --------------------------------------------------------

    def update_append_at_ns(self, last_append_at_ns: int) -> None:
        """Monotonic append timestamp (needle_write.go UpdateAppendAtNs)."""
        now = time.time_ns()
        self.append_at_ns = max(now, last_append_at_ns + 1)

    def disk_size(self, version: int = types.CURRENT_VERSION) -> int:
        return types.actual_size(self.size, version)

    def etag(self) -> str:
        return (self.checksum & 0xFFFFFFFF).to_bytes(4, "big").hex()

    def has_expired(self, now: float | None = None) -> bool:
        """TTL check vs last_modified (volume read path)."""
        if not self.has_ttl or self.ttl.minutes == 0:
            return False
        now = time.time() if now is None else now
        return now >= self.last_modified + self.ttl.minutes * 60


def read_needle_header(f, version: int, offset: int) -> tuple[Needle, int]:
    """-> (needle with header fields, body_length) (needle_read.go:183-199)."""
    f.seek(offset)
    b = f.read(types.NEEDLE_HEADER_SIZE)
    if len(b) < types.NEEDLE_HEADER_SIZE:
        raise EOFError("short needle header")
    n = Needle.parse_header(b)
    body = needle_body_length(n.size, version)
    return n, body


def needle_body_length(needle_size: int, version: int) -> int:
    """Bytes after the 16B header (needle_read.go:205-210)."""
    tail = types.NEEDLE_CHECKSUM_SIZE
    if version == types.VERSION3:
        tail += types.TIMESTAMP_SIZE
    return needle_size + tail + types.padding_length(needle_size, version)
