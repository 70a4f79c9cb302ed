"""Volume superblock (first 8 bytes of every .dat) + replica placement.

Wire-compatible with SeaweedFS weed/storage/super_block/super_block.go:
byte 0 version, byte 1 replica placement, bytes 2-3 TTL, bytes 4-5
compaction revision, bytes 6-7 extra-size (protobuf extra; stored opaque
here). ReplicaPlacement is the "XYZ" digit scheme of replica_placement.go:
X=other DCs, Y=other racks, Z=other servers in rack.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from . import types
from .ttl import EMPTY_TTL, TTL

SUPER_BLOCK_SIZE = 8


@dataclass(frozen=True)
class ReplicaPlacement:
    same_rack_count: int = 0
    diff_rack_count: int = 0
    diff_dc_count: int = 0

    @classmethod
    def parse(cls, s: str) -> "ReplicaPlacement":
        """"XYZ" digits: X diff-DC, Y diff-rack, Z same-rack (0..2 each)."""
        vals = [0, 0, 0]
        for i, c in enumerate(s):
            if not ("0" <= c <= "2") or i > 2:
                raise ValueError(f"unknown replication type {s!r}")
            vals[i] = int(c)
        return cls(diff_dc_count=vals[0], diff_rack_count=vals[1], same_rack_count=vals[2])

    @classmethod
    def from_byte(cls, b: int) -> "ReplicaPlacement":
        return cls.parse(f"{b:03d}")

    def to_byte(self) -> int:
        return self.diff_dc_count * 100 + self.diff_rack_count * 10 + self.same_rack_count

    @property
    def copy_count(self) -> int:
        return self.diff_dc_count + self.diff_rack_count + self.same_rack_count + 1

    def __str__(self) -> str:
        return f"{self.diff_dc_count}{self.diff_rack_count}{self.same_rack_count}"


@dataclass
class SuperBlock:
    version: int = types.CURRENT_VERSION
    replica_placement: ReplicaPlacement = field(default_factory=ReplicaPlacement)
    ttl: TTL = field(default_factory=lambda: EMPTY_TTL)
    compaction_revision: int = 0
    extra: bytes = b""  # opaque SuperBlockExtra protobuf payload

    @property
    def block_size(self) -> int:
        return SUPER_BLOCK_SIZE + len(self.extra)

    def to_bytes(self) -> bytes:
        out = bytearray(SUPER_BLOCK_SIZE)
        out[0] = self.version
        out[1] = self.replica_placement.to_byte()
        out[2:4] = self.ttl.to_bytes()
        out[4:6] = self.compaction_revision.to_bytes(2, "big")
        if self.extra:
            if len(self.extra) > 256 * 256 - 2:
                raise ValueError("super block extra too large")
            out[6:8] = len(self.extra).to_bytes(2, "big")
            return bytes(out) + self.extra
        return bytes(out)

    @classmethod
    def from_file(cls, f) -> "SuperBlock":
        """Read and parse from an open .dat (super_block_read.go semantics)."""
        f.seek(0)
        hdr = f.read(SUPER_BLOCK_SIZE)
        if len(hdr) < SUPER_BLOCK_SIZE:
            raise IOError("cannot read volume superblock")
        sb = cls(
            version=hdr[0],
            replica_placement=ReplicaPlacement.from_byte(hdr[1]),
            ttl=TTL.from_bytes(hdr[2:4]),
            compaction_revision=int.from_bytes(hdr[4:6], "big"),
        )
        extra_size = int.from_bytes(hdr[6:8], "big")
        if extra_size:
            sb.extra = f.read(extra_size)
        return sb

    def bump_compaction(self) -> "SuperBlock":
        return replace(
            self, compaction_revision=(self.compaction_revision + 1) & 0xFFFF
        )
