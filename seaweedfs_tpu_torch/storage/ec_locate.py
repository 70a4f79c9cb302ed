"""EC stripe geometry: map .dat byte extents to shard-file intervals.

Behavioral equivalent of SeaweedFS weed/storage/erasure_coding/ec_locate.go
(LocateData, locateOffset, ToShardIdAndOffset), generalized over the shard
geometry the reference hard-codes (RS(10,4), ec_encoder.go:17-23).

Layout recap: a volume's .dat is striped row-major across `data_shards`
shard files — full rows of `large_block` (1GB) blocks first, then rows of
`small_block` (1MB) blocks for the tail. Parity shards mirror the same
block layout. The nLargeBlockRows derivation adds data_shards*small_block
before dividing (ec_locate.go:19) so the row count is derivable from shard
size alone; we preserve that quirk exactly — .ecx offsets depend on it.
"""

from __future__ import annotations

from dataclasses import dataclass

LARGE_BLOCK_SIZE = 1024 * 1024 * 1024  # 1GB (ec_encoder.go:21)
SMALL_BLOCK_SIZE = 1024 * 1024  # 1MB (ec_encoder.go:22)
DATA_SHARDS_DEFAULT = 10
PARITY_SHARDS_DEFAULT = 4


@dataclass(frozen=True)
class Geometry:
    """Shard-count + block-size geometry of one EC'd volume.

    `code` names the CODE geometry — the GF(256) generator
    matrix layout from models/geometry.py's registry (e.g. "lrc_10_2_2").
    Empty means plain Reed-Solomon over (data_shards, parity_shards),
    exactly the pre-registry behavior; `code_name` canonicalizes that to
    "rs_{k}_{m}". Persisted per EC volume in the .vif sidecar, so mixed
    code geometries coexist on one server/cluster."""

    data_shards: int = DATA_SHARDS_DEFAULT
    parity_shards: int = PARITY_SHARDS_DEFAULT
    large_block: int = LARGE_BLOCK_SIZE
    small_block: int = SMALL_BLOCK_SIZE
    code: str = ""

    @property
    def total_shards(self) -> int:
        return self.data_shards + self.parity_shards

    @property
    def code_name(self) -> str:
        return self.code or f"rs_{self.data_shards}_{self.parity_shards}"

    def code_geometry(self):
        """The models.geometry.CodeGeometry this volume's bytes follow.
        Raises ValueError for an unregistered name or a shard-count
        mismatch — the mount-time validation surface."""
        from ..models import geometry as geom_mod

        return geom_mod.resolve(self.data_shards, self.parity_shards,
                                self.code or None)

    def shard_file_name(self, base: str, shard_id: int) -> str:
        return f"{base}.ec{shard_id:02d}"  # ToExt, ec_encoder.go:65-67

    def row_counts(self, dat_size: int) -> tuple[int, int]:
        """(n_large_rows, n_small_rows) the encoder will emit for dat_size,
        following encodeDatFile's strict `>` loop bounds (ec_encoder.go:214-229)."""
        large_row = self.large_block * self.data_shards
        small_row = self.small_block * self.data_shards
        remaining = dat_size
        n_large = 0
        while remaining > large_row:
            remaining -= large_row
            n_large += 1
        n_small = 0
        while remaining > 0:
            remaining -= small_row
            n_small += 1
        return n_large, n_small

    def shard_size(self, dat_size: int) -> int:
        n_large, n_small = self.row_counts(dat_size)
        return n_large * self.large_block + n_small * self.small_block


@dataclass(frozen=True)
class Interval:
    block_index: int
    inner_block_offset: int
    size: int
    is_large_block: bool
    large_block_rows_count: int

    def to_shard_id_and_offset(self, geo: Geometry) -> tuple[int, int]:
        """(shard_id, offset within .ecXX file) — ec_locate.go:77-87."""
        off = self.inner_block_offset
        row_index = self.block_index // geo.data_shards
        if self.is_large_block:
            off += row_index * geo.large_block
        else:
            off += (
                self.large_block_rows_count * geo.large_block
                + row_index * geo.small_block
            )
        return self.block_index % geo.data_shards, off


def locate_data(
    geo: Geometry, dat_size: int, offset: int, size: int
) -> list[Interval]:
    """Map [offset, offset+size) of the .dat to shard intervals
    (LocateData, ec_locate.go:15-52)."""
    block_index, is_large, inner = _locate_offset(geo, dat_size, offset)
    n_large_rows = (dat_size + geo.data_shards * geo.small_block) // (
        geo.large_block * geo.data_shards
    )
    intervals: list[Interval] = []
    while size > 0:
        block_remaining = (geo.large_block if is_large else geo.small_block) - inner
        take = min(size, block_remaining)
        intervals.append(
            Interval(block_index, inner, take, is_large, n_large_rows)
        )
        if size <= block_remaining:
            return intervals
        size -= take
        block_index += 1
        if is_large and block_index == n_large_rows * geo.data_shards:
            is_large = False
            block_index = 0
        inner = 0
    return intervals


def _locate_offset(
    geo: Geometry, dat_size: int, offset: int
) -> tuple[int, bool, int]:
    large_row_size = geo.large_block * geo.data_shards
    n_large_rows = dat_size // large_row_size
    if offset < n_large_rows * large_row_size:
        return offset // geo.large_block, True, offset % geo.large_block
    offset -= n_large_rows * large_row_size
    return offset // geo.small_block, False, offset % geo.small_block
