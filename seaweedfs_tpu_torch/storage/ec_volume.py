"""EC volume runtime: sorted-index needle lookup, deletion journal, and
needle reads across shard files (with degraded-mode reconstruction).

Counterpart of seaweedfs_tpu/storage/ec_volume.py (SeaweedFS's
ec_volume.go SearchNeedleFromSortedIndex, ec_volume_delete.go
DeleteNeedleFromEcx / RebuildEcxFile, store_ec.go ReadEcShardNeedle).
A degraded read reconstructs through ops/dispatch.reconstruct_now, so
concurrent degraded reads sharing a survivor set ride one stacked
launch; shard files are read through a small mmap reader.
"""

from __future__ import annotations

import io
import json
import mmap
import os

import numpy as np

from ..ops import dispatch
from ..utils import atomic_write
from . import types
from .ec_files import check_ecx_stride, to_host
from .ec_locate import Geometry, locate_data
from .errors import NotFoundError


def load_volume_info(base_file_name: str) -> dict:
    """Read the .vif sidecar (JSON VolumeInfo; {} when absent)."""
    try:
        with open(base_file_name + ".vif") as f:
            return json.load(f)
    except (FileNotFoundError, ValueError):
        return {}


def save_volume_info(base_file_name: str, info: dict) -> None:
    # atomic + fsync'd: the .vif names the volume's code geometry — a
    # crash mid-rewrite leaving a truncated file would refuse the whole
    # volume at next mount
    atomic_write.write_json_atomic(base_file_name + ".vif", info)


def _read_at(f, offset: int, length: int) -> bytes:
    """Positional read that never moves a shared handle's file position
    (concurrent lookups share one .ecx handle). pread when the object has
    a real fd; seek+read for file-likes (BytesIO) in tests."""
    try:
        fd = f.fileno()
    except (AttributeError, OSError, ValueError, io.UnsupportedOperation):
        fd = None
    if fd is not None:
        return os.pread(fd, length, offset)
    f.seek(offset)
    return f.read(length)


def search_needle_from_sorted_index(
    ecx_file, ecx_file_size: int, needle_id: int, process_fn=None
) -> tuple[int, int]:
    """Binary-search the sorted .ecx for needle_id -> (stored_offset, size).

    process_fn(file, entry_offset) is invoked on hit before returning
    (used to tombstone in place). Raises NotFoundError on miss.
    """
    if ecx_file_size % types.NEEDLE_MAP_ENTRY_SIZE:
        raise IOError(
            f".ecx size {ecx_file_size} is not a multiple of the active "
            f"{types.NEEDLE_MAP_ENTRY_SIZE}-byte entry stride — likely a "
            f"large-disk (5-byte offset) mode mismatch"
        )
    lo, hi = 0, ecx_file_size // types.NEEDLE_MAP_ENTRY_SIZE
    while lo < hi:
        mid = (lo + hi) // 2
        buf = _read_at(ecx_file, mid * types.NEEDLE_MAP_ENTRY_SIZE,
                       types.NEEDLE_MAP_ENTRY_SIZE)
        key, offset, size = types.unpack_needle_map_entry(buf)
        if key == needle_id:
            if process_fn is not None:
                process_fn(ecx_file, mid * types.NEEDLE_MAP_ENTRY_SIZE)
            return offset, size
        if key < needle_id:
            lo = mid + 1
        else:
            hi = mid
    raise NotFoundError(f"needle {needle_id:x} not found in ecx")


def mark_needle_deleted(ecx_file, entry_offset: int) -> None:
    """Write the size=-1 tombstone in place (MarkNeedleDeleted)."""
    ecx_file.seek(entry_offset + types.NEEDLE_ID_SIZE + types.OFFSET_SIZE)
    ecx_file.write(
        types.size_to_u32(types.TOMBSTONE_FILE_SIZE).to_bytes(4, "big")
    )


def delete_needle_from_ecx(base_file_name: str, needle_id: int) -> None:
    """Tombstone the .ecx entry in place and append the id to the .ecj
    journal (DeleteNeedleFromEcx). A missing needle is a no-op."""
    check_ecx_stride(base_file_name)  # in-place writes at the wrong
    #                                   stride would corrupt the index
    ecx_path = base_file_name + ".ecx"
    size = os.path.getsize(ecx_path)
    with open(ecx_path, "r+b") as f:
        try:
            search_needle_from_sorted_index(f, size, needle_id,
                                            mark_needle_deleted)
        except NotFoundError:
            return
    with open(base_file_name + ".ecj", "ab") as j:
        j.write(needle_id.to_bytes(8, "big"))


def rebuild_ecx_file(base_file_name: str) -> None:
    """Replay the .ecj journal into .ecx tombstones, then remove the
    journal (RebuildEcxFile, ec_volume_delete.go:51-98)."""
    ecj_path = base_file_name + ".ecj"
    if not os.path.exists(ecj_path):
        return
    check_ecx_stride(base_file_name)  # tombstone replay writes in place
    ecx_path = base_file_name + ".ecx"
    ecx_size = os.path.getsize(ecx_path)
    with open(ecx_path, "r+b") as ecx, open(ecj_path, "rb") as ecj:
        while True:
            buf = ecj.read(types.NEEDLE_ID_SIZE)
            if len(buf) != types.NEEDLE_ID_SIZE:
                break
            nid = int.from_bytes(buf, "big")
            try:
                search_needle_from_sorted_index(ecx, ecx_size, nid,
                                                mark_needle_deleted)
            except NotFoundError:
                pass
    os.remove(ecj_path)


class MmapShard:
    """Read-only mmap of one immutable shard file (zero-copy reads)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._size = os.fstat(self._f.fileno()).st_size
        self._mm = (mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
                    if self._size else None)

    def read_at(self, offset: int, length: int) -> bytes:
        if self._mm is None:
            return b""
        return bytes(self._mm[offset:offset + length])

    def size(self) -> int:
        return self._size

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
        self._f.close()


class EcVolume:
    """Read-side runtime over a local set of shard files: looks up the
    needle in .ecx, maps it to shard intervals, reads from local shard
    files, and — when shards are missing — reconstructs the interval
    bytes from the survivors through the coder (store_ec.go's degraded
    path)."""

    def __init__(
        self,
        base_file_name: str,
        coder,
        geo: Geometry | None = None,
        version: int | None = None,
        coder_for=None,
    ):
        self.base = base_file_name
        # .vif records geometry + needle version, and names the CODE
        # geometry, so a shard set is self-describing at mount
        vif = load_volume_info(base_file_name)
        if geo is None:
            geo = Geometry(
                data_shards=vif.get("dataShards", Geometry.data_shards),
                parity_shards=vif.get("parityShards", Geometry.parity_shards),
                large_block=vif.get("largeBlock", Geometry.large_block),
                small_block=vif.get("smallBlock", Geometry.small_block),
                code=vif.get("geometry", ""),
            )
        if version is None:
            version = vif.get("version", types.CURRENT_VERSION)
        self.geo = geo
        # validate at mount: an unregistered geometry name (or a shard
        # count mismatch) must refuse to serve, not decode garbage
        geo.code_geometry()
        # `coder_for` picks a coder matching THIS volume's code geometry;
        # a bare coder is trusted as matching
        self.coder = coder_for(geo) if coder_for is not None else coder
        self.version = version
        self.ecx_path = base_file_name + ".ecx"
        check_ecx_stride(base_file_name)
        # unbuffered: in-place tombstoning writes through other handles must
        # be visible immediately
        self._ecx_file = open(self.ecx_path, "rb", buffering=0)
        self._ecx_size = os.path.getsize(self.ecx_path)
        self.shard_files: dict[int, MmapShard] = {}
        for i in range(geo.total_shards):
            p = geo.shard_file_name(base_file_name, i)
            if os.path.exists(p):
                self.shard_files[i] = MmapShard(p)
        if not self.shard_files:
            self._ecx_file.close()
            raise FileNotFoundError(f"no shards for {base_file_name}")
        self.shard_size = next(iter(self.shard_files.values())).size()

    def close(self) -> None:
        for f in self.shard_files.values():
            f.close()
        self.shard_files.clear()
        self._ecx_file.close()

    # dat size as the EC runtime derives it: k * shard file size
    @property
    def dat_size_estimate(self) -> int:
        return self.geo.data_shards * self.shard_size

    def find_needle(self, needle_id: int) -> tuple[int, int]:
        """-> (actual_offset, size). Raises NotFoundError if absent; a
        tombstoned needle is returned with its negative size."""
        stored_off, nsize = search_needle_from_sorted_index(
            self._ecx_file, self._ecx_size, needle_id
        )
        return types.stored_to_actual_offset(stored_off), nsize

    def read_needle_blob(self, needle_id: int) -> bytes:
        """Read the full on-disk needle record (header..padding)."""
        offset, size = self.find_needle(needle_id)
        if types.size_is_deleted(size):
            raise NotFoundError(f"needle {needle_id:x} deleted")
        length = types.actual_size(size, self.version)
        return self.read_extent(offset, length)

    def read_extent(self, offset: int, length: int) -> bytes:
        """Read an arbitrary .dat-space extent through the shard layout."""
        intervals = locate_data(self.geo, self.dat_size_estimate, offset,
                                length)
        out = bytearray()
        for iv in intervals:
            shard_id, shard_off = iv.to_shard_id_and_offset(self.geo)
            out += self._read_interval(shard_id, shard_off, iv.size)
        return bytes(out)

    def _read_interval(self, shard_id: int, shard_off: int, size: int) -> bytes:
        f = self.shard_files.get(shard_id)
        if f is not None:
            data = f.read_at(shard_off, size)
            if len(data) == size:
                return data
            return data + b"\0" * (size - len(data))
        # degraded: rebuild this interval from surviving shards. The
        # geometry's minimal-read plan decides WHICH survivors — a lost
        # shard inside an LRC local group reads its 5 group peers — with
        # the generic any-k gather as the fallback when a planned read
        # fails mid-flight.
        from ..models.geometry import UnsolvableError

        geom = self.geo.code_geometry()
        avail = tuple(sorted(i for i in self.shard_files if i != shard_id))
        for attempt in ("planned", "generic"):
            if attempt == "planned":
                try:
                    reads = geom.repair_plan((shard_id,), avail).reads
                except (UnsolvableError, ValueError):
                    continue
            else:
                reads = avail
            pres: list[int] = []
            rows: list[np.ndarray] = []
            for i in reads:
                sf = self.shard_files.get(i)
                if sf is None:
                    continue
                try:
                    chunk = sf.read_at(shard_off, size)
                except OSError:  # bad sector / stale handle
                    continue  # planned attempt degrades to generic
                chunk += b"\0" * (size - len(chunk))
                pres.append(i)
                rows.append(np.frombuffer(chunk, dtype=np.uint8))
                if attempt == "generic" and geom.is_rs and \
                        len(pres) == self.geo.data_shards:
                    break  # any k suffice under RS; non-RS gathers all
            if attempt == "planned" and len(pres) < len(reads):
                continue  # a planned survivor failed: try the wide net
            if attempt == "generic" and len(pres) < self.geo.data_shards:
                # sub-k survivor sets can still solve under non-RS
                # geometries; let the solve decide instead of counting
                try:
                    geom.repair_matrix(tuple(pres), (shard_id,))
                except (UnsolvableError, ValueError):
                    raise IOError(
                        f"cannot reconstruct shard {shard_id}: only "
                        f"{len(pres)} shards available")
            # concurrent degraded reads sharing this survivor set ride ONE
            # stacked reconstruct launch (micro-batched). RS keeps
            # want=None so readers of DIFFERENT lost shards share the lane
            # too (the fused matrix solves every missing data row at
            # once); non-RS solves exactly this shard: the survivor set
            # may not span the full complement
            want = None if geom.is_rs else (shard_id,)
            try:
                missing, out = dispatch.reconstruct_now(
                    self.coder, pres, np.stack(rows), data_only=True,
                    want=want)
            except (UnsolvableError, ValueError) as e:
                if attempt == "planned":
                    continue
                raise IOError(
                    f"cannot reconstruct shard {shard_id}: survivors "
                    f"{pres} do not span it") from e
            return to_host(out[list(missing).index(shard_id)]).tobytes()
        raise IOError(
            f"cannot reconstruct shard {shard_id}: survivors "
            f"{list(avail)} do not span it")

    def delete_needle(self, needle_id: int) -> None:
        delete_needle_from_ecx(self.base, needle_id)
