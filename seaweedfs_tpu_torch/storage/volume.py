"""Volume: append-only .dat + .idx needle store.

Counterpart of seaweedfs_tpu/storage/volume.py (SeaweedFS
weed/storage/volume.go, volume_write.go, volume_read.go,
volume_loading.go, volume_checking.go, volume_vacuum.go,
needle_map_memory.go): the write, read and delete path, group commit, the
startup integrity repair, the needle scan and vacuum (compact /
commit_compact), and the funnel through which a volume attached to the
native C++ data plane (native/dataplane.py) hands that plane write
authority, and the move of a sealed `.dat` to a tier backend and back
(`tier_to_remote`, `tier_from_remote`; volume_tier.go).

One volume = superblock + appended needle records in
`.dat`, with a 16-byte-per-entry `.idx` log replayed into an in-memory map
at load.

Concurrency: one writer lock per volume (the reference serializes through
`dataFileAccessLock`); all reads use os.pread on the same descriptor — no
shared seek state — so they are safe against concurrent appends.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

from . import types
from ..utils import locks
from ..utils.stats import (
    VOLUME_GROUP_COMMIT_FLUSHES,
    VOLUME_GROUP_COMMIT_WRITES,
)
from .errors import (
    CookieMismatch,
    DeletedError,
    NotFoundError,
    QuarantinedError,
)
from .needle import Needle, needle_body_length
from .super_block import SuperBlock
from .ttl import EMPTY_TTL


def _group_commit_enabled() -> bool:
    return os.environ.get("SWFS_GROUP_COMMIT", "1").lower() \
        not in ("0", "false", "off")


def _group_commit_window_s() -> float:
    """Optional extra accumulation window before the leader flushes.
    0 (default) = pure leader batching: a lone writer flushes at once
    (no added latency) and batching emerges only under concurrency."""
    try:
        return float(os.environ.get("SWFS_GROUP_COMMIT_WINDOW_MS", "0")) / 1e3
    except ValueError:
        return 0.0


@dataclass
class NeedleValue:
    offset: int  # stored units (8-byte quanta)
    size: int  # signed


class _SqliteMap:
    """Dict-shaped id -> NeedleValue map on disk (the reference's
    NeedleMapLevelDb{,Medium,Large} kinds, needle_map_leveldb.go — low
    memory for huge volumes; sqlite stands in for LevelDB here)."""

    def __init__(self, db_path: str):
        import sqlite3

        self._db = sqlite3.connect(db_path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS needles ("
            "key INTEGER PRIMARY KEY, off INTEGER, size INTEGER)")
        self._lock = threading.Lock()

    def get(self, key: int) -> NeedleValue | None:
        with self._lock:
            row = self._db.execute(
                "SELECT off, size FROM needles WHERE key=?",
                (key,)).fetchone()
        return NeedleValue(row[0], row[1]) if row else None

    def __setitem__(self, key: int, nv: NeedleValue) -> None:
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO needles VALUES (?,?,?)",
                (key, nv.offset, nv.size))
            self._db.commit()

    def pop(self, key: int, default=None):
        nv = self.get(key)
        if nv is None:
            return default
        with self._lock:
            self._db.execute("DELETE FROM needles WHERE key=?", (key,))
            self._db.commit()
        return nv

    def __len__(self) -> int:
        with self._lock:
            return self._db.execute(
                "SELECT COUNT(*) FROM needles").fetchone()[0]

    def items(self):
        with self._lock:
            rows = self._db.execute(
                "SELECT key, off, size FROM needles ORDER BY key").fetchall()
        for key, off, size in rows:
            yield key, NeedleValue(off, size)

    def clear(self) -> None:
        with self._lock:
            self._db.execute("DELETE FROM needles")
            self._db.commit()

    def clear_close(self) -> None:
        with self._lock:
            self._db.close()


class NeedleMap:
    """id -> (offset, size) map backed by an append-only .idx log
    (needle_map_memory.go: NewCompactNeedleMap/doLoading/Put/Get/Delete).
    kind="memory" keeps the map in a dict; kind="sqlite" keeps it on disk
    (the reference's leveldb index kinds) in a `.ldb` sidecar."""

    def __init__(self, idx_path: str, kind: str = "memory"):
        self.idx_path = idx_path
        self.kind = kind
        if kind == "memory":
            self._m: dict[int, NeedleValue] | _SqliteMap = {}
        elif kind == "sqlite":
            self._m = _SqliteMap(idx_path[:-4] + ".ldb")
            # the .idx log is the source of truth: rebuild the table from
            # scratch so stale rows (compaction, truncation repair, prior
            # runs) can't shadow the replay or inflate deletion counters
            self._m.clear()
        else:
            raise ValueError(f"unknown needle map kind {kind!r}")
        self.max_file_key = 0
        self.file_counter = 0
        self.file_byte_counter = 0
        self.deletion_counter = 0
        self.deletion_byte_counter = 0
        # ids whose LATEST idx entry is a tombstone. The live map pops
        # deleted keys, but anti-entropy (scrub/digest.py) must tell
        # "deleted here" apart from "never written here" — without this a
        # replica that processed a delete gets the needle resurrected by
        # the replica that missed it.
        self.tombstones: set[int] = set()
        # 1MB buffer (64Ki entries): with auto_flush deferred to group
        # commit, a FULL stdio buffer would auto-drain idx entries to
        # the OS independent of the leader's dat-then-idx flush order.
        # Un-flushed batch depth is bounded by the server's thread pool
        # (tens), orders of magnitude under this capacity.
        self._idx_file = open(idx_path, "ab", buffering=1 << 20)
        # False defers the per-entry flush to the owning Volume's
        # group-commit pass; standalone users keep flush-per-append
        self.auto_flush = True
        # bytes of the .idx log reflected in the map — lets catchup_from_idx
        # absorb entries appended by another writer (the native data plane)
        self._idx_consumed = 0
        if os.path.getsize(idx_path):
            self._load()

    def _apply(self, key: int, off: int, size: int) -> None:
        """Replay one idx entry (doLoading semantics).

        Liveness: off != 0 and size >= 0. This deliberately keeps
        zero-byte needles live, diverging from the reference's replay
        (needle_map_memory.go:40 uses size.IsValid(), size > 0) which
        drops on restart the empty files its own read path serves
        (volume_read.go:36 returns success for readSize == 0). Both this
        map and the C++ plane (native/dataplane.cpp Volume::apply) use
        the same predicate so the two planes never diverge on catchup.
        """
        self.max_file_key = max(self.max_file_key, key)
        self.file_counter += 1
        if off != 0 and size >= 0:
            old = self._m.get(key)
            self._m[key] = NeedleValue(off, size)
            self.tombstones.discard(key)
            self.file_byte_counter += size
            if old is not None and old.offset != 0 and old.size >= 0:
                self.deletion_counter += 1
                self.deletion_byte_counter += old.size
        else:
            old = self._m.pop(key, None)
            self.tombstones.add(key)
            self.deletion_counter += 1
            if old is not None:
                self.deletion_byte_counter += max(old.size, 0)

    def _load(self) -> None:
        from . import idx as idx_mod

        ids, offs, sizes = idx_mod.read_index_file(self.idx_path)
        for i in range(len(ids)):
            self._apply(int(ids[i]), int(offs[i]), int(sizes[i]))
        self._idx_consumed = len(ids) * types.NEEDLE_MAP_ENTRY_SIZE

    def catchup_from_idx(self) -> int:
        """Absorb idx entries appended past our watermark by another writer
        (the C++ data plane appends both .dat records and .idx entries;
        this keeps the Python map/counters authoritative for vacuum,
        heartbeats and EC). -> number of entries applied."""
        try:
            size = os.path.getsize(self.idx_path)
        except OSError:
            return 0
        if size <= self._idx_consumed:
            return 0
        with open(self.idx_path, "rb") as f:
            f.seek(self._idx_consumed)
            tail = f.read(size - self._idx_consumed)
        n = len(tail) // types.NEEDLE_MAP_ENTRY_SIZE
        for i in range(n):
            key, off, sz = types.unpack_needle_map_entry(
                tail[i * types.NEEDLE_MAP_ENTRY_SIZE:
                     (i + 1) * types.NEEDLE_MAP_ENTRY_SIZE])
            self._apply(key, off, sz)
        self._idx_consumed += n * types.NEEDLE_MAP_ENTRY_SIZE
        return n

    def put(self, key: int, stored_offset: int, size: int) -> None:
        old = self._m.get(key)
        self._m[key] = NeedleValue(stored_offset, size)
        self.tombstones.discard(key)
        self.max_file_key = max(self.max_file_key, key)
        self.file_counter += 1
        self.file_byte_counter += max(size, 0)
        if old is not None and old.offset != 0 and old.size >= 0:
            self.deletion_counter += 1
            self.deletion_byte_counter += old.size
        self._append(key, stored_offset, size)

    def get(self, key: int) -> NeedleValue | None:
        return self._m.get(key)

    def delete(self, key: int, stored_offset: int) -> int:
        old = self._m.pop(key, None)
        self.tombstones.add(key)
        deleted = old.size if old is not None and old.size >= 0 else 0
        self.deletion_counter += 1
        self.deletion_byte_counter += deleted
        self._append(key, stored_offset, types.TOMBSTONE_FILE_SIZE)
        return deleted

    def _append(self, key: int, off: int, size: int) -> None:
        self._idx_file.write(types.pack_needle_map_entry(key, off, size))
        self._idx_consumed += types.NEEDLE_MAP_ENTRY_SIZE
        if self.auto_flush:
            self._idx_file.flush()

    def flush(self) -> None:
        self._idx_file.flush()

    def __len__(self) -> int:
        return len(self._m)

    def __iter__(self):
        return iter(self._m.items())

    @property
    def content_size(self) -> int:
        return self.file_byte_counter

    def close(self) -> None:
        self._idx_file.close()
        if isinstance(self._m, _SqliteMap):
            self._m.clear_close()

    def destroy(self) -> None:
        self.close()
        os.remove(self.idx_path)
        if self.kind == "sqlite":
            try:
                os.remove(self.idx_path[:-4] + ".ldb")
            except FileNotFoundError:
                pass


class TieredVolumeUnavailable(IOError):
    """A .tier sidecar points at a backend we can't reach/resolve."""


class Volume:
    """One append-only needle volume (volume.go:26-60)."""

    def __init__(
        self,
        dirname: str,
        collection: str,
        vid: int,
        *,
        replica_placement=None,
        ttl=EMPTY_TTL,
        version: int = types.CURRENT_VERSION,
        preallocate: int = 0,
        needle_map_kind: str = "memory",
    ):
        self.needle_map_kind = needle_map_kind
        self.dir = dirname
        self.collection = collection
        self.id = vid
        self.read_only = False
        self.last_append_at_ns = 0
        self.last_modified_ts_seconds = 0
        # replica-epoch causality plane: the owning Store
        # attaches its EpochStamper; a bare Volume (tests, offline
        # tools) stays unstamped (pre-epoch behavior). The per-volume
        # write sequence advances under _lock.
        self.epoch_stamper = None
        self.epoch_seq = 0
        self.is_compacting = False
        # (needles, bytes) CRC re-verified by the last compact(); consumed
        # by commit_compact's scrub-pass publication
        self._vacuum_verified: tuple[int, int] | None = None
        # witnessed: the group-commit flush takes volume.mu
        # THEN volume.gc_cv (see _gc_flush); nothing may reverse that
        self._lock = locks.wrlock("volume.mu", rank=300)
        # scrub plane: needle ids whose on-disk record failed verification
        # and is being repaired — read_needle refuses them (the server
        # layer answers from a healthy replica instead of corrupt bytes)
        self.quarantined: set[int] = set()
        # group commit: appends are buffered and a leader
        # writer flushes dat-then-idx ONCE for every write registered so
        # far; concurrent writers share one flush instead of paying one
        # each. Acks only happen after the covering flush, and the
        # dat-before-idx flush order (with appends excluded by _lock
        # during the flush) keeps the on-disk idx never ahead of dat.
        self._gc_enabled = _group_commit_enabled()
        self._gc_cond = locks.wcondition("volume.gc_cv", rank=320)
        self._gc_seq = 0        # writes appended (registered for flush)
        self._gc_flushed = 0    # writes covered by a completed flush
        self._gc_leader = False
        # set by a failed batch flush: refuses NEW writes (alongside but
        # independent of read_only, so unfreezing can never clobber a
        # read-only state set by an admin/EC/vacuum path meanwhile)
        self._gc_frozen = False
        # cached append offset: the byte past the last buffered record.
        # None = re-derive from seek_end (which also drains the write
        # buffer). Invalidated whenever _dat is replaced or truncated.
        self._dat_tail: int | None = None
        self.remote_dat = None  # set when the .dat lives on a tier backend
        # native (C++) data-plane attachment: when set, the plane is the
        # single writer authority for this volume's .dat/.idx and all
        # needle reads/writes funnel through it (native/dataplane.py).
        # native_writable mirrors the registry's decision (False for
        # replicated/TTL volumes whose PUTs must stay in Python).
        self.native = None
        self.native_writable = False
        base = self.file_name()
        dat_exists = os.path.exists(base + ".dat")
        sidecar = None
        if not dat_exists:
            from .backend import read_tier_sidecar

            sidecar = read_tier_sidecar(base)
        from .backend import DiskFile

        if sidecar is not None:
            # tiered volume: .dat on a remote backend, .idx stays local.
            # Backend resolution / first remote read can fail (backend not
            # configured, endpoint down) — raise a tagged error the store
            # catches so ONE bad volume can't down the whole server.
            import io

            from .backend import RemoteDatFile, get_tier_backend

            self._dat = None
            try:
                self.remote_dat = RemoteDatFile(
                    get_tier_backend(sidecar["backend"]), sidecar["key"],
                    sidecar["size"])
                self.super_block = SuperBlock.from_file(
                    io.BytesIO(self.remote_dat.read_at(0, 64)))
            except Exception as e:
                raise TieredVolumeUnavailable(
                    f"volume {vid}: tier backend "
                    f"{sidecar['backend']!r}: {e}") from e
            self.read_only = True
        elif dat_exists:
            self._dat = DiskFile(base + ".dat")
            self.super_block = SuperBlock.from_file(self._dat)
        else:
            from .super_block import ReplicaPlacement

            self._dat = DiskFile(base + ".dat", create=True)
            self.super_block = SuperBlock(
                version=version,
                replica_placement=replica_placement or ReplicaPlacement(),
                ttl=ttl,
            )
            self._dat.write(self.super_block.to_bytes())
            self._dat.flush()
            types.write_stride_marker(base)
        # Offset-width (stride) guard: a 4-byte-offset .idx parsed at
        # 17-byte stride (or vice versa) is garbage, and the startup
        # integrity repair would then happily truncate the volume to
        # nothing. Volumes created in large-disk mode carry a `.lrg`
        # marker; refuse to open across a mode mismatch. (The reference
        # has the same hazard between 5BytesOffset and default binaries,
        # with no guard — this is deliberately stricter.) Applies to
        # tiered volumes too: their .idx is local even when .dat is not.
        if dat_exists or sidecar is not None:
            has_marker = os.path.exists(base + ".lrg")
            if has_marker != types.large_disk():
                raise IOError(
                    f"volume {vid}: index stride mismatch — volume was "
                    f"written with {'5' if has_marker else '4'}-byte "
                    f"offsets but the process is in "
                    f"{'large-disk (5-byte)' if types.large_disk() else '4-byte'} "
                    f"mode; restart with the matching -largeDisk setting"
                )
        self.nm = self._new_needle_map(base + ".idx")
        if dat_exists:
            self.check_and_fix_integrity()

    def _new_needle_map(self, idx_path: str) -> NeedleMap:
        nm = NeedleMap(idx_path, self.needle_map_kind)
        # under group commit the volume owns idx durability: per-entry
        # flushes are deferred to the shared batch flush
        nm.auto_flush = not self._gc_enabled
        return nm

    # -- naming ------------------------------------------------------------

    def file_name(self) -> str:
        prefix = f"{self.collection}_" if self.collection else ""
        return os.path.join(self.dir, f"{prefix}{self.id}")

    @property
    def version(self) -> int:
        return self.super_block.version

    @property
    def ttl(self):
        return self.super_block.ttl

    # -- size / stats ------------------------------------------------------

    def data_size(self) -> int:
        if self._dat is None:
            return self.remote_dat.size()
        return self._dat.seek_end()

    @property
    def is_tiered(self) -> bool:
        return self.remote_dat is not None

    def content_size(self) -> int:
        return self.nm.content_size

    def deleted_size(self) -> int:
        return self.nm.deletion_byte_counter

    def file_count(self) -> int:
        return len(self.nm)

    def deleted_count(self) -> int:
        return self.nm.deletion_counter

    def garbage_level(self) -> float:
        """deleted bytes / total content bytes (volume_vacuum hook)."""
        if self.is_tiered:
            return 0.0  # immutable remotely; vacuum must not pick it up
        if self.content_size() == 0:
            return 0.0
        return self.nm.deletion_byte_counter / self.content_size()

    # -- write path --------------------------------------------------------

    def _pread(self, offset: int, length: int) -> bytes:
        backend = self.remote_dat if self._dat is None else self._dat
        return backend.read_at(offset, length)

    def _pread_durable(self, offset: int, length: int) -> bytes:
        """pread that tolerates the group-commit window: a map entry can
        exist for a record whose bytes are still in the write buffer
        (pread bypasses it), so a short read drains the buffer once and
        retries before giving up."""
        blob = self._pread(offset, length)
        if len(blob) < length and self._dat is not None:
            try:
                self._dat.flush()
            except OSError:
                return blob
            blob = self._pread(offset, length)
        return blob

    def _read_header_at(self, offset: int) -> Needle:
        b = self._pread_durable(offset, types.NEEDLE_HEADER_SIZE)
        if len(b) < types.NEEDLE_HEADER_SIZE:
            raise EOFError("short needle header")
        return Needle.parse_header(b)

    def _maybe_stamp_epoch(self, n: Needle, stamp: bool) -> None:
        """Attach a replica-epoch tag to a write this server ORIGINATES
        (HTTP PUT, remote fetch). Writes that carry a record verbatim
        (replica heal, tail receive — stamp=False) or already tagged
        records keep their original causality; empty bodies can't carry
        pairs and tombstone-wins needs no tag anyway. _lock held."""
        if not stamp or not n.data or self.epoch_stamper is None:
            return
        from .epoch import tags_enabled

        if not tags_enabled() or n.replica_epoch() is not None:
            return
        n.set_replica_epoch_tag(self.epoch_stamper.tag_for(self))

    # -- native data-plane funnel ------------------------------------------

    def attach_native(self, plane) -> None:
        """Hand write authority for this volume to the C++ data plane."""
        with self._lock:
            self._sync_buffers()  # plane appends at the REAL file tail
            self._dat_tail = None
            self.sync_native()
            self.native = plane

    def detach_native(self) -> None:
        with self._lock:
            self.native = None
            self._dat_tail = None  # the plane moved the file tail
            self.sync_native()

    def sync_native(self) -> None:
        """Absorb .idx entries appended by the C++ plane so nm-based logic
        (heartbeats, vacuum, EC preconditions) stays authoritative."""
        with self._lock:
            self.nm.catchup_from_idx()

    def _native_write(self, n: Needle,
                      check_cookie: bool = True) -> tuple[int, int, bool]:
        """write_needle via the C++ single-writer (same semantics)."""
        old_blob = self.native.read_blob(self.id, n.id)
        if old_blob is not None:
            old = Needle.from_bytes(old_blob, self.version, check_crc=False)
            if n.cookie == 0 and not check_cookie:
                n.cookie = old.cookie
            if old.cookie != n.cookie:
                raise CookieMismatch(f"mismatching cookie {n.cookie:x}")
            if (not str(self.ttl) and old.checksum == n.checksum
                    and old.data == n.data):
                return 0, len(n.data), True
        blob = n.to_bytes(self.version)
        ns_off = types.NEEDLE_HEADER_SIZE + n.size + types.NEEDLE_CHECKSUM_SIZE
        off, ns = self.native.append_record(
            self.id, n.id, blob, n.size,
            ns_off if self.version == types.VERSION3 else -1)
        n.append_at_ns = ns
        self.last_append_at_ns = max(self.last_append_at_ns, ns)
        if self.last_modified_ts_seconds < n.last_modified:
            self.last_modified_ts_seconds = n.last_modified
        return off, n.size, False

    def write_needle(self, n: Needle, check_cookie: bool = True,
                     stamp: bool = True) -> tuple[int, int, bool]:
        """Append a needle (doWriteRequest, volume_write.go:127-176).
        -> (offset_bytes, size, is_unchanged). Acknowledged only after
        the record's bytes reached the OS (group-commit flush)."""
        with self._lock:
            if self.read_only:
                raise IOError(f"volume {self.id} is read only")
            if self._gc_frozen:
                raise IOError(f"volume {self.id} is frozen: a previous "
                              f"group-commit flush failed")
            if self.native is not None:
                self._maybe_stamp_epoch(n, stamp)
                return self._native_write(n, check_cookie)
            unchanged = self._is_file_unchanged(n)
            if unchanged:
                # the matched record may still be in the group-commit
                # window (its writer blocked in _commit_wait): this ack
                # claims the bytes are stored, so it must wait — outside
                # the lock — for the flush covering every write
                # registered so far. A pre-batching dedup hit was always
                # against already-durable data.
                with self._gc_cond:
                    seq = self._gc_seq
                offset = 0
            else:
                nv = self.nm.get(n.id)
                if nv is not None:
                    existing = self._read_header_at(
                        types.stored_to_actual_offset(nv.offset)
                    )
                    if n.cookie == 0 and not check_cookie:
                        n.cookie = existing.cookie
                    if existing.cookie != n.cookie:
                        raise CookieMismatch(
                            f"mismatching cookie {n.cookie:x}")
                self._maybe_stamp_epoch(n, stamp)
                n.update_append_at_ns(self.last_append_at_ns)
                offset = self._append_record(n)
                self.last_append_at_ns = n.append_at_ns
                if nv is None or \
                        types.stored_to_actual_offset(nv.offset) < offset:
                    self.nm.put(n.id, types.offset_to_stored(offset),
                                n.size)
                if self.last_modified_ts_seconds < n.last_modified:
                    self.last_modified_ts_seconds = n.last_modified
                seq = self._commit_register()
        self._commit_wait(seq)
        if unchanged:
            return 0, len(n.data), True
        return offset, n.size, False

    # -- group commit ------------------------------------------------------

    def _commit_register(self) -> int:
        """Mark one buffered write awaiting durability. _lock held."""
        if not self._gc_enabled:
            return 0
        with self._gc_cond:
            self._gc_seq += 1
            return self._gc_seq

    def _commit_wait(self, seq: int) -> None:
        """Block until a flush covering `seq` completed. The first waiter
        with no flush in flight becomes the leader: it flushes dat THEN
        idx under _lock (no concurrent appends), covering every write
        registered so far — followers just wait for that flush.

        Traced: inside a request span the wait lands on the
        PARENT span as `gcWaitMs` + `gcRole` attributes — the
        per-request split between "I flushed" (leader) and "I waited
        behind someone else's flush" (follower, the buffer wait the
        batching trades latency for). Attributes, not a child span: a
        span per write on the group-commit path would sit on the
        volume's serialization point, and attribution must not tax the
        very wait it measures."""
        if not self._gc_enabled or seq == 0:
            return
        from ..utils import trace

        sp = trace.current()
        if sp is None:
            self._commit_wait_inner(seq)
            return
        t0 = time.perf_counter()
        role = self._commit_wait_inner(seq)
        sp.set_attr(gcWaitMs=round((time.perf_counter() - t0) * 1e3, 3),
                    gcRole=role)

    def _commit_wait_inner(self, seq: int) -> str:
        role = "follower"
        window = _group_commit_window_s()
        while True:
            with self._gc_cond:
                if self._gc_flushed >= seq:
                    return role
                if self._gc_leader:
                    self._gc_cond.wait(1.0)
                    continue
                self._gc_leader = True
                prev = self._gc_flushed
            role = "leader"
            err: Exception | None = None
            flushed_ok = False
            target = 0
            try:
                # the leadership MUST be handed back whatever happens
                # (incl. KeyboardInterrupt mid-sleep/flush) — a wedged
                # leader flag would silently stall every writer forever
                if window:
                    time.sleep(window)
                with self._lock:
                    with self._gc_cond:
                        target = self._gc_seq
                    try:
                        from ..utils import failpoint

                        # chaos seam: error -> the frozen-volume path below;
                        # crash -> SIGKILL mid-group-commit, before any
                        # buffered byte of this batch reaches the OS
                        failpoint.fail("volume.commit.flush",
                                       ctx=f"vol={self.id},")
                        # dat first: an idx entry must never hit the OS
                        # before the record bytes it points at
                        if self._dat is not None:
                            self._dat.flush()
                        self.nm.flush()
                        # a waiter's retry drained the buffers after a
                        # transient failure: state is fully durable again
                        self._gc_frozen = False
                        flushed_ok = True
                    except Exception as e:  # noqa: BLE001 - to writers
                        err = e
                        # the in-memory map already holds entries for the
                        # un-acked writes of this batch and they cannot be
                        # selectively rolled back (appends interleave) —
                        # freeze the volume so a LATER write's flush can't
                        # silently commit bytes whose writers were told
                        # 500. Waiters still retry the flush themselves (a
                        # transient ENOSPC may clear); a restart replays
                        # the durable idx prefix and
                        # check_and_fix_integrity truncates whatever never
                        # reached the OS.
                        self._gc_frozen = True
                        from ..utils import glog

                        glog.error(f"volume {self.id}: group-commit flush "
                                   f"failed, volume frozen for writes: {e}")
            finally:
                with self._gc_cond:
                    self._gc_leader = False
                    if flushed_ok:
                        self._gc_flushed = max(self._gc_flushed, target)
                    self._gc_cond.notify_all()
            if err is not None:
                raise IOError(
                    f"volume {self.id}: group-commit flush failed: {err}")
            VOLUME_GROUP_COMMIT_FLUSHES.inc()
            VOLUME_GROUP_COMMIT_WRITES.inc(target - prev)

    def _sync_buffers(self) -> None:
        """Push buffered dat/idx bytes to the OS — for paths that read
        the files (or their sizes) directly: compaction snapshots, admin
        status RPCs, incremental copy."""
        if self._dat is not None:
            self._dat.flush()
        self.nm.flush()

    def _append_record(self, n: Needle) -> int:
        if self._dat is None:
            raise IOError(f"volume {self.id} is tiered (read only)")
        offset = self._dat_tail
        if offset is None:
            # seek_end also drains the stdio write buffer, so the cached
            # tail and the buffered stream agree from here on
            offset = self._dat.seek_end()
        if offset % types.NEEDLE_PADDING_SIZE != 0:
            # realign a torn tail (Needle.Append alignment guard)
            offset += types.NEEDLE_PADDING_SIZE - (offset % types.NEEDLE_PADDING_SIZE)
            self._dat.seek(offset)
        blob = n.to_bytes(self.version)  # also computes n.size
        from ..utils import failpoint

        if failpoint.is_armed("volume.dat.write.corrupt") \
                and len(n.data) > 0:
            # chaos hook (scrub plane): flip the first DATA byte of the
            # record as it lands on disk — the stored CRC (computed from
            # the good bytes) no longer matches, i.e. simulated bit rot
            # the background scrubber must find. Data starts after the
            # 16B header + 4B dataSize for v2/v3 (v1 has no dataSize).
            doff = types.NEEDLE_HEADER_SIZE + (
                0 if self.version == types.VERSION1 else 4)
            tail = bytes(blob[doff:])
            out = failpoint.corrupt(
                "volume.dat.write.corrupt", tail,
                ctx=f"vol={self.id}, {self.dir},")
            if out is not tail:
                blob = blob[:doff] + out
        if offset + len(blob) > types.MAX_POSSIBLE_VOLUME_SIZE:
            # past 32GB the 4-byte stored offset would wrap -> corruption
            raise IOError(
                f"volume size limit {types.MAX_POSSIBLE_VOLUME_SIZE} exceeded"
            )
        try:
            self._dat.write(blob)
            if not self._gc_enabled:
                self._dat.flush()
        except OSError:
            self._dat_tail = None
            self._dat.truncate(offset)
            raise
        self._dat_tail = offset + len(blob)
        return offset

    def _is_file_unchanged(self, n: Needle) -> bool:
        """Dedup same-content rewrite (isFileUnchanged, volume_write.go:32-52)."""
        if str(self.ttl):
            return False
        nv = self.nm.get(n.id)
        if nv is None or nv.offset == 0 or nv.size < 0:
            return False
        try:
            old = self._read_record(nv)
        except IOError:
            return False
        return (
            old.cookie == n.cookie
            and old.checksum == n.checksum
            and old.data == n.data
        )

    def delete_needle(self, needle_id: int, cookie: int | None = None) -> int:
        """Append a zero-size deletion marker + tombstone the map
        (doDeleteRequest, volume_write.go:209-230). -> freed size."""
        with self._lock:
            if self.read_only:
                raise IOError(f"volume {self.id} is read only")
            if self._gc_frozen:
                raise IOError(f"volume {self.id} is frozen: a previous "
                              f"group-commit flush failed")
            if self.native is not None:
                return self._native_delete(needle_id, cookie)
            nv = self.nm.get(needle_id)
            if nv is None or nv.offset == 0 or nv.size < 0:
                return 0
            if cookie is not None:
                existing = self._read_header_at(
                    types.stored_to_actual_offset(nv.offset)
                )
                if existing.cookie != cookie:
                    raise CookieMismatch("cookie mismatch on delete")
            size = nv.size
            marker = Needle(id=needle_id, cookie=cookie or 0)
            marker.update_append_at_ns(self.last_append_at_ns)
            offset = self._append_record(marker)
            self.last_append_at_ns = marker.append_at_ns
            self.nm.delete(needle_id, types.offset_to_stored(offset))
            seq = self._commit_register()
        self._commit_wait(seq)
        return size

    def _native_delete(self, needle_id: int, cookie: int | None) -> int:
        old_blob = self.native.read_blob(self.id, needle_id)
        if old_blob is None:
            return 0
        old = Needle.from_bytes(old_blob, self.version, check_crc=False)
        if cookie is not None and old.cookie != cookie:
            raise CookieMismatch("cookie mismatch on delete")
        marker = Needle(id=needle_id, cookie=cookie or 0)
        blob = marker.to_bytes(self.version)
        ns_off = types.NEEDLE_HEADER_SIZE + types.NEEDLE_CHECKSUM_SIZE
        _, ns = self.native.append_record(
            self.id, needle_id, blob, types.TOMBSTONE_FILE_SIZE,
            ns_off if self.version == types.VERSION3 else -1)
        self.last_append_at_ns = max(self.last_append_at_ns, ns)
        return old.size

    # -- read path ---------------------------------------------------------

    # -- scrub quarantine --------------------------------------------------

    def quarantine(self, needle_id: int) -> None:
        """Refuse to serve this needle's local bytes until unquarantined
        (scrub found the record corrupt; repair is in flight)."""
        self.quarantined.add(needle_id)

    def unquarantine(self, needle_id: int) -> None:
        self.quarantined.discard(needle_id)

    def read_needle(self, needle_id: int, cookie: int | None = None) -> Needle:
        """readNeedle (volume_read.go:19-72): map lookup, record read, CRC,
        cookie + TTL checks."""
        if self.quarantined and needle_id in self.quarantined:
            raise QuarantinedError(self.id, needle_id)
        if self.native is not None:
            blob = self.native.read_blob(self.id, needle_id)
            if blob is None:
                raise NotFoundError(f"needle {needle_id:x} not found")
            n = Needle.from_bytes(blob, self.version)
            if cookie is not None and n.cookie != cookie:
                raise CookieMismatch(
                    f"cookie mismatch: read {n.cookie:x} expected {cookie:x}"
                )
            if n.has_expired():
                raise NotFoundError(f"needle {needle_id:x} expired")
            return n
        nv = self.nm.get(needle_id)
        if nv is None or nv.offset == 0:
            raise NotFoundError(f"needle {needle_id:x} not found")
        if types.size_is_deleted(nv.size):
            raise DeletedError(f"needle {needle_id:x} deleted")
        n = self._read_record(nv)
        if cookie is not None and n.cookie != cookie:
            raise CookieMismatch(
                f"cookie mismatch: read {n.cookie:x} expected {cookie:x}"
            )
        if n.has_expired():
            raise NotFoundError(f"needle {needle_id:x} expired")
        return n

    def _read_record(self, nv: NeedleValue) -> Needle:
        offset = types.stored_to_actual_offset(nv.offset)
        length = types.actual_size(nv.size, self.version)
        blob = self._pread_durable(offset, length)
        if len(blob) < length:
            raise IOError("short needle read")
        return Needle.from_bytes(blob, self.version, expected_size=nv.size)

    def read_needle_blob(self, offset: int, size: int) -> bytes:
        """Raw record bytes (ReadNeedleBlob) for replication/EC streaming."""
        length = types.actual_size(size, self.version)
        blob = self._pread_durable(offset, length)
        if len(blob) < length:
            raise IOError("short needle blob read")
        return blob

    # -- integrity (volume_checking.go) ------------------------------------

    def check_and_fix_integrity(self) -> None:
        """Startup repair (CheckAndFixVolumeDataIntegrity, volume_checking.go:17):
        verify the last .idx entry points at a well-formed record in .dat;
        truncate torn appends off both files."""
        from . import idx as idx_mod

        if not os.path.getsize(self.nm.idx_path):
            return
        ids, offs, sizes = idx_mod.read_index_file(self.nm.idx_path)
        dat_size = self.data_size()
        keep = len(ids)
        while keep > 0:
            off = types.stored_to_actual_offset(int(offs[keep - 1]))
            size = int(sizes[keep - 1])
            if size == types.TOMBSTONE_FILE_SIZE:
                break  # tombstones carry the deletion-marker offset; trust them
            end = off + types.actual_size(max(size, 0), self.version)
            if end <= dat_size and self._verify_needle_at(off, int(ids[keep - 1]), size):
                break
            keep -= 1
        if keep < len(ids):
            with open(self.nm.idx_path, "r+b") as f:
                f.truncate(keep * types.NEEDLE_MAP_ENTRY_SIZE)
            # drop torn .dat tail past the last good record
            if keep:
                off = types.stored_to_actual_offset(int(offs[keep - 1]))
                size = int(sizes[keep - 1])
                end = off + types.actual_size(max(size, 0), self.version)
            else:
                end = self.super_block.block_size
            self._dat.truncate(end)
            self._dat.flush()
            self._dat_tail = None
            # reload the map from the repaired idx
            self.nm.close()
            self.nm = self._new_needle_map(self.nm.idx_path)

    def _verify_needle_at(self, offset: int, needle_id: int, size: int) -> bool:
        """verifyNeedleIntegrity (volume_checking.go:88): id matches and the
        record parses with a valid CRC."""
        try:
            n = self._read_header_at(offset)
            if n.id != needle_id:
                return False
            if size >= 0 and n.size != size:
                return False
            blob = self._pread(offset, types.actual_size(n.size, self.version))
            Needle.from_bytes(blob, self.version)
            return True
        except (IOError, EOFError, ValueError):
            return False

    # -- scanning ----------------------------------------------------------

    def scan_needles(self, strict: bool = True):
        """Yield (needle, offset) for every record in .dat append order
        (ScanVolumeFile semantics). A partial record at EOF ends the scan;
        an unparsable record mid-file raises IOError when `strict` (the
        reference aborts compaction on scan errors rather than silently
        truncating)."""
        offset = self.super_block.block_size
        dat_size = self.data_size()
        while offset + types.NEEDLE_HEADER_SIZE <= dat_size:
            n = self._read_header_at(offset)
            total = types.NEEDLE_HEADER_SIZE + needle_body_length(
                max(n.size, 0), self.version
            )
            if offset + total > dat_size:
                return  # torn tail
            blob = self._pread(offset, total)
            try:
                full = Needle.from_bytes(blob, self.version, check_crc=False)
            except (IOError, ValueError) as e:
                if strict:
                    raise IOError(
                        f"volume {self.id}: corrupt record at offset {offset}: {e}"
                    )
                return
            yield full, offset
            offset += total

    # -- vacuum (volume_vacuum.go) -----------------------------------------

    def compact(self) -> None:
        """Compact2 (volume_vacuum.go:67): copy live needles into .cpd/.cpx.

        Scrub-aware: compaction reads every
        live record anyway, so each one is CRC re-verified as it is
        copied — for free, byte-wise. A mismatch ABORTS the vacuum (a
        compacted volume must never launder rot into a freshly-written
        .dat where the scrubber would re-find it with no healthy replica
        journal behind it) and surfaces the needle id for the repair
        ladder; after a clean commit the vacuum is published as a
        completed scrub pass (scrub.scrubber.record_vacuum_pass).
        SWFS_VACUUM_VERIFY=0 restores the old unverified copy."""
        verify = os.environ.get("SWFS_VACUUM_VERIFY", "1").lower() \
            not in ("0", "false", "off")
        with self._lock:
            if self._dat is None:
                raise IOError(
                    f"volume {self.id} is tiered; download before vacuum")
            self.is_compacting = True
            self._sync_buffers()  # the snapshot must cover buffered writes
            self.nm.catchup_from_idx()  # native plane may have appended
            self._compact_idx_snapshot = os.path.getsize(self.nm.idx_path)
        self._vacuum_verified = None
        try:
            base = self.file_name()
            new_sb = self.super_block.bump_compaction()
            checked_needles = checked_bytes = 0
            with open(base + ".cpd", "wb") as dst:
                dst.write(new_sb.to_bytes())
                from .needle_map import MemDb

                newdb = MemDb()
                for n, _off in self.scan_needles():
                    nv = self.nm.get(n.id)
                    if nv is None or types.size_is_deleted(nv.size):
                        continue
                    if types.stored_to_actual_offset(nv.offset) != _off:
                        continue  # superseded by a later rewrite
                    if n.has_expired():
                        continue
                    if verify:
                        if not n.crc_ok():
                            from .errors import VacuumCrcError

                            raise VacuumCrcError(self.id, n.id, _off)
                        checked_needles += 1
                        checked_bytes += len(n.data)
                    new_off = dst.tell()
                    dst.write(n.to_bytes(self.version))
                    newdb.set(n.id, types.offset_to_stored(new_off), n.size)
            with open(base + ".cpx", "wb") as f:
                f.write(newdb.to_sorted_bytes())
            if verify:
                self._vacuum_verified = (checked_needles, checked_bytes)
        except BaseException:
            self.is_compacting = False
            raise

    def commit_compact(self) -> None:
        """CommitCompact (volume_vacuum.go:102): catch up writes since the
        snapshot (makeupDiff), atomically swap .cpd/.cpx into place."""
        base = self.file_name()
        with self._lock:
            # freeze the C++ writer: anything it appended before the freeze
            # is caught by _makeup_diff's idx-tail replay; nothing may land
            # in the old .dat after the replay reads the tail
            if self.native is not None:
                self.native.set_writable(self.id, False)
            self._sync_buffers()  # the diff replay reads the idx FILE
            self._makeup_diff(base + ".cpd", base + ".cpx")
            self._dat.close()
            self.nm.close()
            os.replace(base + ".cpd", base + ".dat")
            from ..utils import failpoint

            # chaos seam between the two renames: a crash here leaves
            # .cpx without .cpd, the one state the recovery ladder must
            # roll FORWARD (the new .dat is already live)
            failpoint.fail("volume.vacuum.commit", ctx=base + ",")
            os.replace(base + ".cpx", base + ".idx")
            from .backend import DiskFile

            self._dat = DiskFile(base + ".dat")
            self._dat_tail = None
            self.super_block = SuperBlock.from_file(self._dat)
            self.nm = self._new_needle_map(base + ".idx")
            self.is_compacting = False
            if self.native is not None:
                if self.native.reload_volume(self.id):
                    # restore the REGISTRY's writability decision, not
                    # blanket True: replicated/TTL volumes must keep
                    # redirecting PUTs
                    self.native.set_writable(self.id, self.native_writable)
                else:
                    # the plane dropped the volume (failed reopen):
                    # detach so the python engine serves it — stale
                    # plane state must never answer for it again
                    self.native = None
            # extent of the freshly-committed, CRC-verified .dat — read
            # under the lock so appends racing the publication below are
            # never claimed as verified
            verified_end = self.data_size()
        # scrub-aware vacuum: every live record was CRC re-verified on
        # the way into the new .dat, so publish the vacuum as a completed
        # scrub pass — cursor (.scb) at the new revision, fresh digest
        # manifest (.dig), sweep counters credited. Outside the volume
        # lock (the digest pass re-reads every CRC tail) and best-effort:
        # a failed publication must never fail the committed vacuum.
        verified, self._vacuum_verified = self._vacuum_verified, None
        if verified is not None:
            # lint: allow-broad-except(the vacuum is committed; a failed
            # publication is logged and the next scrub pass covers it)
            try:
                from ..scrub.scrubber import record_vacuum_pass

                record_vacuum_pass(self, *verified,
                                   verified_end=verified_end)
            except Exception as e:  # noqa: BLE001
                from ..utils import glog

                glog.warning(
                    f"volume {self.id}: vacuum scrub-pass publication "
                    f"failed: {e}")

    def _makeup_diff(self, cpd: str, cpx: str) -> None:
        """Replay .idx entries appended after the compaction snapshot onto
        the compacted copies (makeupDiff, volume_vacuum.go:200-280)."""
        from .needle_map import read_needle_map

        with open(self.nm.idx_path, "rb") as f:
            f.seek(self._compact_idx_snapshot)
            tail = f.read()
        if not tail:
            return
        newdb = read_needle_map(cpx)
        with open(cpd, "r+b") as dst:
            for i in range(0, len(tail) - (types.NEEDLE_MAP_ENTRY_SIZE - 1),
                           types.NEEDLE_MAP_ENTRY_SIZE):
                key, off, size = types.unpack_needle_map_entry(
                    tail[i : i + types.NEEDLE_MAP_ENTRY_SIZE]
                )
                if off != 0 and size >= 0:  # same liveness as _apply
                    nv = NeedleValue(off, size)
                    n = self._read_record(nv)
                    dst.seek(0, 2)
                    new_off = dst.tell()
                    dst.write(n.to_bytes(self.version))
                    newdb.set(key, types.offset_to_stored(new_off), n.size)
                else:
                    newdb.delete(key)
        with open(cpx, "wb") as f:
            f.write(newdb.to_sorted_bytes())

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            if self.native is not None:
                self.native.remove_volume(self.id)
                self.native = None
            if self._dat is not None:
                self._dat.close()
            self.nm.close()

    # -- tiering (volume_tier.go + VolumeTierMoveDat* RPC backends) --------

    def tier_key(self) -> str:
        prefix = f"{self.collection}_" if self.collection else ""
        return f"{prefix}{self.id}.dat"

    def tier_to_remote(self, backend, keep_local: bool = False,
                       progress_fn=None) -> int:
        """Upload the sealed .dat to a tier backend; reads then range-fetch
        remotely. -> bytes moved."""
        from .backend import RemoteDatFile, write_tier_sidecar

        with self._lock:
            if self._dat is None:
                raise IOError(f"volume {self.id} is already tiered")
            was_read_only = self.read_only
            self.read_only = True
            try:
                self._dat.flush()
                base = self.file_name()
                size = self.data_size()
                moved = backend.upload(self.tier_key(), base + ".dat")
            except BaseException:
                self.read_only = was_read_only  # failed upload: stay local
                raise
            if progress_fn:
                progress_fn(moved)
            write_tier_sidecar(base, backend.name, self.tier_key(), size)
            self._dat.close()
            self._dat = None
            self._dat_tail = None
            self.remote_dat = RemoteDatFile(backend, self.tier_key(), size)
            if not keep_local:
                os.remove(base + ".dat")
            return moved

    def tier_from_remote(self, keep_remote: bool = False,
                         progress_fn=None) -> int:
        """Bring a tiered .dat back to local disk. -> bytes moved."""
        from .backend import tier_sidecar_path

        with self._lock:
            if self.remote_dat is None:
                raise IOError(f"volume {self.id} is not tiered")
            base = self.file_name()
            moved = self.remote_dat.backend.download(
                self.remote_dat.key, base + ".dat")
            if progress_fn:
                progress_fn(moved)
            if not keep_remote:
                self.remote_dat.backend.delete(self.remote_dat.key)
            os.remove(tier_sidecar_path(base))
            from .backend import DiskFile

            self.remote_dat = None
            self._dat = DiskFile(base + ".dat")
            self._dat_tail = None
            self.read_only = False
            return moved

    def destroy(self) -> None:
        """Remove every file of this volume (Destroy, volume_write.go:55-85).

        Keeps the .vif sidecar while EC artifacts share the base name: after
        ec.encode deletes the plain volume, the shards still need the
        geometry/version recorded there (the reference re-creates a default
        .vif on EC load, ec_volume.go:66-71; we preserve the real one)."""
        base = self.file_name()
        self.close()
        exts = [".dat", ".idx", ".sdx", ".cpd", ".cpx", ".note"]
        if not os.path.exists(base + ".ecx"):
            exts.append(".vif")
        for ext in exts:
            try:
                os.remove(base + ext)
            except FileNotFoundError:
                pass
