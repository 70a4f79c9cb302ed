"""Store: per-volume-server registry of disk locations, volumes, EC shards.

Counterpart of seaweedfs_tpu/storage/store.py (SeaweedFS
weed/storage/store.go: Store, WriteVolumeNeedle :386, ReadVolumeNeedle
:410, CollectHeartbeat :249; disk_location.go; disk_location_ec.go:134
loadAllEcShards). A Store owns N directories; each directory holds
`.dat/.idx` volume pairs plus `.ec00..` shard sets, all discovered at
startup.

The store's coder is ``new_coder()`` unless the caller passes one, so a
store runs its EC work on the CUDA device by default; ``coder_for``
builds every other geometry's coder on that coder's own backend and
device (a store built on a CPU coder never reaches for the card).
"""

from __future__ import annotations

import os
import re
import threading

from ..pb import master_pb2
from . import types
from .ec_locate import Geometry
from .ec_volume import EcVolume
from .errors import NotFoundError
from .needle import Needle
from .super_block import ReplicaPlacement
from .ttl import EMPTY_TTL, TTL
from .volume import Volume

_VOLUME_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.dat$")
_TIER_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.tier$")
_ECX_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.ecx$")


class DiskLocation:
    """One data directory (disk_location.go)."""

    def __init__(self, directory: str, max_volume_count: int = 8,
                 disk_type: str = ""):
        self.directory = os.path.abspath(directory)
        self.max_volume_count = max_volume_count
        self.disk_type = disk_type
        self.volumes: dict[int, Volume] = {}
        self.ec_volumes: dict[int, EcVolume] = {}
        os.makedirs(self.directory, exist_ok=True)

    def base_name(self, collection: str, vid: int) -> str:
        prefix = f"{collection}_" if collection else ""
        return os.path.join(self.directory, f"{prefix}{vid}")

    def scan(self) -> tuple[dict[int, tuple[str, str]], dict[int, tuple[str, str]]]:
        """-> ({vid: (collection, dat_path)}, {vid: (collection, ecx_path)})"""
        vols: dict[int, tuple[str, str]] = {}
        ecs: dict[int, tuple[str, str]] = {}
        for name in os.listdir(self.directory):
            m = _VOLUME_RE.match(name)
            if m:
                vols[int(m.group("vid"))] = (
                    m.group("col") or "", os.path.join(self.directory, name)
                )
                continue
            m = _TIER_RE.match(name)
            if m:
                # tiered volume: .dat moved to a remote backend, .tier
                # sidecar + local .idx remain
                vols.setdefault(
                    int(m.group("vid")),
                    (m.group("col") or "",
                     os.path.join(self.directory, name)))
                continue
            m = _ECX_RE.match(name)
            if m:
                ecs[int(m.group("vid"))] = (
                    m.group("col") or "", os.path.join(self.directory, name)
                )
        return vols, ecs


class Store:
    """Volume-server storage root (store.go:57-99)."""

    def __init__(self, directories: list[str], *, coder=None,
                 max_volume_counts: list[int] | None = None,
                 ip: str = "", port: int = 0, public_url: str = "",
                 grpc_port: int = 0, data_center: str = "", rack: str = "",
                 needle_map_kind: str = "memory"):
        from ..models.coder import new_coder

        self.ip = ip
        self.port = port
        self.public_url = public_url or (f"{ip}:{port}" if ip else "")
        self.grpc_port = grpc_port
        self.data_center = data_center
        self.rack = rack
        self.coder = coder or new_coder()
        self.needle_map_kind = needle_map_kind
        self._lock = threading.RLock()
        # per-code-geometry coder cache: volumes carrying a
        # different generator matrix (or shard counts) than the default
        # coder get their own — each owns its own dispatch scheduler, so
        # mixed-geometry slabs can never share a stacked device dispatch
        self._geo_coders: dict[str, object] = {}
        self.locations: list[DiskLocation] = []
        counts = max_volume_counts or [8] * len(directories)
        for d, c in zip(directories, counts):
            self.locations.append(DiskLocation(d, c))
        # crash-consistency ladder: if the previous process
        # died with the dirty marker still down, repair every location
        # FILE-LEVEL before any Volume/EcVolume runtime opens the files
        # (and before the epoch stamper reads the incarnation sidecar);
        # recover_store also re-arms the markers for THIS incarnation —
        # close() lifts them, so an unlifted marker at the next mount is
        # the unclean-shutdown signal
        from . import recovery as recovery_mod

        self.recovery_report = recovery_mod.recover_store(
            [loc.directory for loc in self.locations])
        # replica-epoch causality mint: one incarnation bump
        # per store start, attached to every volume this store serves
        from .epoch import EpochStamper

        self.epoch_stamper = EpochStamper(
            self.locations[0].directory,
            f"{ip}:{port}" if ip or port else "")
        self.load_existing_volumes()
        # deltas accumulated for incremental heartbeats
        self.new_volumes: list[master_pb2.VolumeShortInformationMessage] = []
        self.deleted_volumes: list[master_pb2.VolumeShortInformationMessage] = []

    # -- loading (disk_location.go loadExistingVolumes /
    #    disk_location_ec.go loadAllEcShards) ------------------------------

    def load_existing_volumes(self) -> None:
        from ..utils import glog

        for loc in self.locations:
            vols, ecs = loc.scan()
            for vid, (col, _path) in vols.items():
                if vid not in loc.volumes:
                    try:
                        v = Volume(loc.directory, col, vid,
                            needle_map_kind=self.needle_map_kind)
                        v.epoch_stamper = self.epoch_stamper
                        loc.volumes[vid] = v
                    except Exception as e:
                        # one unloadable volume (e.g. a .tier sidecar whose
                        # backend isn't configured) must not down the server
                        glog.error(f"skip loading volume {vid}: {e}")
            for vid, (col, _path) in ecs.items():
                if vid not in loc.ec_volumes:
                    try:
                        loc.ec_volumes[vid] = EcVolume(
                            loc.base_name(col, vid), self.coder,
                            coder_for=self.coder_for,
                        )
                        loc.ec_volumes[vid].collection = col
                    except FileNotFoundError:
                        pass  # .ecx without local shards
                    except ValueError as e:
                        # unregistered code geometry in the .vif: refuse
                        # to serve bytes we cannot decode, keep the rest
                        glog.error(f"skip loading ec volume {vid}: {e}")

    # -- volume lifecycle --------------------------------------------------

    def has_volume(self, vid: int) -> bool:
        return self.find_volume(vid) is not None

    def find_volume(self, vid: int) -> Volume | None:
        for loc in self.locations:
            v = loc.volumes.get(vid)
            if v is not None:
                return v
        return None

    def coder_for(self, geo: Geometry):
        """The coder matching a volume's code geometry — the store's own
        when it already speaks it (the common all-default case), else a
        cached per-geometry coder on the store coder's backend and
        device."""
        name = geo.code_name
        mine = getattr(self.coder, "geometry_id",
                       f"rs_{self.coder.data_shards}_"
                       f"{self.coder.parity_shards}")
        if name == mine:
            return self.coder
        with self._lock:
            got = self._geo_coders.get(name)
            if got is None:
                got = self._geo_coders[name] = _coder_like(
                    self.coder, geo.data_shards, geo.parity_shards,
                    geo.code_geometry())
            return got

    def find_ec_volume(self, vid: int) -> EcVolume | None:
        for loc in self.locations:
            v = loc.ec_volumes.get(vid)
            if v is not None:
                return v
        return None

    def location_of(self, vid: int) -> DiskLocation | None:
        for loc in self.locations:
            if vid in loc.volumes or vid in loc.ec_volumes:
                return loc
        return None

    def _pick_location(self, disk_type: str | None = None) -> DiskLocation:
        """Most-free location, optionally restricted to one disk type
        (store.go findFreeLocation's diskType filter)."""
        with self._lock:
            candidates = self.locations
            if disk_type is not None:
                want = "" if disk_type == "hdd" else disk_type
                candidates = [l for l in self.locations
                              if (l.disk_type or "") == want]
                if not candidates:
                    raise IOError(
                        f"no volume directory with disk type {disk_type!r}")
            best = max(
                candidates,
                key=lambda l: l.max_volume_count - len(l.volumes),
            )
            if l_free(best) <= 0:
                raise IOError("no free volume slots on this server")
            return best

    def add_volume(self, vid: int, collection: str = "",
                   replication: str = "", ttl: str = "") -> Volume:
        """AllocateVolume handler (store.go:198 AddVolume)."""
        with self._lock:
            if self.has_volume(vid):
                raise ValueError(f"volume {vid} already exists")
            loc = self._pick_location()
            rp = ReplicaPlacement.parse(replication) if replication else ReplicaPlacement()
            t = TTL.parse(ttl) if ttl else EMPTY_TTL
            v = Volume(loc.directory, collection, vid, replica_placement=rp,
                       ttl=t, needle_map_kind=self.needle_map_kind)
            v.epoch_stamper = self.epoch_stamper
            loc.volumes[vid] = v
            self.new_volumes.append(master_pb2.VolumeShortInformationMessage(
                id=vid, collection=collection,
                replica_placement=rp.to_byte(), version=v.version,
                ttl=t.to_uint32(),
            ))
            return v

    def delete_volume(self, vid: int, only_empty: bool = False) -> None:
        with self._lock:
            for loc in self.locations:
                v = loc.volumes.get(vid)
                if v is None:
                    continue
                if only_empty and v.file_count() > 0:
                    raise ValueError(f"volume {vid} is not empty")
                info = master_pb2.VolumeShortInformationMessage(
                    id=vid, collection=v.collection,
                    replica_placement=v.super_block.replica_placement.to_byte(),
                    version=v.version, ttl=v.ttl.to_uint32(),
                )
                v.destroy()
                del loc.volumes[vid]
                self.deleted_volumes.append(info)
                return
            raise NotFoundError(f"volume {vid} not found")

    def mount_volume(self, vid: int) -> None:
        for loc in self.locations:
            vols, _ = loc.scan()
            if vid in vols:
                col, _ = vols[vid]
                v = Volume(loc.directory, col, vid,
                           needle_map_kind=self.needle_map_kind)
                v.epoch_stamper = self.epoch_stamper
                loc.volumes[vid] = v
                return
        raise NotFoundError(f"volume {vid} not found on disk")

    def unmount_volume(self, vid: int) -> None:
        with self._lock:
            for loc in self.locations:
                v = loc.volumes.pop(vid, None)
                if v is not None:
                    v.close()
                    return
            raise NotFoundError(f"volume {vid} not mounted")

    def delete_collection(self, collection: str) -> None:
        with self._lock:
            for loc in self.locations:
                for vid, v in list(loc.volumes.items()):
                    if v.collection == collection:
                        v.destroy()
                        del loc.volumes[vid]
                for vid, ev in list(loc.ec_volumes.items()):
                    if getattr(ev, "collection", "") == collection:
                        ev.close()
                        del loc.ec_volumes[vid]

    # -- needle ops (store.go:386,410) -------------------------------------

    def write_needle(self, vid: int, n: Needle, check_cookie: bool = True):
        v = self.find_volume(vid)
        if v is None:
            raise NotFoundError(f"volume {vid} not found")
        return v.write_needle(n, check_cookie=check_cookie)

    def read_needle(self, vid: int, needle_id: int, cookie: int | None = None) -> Needle:
        v = self.find_volume(vid)
        if v is None:
            raise NotFoundError(f"volume {vid} not found")
        return v.read_needle(needle_id, cookie)

    def delete_needle(self, vid: int, needle_id: int, cookie: int | None = None) -> int:
        v = self.find_volume(vid)
        if v is None:
            raise NotFoundError(f"volume {vid} not found")
        return v.delete_needle(needle_id, cookie)

    # -- EC runtime --------------------------------------------------------

    def mount_ec_shards(self, vid: int, collection: str, shard_ids: list[int]) -> None:
        """Open (or re-open) the EC volume after new shard files arrived
        (store_ec.go:25 MountEcShards).

        The OLD runtime is NOT closed here: in-flight readers (degraded
        reads, the scrub sweep) may still hold it, and closing its mmaps
        under them turns a routine remount — including the scrub plane's
        rebuild-then-remount repair — into client-visible 500s. Dropping
        the reference is enough: refcounting closes the mmaps the moment
        the last reader returns."""
        with self._lock:
            for loc in self.locations:
                base = loc.base_name(collection, vid)
                if os.path.exists(base + ".ecx"):
                    ev = EcVolume(base, self.coder,
                                  coder_for=self.coder_for)
                    ev.collection = collection
                    # single dict assignment: concurrent readers see the
                    # old runtime or the new one, never a gap (a pop
                    # first would 404 reads racing a remount)
                    loc.ec_volumes[vid] = ev
                    return
            raise NotFoundError(f"no .ecx for EC volume {vid}")

    def unmount_ec_shards(self, vid: int, shard_ids: list[int] | None = None) -> None:
        with self._lock:
            for loc in self.locations:
                ev = loc.ec_volumes.get(vid)
                if ev is None:
                    continue
                # teardown deferred to GC, as in mount_ec_shards: reads
                # already past find_ec_volume() complete against the old
                # runtime instead of crashing on a closed mmap
                del loc.ec_volumes[vid]
                return

    # -- heartbeat (store.go:249 CollectHeartbeat + store_ec.go:25) --------

    def collect_heartbeat(self) -> master_pb2.Heartbeat:
        hb = master_pb2.Heartbeat(
            ip=self.ip, port=self.port, public_url=self.public_url,
            grpc_port=self.grpc_port,
            data_center=self.data_center, rack=self.rack,
        )
        max_file_key = 0
        # snapshot the volume maps: this runs on the heartbeat stream's
        # request generator while AllocateVolume / unmount / EC mounts
        # mutate them from gRPC handler threads. Iterating live dicts
        # raised "dictionary changed size during iteration" under volume
        # churn, which killed the heartbeat STREAM — and a broken stream
        # unregisters the whole node, flapping the master topology
        # (found by the reference's cluster harness).
        for loc in self.locations:
            hb.max_volume_counts[loc.disk_type or ""] = (
                hb.max_volume_counts.get(loc.disk_type or "", 0)
                + loc.max_volume_count
            )
            for vid, v in list(loc.volumes.items()):
                # under the volume's lock: a vacuum commit swaps .dat and
                # .idx with both closed, and a volume skipped from this
                # full-state report is unregistered from the master's
                # layout until the next pulse
                try:
                    with v._lock:
                        info = master_pb2.VolumeInformationMessage(
                            id=vid, size=v.data_size(),
                            collection=v.collection,
                            file_count=v.file_count(),
                            delete_count=v.deleted_count(),
                            deleted_byte_count=v.deleted_size(),
                            # a flush-frozen volume must leave the
                            # master's writable set like a read-only one
                            read_only=v.read_only or v._gc_frozen,
                            replica_placement=v.super_block
                            .replica_placement.to_byte(),
                            version=v.version, ttl=v.ttl.to_uint32(),
                            compact_revision=v.super_block
                            .compaction_revision,
                            modified_at_second=int(
                                v.last_modified_ts_seconds),
                        )
                        file_key = v.nm.max_file_key
                except (OSError, ValueError, AttributeError):
                    continue  # mid-unmount; the next pulse reconciles
                hb.volumes.append(info)
                max_file_key = max(max_file_key, file_key)
            for vid, ev in list(loc.ec_volumes.items()):
                bits = 0
                for sid in list(ev.shard_files):
                    bits |= 1 << sid
                hb.ec_shards.append(master_pb2.VolumeEcShardInformationMessage(
                    id=vid, collection=getattr(ev, "collection", ""),
                    ec_index_bits=bits,
                ))
        hb.max_file_key = max_file_key
        hb.has_no_volumes = len(hb.volumes) == 0
        hb.has_no_ec_shards = len(hb.ec_shards) == 0
        return hb

    def close(self) -> None:
        # idempotent: tests (and belt-and-braces teardown paths) close a
        # store twice — the second call must not re-close volumes or
        # re-join the dispatch flusher thread (a double-join against an
        # already-dead flusher used to be able to hang the teardown)
        if getattr(self, "_closed", False):
            return
        self._closed = True
        for loc in self.locations:
            for v in loc.volumes.values():
                v.close()
            for ev in loc.ec_volumes.values():
                ev.close()
            loc.volumes.clear()
            loc.ec_volumes.clear()
        # the EC dispatch scheduler attached to this store's coder (if any
        # EC work ran) owns a flusher thread — flush + join it so tests
        # and restarts never leak one (close() itself is idempotent too,
        # so atexit's shutdown_all and this call compose in any order)
        for coder in (self.coder, *self._geo_coders.values()):
            sched = getattr(coder, "_ec_dispatch_sched", None)
            if sched is not None:
                sched.close()
        # clean shutdown: lift the dirty markers LAST — everything above
        # flushed and closed, so the next mount can trust the disk
        from . import recovery as recovery_mod

        for loc in self.locations:
            recovery_mod.clear_dirty(loc.directory)


def _coder_like(coder, data_shards: int, parity_shards: int, geometry):
    """A coder for `geometry` on `coder`'s own backend and device: the
    torch codec on the same device, the mesh coder over the same devices
    with the same kernel, the host codec (numpy or native) with the same
    backend reason. Any other coder goes through the registry's default,
    as in the reference."""
    from ..ops.rs_cpu import RSCodecCPU
    from ..ops.rs_torch import RSCodecTorch
    from ..parallel.mesh import ShardedCoder

    if isinstance(coder, RSCodecTorch):
        return RSCodecTorch(data_shards, parity_shards, geometry=geometry,
                            device=coder.device)
    if isinstance(coder, ShardedCoder):
        return ShardedCoder(data_shards, parity_shards, mesh=coder.mesh,
                            kernel=coder.kernel, geometry=geometry)
    if isinstance(coder, RSCodecCPU):
        got = type(coder)(data_shards, parity_shards, geometry=geometry)
        got.backend_reason = getattr(coder, "backend_reason", "cpu_explicit")
        return got
    from ..models.coder import new_coder

    return new_coder(data_shards, parity_shards, geometry=geometry)


def l_free(loc: DiskLocation) -> int:
    return loc.max_volume_count - len(loc.volumes)
