"""Cluster topology: node registry, volume layouts, EC shard map.

Counterpart of seaweedfs_tpu/topology/topology.py (SeaweedFS
weed/topology/topology.go:28-54, node.go, volume_layout.go,
topology_ec.go). Where the reference keeps a DC→Rack→DataNode→Disk tree
with usage counters rolled up on every mutation, this build keeps a flat
`DataNode` registry and derives groupings/rollups with comprehensions —
the tree was an artifact of hand-maintained counters, not of the domain.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..pb import master_pb2
from ..storage.super_block import ReplicaPlacement
from ..storage.ttl import EMPTY_TTL, TTL


@dataclass
class VolumeInfo:
    """Master-side record of one volume replica (storage.VolumeInfo)."""

    id: int
    size: int = 0
    collection: str = ""
    file_count: int = 0
    delete_count: int = 0
    deleted_byte_count: int = 0
    read_only: bool = False
    replica_placement: ReplicaPlacement = field(default_factory=ReplicaPlacement)
    version: int = 3
    ttl: TTL = field(default_factory=lambda: EMPTY_TTL)
    disk_type: str = ""
    modified_at_second: int = 0

    @classmethod
    def from_pb(cls, m: master_pb2.VolumeInformationMessage) -> "VolumeInfo":
        return cls(
            id=m.id, size=m.size, collection=m.collection,
            file_count=m.file_count, delete_count=m.delete_count,
            deleted_byte_count=m.deleted_byte_count, read_only=m.read_only,
            replica_placement=ReplicaPlacement.from_byte(m.replica_placement),
            version=m.version or 3, ttl=TTL.from_uint32(m.ttl),
            disk_type=m.disk_type, modified_at_second=m.modified_at_second,
        )

    def to_pb(self) -> master_pb2.VolumeInformationMessage:
        return master_pb2.VolumeInformationMessage(
            id=self.id, size=self.size, collection=self.collection,
            file_count=self.file_count, delete_count=self.delete_count,
            deleted_byte_count=self.deleted_byte_count, read_only=self.read_only,
            replica_placement=self.replica_placement.to_byte(),
            version=self.version, ttl=self.ttl.to_uint32(),
            disk_type=self.disk_type, modified_at_second=self.modified_at_second,
        )


class DataNode:
    """One volume server as seen by the master (data_node.go)."""

    def __init__(self, ip: str, port: int, public_url: str = "",
                 grpc_port: int = 0, data_center: str = "DefaultDataCenter",
                 rack: str = "DefaultRack", max_volume_count: int = 8):
        self.ip = ip
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        self.grpc_port = grpc_port or port + 10000
        self.data_center = data_center
        self.rack = rack
        self.max_volume_count = max_volume_count
        self.volumes: dict[int, VolumeInfo] = {}
        self.ec_shards: dict[int, "EcShardInfo"] = {}  # vid -> bits
        self.last_seen = time.time()
        self.max_file_key = 0
        # integrity plane: when the master last asked this node to run a
        # scrub pass (next_scrub_targets round-robins on it)
        self.last_scrub = 0.0
        # QoS plane: last backpressure score this node reported
        # on a QosGrant lease refresh, and when — stale reports decay to
        # 0 in effective_pressure so a silent node can't repel placement
        self.qos_pressure = 0.0
        self.qos_pressure_at = 0.0

    def effective_pressure(self, max_age_s: float = 15.0) -> float:
        if time.time() - self.qos_pressure_at > max_age_s:
            return 0.0
        return self.qos_pressure

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    @property
    def grpc_address(self) -> str:
        return f"{self.ip}:{self.grpc_port}"

    def free_space(self) -> int:
        # EC shards count fractionally against capacity (erasure_coding/ec_volume_info.go ShardBits)
        ec = sum(bin(e.bits).count("1") for e in self.ec_shards.values())
        return self.max_volume_count - len(self.volumes) - (ec + 13) // 14

    def to_location(self) -> master_pb2.Location:
        return master_pb2.Location(
            url=self.url, public_url=self.public_url,
            grpc_port=self.grpc_port, data_center=self.data_center,
        )


@dataclass
class EcShardInfo:
    """Which shards of an EC volume a node holds (ShardBits bitmask,
    ec_volume_info.go)."""

    volume_id: int
    collection: str = ""
    bits: int = 0

    def shard_ids(self) -> list[int]:
        return [i for i in range(32) if self.bits >> i & 1]

    def add(self, *ids: int) -> None:
        for i in ids:
            self.bits |= 1 << i

    def remove(self, *ids: int) -> None:
        for i in ids:
            self.bits &= ~(1 << i)


def layout_key(collection: str, rp: ReplicaPlacement, ttl: TTL, disk_type: str = "") -> str:
    return f"{collection}/{rp}/{ttl}/{disk_type}"


class VolumeLayout:
    """Writable/readonly vid sets + locations for one (collection, rp, ttl,
    disk) class (volume_layout.go)."""

    def __init__(self, rp: ReplicaPlacement, ttl: TTL, volume_size_limit: int):
        self.rp = rp
        self.ttl = ttl
        self.volume_size_limit = volume_size_limit
        self.locations: dict[int, list[DataNode]] = {}
        self.writables: set[int] = set()
        self.readonly: set[int] = set()
        self._lock = threading.RLock()
        self._rr = 0

    def register(self, v: VolumeInfo, dn: DataNode) -> None:
        with self._lock:
            locs = self.locations.setdefault(v.id, [])
            if dn not in locs:
                locs.append(dn)
            if v.read_only:
                self.readonly.add(v.id)
                self.writables.discard(v.id)
            elif v.size < self.volume_size_limit:
                if len(locs) >= self.rp.copy_count:
                    self.writables.add(v.id)
            else:
                self.writables.discard(v.id)

    def unregister(self, vid: int, dn: DataNode) -> None:
        with self._lock:
            locs = self.locations.get(vid, [])
            if dn in locs:
                locs.remove(dn)
            if not locs:
                self.locations.pop(vid, None)
                self.writables.discard(vid)
                self.readonly.discard(vid)
            elif len(locs) < self.rp.copy_count:
                self.writables.discard(vid)

    def pick_for_write(self) -> tuple[int, list[DataNode]] | None:
        with self._lock:
            if not self.writables:
                return None
            vids = sorted(self.writables)
            self._rr = (self._rr + 1) % len(vids)
            # QoS plane: among a few round-robin candidates,
            # prefer the volume whose replica set is calmest. With no
            # pressure reports every score is 0.0 and this degrades to
            # the plain round-robin pick (ties keep rotation order).
            k = min(4, len(vids))
            best = None
            for i in range(k):
                vid = vids[(self._rr + i) % len(vids)]
                locs = self.locations[vid]
                score = max((dn.effective_pressure() for dn in locs),
                            default=0.0)
                if best is None or score < best[0]:
                    best = (score, vid, list(locs))
                if score <= 0.0:
                    break  # calm replica set: no need to scan further
            return best[1], best[2]

    def set_volume_unavailable(self, vid: int) -> None:
        with self._lock:
            self.writables.discard(vid)

    def active_count(self) -> int:
        with self._lock:
            return len(self.writables)


class Topology:
    """Master-side cluster state (topology.go:28-54 + topology_ec.go)."""

    def __init__(self, volume_size_limit: int = 30_000 * 1024 * 1024,
                 pulse_seconds: int = 5, sequencer=None):
        from ..sequence import MemorySequencer

        self.volume_size_limit = volume_size_limit
        self.pulse_seconds = pulse_seconds
        self.sequence = sequencer or MemorySequencer()
        self.nodes: dict[str, DataNode] = {}  # url -> node
        self.layouts: dict[str, VolumeLayout] = {}
        # vid -> shard id -> set of node urls (topology.go:33 ecShardMap)
        self.ec_shard_map: dict[int, dict[int, set[str]]] = {}
        self.ec_collections: dict[int, str] = {}
        self.max_volume_id = 0
        self._lock = threading.RLock()

    # -- node lifecycle ----------------------------------------------------

    def register_node(self, dn: DataNode) -> DataNode:
        with self._lock:
            existing = self.nodes.get(dn.url)
            if existing is None:
                self.nodes[dn.url] = dn
                return dn
            existing.last_seen = time.time()
            return existing

    def unregister_node(self, url: str) -> None:
        with self._lock:
            dn = self.nodes.pop(url, None)
            if dn is None:
                return
            for v in list(dn.volumes.values()):
                self._unregister_volume(v, dn)
            for vid in list(dn.ec_shards):
                self.unregister_ec_shards(vid, dn)

    def alive_nodes(self) -> list[DataNode]:
        with self._lock:
            deadline = time.time() - 10 * self.pulse_seconds
            return [n for n in self.nodes.values() if n.last_seen >= deadline]

    # -- volume registration (heartbeat ingest) ----------------------------

    def get_layout(self, collection: str, rp: ReplicaPlacement,
                   ttl: TTL = EMPTY_TTL, disk_type: str = "") -> VolumeLayout:
        key = layout_key(collection, rp, ttl, disk_type)
        with self._lock:
            vl = self.layouts.get(key)
            if vl is None:
                vl = VolumeLayout(rp, ttl, self.volume_size_limit)
                self.layouts[key] = vl
            return vl

    def register_volume(self, v: VolumeInfo, dn: DataNode) -> None:
        with self._lock:
            dn.volumes[v.id] = v
            self.max_volume_id = max(self.max_volume_id, v.id)
            self.get_layout(v.collection, v.replica_placement, v.ttl, v.disk_type).register(v, dn)

    def _unregister_volume(self, v: VolumeInfo, dn: DataNode) -> None:
        dn.volumes.pop(v.id, None)
        self.get_layout(v.collection, v.replica_placement, v.ttl, v.disk_type).unregister(v.id, dn)

    def sync_node_volumes(self, dn: DataNode, volumes: list[VolumeInfo]) -> None:
        """Full-state heartbeat: diff against what we knew (SendHeartbeat,
        master_grpc_server.go:61)."""
        with self._lock:
            new_ids = {v.id for v in volumes}
            for vid in list(dn.volumes):
                if vid not in new_ids:
                    self._unregister_volume(dn.volumes[vid], dn)
            for v in volumes:
                self.register_volume(v, dn)
            dn.last_seen = time.time()

    def mark_volume_readonly(self, collection: str, vid: int,
                             readonly: bool, *, url: str = "") -> bool:
        """Flip a volume's readonly standing in its layout (the master
        half of VolumeMarkReadonly, master_grpc_server_volume.go:301):
        readonly volumes leave the writable set so assignment skips
        them. `url` narrows the flip to one replica's VolumeInfo; the
        layout-level sets are global either way (a volume with ANY
        readonly replica is not safely writable under replication).
        -> True when the volume was found."""
        with self._lock:
            for key, vl in self.layouts.items():
                if collection and key.split("/")[0] != collection:
                    continue
                if vid not in vl.locations:
                    continue
                with vl._lock:
                    if readonly:
                        vl.readonly.add(vid)
                        vl.writables.discard(vid)
                    else:
                        vl.readonly.discard(vid)
                        # mirror register(): a replica short of the
                        # placement OR a volume past the size limit must
                        # not re-enter the writable set
                        infos = [dn.volumes[vid]
                                 for dn in vl.locations[vid]
                                 if vid in dn.volumes]
                        if (len(vl.locations[vid]) >= vl.rp.copy_count
                                and all(v.size < vl.volume_size_limit
                                        for v in infos)):
                            vl.writables.add(vid)
                for dn in vl.locations[vid]:
                    if url and dn.url != url:
                        continue
                    v = dn.volumes.get(vid)
                    if v is not None:
                        v.read_only = readonly
                return True
            return False

    def lookup(self, collection: str, vid: int) -> list[DataNode]:
        with self._lock:
            for key, vl in self.layouts.items():
                if (not collection or key.split("/")[0] == collection) and vid in vl.locations:
                    return list(vl.locations[vid])
            # fall back to EC shard locations (any node holding a shard can serve)
            shard_map = self.ec_shard_map.get(vid)
            if shard_map:
                urls = {u for urls in shard_map.values() for u in urls}
                return [self.nodes[u] for u in urls if u in self.nodes]
            return []

    def next_volume_id(self) -> int:
        with self._lock:
            self.max_volume_id += 1
            return self.max_volume_id

    # -- EC shard map (topology_ec.go) -------------------------------------

    def register_ec_shards(self, info: EcShardInfo, dn: DataNode) -> None:
        with self._lock:
            existing = dn.ec_shards.get(info.volume_id)
            if existing is None:
                dn.ec_shards[info.volume_id] = EcShardInfo(
                    info.volume_id, info.collection, info.bits
                )
            else:
                existing.bits |= info.bits
            m = self.ec_shard_map.setdefault(info.volume_id, {})
            for sid in info.shard_ids():
                m.setdefault(sid, set()).add(dn.url)
            if info.collection:
                self.ec_collections[info.volume_id] = info.collection
            self.max_volume_id = max(self.max_volume_id, info.volume_id)

    def unregister_ec_shards(self, vid: int, dn: DataNode, bits: int | None = None) -> None:
        with self._lock:
            info = dn.ec_shards.get(vid)
            if info is None:
                return
            remove = info.bits if bits is None else bits
            info.bits &= ~remove
            m = self.ec_shard_map.get(vid, {})
            for sid in range(32):
                if remove >> sid & 1:
                    holders = m.get(sid)
                    if holders:
                        holders.discard(dn.url)
                        if not holders:
                            m.pop(sid, None)
            if not info.bits:
                dn.ec_shards.pop(vid, None)
            if not m:
                self.ec_shard_map.pop(vid, None)

    def sync_node_ec_shards(self, dn: DataNode, infos: list[EcShardInfo]) -> None:
        with self._lock:
            new_vids = {i.volume_id for i in infos}
            for vid in list(dn.ec_shards):
                if vid not in new_vids:
                    self.unregister_ec_shards(vid, dn)
            for info in infos:
                old = dn.ec_shards.get(info.volume_id)
                if old is not None:
                    gone = old.bits & ~info.bits
                    if gone:
                        self.unregister_ec_shards(info.volume_id, dn, gone)
                self.register_ec_shards(info, dn)

    def lookup_ec_shards(self, vid: int) -> dict[int, list[DataNode]]:
        with self._lock:
            out: dict[int, list[DataNode]] = {}
            for sid, urls in self.ec_shard_map.get(vid, {}).items():
                out[sid] = [self.nodes[u] for u in urls if u in self.nodes]
            return out

    # -- scrub scheduling --------------------------------------------------

    def next_scrub_targets(self, max_nodes: int = 1,
                           min_spacing_s: float = 0.0) -> list[DataNode]:
        """Pick the alive nodes whose last master-driven scrub pass is
        oldest (round-robin over the fleet: one node per master tick, so
        a large cluster never scrubs everywhere at once). Nodes scrubbed
        within `min_spacing_s` are skipped — the hook the master's
        periodic driver uses to spread a full-fleet pass across its
        interval instead of front-loading it."""
        with self._lock:
            now = time.time()
            due = [n for n in self.alive_nodes()
                   if now - n.last_scrub >= min_spacing_s]
            due.sort(key=lambda n: (n.last_scrub, n.url))
            picked = due[:max(0, max_nodes)]
            for n in picked:
                n.last_scrub = now
            return picked

    # -- assignment --------------------------------------------------------

    def pick_for_write(self, collection: str, rp: ReplicaPlacement,
                       ttl: TTL = EMPTY_TTL, disk_type: str = "",
                       count: int = 1) -> tuple[str, int, list[DataNode]]:
        """-> (fid, count, replica locations). Raises if no writable volume."""
        vl = self.get_layout(collection, rp, ttl, disk_type)
        picked = vl.pick_for_write()
        if picked is None:
            raise ValueError("no writable volumes")
        vid, locations = picked
        key = self.sequence.next_file_id(count)
        import secrets

        from ..storage.file_id import format_needle_id_cookie

        fid = f"{vid},{format_needle_id_cookie(key, secrets.randbits(32))}"
        return fid, count, locations

    # -- reporting ---------------------------------------------------------

    def collections(self) -> list[str]:
        with self._lock:
            names = {key.split("/")[0] for key in self.layouts}
            names |= set(self.ec_collections.values())
            return sorted(n for n in names)

    def to_topology_info(self) -> master_pb2.TopologyInfo:
        """The DC→rack→node tree, derived on demand (VolumeList RPC)."""
        with self._lock:
            dcs: dict[str, dict[str, list[DataNode]]] = {}
            for dn in self.nodes.values():
                dcs.setdefault(dn.data_center, {}).setdefault(dn.rack, []).append(dn)
            info = master_pb2.TopologyInfo(id="topo")
            for dc_name in sorted(dcs):
                dc = master_pb2.DataCenterInfo(id=dc_name)
                for rack_name in sorted(dcs[dc_name]):
                    rack = master_pb2.RackInfo(id=rack_name)
                    for dn in dcs[dc_name][rack_name]:
                        node = master_pb2.DataNodeInfo(id=dn.url, grpc_port=dn.grpc_port)
                        disk = master_pb2.DiskInfo(
                            type="", volume_count=len(dn.volumes),
                            max_volume_count=dn.max_volume_count,
                            free_volume_count=dn.free_space(),
                            active_volume_count=len(dn.volumes),
                        )
                        for v in dn.volumes.values():
                            disk.volume_infos.append(v.to_pb())
                        for e in dn.ec_shards.values():
                            disk.ec_shard_infos.append(
                                master_pb2.VolumeEcShardInformationMessage(
                                    id=e.volume_id, collection=e.collection,
                                    ec_index_bits=e.bits,
                                )
                            )
                        node.disk_infos[""].CopyFrom(disk)
                        rack.data_node_infos.append(node)
                    dc.rack_infos.append(rack)
                info.data_center_infos.append(dc)
            return info

    def statistics(self, collection: str = "") -> tuple[int, int, int]:
        """-> (total_size, used_size, file_count) over registered volumes."""
        with self._lock:
            used = files = 0
            for dn in self.nodes.values():
                for v in dn.volumes.values():
                    if collection and v.collection != collection:
                        continue
                    used += v.size
                    files += v.file_count
            total = sum(
                dn.max_volume_count * self.volume_size_limit
                for dn in self.nodes.values()
            )
            return total, used, files
