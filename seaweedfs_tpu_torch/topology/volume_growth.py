"""Volume growth: pick servers honoring XYZ replica placement.

Counterpart of seaweedfs_tpu/topology/volume_growth.py (SeaweedFS
weed/topology/volume_growth.go:91-220, `GrowByCountAndType`,
`findEmptySlotsForOneVolume`): choose a primary data center/rack/node plus
diff-DC, diff-rack, and same-rack replicas, each with free capacity, then
allocate the volume on every chosen node.

Where the reference draws its picks from the global `random` module, the
port takes an explicit `random.Random`: a caller that seeds it gets the
placements the reference makes after `random.seed` with the same seed.
"""

from __future__ import annotations

import random

from ..storage.super_block import ReplicaPlacement
from ..storage.ttl import EMPTY_TTL, TTL
from .topology import DataNode, Topology, VolumeInfo


def find_empty_slots(topo: Topology, rp: ReplicaPlacement,
                     data_center: str = "", rack: str = "",
                     data_node: str = "",
                     rng: random.Random | None = None) -> list[DataNode]:
    """Pick rp.copy_count nodes satisfying the placement constraints, drawing
    from `rng` (a fresh unseeded generator when None). Raises ValueError
    when the cluster can't satisfy them."""
    rng = rng or random.Random()
    nodes = [n for n in topo.alive_nodes() if n.free_space() > 0]
    if data_center:
        main_dc_nodes = [n for n in nodes if n.data_center == data_center]
    else:
        main_dc_nodes = nodes
    if not main_dc_nodes:
        raise ValueError("no free volume slot in requested data center")

    # group by dc
    by_dc: dict[str, list[DataNode]] = {}
    for n in nodes:
        by_dc.setdefault(n.data_center, []).append(n)

    main_dc = data_center or _pick_weighted_dc(by_dc, rp, rng)
    dc_nodes = by_dc.get(main_dc, [])
    if len({n.rack for n in dc_nodes}) < rp.diff_rack_count + 1:
        raise ValueError("not enough racks for replica placement")

    by_rack: dict[str, list[DataNode]] = {}
    for n in dc_nodes:
        if rack and n.rack != rack:
            continue
        by_rack.setdefault(n.rack, []).append(n)
    candidates = [
        r for r, ns in by_rack.items()
        if len(ns) >= rp.same_rack_count + 1
    ]
    if not candidates:
        raise ValueError("not enough servers in any rack")
    main_rack = rng.choice(candidates)
    rack_nodes = by_rack[main_rack]
    if data_node:
        rack_nodes = [n for n in rack_nodes if n.url == data_node]
        if not rack_nodes:
            raise ValueError(f"requested node {data_node} unavailable")

    picked = rng.sample(rack_nodes, rp.same_rack_count + 1)

    # diff racks in the same dc
    other_racks = [r for r in by_rack if r != main_rack]
    if len(other_racks) < rp.diff_rack_count:
        raise ValueError("not enough other racks")
    for r in rng.sample(other_racks, rp.diff_rack_count):
        picked.append(rng.choice(by_rack[r]))

    # diff data centers
    other_dcs = [d for d in by_dc if d != main_dc]
    if len(other_dcs) < rp.diff_dc_count:
        raise ValueError("not enough other data centers")
    for d in rng.sample(other_dcs, rp.diff_dc_count):
        picked.append(rng.choice(by_dc[d]))
    return picked


def _pick_weighted_dc(by_dc: dict[str, list[DataNode]], rp: ReplicaPlacement,
                      rng: random.Random) -> str:
    eligible = [
        d for d, ns in by_dc.items()
        if sum(n.free_space() for n in ns) >= rp.copy_count
    ]
    if not eligible:
        raise ValueError("no data center with enough free slots")
    return rng.choice(eligible)


class VolumeGrowth:
    """Allocates new volumes on chosen nodes via the volume-server RPC
    (GrowByCountAndType -> AllocateVolume)."""

    def __init__(self, topo: Topology, allocate_fn=None,
                 rng: random.Random | None = None):
        self.topo = topo
        # the placement picks' generator; seed it for repeatable placement
        self.rng = rng or random.Random()
        # allocate_fn(dn, vid, collection, rp, ttl) — injectable for tests
        self._allocate = allocate_fn or self._grpc_allocate

    def _grpc_allocate(self, dn: DataNode, vid: int, collection: str,
                       rp: ReplicaPlacement, ttl: TTL) -> None:
        from ..pb import rpc, volume_server_pb2

        stub = rpc.volume_stub(dn.grpc_address)
        stub.AllocateVolume(volume_server_pb2.AllocateVolumeRequest(
            volume_id=vid, collection=collection, replication=str(rp),
            ttl=str(ttl),
        ), timeout=30)

    def grow(self, collection: str, rp: ReplicaPlacement,
             ttl: TTL = EMPTY_TTL, disk_type: str = "", count: int = 1,
             data_center: str = "", rack: str = "", data_node: str = "") -> int:
        """Create `count` new volumes; -> number actually created."""
        grown = 0
        for _ in range(count):
            try:
                nodes = find_empty_slots(self.topo, rp, data_center, rack,
                                         data_node, self.rng)
            except ValueError:
                if grown:
                    break
                raise
            vid = self.topo.next_volume_id()
            for dn in nodes:
                self._allocate(dn, vid, collection, rp, ttl)
                self.topo.register_volume(
                    VolumeInfo(id=vid, collection=collection,
                               replica_placement=rp, ttl=ttl,
                               disk_type=disk_type),
                    dn,
                )
            grown += 1
        return grown

    def default_count(self, rp: ReplicaPlacement) -> int:
        """How many volumes to grow per trigger (grow_request defaults)."""
        copies = rp.copy_count
        if copies == 1:
            return 7
        if copies == 2:
            return 6
        return 3
