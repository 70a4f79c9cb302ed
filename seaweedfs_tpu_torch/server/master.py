"""Master server: cluster brain — heartbeat ingest, assignment, EC lookup.

Counterpart of seaweedfs_tpu/server/master.py (SeaweedFS
weed/server/master_server.go + master_grpc_server.go +
master_server_handlers.go). Serves:

* gRPC (master_pb.Seaweed): SendHeartbeat bidirectional stream (:61),
  Assign, LookupVolume, LookupEcVolume, VolumeList, Statistics,
  CollectionList/Delete, KeepConnected membership push (:250),
  LeaseAdminToken (shell cluster lock), Ping.
* HTTP on the master port: /dir/assign (master_server_handlers.go:102),
  /dir/lookup, /vol/vacuum, /col/delete, /cluster/status, /dir/status,
  /metrics (Prometheus text).

A single master is the default; with `peers=` (`-peers`) the masters form
a Raft group (master/raft.py) that replicates MaxVolumeId and elects the
leader, and every mutating RPC is gated on leadership as the reference
gates it on `Topo.IsLeader()`: a follower proxies lookups to the leader
and refuses assigns. `/` and `/ui` serve the status page (server/ui.py).
The master is the metadata ring's authority (GetMetaRing, JoinMetaRing). Volume
placement draws from an explicit generator (`placement_seed=`) where the
reference draws from the global `random` module.
"""

from __future__ import annotations

import json
import queue
import random
import threading
import time
from http.server import BaseHTTPRequestHandler

from ..utils.httpd import TunedThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import grpc

from ..cluster import Cluster
from ..pb import master_pb2, rpc
from ..sequence import new_sequencer
from ..storage.super_block import ReplicaPlacement
from ..storage.ttl import EMPTY_TTL, TTL
from ..topology import Topology, VolumeGrowth
from ..topology.topology import EcShardInfo, VolumeInfo
from ..utils import glog, locks, trace
from ..utils.stats import (
    MASTER_RECEIVED_HEARTBEATS,
    gather,
    metrics_content_type,
    qos_stats,
    status_base,
)


class MasterServer:
    def __init__(self, *, ip: str = "localhost", port: int = 9333,
                 volume_size_limit_mb: int = 30_000,
                 default_replication: str = "000",
                 pulse_seconds: int = 5,
                 sequencer_type: str = "memory",
                 garbage_threshold: float = 0.3,
                 allocate_fn=None,
                 placement_seed: int | None = None,
                 peers: list[str] | None = None,
                 raft_dir: str | None = None,
                 raft_transport=None,
                 metrics_address: str = "",
                 metrics_interval_sec: int = 15,
                 write_jwt_key: bytes = b"",
                 jwt_expires_sec: int = 10):
        # JWT minting for authorized writes (security/jwt.go:30)
        self.write_jwt_key = write_jwt_key
        self.jwt_expires_sec = jwt_expires_sec
        # push-gateway target broadcast to the fleet at heartbeat
        # (GetMasterConfiguration -> volume servers start pushing)
        self.metrics_address = metrics_address
        self.metrics_interval_sec = metrics_interval_sec
        self.ip = ip
        self.port = port
        self.grpc_port = rpc.derived_grpc_port(port)
        self.default_replication = default_replication
        self.garbage_threshold = garbage_threshold
        # volume.vacuum.disable pauses the periodic loop (the reference's
        # Topology.isDisableVacuum); manual /vol/vacuum still works
        self.vacuum_disabled = False
        # integrity plane: periodic fleet-wide scrub loop —
        # each tick asks the least-recently-scrubbed volume server (the
        # topology round-robin hook) to run one self-healing pass
        self.scrub_disabled = False
        self.topo = Topology(
            volume_size_limit=volume_size_limit_mb * 1024 * 1024,
            pulse_seconds=pulse_seconds,
            sequencer=new_sequencer(sequencer_type),
        )
        # placement picks draw from this generator; seed it for
        # repeatable placement
        self.growth = VolumeGrowth(self.topo, allocate_fn=allocate_fn,
                                   rng=random.Random(placement_seed))
        # QoS plane: cluster-wide background byte budget leased
        # to volume servers over QosGrant (strict priority: repair >
        # scrub/archival), plus the per-node pressure reports assign
        # placement consults. Unconfigured env = observe-only.
        from ..qos import GrantLedger

        self.qos_ledger = GrantLedger()
        # master-plane locks on the witness (ranks 30-70, above the
        # rank-20 run locks, below the volume plane at 300)
        self._grow_lock = locks.wlock("master.grow", rank=30)
        self._admin_locks: dict[str, tuple[int, int, str]] = {}  # name -> (token, ts, client)
        self._admin_lock_mu = locks.wlock("master.admin_locks", rank=60)
        self._keepalive_clients: dict[str, queue.Queue] = {}
        self._keepalive_mu = locks.wlock("master.keepalive", rank=70)
        # the metadata ring's authority: filer shards join/renew over
        # JoinMetaRing, every membership change bumps the epoch, and
        # clients fetch the published picture via GetMetaRing (direct or
        # proxied by any shard). Empty ring = unpartitioned deployment,
        # nothing routes.
        from ..cluster.metaring import MetaRing

        self.meta_ring = MetaRing([])
        self._meta_ring_mu = locks.wlock("master.meta_ring", rank=50)
        # filer/broker group membership + leader hinting (weed/cluster)
        self.cluster = Cluster()
        self._grpc_server = None
        self._http_server = None
        self._vacuum_thread = None
        self._stop = threading.Event()
        self._started_at = time.time()
        # multi-master: Raft-replicated MaxVolumeId + leader election
        # (raft_server.go / cluster_commands.go)
        self.raft = None
        self._vid_propose_lock = locks.wlock("master.vid_propose", rank=40)
        if peers:
            from ..master.raft import RaftNode

            self.raft = RaftNode(
                self.address, peers, self._raft_apply,
                transport=raft_transport, state_dir=raft_dir,
                snapshot_fn=lambda: {
                    "max_volume_id": self.topo.max_volume_id},
                restore_fn=lambda s: self._raft_apply(
                    {"op": "max_volume_id", "value": s["max_volume_id"]}),
            )
            self.topo.next_volume_id = self._raft_next_volume_id

    # -- leadership --------------------------------------------------------

    def is_leader(self) -> bool:
        return self.raft is None or self.raft.role == "leader"

    def leader_address(self) -> str:
        if self.raft is None or self.raft.leader_id is None:
            return self.address
        return self.raft.leader_id

    def mint_write_jwt(self, fid: str) -> str:
        if not self.write_jwt_key:
            return ""
        from ..security import gen_write_jwt

        return gen_write_jwt(self.write_jwt_key, fid, self.jwt_expires_sec)

    @property
    def address(self) -> str:
        return f"{self.ip}:{self.port}"

    def _raft_apply(self, cmd: dict) -> None:
        if cmd.get("op") == "max_volume_id":
            with self.topo._lock:
                self.topo.max_volume_id = max(self.topo.max_volume_id,
                                              int(cmd["value"]))

    def _raft_next_volume_id(self) -> int:
        """Raft-committed replacement for Topology.next_volume_id
        (MaxVolumeIdCommand, cluster_commands.go)."""
        with self._vid_propose_lock:
            candidate = self.topo.max_volume_id + 1
            self.raft.propose({"op": "max_volume_id", "value": candidate})
            return candidate

    # -- lifecycle ---------------------------------------------------------

    def start(self, *, vacuum_interval: float = 60.0,
              scrub_interval: float | None = None) -> None:
        trace.set_identity("master", self.address)
        self._grpc_server = rpc.new_server()
        creds = rpc.add_servicer(self._grpc_server, rpc.MASTER_SERVICE,
                                 MasterGrpc(self), component="master",
                                 address=self.address)
        rpc.serve_port(self._grpc_server, f"[::]:{self.grpc_port}",
                       "master", creds=creds)
        self._grpc_server.start()
        # HTTPS: the master's HTTP plane (assign/lookup/status/debug)
        # rides the same gate as the data planes — one SWFS_HTTPS switch
        # moves the whole fleet
        from ..security.tls import load_http_server_context

        self._http_server = TunedThreadingHTTPServer(
            ("", self.port), _make_http_handler(self),
            ssl_context=load_http_server_context("master")
        )
        threading.Thread(target=self._http_server.serve_forever, daemon=True).start()
        self._vacuum_thread = threading.Thread(
            target=self._vacuum_loop, args=(vacuum_interval,), daemon=True
        )
        self._vacuum_thread.start()
        if scrub_interval is None:
            import os as _os

            try:
                scrub_interval = float(_os.environ.get(
                    "SWFS_MASTER_SCRUB_INTERVAL_S", "0"))
            except ValueError:
                scrub_interval = 0.0
        if scrub_interval > 0:
            threading.Thread(target=self._scrub_loop,
                             args=(scrub_interval,), daemon=True).start()
        if self.raft is not None:
            self.raft.start()
        glog.info(f"master started on {self.address} (grpc :{self.grpc_port})")

    def stop(self) -> None:
        self._stop.set()
        if self.raft is not None:
            self.raft.stop()
        if self._http_server:
            self._http_server.shutdown()
        if self._grpc_server:
            self._grpc_server.stop(grace=0.5)

    # -- assignment --------------------------------------------------------

    def assign(self, *, count: int = 1, replication: str = "",
               collection: str = "", ttl: str = "", data_center: str = "",
               rack: str = "", data_node: str = "") -> dict:
        if not self.is_leader():
            return {"error": f"not the leader; ask {self.leader_address()}",
                    "leader": self.leader_address()}
        rp = ReplicaPlacement.parse(replication or self.default_replication)
        t = TTL.parse(ttl) if ttl else EMPTY_TTL
        vl = self.topo.get_layout(collection, rp, t)
        grow_err: Exception | None = None
        if vl.active_count() == 0:
            with self._grow_lock:  # single grower, like vgCh serialization
                if vl.active_count() == 0:
                    try:
                        self.growth.grow(
                            collection, rp, t,
                            count=self.growth.default_count(rp),
                            data_center=data_center, rack=rack,
                            data_node=data_node,
                        )
                    except (ValueError, grpc.RpcError, IOError) as e:
                        # a full/churning cluster is a routine condition —
                        # including a chosen volume server dying between
                        # heartbeat and AllocateVolume (grpc.RpcError):
                        # surface it as an assign error (clients retry it
                        # as transient), never as a raw gRPC exception
                        glog.v(1, f"volume growth failed: {e}")
                        grow_err = e
        try:
            fid, n, locations = self.topo.pick_for_write(collection, rp, t, count=count)
        except ValueError as e:
            # when growth is WHY there is nothing to pick, the grow error
            # is the real diagnosis — a generic "no writable volumes"
            # would read as transient churn to clients and bury a
            # permanent placement-shape misconfiguration. Placement
            # ValueErrors pass through raw (their strings classify
            # client-side); transport failures get a marker that
            # operation.assign treats as transient.
            if isinstance(grow_err, ValueError):
                return {"error": str(grow_err)}
            if grow_err is not None:
                return {"error": f"volume growth rpc failed: {grow_err}"}
            return {"error": str(e)}
        # QoS shed: above SWFS_QOS_SHED_PRESSURE (0 = off)
        # refuse the assign OUTRIGHT instead of handing out a target
        # whose write would queue behind a saturated group-commit /
        # dispatch plane and time out late. Clients see an explicit
        # overload marker with a retry hint (HTTP maps it to 429).
        import os as _os

        try:
            shed_at = float(_os.environ.get("SWFS_QOS_SHED_PRESSURE", "0"))
        except ValueError:
            shed_at = 0.0
        if shed_at > 0:
            from ..utils.stats import QOS_ADMISSION_OPS

            worst = max((dn.effective_pressure() for dn in locations),
                        default=0.0)
            if worst >= shed_at:
                QOS_ADMISSION_OPS.inc(plane="master", result="reject")
                return {"error": f"overloaded: volume server pressure "
                                 f"{worst:.2f} >= {shed_at:.2f}",
                        "overloaded": True, "retryAfterS": 1.0}
            QOS_ADMISSION_OPS.inc(plane="master", result="admit")
        primary = locations[0]
        return {
            "fid": fid,
            "count": n,
            "url": primary.url,
            "publicUrl": primary.public_url,
            "replicas": locations[1:],
            "location": primary,
        }

    # -- heartbeat ingest --------------------------------------------------

    def handle_heartbeat(self, hb: master_pb2.Heartbeat, dn=None):
        from ..topology.topology import DataNode

        MASTER_RECEIVED_HEARTBEATS.inc()
        if dn is None:
            dn = DataNode(
                ip=hb.ip, port=hb.port, public_url=hb.public_url,
                grpc_port=hb.grpc_port or hb.port + rpc.GRPC_PORT_DELTA,
                data_center=hb.data_center or "DefaultDataCenter",
                rack=hb.rack or "DefaultRack",
            )
            dn = self.topo.register_node(dn)
        dn.last_seen = time.time()
        if hb.max_volume_counts:
            dn.max_volume_count = sum(hb.max_volume_counts.values())
        if hb.max_file_key:
            dn.max_file_key = hb.max_file_key
            self.topo.sequence.set_max(hb.max_file_key)
        new_vids, gone_vids = [], []
        if hb.volumes or hb.has_no_volumes:
            before = set(dn.volumes)
            self.topo.sync_node_volumes(dn, [VolumeInfo.from_pb(v) for v in hb.volumes])
            after = set(dn.volumes)
            new_vids, gone_vids = sorted(after - before), sorted(before - after)
        for v in hb.new_volumes:
            self.topo.register_volume(VolumeInfo(
                id=v.id, collection=v.collection,
                replica_placement=ReplicaPlacement.from_byte(v.replica_placement),
                ttl=TTL.from_uint32(v.ttl), version=v.version or 3,
            ), dn)
            new_vids.append(v.id)
        for v in hb.deleted_volumes:
            if v.id in dn.volumes:
                self.topo._unregister_volume(dn.volumes[v.id], dn)
                gone_vids.append(v.id)
        if hb.ec_shards or hb.has_no_ec_shards:
            self.topo.sync_node_ec_shards(dn, [
                EcShardInfo(e.id, e.collection, e.ec_index_bits)
                for e in hb.ec_shards
            ])
        for e in hb.new_ec_shards:
            self.topo.register_ec_shards(
                EcShardInfo(e.id, e.collection, e.ec_index_bits), dn
            )
        for e in hb.deleted_ec_shards:
            self.topo.unregister_ec_shards(e.id, dn, e.ec_index_bits)
        if new_vids or gone_vids:
            self._broadcast_location(dn, new_vids, gone_vids)
        return dn

    def _broadcast_cluster_updates(self, updates) -> None:
        """Push cluster.NodeUpdate events to every KeepConnected client
        (master_grpc_server.go broadcastToClients)."""
        for u in updates:
            msg = master_pb2.KeepConnectedResponse(
                cluster_node_update=master_pb2.ClusterNodeUpdate(
                    node_type=u.node_type, address=u.address,
                    filer_group=u.filer_group, is_leader=u.is_leader,
                    is_add=u.is_add))
            with self._keepalive_mu:
                for q in self._keepalive_clients.values():
                    q.put(msg)

    def meta_ring_join(self, address: str, leave: bool = False):
        """Ring membership mutation (JoinMetaRing): idempotent — a shard
        re-announcing over its heartbeat loop neither bumps the epoch
        nor disturbs routing, so a crashed-and-restarted shard rejoins
        at the SAME ring position. -> the current ring snapshot."""
        from ..utils.stats import META_RING_EPOCH, META_RING_SHARDS

        changed = False
        with self._meta_ring_mu:
            ring = self.meta_ring
            present = address in ring.shards
            if leave and present:
                self.meta_ring = ring.without_shard(address)
                changed = True
            elif not leave and not present:
                self.meta_ring = ring.with_shard(address)
                changed = True
            ring = self.meta_ring
        if changed:
            META_RING_EPOCH.set(ring.epoch)
            META_RING_SHARDS.set(len(ring))
            glog.info(f"meta ring epoch {ring.epoch}: "
                      f"{'-' if leave else '+'}{address} "
                      f"({len(ring)} shard(s))")
            # nudge every KeepConnected client: shards and gateways
            # refetch the ring on any metaRingShard update instead of
            # waiting out their cache TTL
            with self._keepalive_mu:
                for q in self._keepalive_clients.values():
                    q.put(master_pb2.KeepConnectedResponse(
                        cluster_node_update=master_pb2.ClusterNodeUpdate(
                            node_type="metaRingShard", address=address,
                            is_add=not leave)))
        return ring

    def _broadcast_location(self, dn, new_vids, deleted_vids) -> None:
        msg = master_pb2.KeepConnectedResponse(
            volume_location=master_pb2.VolumeLocation(
                url=dn.url, public_url=dn.public_url, grpc_port=dn.grpc_port,
                data_center=dn.data_center,
                new_vids=new_vids, deleted_vids=deleted_vids,
                leader=self.address,
            )
        )
        with self._keepalive_mu:
            for q in self._keepalive_clients.values():
                q.put(msg)

    # -- vacuum loop (topology_vacuum.go) ----------------------------------

    def _vacuum_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            if self.vacuum_disabled:
                continue
            # lint: allow-broad-except(a failed pass is logged; the
            # loop stays alive for the next tick)
            try:
                self.vacuum_once(self.garbage_threshold)
            except Exception as e:  # noqa: BLE001 - keep the loop alive
                glog.warning(f"vacuum pass failed: {e}")

    # -- scrub loop (integrity plane) -------------------------------------

    def _scrub_loop(self, interval: float) -> None:
        """Periodic fleet scrub: each tick nudges the least-recently-
        scrubbed volume server (topology.next_scrub_targets) to run a
        self-healing pass. The per-server scrubber does its own pacing;
        this loop only spreads WHICH server sweeps WHEN."""
        while not self._stop.wait(interval):
            if self.scrub_disabled or not self.is_leader():
                continue
            # lint: allow-broad-except(a failed pass is logged; the
            # loop stays alive for the next tick)
            try:
                self.scrub_once()
            except Exception as e:  # noqa: BLE001 - keep the loop alive
                glog.warning(f"scrub pass failed: {e}")

    def scrub_once(self, max_nodes: int = 1, repair: bool = True) -> int:
        """Ask up to `max_nodes` due volume servers for one scrub pass.
        -> servers that completed."""
        from ..pb import scrub_pb2

        done = 0
        for dn in self.topo.next_scrub_targets(max_nodes):
            try:
                stub = rpc.volume_stub(dn.grpc_address)
                resp = stub.VolumeScrub(
                    scrub_pb2.VolumeScrubRequest(repair=repair),
                    timeout=3600)
                if resp.findings:
                    glog.warning(
                        f"scrub on {dn.url}: {len(resp.findings)} "
                        f"finding(s), {resp.repaired} repaired")
                done += 1
            except grpc.RpcError as e:
                glog.warning(f"scrub on {dn.url}: {e.code()}")
        return done

    def vacuum_once(self, threshold: float, volume_id: int = 0) -> int:
        """One scan: compact+commit every volume whose garbage ratio exceeds
        `threshold` on all replicas. -> volumes vacuumed."""
        from ..pb import volume_server_pb2 as vs

        done = 0
        for vl in list(self.topo.layouts.values()):
            for vid, nodes in list(vl.locations.items()):
                if volume_id and vid != volume_id:
                    continue
                # a copy of the replica list (topology_vacuum.go's
                # locationList.Copy()): a heartbeat folded mid-pass
                # re-orders the live list, and iterating it then skipped
                # a replica's compact or commit
                nodes = list(nodes)
                try:
                    ratios = []
                    for dn in nodes:
                        stub = rpc.volume_stub(dn.grpc_address)
                        r = stub.VacuumVolumeCheck(
                            vs.VacuumVolumeCheckRequest(volume_id=vid), timeout=30)
                        ratios.append(r.garbage_ratio)
                    if not ratios or min(ratios) < threshold:
                        continue
                    vl.set_volume_unavailable(vid)
                    for dn in nodes:
                        stub = rpc.volume_stub(dn.grpc_address)
                        for _ in stub.VacuumVolumeCompact(
                                vs.VacuumVolumeCompactRequest(volume_id=vid),
                                timeout=3600):
                            pass
                    for dn in nodes:
                        stub = rpc.volume_stub(dn.grpc_address)
                        stub.VacuumVolumeCommit(
                            vs.VacuumVolumeCommitRequest(volume_id=vid), timeout=600)
                    done += 1
                except grpc.RpcError as e:
                    glog.warning(f"vacuum volume {vid}: {e.code()}")
        return done


# -- gRPC servicer ---------------------------------------------------------

class MasterGrpc:
    def __init__(self, ms: MasterServer):
        self.ms = ms

    def SendHeartbeat(self, request_iterator, context):
        ms = self.ms
        dn = None
        try:
            for hb in request_iterator:
                dn = ms.handle_heartbeat(hb, dn)
                yield master_pb2.HeartbeatResponse(
                    volume_size_limit=ms.topo.volume_size_limit,
                    leader=ms.leader_address(),
                )
        finally:
            # stream break = node presumed down (defer-unregister path)
            if dn is not None:
                ms.topo.unregister_node(dn.url)

    def KeepConnected(self, request_iterator, context):
        ms = self.ms
        first = next(iter(request_iterator), None)
        if first is None:
            return
        key = f"{first.client_type}@{first.client_address}#{id(context)}"
        q: queue.Queue = queue.Queue()
        with ms._keepalive_mu:
            ms._keepalive_clients[key] = q
        # filers/brokers joining the stream join their cluster group
        # (master_grpc_server.go KeepConnected -> AddClusterNode)
        ms._broadcast_cluster_updates(ms.cluster.add_cluster_node(
            first.filer_group, first.client_type, first.client_address,
            version=first.version))
        # seed the newcomer with the CURRENT group membership — members
        # that joined earlier were broadcast before this stream existed
        for node_type in ("filer", "broker"):
            for n in ms.cluster.list_cluster_nodes(first.filer_group,
                                                   node_type):
                q.put(master_pb2.KeepConnectedResponse(
                    cluster_node_update=master_pb2.ClusterNodeUpdate(
                        node_type=node_type, address=n.address,
                        filer_group=first.filer_group, is_add=True,
                        is_leader=ms.cluster.is_one_leader(
                            first.filer_group, node_type, n.address))))
        try:
            # initial full picture: every node with its volumes
            for dn in ms.topo.alive_nodes():
                yield master_pb2.KeepConnectedResponse(
                    volume_location=master_pb2.VolumeLocation(
                        url=dn.url, public_url=dn.public_url,
                        grpc_port=dn.grpc_port, data_center=dn.data_center,
                        new_vids=sorted(dn.volumes),
                        new_ec_vids=sorted(dn.ec_shards),
                        leader=ms.leader_address(),
                    )
                )
            while context.is_active():
                try:
                    yield q.get(timeout=1.0)
                except queue.Empty:
                    continue
        finally:
            with ms._keepalive_mu:
                ms._keepalive_clients.pop(key, None)
            ms._broadcast_cluster_updates(ms.cluster.remove_cluster_node(
                first.filer_group, first.client_type, first.client_address))

    def ListClusterNodes(self, request, context):
        ms = self.ms
        resp = master_pb2.ListClusterNodesResponse()
        for n in ms.cluster.list_cluster_nodes(request.filer_group,
                                               request.client_type):
            resp.cluster_nodes.add(
                address=n.address, version=n.version,
                is_leader=ms.cluster.is_one_leader(
                    request.filer_group, request.client_type, n.address),
                created_at_ns=int(n.created_ts * 1e9),
                data_center=n.data_center, rack=n.rack)
        return resp

    def _leader_stub(self):
        """Stub to the Raft leader, or None when we are it. Followers hold
        no topology (volume servers heartbeat only to the leader), so
        lookups are proxied (the reference redirects the same way)."""
        ms = self.ms
        if ms.is_leader() or ms.leader_address() == ms.address:
            return None
        return rpc.master_stub(rpc.grpc_address(ms.leader_address()))

    def LookupVolume(self, request, context):
        leader = self._leader_stub()
        if leader is not None:
            try:
                return leader.LookupVolume(request, timeout=10)
            except grpc.RpcError:
                pass  # fall through to (possibly stale) local view
        resp = master_pb2.LookupVolumeResponse()
        for vof in request.volume_or_file_ids:
            entry = resp.volume_id_locations.add(volume_or_file_id=vof)
            try:
                vid_str = vof.split(",")[0]
                vid = int(vid_str)
            except ValueError:
                entry.error = f"unknown volume id {vof}"
                continue
            nodes = self.ms.topo.lookup(request.collection, vid)
            if not nodes:
                entry.error = f"volume {vid} not found"
                continue
            for dn in nodes:
                entry.locations.append(dn.to_location())
        return resp

    def Assign(self, request, context):
        r = self.ms.assign(
            count=int(request.count) or 1, replication=request.replication,
            collection=request.collection, ttl=request.ttl,
            data_center=request.data_center, rack=request.rack,
            data_node=request.data_node,
        )
        if "error" in r:
            return master_pb2.AssignResponse(error=r["error"])
        return master_pb2.AssignResponse(
            fid=r["fid"], count=r["count"],
            location=r["location"].to_location(),
            replicas=[dn.to_location() for dn in r["replicas"]],
            auth=self.ms.mint_write_jwt(r["fid"]),
        )

    def Statistics(self, request, context):
        total, used, files = self.ms.topo.statistics(request.collection)
        return master_pb2.StatisticsResponse(
            total_size=total, used_size=used, file_count=files
        )

    def CollectionList(self, request, context):
        return master_pb2.CollectionListResponse(
            collections=[master_pb2.Collection(name=c)
                         for c in self.ms.topo.collections()]
        )

    def CollectionDelete(self, request, context):
        from ..pb import volume_server_pb2 as vs

        for dn in self.ms.topo.alive_nodes():
            try:
                rpc.volume_stub(dn.grpc_address).DeleteCollection(
                    vs.DeleteCollectionRequest(collection=request.name), timeout=60)
            except grpc.RpcError:
                pass
        return master_pb2.CollectionDeleteResponse()

    def VolumeList(self, request, context):
        return master_pb2.VolumeListResponse(
            topology_info=self.ms.topo.to_topology_info(),
            volume_size_limit_mb=self.ms.topo.volume_size_limit // (1024 * 1024),
        )

    def LookupEcVolume(self, request, context):
        leader = self._leader_stub()
        if leader is not None:
            try:
                return leader.LookupEcVolume(request, timeout=10)
            except grpc.RpcError as e:
                if e.code() == grpc.StatusCode.NOT_FOUND:
                    context.abort(grpc.StatusCode.NOT_FOUND,
                                  f"ec volume {request.volume_id} not found")
        shard_locs = self.ms.topo.lookup_ec_shards(request.volume_id)
        if not shard_locs:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"ec volume {request.volume_id} not found")
        resp = master_pb2.LookupEcVolumeResponse(volume_id=request.volume_id)
        for sid in sorted(shard_locs):
            entry = resp.shard_id_locations.add(shard_id=sid)
            for dn in shard_locs[sid]:
                entry.locations.append(dn.to_location())
        return resp

    def VacuumVolume(self, request, context):
        self.ms.vacuum_once(request.garbage_threshold or 0.0001,
                            volume_id=request.volume_id)
        return master_pb2.VacuumVolumeResponse()

    def DisableVacuum(self, request, context):
        # master_grpc_server_volume.go:287 (Topo.DisableVacuum)
        self.ms.vacuum_disabled = True
        return master_pb2.DisableVacuumResponse()

    def EnableVacuum(self, request, context):
        # master_grpc_server_volume.go:294 (Topo.EnableVacuum)
        self.ms.vacuum_disabled = False
        return master_pb2.EnableVacuumResponse()

    def DisableScrub(self, request, context):
        # pause the fleet scrub loop (incident knob; per-server
        # daemons keep their own SWFS_SCRUB_INTERVAL_S schedule)
        from ..pb import scrub_pb2

        self.ms.scrub_disabled = True
        return scrub_pb2.DisableScrubResponse()

    def EnableScrub(self, request, context):
        from ..pb import scrub_pb2

        self.ms.scrub_disabled = False
        return scrub_pb2.EnableScrubResponse()

    def VolumeMarkReadonly(self, request, context):
        # master_grpc_server_volume.go:301 — flip the layout standing so
        # assignment stops (or resumes) handing out the volume
        ms = self.ms
        if not ms.is_leader():
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          f"not the leader; leader is {ms.leader_address()}")
        url = f"{request.ip}:{request.port}" if request.ip else ""
        found = ms.topo.mark_volume_readonly(
            request.collection, request.volume_id, request.is_readonly,
            url=url)
        if not found:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"volume {request.volume_id} not found")
        return master_pb2.VolumeMarkReadonlyResponse()

    def RaftListClusterServers(self, request, context):
        # master_grpc_server_raft.go:13; in single-master mode the
        # cluster is this one server, leading itself
        ms = self.ms
        resp = master_pb2.RaftListClusterServersResponse()
        if ms.raft is None:
            resp.cluster_servers.add(id=ms.address, address=ms.address,
                                     suffrage="Voter", isLeader=True)
            return resp
        st = ms.raft.status()
        for addr in sorted({st["id"], *st["peers"]}):
            resp.cluster_servers.add(
                id=addr, address=addr, suffrage="Voter",
                isLeader=addr == st["leader"])
        return resp

    def RaftAddServer(self, request, context):
        # master_grpc_server_raft.go:37
        ms = self.ms
        if ms.raft is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "raft not enabled (single-master mode)")
        if not ms.is_leader():
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          f"not the leader; leader is {ms.leader_address()}")
        # this raft identifies peers BY address (id == address); a
        # distinct id would be registered under the address and then be
        # unremovable by RaftRemoveServer(id=...)
        if request.id and request.address and request.id != request.address:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "server id must equal its address here "
                          f"(got id={request.id!r} "
                          f"address={request.address!r})")
        try:
            ms.raft.add_peer(request.address or request.id)
        except Exception as e:  # noqa: BLE001 - surface the raft error
            context.abort(grpc.StatusCode.INTERNAL, str(e))
        return master_pb2.RaftAddServerResponse()

    def RaftRemoveServer(self, request, context):
        # master_grpc_server_raft.go:64
        ms = self.ms
        if ms.raft is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "raft not enabled (single-master mode)")
        if not ms.is_leader():
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          f"not the leader; leader is {ms.leader_address()}")
        st = ms.raft.status()
        if request.id not in {st["id"], *st["peers"]}:
            # a silent no-op "success" would hide a typo'd id forever
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"{request.id} is not a member")
        try:
            ms.raft.remove_peer(request.id)
        except Exception as e:  # noqa: BLE001
            context.abort(grpc.StatusCode.INTERNAL, str(e))
        return master_pb2.RaftRemoveServerResponse()

    def GetMasterConfiguration(self, request, context):
        return master_pb2.GetMasterConfigurationResponse(
            leader=self.ms.leader_address(),
            default_replication=self.ms.default_replication,
            volume_size_limit_m_b=self.ms.topo.volume_size_limit // (1024 * 1024),
            metrics_address=self.ms.metrics_address,
            metrics_interval_seconds=self.ms.metrics_interval_sec,
        )

    def LeaseAdminToken(self, request, context):
        ms = self.ms
        now = time.time_ns()
        with ms._admin_lock_mu:
            cur = ms._admin_locks.get(request.lock_name)
            if cur is not None:
                token, ts, client = cur
                expired = now - ts > 60e9
                same_client = client == request.client_name
                if not expired and not same_client and request.previous_token != token:
                    context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                                  f"lock is held by {client}")
            token = now
            ms._admin_locks[request.lock_name] = (token, now, request.client_name)
            return master_pb2.LeaseAdminTokenResponse(token=token, lock_ts_ns=now)

    def ReleaseAdminToken(self, request, context):
        with self.ms._admin_lock_mu:
            cur = self.ms._admin_locks.get(request.lock_name)
            if cur is not None and cur[0] == request.previous_token:
                del self.ms._admin_locks[request.lock_name]
        return master_pb2.ReleaseAdminTokenResponse()

    def Ping(self, request, context):
        now = time.time_ns()
        return master_pb2.PingResponse(
            start_time_ns=now, remote_time_ns=now, stop_time_ns=time.time_ns()
        )

    def GetMetaRing(self, request, context):
        """Metadata ring fetch: the published membership and epoch;
        clients derive the identical virtual-node layout."""
        from ..pb import meta_ring_pb2

        resp = meta_ring_pb2.MetaRingResponse()
        self.ms.meta_ring.fill_response(resp)
        return resp

    def JoinMetaRing(self, request, context):
        """Shard join/renew/leave — the response doubles as an
        epoch-bumped ring update riding the shard's heartbeat loop."""
        from ..pb import meta_ring_pb2

        ring = self.ms.meta_ring_join(request.address,
                                      leave=request.leave)
        resp = meta_ring_pb2.MetaRingResponse()
        ring.fill_response(resp)
        return resp

    def QosGrant(self, request, context):
        """QoS plane: lease background byte budget to a volume
        server (strict priority by reservation in the GrantLedger) and
        absorb its pressure report into the topology so assign placement
        prefers calm servers."""
        from ..pb import qos_pb2

        ms = self.ms
        granted, ttl = ms.qos_ledger.grant(
            request.address, request.work_class,
            request.requested_bytes, request.pressure)
        dn = ms.topo.nodes.get(request.address)
        if dn is not None:
            dn.qos_pressure = float(request.pressure)
            dn.qos_pressure_at = time.time()
        rate = ms.qos_ledger.rate_bytes()
        return qos_pb2.QosGrantResponse(
            granted_bytes=granted, lease_ttl_seconds=ttl,
            cluster_rate_bytes=int(max(rate, 0.0)))


# -- HTTP plane ------------------------------------------------------------

def _make_http_handler(ms: MasterServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route to glog, not stderr
            glog.v(2, f"master http: {fmt % args}")

        def _json(self, obj, code: int = 200, headers=None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            tid = getattr(self, "_trace_id", "")
            if tid:
                self.send_header("X-Trace-Id", tid)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: C901 - flat route table
            self._trace_id = ""  # never leak across keep-alive requests
            if urlparse(self.path).path in ("/", "/ui"):
                from .ui import master_ui

                body = master_ui(ms)
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            u = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            if u.path == "/dir/assign":
                with trace.span("master.assign", carrier=self.headers,
                                component="master",
                                server=ms.address) as tsp:
                    self._trace_id = tsp.trace_id
                    r = ms.assign(
                        count=int(q.get("count", 1)),
                        replication=q.get("replication", ""),
                        collection=q.get("collection", ""),
                        ttl=q.get("ttl", ""),
                        data_center=q.get("dataCenter", ""),
                        rack=q.get("rack", ""),
                    )
                    if "error" in r:
                        # an attribute, not keep-if-error: a cluster-full
                        # burst answers hundreds of these per second and
                        # must not flush the bounded retained set (same
                        # policy as expected S3 4xx)
                        tsp.set_attr(assignError=r["error"][:120])
                        if r.get("overloaded"):
                            # QoS shed: explicit early
                            # rejection with a retry hint, not a 404
                            return self._json(
                                r, 429, headers={"Retry-After": str(
                                    int(r.get("retryAfterS", 1) + 0.5)
                                    or 1)})
                        return self._json(r, 404)
                    out = {
                        "fid": r["fid"], "count": r["count"],
                        "url": r["url"], "publicUrl": r["publicUrl"],
                    }
                    auth = ms.mint_write_jwt(r["fid"])
                    if auth:
                        out["auth"] = auth
                    return self._json(out)
            if u.path == "/dir/lookup":
                if not ms.is_leader() and ms.leader_address() != ms.address:
                    import requests as _rq

                    from ..utils.http import requests_verify, url_for

                    try:
                        r = _rq.get(
                            url_for(ms.leader_address(), self.path),
                            timeout=10, verify=requests_verify())
                        return self._json(r.json(), r.status_code)
                    except _rq.RequestException:
                        pass  # fall through to local (stale) view
                vof = q.get("volumeId", q.get("fileId", ""))
                try:
                    vid = int(str(vof).split(",")[0])
                except ValueError:
                    return self._json({"error": f"bad volumeId {vof}"}, 400)
                nodes = ms.topo.lookup(q.get("collection", ""), vid)
                if not nodes:
                    return self._json(
                        {"volumeOrFileId": vof, "error": "not found"}, 404)
                return self._json({
                    "volumeOrFileId": vof,
                    "locations": [
                        {"url": n.url, "publicUrl": n.public_url} for n in nodes
                    ],
                })
            if u.path == "/cluster/raft/status":
                if ms.raft is None:
                    return self._json({"mode": "single-master",
                                       "leader": ms.address})
                return self._json(ms.raft.status())
            if u.path in ("/status", "/dir/status", "/cluster/status"):
                total, used, files = ms.topo.statistics()
                return self._json({
                    **status_base(ms._started_at),
                    "IsLeader": ms.is_leader(),
                    "Leader": ms.leader_address(),
                    "Topology": {
                        "Max": total, "Size": used, "FileCount": files,
                        "DataNodes": sorted(ms.topo.nodes),
                    },
                    "Trace": trace.STORE.stats(),
                    # QoS plane: grant ledger + per-node pressure +
                    # admission counters
                    "Qos": {
                        **qos_stats(),
                        "ledger": ms.qos_ledger.status(),
                    },
                    "MetaRing": ms.meta_ring.describe(),
                })
            if u.path == "/debug/traces":
                return self._json(trace.debug_traces_payload(q))
            if u.path == "/vol/grow":
                if not ms.is_leader():
                    return self._json(
                        {"error": "not the leader",
                         "leader": ms.leader_address()}, 400)
                try:
                    rp = ReplicaPlacement.parse(
                        q.get("replication") or ms.default_replication)
                    t = TTL.parse(q["ttl"]) if q.get("ttl") else EMPTY_TTL
                    n = ms.growth.grow(
                        q.get("collection", ""), rp, t,
                        count=int(q.get("count", 1)))
                except ValueError as e:
                    return self._json({"error": str(e)}, 400)
                return self._json({"count": n})
            if u.path == "/vol/vacuum":
                n = ms.vacuum_once(float(q.get("garbageThreshold", 0.0001)))
                return self._json({"vacuumed": n})
            # vacuum enable/disable and raft membership moved to gRPC
            # (DisableVacuum/EnableVacuum/RaftAddServer/RaftRemoveServer)
            # — the reference keeps no HTTP twin for them either
            if u.path == "/col/delete":
                return self._json({"error": "use gRPC CollectionDelete"}, 400)
            if u.path == "/metrics":
                ex = "exemplars" in q
                body = gather(exemplars=ex).encode()
                self.send_response(200)
                self.send_header("Content-Type", metrics_content_type(ex))
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self._json({"error": "not found"}, 404)

        def do_POST(self):
            u = urlparse(self.path)
            if u.path == "/cluster/raft":
                if ms.raft is None:
                    return self._json({"error": "raft not enabled"}, 400)
                n = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(n) or b"{}")
                handler = getattr(ms.raft, "handle_" + req.get("method", ""),
                                  None)
                if handler is None:
                    return self._json({"error": "unknown raft method"}, 400)
                return self._json(handler(req.get("payload", {})))
            return self.do_GET()

    return Handler
