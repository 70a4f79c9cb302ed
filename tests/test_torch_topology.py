"""The port's cluster-layer units against the JAX package's, on the CPU.

The same seeded inputs go through both packages and the results must be
equal (tolerance 0): the needle-id sequencers, the master's topology
folding a seeded stream of heartbeats (full-state volume and EC shard
reports, deltas, node loss), volume placement (`find_empty_slots` and
`VolumeGrowth` under one seed: the reference's global `random`, the
port's explicit generator), `ec.encode`'s rack-aware `_plan_placement`,
the cluster membership registry, the master's HTTP and gRPC answers over
one topology, the master's /ui page and its Raft member RPCs, and the
shell's tier and Raft commands. One test holds the port alone: the master's
vacuum pass commits every replica when a heartbeat folds mid-pass,
where the reference skips one."""

import io
import random
import re
import secrets
import socket

import grpc
import pytest
import requests

from seaweedfs_tpu import cluster as ref_cluster
from seaweedfs_tpu import sequence as ref_sequence
from seaweedfs_tpu.pb import master_pb2 as ref_master_pb2
from seaweedfs_tpu.pb import meta_ring_pb2 as ref_ring_pb2
from seaweedfs_tpu.pb import rpc as ref_rpc
from seaweedfs_tpu.server import master as ref_master
from seaweedfs_tpu.shell import env as ref_env
from seaweedfs_tpu.shell.commands import ec as ref_ec
from seaweedfs_tpu.storage.super_block import ReplicaPlacement as RefRP
from seaweedfs_tpu.topology import volume_growth as ref_growth
from seaweedfs_tpu.utils import trace as ref_trace
from seaweedfs_tpu_torch import cluster
from seaweedfs_tpu_torch import sequence
from seaweedfs_tpu_torch.pb import master_pb2
from seaweedfs_tpu_torch.pb import meta_ring_pb2
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.server import master
from seaweedfs_tpu_torch.shell import env as port_env
from seaweedfs_tpu_torch.shell.commands import ec as port_ec
from seaweedfs_tpu_torch.shell.registry import run_command
from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement
from seaweedfs_tpu_torch.topology import volume_growth
from tests import torch_ports

SEEDS = range(6)
REF = dict(sequence=ref_sequence, master=ref_master, pb=ref_master_pb2,
           growth=ref_growth, RP=RefRP, env=ref_env, ec=ref_ec,
           cluster=ref_cluster, rpc=ref_rpc, ring_pb=ref_ring_pb2)
PORT = dict(sequence=sequence, master=master, pb=master_pb2,
            growth=volume_growth, RP=ReplicaPlacement, env=port_env,
            ec=port_ec, cluster=cluster, rpc=rpc, ring_pb=meta_ring_pb2)


@pytest.fixture(autouse=True)
def _global_random_restored():
    """The reference draws placements from the global generator, which
    these tests seed: leave it to the next test as it was."""
    state = random.getstate()
    yield
    random.setstate(state)


# -- sequencers ---------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_memory_sequencer_allocates_the_same_ids(seed):
    rng = random.Random(seed)
    ops = [(rng.choice(("next", "next", "set_max", "peek")),
            rng.randrange(1, 200)) for _ in range(200)]

    def drive(mod):
        s = mod.new_sequencer("memory")
        out = []
        for op, n in ops:
            if op == "next":
                out.append(s.next_file_id(n))
            elif op == "set_max":
                s.set_max(n * 7)
            else:
                out.append(s.peek())
        return out

    assert drive(sequence) == drive(ref_sequence)


class _FakeTime:
    def __init__(self, ms: list[int]):
        self.ms = ms

    def time(self) -> float:
        return self.ms.pop(0) / 1000.0 if len(self.ms) > 1 \
            else self.ms[0] / 1000.0


@pytest.mark.parametrize("node", [0, 1, 513, 1023])
def test_snowflake_sequencer_packs_the_same_ids(node, monkeypatch):
    epoch = ref_sequence.SnowflakeSequencer.EPOCH_MS
    stamps = [epoch + t for t in (5, 5, 5, 6, 6, 9, 9, 9, 9, 12)]
    out = []
    for mod in (ref_sequence, sequence):
        monkeypatch.setattr(mod, "time", _FakeTime(list(stamps)))
        s = mod.new_sequencer("snowflake", node_id=node)
        out.append([s.next_file_id() for _ in range(len(stamps) - 1)])
    assert out[0] == out[1]
    with pytest.raises(ValueError):
        sequence.SnowflakeSequencer(1024)


# -- topology folding -------------------------------------------------------------


def _nodes(rng) -> list[dict]:
    out = []
    for i in range(rng.randrange(3, 7)):
        out.append(dict(ip="10.0.0.%d" % (i + 1), port=8080 + i,
                        data_center=f"dc{rng.randrange(2)}",
                        rack=f"rack{rng.randrange(3)}",
                        max_volume_counts={"": rng.randrange(4, 12)}))
    return out


def _volume(pb, rng, vid: int):
    return pb.VolumeInformationMessage(
        id=vid, size=rng.randrange(0, 5000), collection=f"c{vid % 2}",
        file_count=rng.randrange(0, 50), delete_count=rng.randrange(0, 5),
        deleted_byte_count=rng.randrange(0, 900),
        read_only=rng.random() < 0.2,
        replica_placement=rng.choice((0, 1, 10)), version=3,
        modified_at_second=1_700_000_000)


def _heartbeats(seed: int, pb) -> list:
    """A seeded stream of (node index, Heartbeat) in one package's pb."""
    rng = random.Random(seed)
    nodes = _nodes(rng)
    out = []
    for _ in range(60):
        i = rng.randrange(len(nodes))
        hb = pb.Heartbeat(**nodes[i])
        kind = rng.randrange(6)
        if kind == 0:  # full volume report
            vids = rng.sample(range(1, 12), rng.randrange(0, 5))
            hb.volumes.extend(_volume(pb, rng, v) for v in vids)
            hb.has_no_volumes = not vids
        elif kind == 1:
            for v in rng.sample(range(1, 12), rng.randrange(1, 3)):
                hb.new_volumes.add(id=v, collection=f"c{v % 2}",
                                   replica_placement=rng.choice((0, 1)),
                                   version=3)
        elif kind == 2:
            for v in rng.sample(range(1, 12), rng.randrange(1, 3)):
                hb.deleted_volumes.add(id=v)
        elif kind == 3:  # full EC report
            for v in rng.sample(range(20, 24), rng.randrange(0, 3)):
                hb.ec_shards.add(id=v, collection="ec",
                                 ec_index_bits=rng.randrange(1, 1 << 14))
            hb.has_no_ec_shards = not hb.ec_shards
        elif kind == 4:
            hb.new_ec_shards.add(id=rng.randrange(20, 24), collection="ec",
                                 ec_index_bits=rng.randrange(1, 1 << 14))
        else:
            hb.deleted_ec_shards.add(id=rng.randrange(20, 24),
                                     ec_index_bits=rng.randrange(1, 1 << 14))
        hb.max_file_key = rng.randrange(0, 10_000)
        out.append((i, hb))
    return out


def _topology_view(ms) -> dict:
    topo = ms.topo
    return dict(
        info=topo.to_topology_info().SerializeToString(deterministic=True),
        layouts={k: (sorted(vl.writables), sorted(vl.readonly),
                     {vid: [dn.url for dn in locs]
                      for vid, locs in sorted(vl.locations.items())})
                 for k, vl in sorted(topo.layouts.items())},
        ec={vid: {sid: sorted(urls) for sid, urls in sorted(m.items())}
            for vid, m in sorted(topo.ec_shard_map.items())},
        lookups={vid: sorted(dn.url for dn in topo.lookup("", vid))
                 for vid in range(1, 25)},
        stats=topo.statistics(), collections=topo.collections(),
        max_vid=topo.max_volume_id, next_key=topo.sequence.peek())


def _fold(mods, seed: int, drop: int | None = None) -> list[dict]:
    ms = mods["master"].MasterServer(ip="127.0.0.1", port=1,
                                     allocate_fn=lambda *a: None)
    dns: dict[int, object] = {}
    views = []
    for step, (i, hb) in enumerate(_heartbeats(seed, mods["pb"])):
        dns[i] = ms.handle_heartbeat(hb, dns.get(i))
        if drop is not None and step == drop:
            ms.topo.unregister_node(dns.pop(i).url)
        views.append(_topology_view(ms))
    return views


@pytest.mark.parametrize("seed", SEEDS)
def test_heartbeat_stream_folds_to_the_same_topology(seed):
    assert _fold(PORT, seed) == _fold(REF, seed)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_a_lost_node_leaves_the_same_topology(seed):
    assert _fold(PORT, seed, drop=30) == _fold(REF, seed, drop=30)


def test_scrub_targets_round_robin_alike():
    picks = []
    for mods in (REF, PORT):
        ms = mods["master"].MasterServer(ip="127.0.0.1", port=1)
        for i, hb in _heartbeats(3, mods["pb"]):
            ms.handle_heartbeat(hb)
        picks.append([[n.url for n in ms.topo.next_scrub_targets(2)]
                      for _ in range(6)])
    assert picks[0] == picks[1]
    assert len({u for p in picks[1] for u in p}) > 2


# -- volume placement ----------------------------------------------------------------


def _placement_master(mods, seed: int):
    """A master whose topology holds a seeded fleet (no servers run)."""
    rng = random.Random(100 + seed)
    ms = mods["master"].MasterServer(ip="127.0.0.1", port=1,
                                     allocate_fn=lambda *a: None)
    for i in range(rng.randrange(5, 12)):
        hb = mods["pb"].Heartbeat(
            ip=f"10.1.0.{i + 1}", port=8080, data_center=f"dc{i % 3}",
            rack=f"rack{rng.randrange(3)}",
            max_volume_counts={"": rng.randrange(1, 6)})
        hb.has_no_volumes = True
        ms.handle_heartbeat(hb)
    return ms


PLACEMENTS = ("000", "001", "002", "010", "011", "020", "100", "110", "200")


@pytest.mark.parametrize("rp", PLACEMENTS)
def test_find_empty_slots_picks_the_same_nodes(rp):
    for seed in SEEDS:
        got = []
        for mods in (REF, PORT):
            ms = _placement_master(mods, seed)
            kw = {}
            if mods is REF:
                random.seed(seed)
            else:
                kw["rng"] = random.Random(seed)
            try:
                nodes = mods["growth"].find_empty_slots(
                    ms.topo, mods["RP"].parse(rp), **kw)
                got.append([n.url for n in nodes])
            except ValueError as e:
                got.append(str(e))
        assert got[0] == got[1], (rp, seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_volume_growth_allocates_alike(seed):
    calls = []
    for mods in (REF, PORT):
        made = []
        ms = _placement_master(mods, seed)
        growth = mods["growth"].VolumeGrowth(
            ms.topo, allocate_fn=lambda dn, vid, col, rp, ttl: made.append(
                (dn.url, vid, col, str(rp), str(ttl))),
            **({} if mods is REF else {"rng": random.Random(seed)}))
        if mods is REF:
            random.seed(seed)
        n = []
        for rp in ("001", "010", "000"):
            try:
                n.append(growth.grow("col", mods["RP"].parse(rp), count=3))
            except ValueError as e:
                n.append(str(e))
        calls.append((n, made, _topology_view(ms)))
    assert calls[0] == calls[1]


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_master_placement_seed_picks_like_the_global_generator(seed):
    """The master's `placement_seed` is the reference's `random.seed`."""
    got = []
    for mods in (REF, PORT):
        made = []
        kw = {} if mods is REF else {"placement_seed": seed}
        ms = mods["master"].MasterServer(
            ip="127.0.0.1", port=1, default_replication="010",
            allocate_fn=lambda dn, vid, *a: made.append((dn.url, vid)), **kw)
        for i, hb in _heartbeats(seed, mods["pb"]):
            ms.handle_heartbeat(hb)
        if mods is REF:
            random.seed(seed)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(secrets, "randbits", random.Random(seed).getrandbits)
            r = ms.assign(collection="new", count=2)
        got.append(({k: v for k, v in r.items()
                     if k not in ("replicas", "location")}, made))
    assert got[0] == got[1]


# -- ec.encode's rack-aware placement ------------------------------------------------


class _Env:
    """A shell env over a fixed VolumeList answer."""

    def __init__(self, mods, topo_info):
        self.env = mods["env"].CommandEnv("127.0.0.1:1")
        self.env.volume_list = lambda: mods["pb"].VolumeListResponse(
            topology_info=topo_info, volume_size_limit_mb=64)


@pytest.mark.parametrize("total", [14, 9, 16])
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_plan_placement_spreads_shards_alike(seed, total):
    got = []
    for mods in (REF, PORT):
        ms = mods["master"].MasterServer(ip="127.0.0.1", port=1)
        for i, hb in _heartbeats(seed, mods["pb"]):
            ms.handle_heartbeat(hb)
        env = _Env(mods, ms.topo.to_topology_info()).env
        shared = mods["ec"]._SharedPlacement()
        # two volumes through one ledger, as a parallel ec.encode does
        got.append([dict(mods["ec"]._plan_placement(env, total, shared))
                    for _ in range(2)])
    assert got[0] == got[1]
    assert sorted(s for sids in got[1][0].values() for s in sids) == \
        list(range(total))


# -- cluster membership ---------------------------------------------------------------


class _Tick:
    def __init__(self):
        self.t = 1000.0

    def time(self) -> float:
        self.t += 1.0
        return self.t


@pytest.mark.parametrize("seed", SEEDS)
def test_cluster_membership_updates_alike(seed, monkeypatch):
    rng = random.Random(seed)
    ops = [(rng.random() < 0.6, rng.choice(("g1", "")),
            rng.choice(("filer", "broker", "master", "volumeServer")),
            f"10.2.0.{rng.randrange(6)}:8888") for _ in range(80)]
    out = []
    for mods in (REF, PORT):
        monkeypatch.setattr(mods["cluster"], "time", _Tick())
        c = mods["cluster"].Cluster()
        log = []
        for add, group, kind, addr in ops:
            ups = (c.add_cluster_node(group, kind, addr) if add
                   else c.remove_cluster_node(group, kind, addr))
            log.append([(u.node_type, u.address, u.filer_group, u.is_leader,
                         u.is_add) for u in ups])
            log.append((sorted(n.address for n in
                               c.list_cluster_nodes(group, kind)),
                        c.list_leaders(group, kind)))
        out.append(log)
    assert out[0] == out[1]


# -- the master's answers --------------------------------------------------------------


def _free_port_pair() -> int:
    for _ in range(200):
        port = torch_ports.draw(random, 12000, 22000)
        try:
            for p in (port, port + 10000):
                with socket.socket() as s:
                    s.bind(("", p))
        except OSError:
            continue
        return port
    raise RuntimeError("no free port pair")


MASTER_PORT = _free_port_pair()
HTTP_PATHS = ("/dir/assign?collection=c1", "/dir/assign?replication=001",
              "/dir/lookup?volumeId=3", "/dir/lookup?fileId=5,01637037d6",
              "/dir/lookup?volumeId=99", "/dir/lookup?volumeId=x",
              "/vol/grow?collection=g&count=2", "/vol/grow?replication=300",
              "/cluster/raft/status", "/col/delete", "/nowhere")


def _served_master(mods):
    ms = mods["master"].MasterServer(
        ip="127.0.0.1", port=MASTER_PORT, allocate_fn=lambda *a: None,
        **({} if mods is REF else {"placement_seed": 5}))
    for i, hb in _heartbeats(4, mods["pb"]):
        ms.handle_heartbeat(hb)
    ms.start(vacuum_interval=3600)
    return ms


def _stop(ms, mods) -> None:
    ms.stop()
    ms._http_server.server_close()
    ms._grpc_server.stop(None).wait(10)
    mods["rpc"].reset_channels()


_ANSWERS: dict = {}


def _answers(name: str) -> dict:
    """HTTP and gRPC answers of one package's master over one topology."""
    if name in _ANSWERS:
        return _ANSWERS[name]
    mods = REF if name == "ref" else PORT
    ms = _served_master(mods)
    out = {}
    try:
        random.seed(5)
        http = requests.Session()  # one connection, not one per request
        http.trust_env = False
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(secrets, "randbits", random.Random(5).getrandbits)
            # the reference's trace sampling draws from the global
            # generator too: give it its own, so that the global stream
            # feeds only the placement picks, as the port's seed does
            mp.setattr(ref_trace, "random", random.Random(0))
            for path in HTTP_PATHS:
                r = http.get(f"http://127.0.0.1:{MASTER_PORT}{path}",
                                 timeout=30)
                out[path] = (r.status_code, r.json())
        stub = mods["rpc"].master_stub(f"127.0.0.1:{MASTER_PORT + 10000}")
        pb = mods["pb"]
        out["VolumeList"] = stub.VolumeList(
            pb.VolumeListRequest(), timeout=30).SerializeToString(
                deterministic=True)
        out["LookupEcVolume"] = stub.LookupEcVolume(
            pb.LookupEcVolumeRequest(volume_id=21),
            timeout=30).SerializeToString(deterministic=True)
        out["Statistics"] = stub.Statistics(
            pb.StatisticsRequest(), timeout=30).SerializeToString()
        out["CollectionList"] = stub.CollectionList(
            pb.CollectionListRequest(), timeout=30).SerializeToString()
        out["Config"] = stub.GetMasterConfiguration(
            pb.GetMasterConfigurationRequest(),
            timeout=30).SerializeToString()
        out["Raft"] = stub.RaftListClusterServers(
            pb.RaftListClusterServersRequest(),
            timeout=30).SerializeToString()
        lease = stub.LeaseAdminToken(pb.LeaseAdminTokenRequest(
            lock_name="admin", client_name="a"), timeout=30)
        try:
            stub.LeaseAdminToken(pb.LeaseAdminTokenRequest(
                lock_name="admin", client_name="b"), timeout=30)
            out["lock"] = "granted twice"
        except grpc.RpcError as e:
            out["lock"] = (e.code(), e.details())
        stub.ReleaseAdminToken(pb.ReleaseAdminTokenRequest(
            lock_name="admin", previous_token=lease.token), timeout=30)
        out["relock"] = bool(stub.LeaseAdminToken(pb.LeaseAdminTokenRequest(
            lock_name="admin", client_name="b"), timeout=30).token)
        for rpc_name in RAFT_MEMBER_RPCS:
            try:
                getattr(stub, rpc_name)(
                    getattr(pb, rpc_name + "Request")(id="127.0.0.1:2"),
                    timeout=30)
                out[rpc_name] = "answered"
            except grpc.RpcError as e:
                out[rpc_name] = (e.code(), e.details())
        out["ui"] = _ui_page(name)
        out["shell"] = _shell_answers(name)
        # the metadata ring: two shards join, one renews (no epoch bump),
        # one leaves; every answer is the published ring
        ring_pb = mods["ring_pb"]
        answers = [stub.JoinMetaRing(ring_pb.JoinMetaRingRequest(
            address=a, leave=leave), timeout=30).SerializeToString(
                deterministic=True)
            for a, leave in (("127.0.0.1:1", False), ("127.0.0.1:2", False),
                             ("127.0.0.1:1", False), ("127.0.0.1:1", True))]
        out["JoinMetaRing"] = answers
        out["GetMetaRing"] = stub.GetMetaRing(
            ring_pb.GetMetaRingRequest(), timeout=30).SerializeToString(
                deterministic=True)
    finally:
        http.close()
        _stop(ms, mods)
    _ANSWERS[name] = out
    return out


@pytest.mark.parametrize("key", HTTP_PATHS + (
    "VolumeList", "LookupEcVolume", "Statistics", "CollectionList", "Config",
    "Raft", "lock", "relock", "JoinMetaRing", "GetMetaRing"))
def test_the_master_answers_like_the_reference(key):
    assert _answers("port")[key] == _answers("ref")[key]


RAFT_MEMBER_RPCS = ("RaftAddServer", "RaftRemoveServer")
SHELL_LINES = (
    "volume.tier.upload -node 127.0.0.1:1 -volumeId 1 -dest s3",
    "volume.tier.download -node 127.0.0.1:1 -volumeId 1",
    "volume.tier.move -toDiskType ssd",
    "cluster.raft.add -id=127.0.0.1:2",
    "cluster.raft.remove -id=127.0.0.1:2",
)


def _ui_page(name: str) -> bytes:
    """The master's /ui with the page's clock pinned."""
    from seaweedfs_tpu.server import ui as ref_ui
    from seaweedfs_tpu_torch.server import ui as port_ui

    clock = type("Clock", (), {
        "strftime": staticmethod(lambda fmt, *a: "2023-11-14 22:13:20")})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_ui if name == "ref" else port_ui, "time", clock)
        r = requests.get(f"http://127.0.0.1:{MASTER_PORT}/ui", timeout=30)
    return r.status_code, r.headers["Content-Type"], r.content


def _shell_answers(name: str) -> dict:
    """What each of SHELL_LINES prints through one package's shell on
    the served master (the admin lease taken as after `lock`)."""
    if name == "ref":
        from seaweedfs_tpu.shell.registry import run_command as run
    else:
        run = run_command
    env = (REF if name == "ref" else PORT)["env"].CommandEnv(
        f"127.0.0.1:{MASTER_PORT}")
    env._lock_token = 1
    got = {}
    for line in SHELL_LINES:
        out = io.StringIO()
        rc = run(env, line, out)
        # gRPC's debug string orders its fields as it pleases
        got[line] = (rc, re.sub(r"\tdebug_error_string = .*\n", "",
                                out.getvalue()))
    return got


@pytest.mark.parametrize("name", RAFT_MEMBER_RPCS)
def test_the_raft_member_rpcs_answer_as_the_reference(name):
    """A master without peers answers RaftAddServer and RaftRemoveServer
    as the reference's does: FAILED_PRECONDITION, Raft not enabled."""
    assert _answers("port")[name] == _answers("ref")[name]
    assert _answers("port")[name][0] == grpc.StatusCode.FAILED_PRECONDITION


def test_vacuum_commits_every_replica_when_a_heartbeat_folds_mid_pass(
        monkeypatch):
    """A full-state heartbeat folded while the vacuum pass runs moves its
    node to the end of the volume's live location list. The pass works
    on a copy of the list, so each replica is compacted and committed
    exactly once (the reference iterates the live list and, in that
    case, commits the first replica twice and never the second)."""
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs

    ms = master.MasterServer(ip="127.0.0.1", port=1,
                             allocate_fn=lambda *a: None)

    def beat(port, vids):
        hb = master_pb2.Heartbeat(ip="127.0.0.1", port=port, rack="r1",
                                  data_center="dc1")
        for vid in vids:
            hb.volumes.add(id=vid, replica_placement=1, version=3, size=8)
        hb.has_no_volumes = not vids
        return hb

    dns = {port: ms.handle_heartbeat(beat(port, [5])) for port in (8001,
                                                                   8002)}
    calls = []

    class Stub:
        def __init__(self, addr):
            self.port = int(addr.rsplit(":", 1)[1]) - rpc.GRPC_PORT_DELTA

        def VacuumVolumeCheck(self, req, timeout):
            return vs.VacuumVolumeCheckResponse(garbage_ratio=0.5)

        def VacuumVolumeCompact(self, req, timeout):
            calls.append(("compact", self.port))
            return iter(())

        def VacuumVolumeCommit(self, req, timeout):
            calls.append(("commit", self.port))
            if self.port == 8001:  # its pulse lands mid-commit
                ms.handle_heartbeat(beat(8001, []), dns[8001])
                ms.handle_heartbeat(beat(8001, [5]), dns[8001])
            return vs.VacuumVolumeCommitResponse()

    monkeypatch.setattr(master.rpc, "volume_stub", Stub)
    assert ms.vacuum_once(0.3) == 1
    assert calls == [("compact", 8001), ("compact", 8002),
                     ("commit", 8001), ("commit", 8002)]


def test_every_rpc_of_the_master_service_has_a_handler():
    names = [m["name"] for m in rpc.MASTER_SERVICE[1]]
    assert names == [m["name"] for m in ref_rpc.MASTER_SERVICE[1]]
    assert all(callable(getattr(master.MasterGrpc, n)) for n in names)


def test_a_master_with_peers_forms_a_raft_group_at_construction(tmp_path):
    """`peers=` builds the Raft node as the reference's constructor does:
    a follower of term 0 that knows its peers, leading nobody yet."""
    got = {}
    for name, mods in (("ref", REF), ("port", PORT)):
        ms = mods["master"].MasterServer(
            ip="127.0.0.1", port=1, peers=["127.0.0.1:1", "127.0.0.1:2"],
            raft_dir=str(tmp_path / name))
        got[name] = (ms.raft.status(), ms.is_leader(), ms.leader_address())
    assert got["port"] == got["ref"]


def test_the_ui_answers_as_the_reference():
    """The master's /ui over one topology: the same page, byte for byte,
    with the clock pinned; it names every data node."""
    assert _answers("port")["ui"] == _answers("ref")["ui"]
    status, ctype, body = _answers("port")["ui"]
    assert status == 200 and ctype.startswith("text/html")
    assert b"Topology" in body


# -- the tier and Raft shell commands --------------------------------------------


@pytest.mark.parametrize("line", SHELL_LINES)
def test_the_tier_and_raft_shell_commands_answer_as_the_reference(line):
    """Each line prints what the reference's shell prints on the same
    single master: a tier move names the volume server it cannot reach,
    `volume.tier.move` finds no ssd, a Raft membership change is refused
    by a master without peers."""
    assert _answers("port")["shell"][line] == _answers("ref")["shell"][line]
    assert "ROADMAP.md" not in _answers("port")["shell"][line][1]


def test_the_port_shell_registers_the_reference_commands_it_ports():
    from seaweedfs_tpu.shell.registry import COMMANDS as REF_COMMANDS
    from seaweedfs_tpu_torch.shell.registry import COMMANDS

    ported = {n for n in REF_COMMANDS
              if n.split(".")[0] in ("volume", "volumeServer", "ec", "lock",
                                     "unlock", "cluster", "collection",
                                     "qos", "trace", "fs", "s3", "mq",
                                     "mount", "remote")}
    assert ported <= set(COMMANDS) <= set(REF_COMMANDS)
    # every reference command is registered in the port
    assert set(COMMANDS) == set(REF_COMMANDS)
