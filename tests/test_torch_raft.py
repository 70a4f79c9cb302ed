"""The port's master Raft group against the JAX package's, on the CPU.

The consensus core (`master/raft.py`) runs over the in-process
`LocalTransport`: the reference's protocol cases (election, replication,
failover with log repair, a minority that cannot commit, persistence,
compaction, InstallSnapshot for a lagging follower, membership changes)
on port nodes, then groups that mix both packages' nodes, whose messages
must be understood both ways. A state directory written by one package
loads in the other. Then live masters over the HTTP transport: a group
of three port masters with a port volume server (leader, assign, the
followers' leader hint and proxied lookups, MaxVolumeId replicated, the
leader lost, `cluster.raft.remove` and `.add` from the shell), and one
group of both packages' masters. Raft's timings are random by design, so
outcomes are compared, not timings: one leader, equal committed logs,
equal MaxVolumeId. Deadlines are generous, for six busy workers."""

import io
import json
import os
import time

import grpc
import pytest
import requests

from seaweedfs_tpu.master import raft as ref_raft
from seaweedfs_tpu.server import master as ref_master
from seaweedfs_tpu.shell.env import CommandEnv as RefEnv
from seaweedfs_tpu.shell.registry import run_command as ref_run_command
from seaweedfs_tpu_torch.master import raft
from seaweedfs_tpu_torch.master.raft import (
    LEADER,
    LocalTransport,
    NotLeader,
    RaftNode,
)
from seaweedfs_tpu_torch.operation import assign
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.shell.registry import run_command
from tests.test_torch_native_dataplane import pick_port, wait_http

WAIT = 30.0  # seconds: elections are 0.15-0.3 s, but six workers share cores


def _wait(cond, timeout=WAIT, what="condition"):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


def _group(kinds, state_dir=None, transport=None):
    """Nodes node0.. of the given packages ("ref"/"port") on one
    LocalTransport, each applying into its own list."""
    transport = transport or LocalTransport()
    ids = [f"node{i}" for i in range(len(kinds))]
    applied = {i: [] for i in ids}
    nodes = []
    for i, kind in zip(ids, kinds):
        mod = ref_raft if kind == "ref" else raft
        node = mod.RaftNode(i, list(ids), applied[i].append,
                            transport=transport, state_dir=state_dir)
        transport.register(node)
        nodes.append(node)
    return transport, nodes, applied


def _leader(nodes, timeout=WAIT):
    found = []

    def one():
        found[:] = [n for n in nodes if n.role == LEADER]
        return len(found) == 1
    _wait(one, timeout, f"one leader among {[n.node_id for n in nodes]}")
    return found[0]


def _propose(nodes, cmd):
    """Propose through whichever node leads: a leader deposed by a
    starved heartbeat refuses with NotLeader before it appends, so the
    retry never duplicates an entry."""
    deadline = time.time() + WAIT
    while True:
        try:
            return _leader(nodes).propose(cmd, timeout=WAIT)
        except (NotLeader, ref_raft.NotLeader):
            assert time.time() < deadline, "no leader took the proposal"


def _stop(nodes):
    for n in nodes:
        n.stop()


# -- the protocol over LocalTransport ---------------------------------------------

@pytest.mark.parametrize("kinds", [
    ("port", "port", "port"), ("ref", "port", "port"),
    ("port", "ref", "ref"), ("port", "ref", "port", "ref", "port")],
    ids=["port", "ref-port-port", "port-ref-ref", "mixed5"])
def test_a_group_elects_one_leader_and_commits_the_same_log(kinds):
    """Whatever mix of packages, the group elects one leader and every
    node applies the same commands in the same order; a follower refuses
    a proposal (NotLeader of its own package)."""
    _, nodes, applied = _group(kinds)
    for n in nodes:
        n.start()
    try:
        for v in range(1, 9):
            _propose(nodes, {"op": "max_volume_id", "value": v})
        _wait(lambda: all(len(a) == 8 for a in applied.values()),
              what="every node applied 8 commands")
        logs = {i: [c["value"] for c in a] for i, a in applied.items()}
        assert all(log == list(range(1, 9)) for log in logs.values()), logs
        follower = next(n for n in nodes if n.role != LEADER)
        mod = ref_raft if isinstance(follower, ref_raft.RaftNode) else raft
        with pytest.raises(mod.NotLeader):
            follower.propose({"op": "x"})
    finally:
        _stop(nodes)


@pytest.mark.parametrize("kinds", [("port",) * 3, ("ref", "port", "ref")],
                         ids=["port", "mixed"])
def test_failover_repairs_the_old_leaders_log(kinds):
    transport, nodes, applied = _group(kinds)
    for n in nodes:
        n.start()
    try:
        leader = _leader(nodes)
        leader.propose({"v": 1}, timeout=WAIT)
        transport.partitioned.add(leader.node_id)
        survivors = [n for n in nodes if n is not leader]
        new_leader = _leader(survivors)
        new_leader.propose({"v": 2}, timeout=WAIT)
        transport.partitioned.clear()
        _wait(lambda: leader.role != LEADER
              and len(applied[leader.node_id]) >= 2,
              what="the old leader to step down and catch up")
        for a in applied.values():
            _wait(lambda a=a: len(a) >= 2, what="every node at 2")
            assert [c.get("v") for c in a] == [1, 2]
    finally:
        _stop(nodes)


def test_a_minority_cannot_commit():
    transport, nodes, applied = _group(("port",) * 3)
    for n in nodes:
        n.start()
    try:
        leader = _leader(nodes)
        for n in nodes:
            if n is not leader:
                transport.partitioned.add(n.node_id)
        with pytest.raises(TimeoutError):
            leader.propose({"v": 99}, timeout=1.0)
        assert all(not a for a in applied.values())
    finally:
        _stop(nodes)


def test_install_snapshot_catches_up_a_lagging_follower():
    """A follower cut off past the leader's compaction point receives the
    state machine's snapshot, then follows the log again."""
    transport = LocalTransport()
    ids = [f"node{i}" for i in range(3)]
    states = {i: [] for i in ids}
    nodes = []
    for i, kind in zip(ids, ("port", "ref", "port")):
        mod = ref_raft if kind == "ref" else raft

        def apply(cmd, _s=states[i]):
            _s.append(cmd["v"])

        def snap(_s=states[i]):
            return list(_s)

        def restore(data, _s=states[i]):
            _s[:] = data

        node = mod.RaftNode(i, list(ids), apply, transport=transport,
                            snapshot_fn=snap, restore_fn=restore)
        transport.register(node)
        nodes.append(node)
    for n in nodes:
        n.start()
    try:
        leader = _leader(nodes)
        follower = next(n for n in nodes if n.role != LEADER)
        transport.partitioned.add(follower.node_id)
        for v in range(1, 7):
            leader.propose({"v": v}, timeout=WAIT)
        leader.compact()
        assert leader.snapshot_index >= 6 and not leader.log
        transport.partitioned.discard(follower.node_id)
        _wait(lambda: states[follower.node_id] == [1, 2, 3, 4, 5, 6],
              what="the snapshot at the follower")
        assert follower.snapshot_index >= 6
        leader.propose({"v": 7}, timeout=WAIT)
        _wait(lambda: states[follower.node_id][-1:] == [7],
              what="the next entry at the follower")
        assert states[follower.node_id] == [1, 2, 3, 4, 5, 6, 7]
    finally:
        _stop(nodes)


def test_membership_add_and_remove():
    """A replicated config entry grows the voter set (the new node
    catches up) and shrinks it again; the removed node cannot disturb
    the rest."""
    transport = LocalTransport()
    applied = {f"m{i}": [] for i in range(3)}
    nodes = {}
    for i in ("m0", "m1"):
        n = RaftNode(i, ["m0", "m1"], applied[i].append, transport=transport)
        transport.register(n)
        nodes[i] = n
        n.start()
    try:
        leader = _leader(list(nodes.values()))
        for v in range(1, 4):
            leader.propose({"op": "max_volume_id", "value": v}, timeout=WAIT)
        n2 = ref_raft.RaftNode("m2", ["m0", "m1", "m2"], applied["m2"].append,
                               transport=transport)
        transport.register(n2)
        nodes["m2"] = n2
        n2.start()
        leader.add_peer("m2")
        assert "m2" in leader.peers
        leader.propose({"op": "max_volume_id", "value": 9}, timeout=WAIT)
        _wait(lambda: applied["m2"][-1:] == [{"op": "max_volume_id",
                                              "value": 9}],
              what="the new voter to catch up")
        leader.remove_peer("m2")
        assert "m2" not in leader.peers
        leader = _leader([nodes["m0"], nodes["m1"]])
        leader.propose({"op": "max_volume_id", "value": 11}, timeout=WAIT)
        time.sleep(1.2)  # m2's would-be election timeouts
        assert _leader([nodes["m0"], nodes["m1"]]).node_id != "m2"
        assert applied["m2"][-1]["value"] != 11
    finally:
        _stop(nodes.values())


# -- state directories across the packages ----------------------------------------

@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_a_state_directory_loads_in_the_other_package(tmp_path, writer,
                                                      reader):
    """A group of the writer's package persists its terms, logs and a
    compacted snapshot; each node of the reader's package restored from
    that directory holds the same term, log and snapshot, and replays
    the same committed commands."""
    d = str(tmp_path)
    wmod = ref_raft if writer == "ref" else raft
    rmod = ref_raft if reader == "ref" else raft
    transport = wmod.LocalTransport()
    ids = ["node0", "node1", "node2"]
    states = {i: [] for i in ids}
    nodes = []
    for i in ids:
        node = wmod.RaftNode(
            i, ids, lambda c, _s=states[i]: _s.append(c["value"]),
            transport=transport, state_dir=d,
            snapshot_fn=lambda _s=states[i]: {"max_volume_id": max(
                _s, default=0)},
            restore_fn=lambda s, _s=states[i]: _s.append(s["max_volume_id"]))
        transport.register(node)
        nodes.append(node)
    for n in nodes:
        n.start()
    for v in range(1, 6):
        _propose(nodes, {"op": "max_volume_id", "value": v})
    _leader(nodes).compact()
    for v in range(6, 9):
        _propose(nodes, {"op": "max_volume_id", "value": v})
    _wait(lambda: all(s[-1:] == [8] for s in states.values()),
          what="every node at 8")
    _stop(nodes)
    for i in ids:
        with open(os.path.join(d, f"raft-{i}.json")) as f:
            blob = json.load(f)
        for mod in (wmod, rmod):
            replayed = []
            node = mod.RaftNode(
                i, ids, lambda c: replayed.append(c["value"]),
                transport=mod.LocalTransport(), state_dir=d,
                restore_fn=lambda s: replayed.append(
                    ("snapshot", s["max_volume_id"])))
            got = (node.term, node.snapshot_index, node.commit_index,
                   [(e.term, e.index, e.command) for e in node.log],
                   replayed)
            if mod is wmod:
                want = got
            node._pool.shutdown(wait=False)
        assert got == want
        assert blob["term"] == got[0] and got[4][-1] == 8


# -- live masters over the HTTP transport -----------------------------------------

def _masters(kinds, tmp_path):
    ports = []
    for _ in kinds:
        ports.append(pick_port(tuple(ports)))
    addrs = [f"localhost:{p}" for p in ports]
    masters = []
    for kind, p in zip(kinds, ports):
        mod = ref_master if kind == "ref" else __import__(
            "seaweedfs_tpu_torch.server.master", fromlist=["x"])
        ms = mod.MasterServer(ip="localhost", port=p, volume_size_limit_mb=64,
                              peers=list(addrs),
                              raft_dir=str(tmp_path / f"m{p}"))
        ms.start(vacuum_interval=3600)
        masters.append(ms)
    return masters, addrs


def _volume_server(tmp_path, addrs):
    port = pick_port()
    vsrv = VolumeServer(directories=[str(tmp_path / "v")],
                        master=",".join(addrs), ip="localhost", port=port,
                        pulse_seconds=1, max_volume_counts=[32],
                        coder=RSCodecTorch(10, 4, device="cpu"))
    vsrv.start()
    return vsrv


def _leader_master(masters, timeout=WAIT):
    found = []

    def one():
        found[:] = [m for m in masters if m.is_leader()]
        return len(found) == 1
    _wait(one, timeout, "one leading master")
    return found[0]


@pytest.fixture()
def ha_cluster(tmp_path):
    masters, addrs = _masters(("port",) * 3, tmp_path)
    vsrv = _volume_server(tmp_path, addrs)
    yield masters, vsrv, addrs
    vsrv.stop()
    for ms in masters:
        ms.stop()
    rpc.reset_channels()


def test_three_masters_elect_assign_and_replicate_max_volume_id(ha_cluster):
    masters, vsrv, addrs = ha_cluster
    leader = _leader_master(masters)
    _wait(lambda: leader.topo.nodes, what="the volume server at the leader")
    r = requests.get(f"http://{leader.address}/dir/assign?count=1",
                     timeout=30).json()
    assert "fid" in r, r
    follower = next(m for m in masters if m is not leader)
    r = requests.get(f"http://{follower.address}/dir/assign?count=1",
                     timeout=30).json()
    assert "error" in r and r.get("leader") == leader.address
    st = requests.get(f"http://{leader.address}/cluster/raft/status",
                      timeout=30).json()
    assert st["role"] == "leader" and sorted(st["peers"]) == sorted(
        a for a in addrs if a != leader.address)
    _wait(lambda: all(m.topo.max_volume_id == leader.topo.max_volume_id > 0
                      for m in masters), what="MaxVolumeId everywhere")
    vid = requests.get(f"http://{leader.address}/dir/assign?count=1",
                       timeout=30).json()["fid"].split(",")[0]
    lr = requests.get(f"http://{follower.address}/dir/lookup?volumeId={vid}",
                      timeout=30).json()
    assert lr.get("locations"), lr
    page = requests.get(f"http://{leader.address}/ui", timeout=30)
    assert page.status_code == 200 and b"<h2>Raft</h2>" in page.content


def test_a_new_leader_after_the_leader_is_lost(ha_cluster):
    """The leader stops; the other two elect one, the volume server
    follows it, and a new volume's id is above every id assigned before,
    because MaxVolumeId was replicated."""
    masters, vsrv, addrs = ha_cluster
    leader = _leader_master(masters)
    _wait(lambda: leader.topo.nodes, what="the volume server at the leader")
    before = leader.topo.max_volume_id
    assert before > 0 or assign(leader.address).fid
    before = leader.topo.max_volume_id
    leader.stop()
    survivors = [m for m in masters if m is not leader]
    new = _leader_master(survivors)
    # the new leader holds every committed entry; it applies them once
    # an entry of its own term commits
    _wait(lambda: new.topo.max_volume_id >= before,
          what="the committed MaxVolumeId at the new leader")
    _wait(lambda: new.topo.nodes, what="the volume server at the new leader")
    r = {}

    def grown():
        r.update(requests.get(
            f"http://{new.address}/vol/grow?count=1&collection=after",
            timeout=30).json())
        return "error" not in r
    _wait(grown, what="a volume grown by the new leader")
    assert new.topo.max_volume_id > before
    env = CommandEnv(",".join(a for a in addrs if a != leader.address))
    out = io.StringIO()
    assert run_command(env, "cluster.raft.ps", out) == 0
    assert f"{new.address} Voter *leader*" in out.getvalue()


def test_cluster_raft_remove_and_add_from_the_shell(ha_cluster):
    """`cluster.raft.remove` of a follower shrinks the group, which keeps
    assigning; `cluster.raft.add` takes it back."""
    masters, vsrv, addrs = ha_cluster
    leader = _leader_master(masters)
    victim = next(m for m in masters if m is not leader)
    env = CommandEnv(leader.address)
    out = io.StringIO()
    assert run_command(env, "lock", out) == 0
    assert run_command(env, f"cluster.raft.remove -id={victim.address}",
                       out) == 0, out.getvalue()
    assert f"removed {victim.address}" in out.getvalue()
    _wait(lambda: victim.address not in leader.raft.status()["peers"],
          what="the victim out of the leader's peers")
    survivors = [m for m in masters if m is not victim]

    def assigns():
        for m in survivors:
            try:
                if not assign(m.address).error:
                    return True
            except grpc.RpcError:
                pass
        return False
    _wait(assigns, what="an assign from the remaining pair")
    out = io.StringIO()
    leader = _leader_master(survivors)
    env = CommandEnv(leader.address)
    assert run_command(env, "lock", out) == 0
    assert run_command(env, f"cluster.raft.add -id={victim.address}",
                       out) == 0, out.getvalue()
    assert f"added {victim.address}" in out.getvalue()
    _wait(lambda: victim.address in leader.raft.status()["peers"],
          what="the victim back among the leader's peers")


def test_a_group_of_both_packages_masters(tmp_path):
    """Two port masters and one reference master over HTTP: one leader,
    whichever package it is; MaxVolumeId equal on all three; both
    packages' shells print the same `cluster.raft.ps`."""
    masters, addrs = _masters(("port", "ref", "port"), tmp_path)
    vsrv = _volume_server(tmp_path, addrs)
    try:
        leader = _leader_master(masters)
        _wait(lambda: leader.topo.nodes, what="the volume server")

        def assigned():
            return "fid" in requests.get(
                f"http://{leader.address}/dir/assign?count=1",
                timeout=30).json()
        _wait(assigned, what="an assign at the leader")
        _wait(lambda: len({m.topo.max_volume_id for m in masters}) == 1,
              what="MaxVolumeId equal on every master")
        assert masters[0].topo.max_volume_id > 0
        outs = []
        for env_cls, run in ((RefEnv, ref_run_command),
                             (CommandEnv, run_command)):
            out = io.StringIO()
            assert run(env_cls(leader.address), "cluster.raft.ps", out) == 0
            outs.append(out.getvalue())
        assert outs[1] == outs[0]
        assert f"{leader.address} Voter *leader*" in outs[1]
    finally:
        vsrv.stop()
        for ms in masters:
            ms.stop()
        rpc.reset_channels()
        from seaweedfs_tpu.pb import rpc as ref_rpc

        ref_rpc.reset_channels()


def test_the_master_follower_command_serves(tmp_path):
    """`master.follower -peers` as a process of the port, without JAX:
    it joins the peers it is given and answers /cluster/raft/status."""
    import subprocess
    import sys

    from tests.test_torch_native_dataplane import REPO

    port = pick_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "master.follower",
         "-ip", "localhost", "-port", str(port), "-peers",
         f"localhost:{port}", "-mdir", str(tmp_path)], cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        wait_http(port, "/cluster/raft/status", proc=proc)
        _wait(lambda: requests.get(
            f"http://localhost:{port}/cluster/raft/status",
            timeout=10).json()["role"] == "leader",
            what="a one-member group to lead itself")
    finally:
        proc.terminate()
        proc.wait(60)
    assert os.path.exists(tmp_path / f"raft-localhost_{port}.json")
