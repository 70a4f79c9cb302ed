"""cluster.* commands (counterpart of seaweedfs_tpu/shell/commands/cluster.py;
SeaweedFS weed/shell/command_cluster_*.go).

The master's Raft group is not part of the port yet (ROADMAP.md A2d): a
port master always runs alone. `cluster.raft.ps` and `cluster.raft.leader`
show that one master and name the item; `cluster.raft.add` and
`cluster.raft.remove` fail, naming it.
"""

from __future__ import annotations

import time

from ...pb import master_pb2, volume_server_pb2 as vs
from ..registry import command

ROADMAP_RAFT = "ROADMAP.md A2d (master Raft: -peers)"


@command("cluster.ps", "list cluster processes (masters, volume servers, filers, brokers)")
def cluster_ps(env, args, out):
    """command_cluster_ps.go: volume servers from topology, filers/brokers
    from the master's cluster membership (weed/cluster)."""
    filer_group = args[0] if args else ""
    print(f"master: {env.master}", file=out)
    for dn in env.collect_data_nodes():
        print(f"  volume server: {dn.id} (grpc :{dn.grpc_port})", file=out)
    for node_type in ("filer", "broker"):
        try:
            resp = env.master_stub().ListClusterNodes(
                master_pb2.ListClusterNodesRequest(
                    client_type=node_type, filer_group=filer_group),
                timeout=10)
        # lint: allow-broad-except(a master without the RPC lists
        # no filers or brokers)
        except Exception:  # older master without the RPC
            continue
        for n in resp.cluster_nodes:
            star = " *leader*" if n.is_leader else ""
            group = f" group={filer_group}" if filer_group else ""
            print(f"  {node_type}: {n.address}{group}{star}", file=out)


@command("cluster.check", "ping every node and report health")
def cluster_check(env, args, out):
    t0 = time.time_ns()
    env.master_stub().Ping(master_pb2.PingRequest(), timeout=10)
    print(f"master {env.master}: ok "
          f"({(time.time_ns() - t0) / 1e6:.1f} ms)", file=out)
    for dn in env.collect_data_nodes():
        t0 = time.time_ns()
        try:
            env.volume_stub(dn.id).Ping(vs.PingRequest(), timeout=10)
            print(f"volume server {dn.id}: ok "
                  f"({(time.time_ns() - t0) / 1e6:.1f} ms)", file=out)
        except Exception as e:  # noqa: BLE001
            print(f"volume server {dn.id}: UNREACHABLE ({e})", file=out)


@command("cluster.status", "overall capacity and usage")
def cluster_status(env, args, out):
    stats = env.master_stub().Statistics(
        master_pb2.StatisticsRequest(), timeout=10)
    print(f"capacity: {stats.total_size}", file=out)
    print(f"used:     {stats.used_size}", file=out)
    print(f"files:    {stats.file_count}", file=out)


def _raft_servers(env):
    return env.master_stub().RaftListClusterServers(
        master_pb2.RaftListClusterServersRequest(), timeout=10
    ).cluster_servers


@command("cluster.raft.ps", "show Raft membership and roles")
def cluster_raft_ps(env, args, out):
    """command_cluster_raft_ps.go via master RaftListClusterServers —
    the same gRPC a stock `weed shell` issues."""
    for s in _raft_servers(env):
        star = " *leader*" if s.isLeader else ""
        print(f"  {s.id} {s.suffrage}{star}", file=out)
    print(f"single master: Raft is not part of the PyTorch port yet: "
          f"{ROADMAP_RAFT}", file=out)


@command("cluster.raft.leader", "print the current Raft leader")
def cluster_raft_leader(env, args, out):
    for s in _raft_servers(env):
        if s.isLeader:
            print(s.address, file=out)
            return
    print(env.master, file=out)


def _raft_member_op(op: str) -> None:
    raise NotImplementedError(
        f"cluster.raft.{op}: Raft is not part of the PyTorch port yet: "
        f"{ROADMAP_RAFT}")


@command("cluster.raft.add", "cluster.raft.add -id=<master-address>")
def cluster_raft_add(env, args, out):
    """command_cluster_raft_add.go: add a voter to the master Raft group."""
    _raft_member_op("add")


@command("cluster.raft.remove", "cluster.raft.remove -id=<master-address>")
def cluster_raft_remove(env, args, out):
    """command_cluster_raft_remove.go: remove a server from the master
    Raft group."""
    _raft_member_op("remove")
