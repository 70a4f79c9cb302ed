"""cluster.* commands (counterpart of seaweedfs_tpu/shell/commands/cluster.py;
SeaweedFS weed/shell/command_cluster_*.go)."""

from __future__ import annotations

import time

from ...pb import master_pb2, volume_server_pb2 as vs
from ..registry import command


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


@command("cluster.raft.leader", "print the current Raft leader")
def cluster_raft_leader(env, args, out):
    for s in _raft_servers(env):
        if s.isLeader:
            print(s.address, file=out)
            return
    print(env.master, file=out)


def _raft_leader_addr(env) -> str:
    for s in _raft_servers(env):
        if s.isLeader:
            return s.address
    return env.master


def _raft_member_op(env, args, out, op: str) -> None:
    from ...pb import rpc
    from ..registry import kv_flags

    env.confirm_is_locked()  # membership changes mutate cluster topology
    opts = kv_flags(args)
    if not opts.get("id"):
        raise RuntimeError(f"usage: cluster.raft.{op} -id=<master-address>")
    # membership ops must land on the leader (followers reject them)
    stub = rpc.master_stub(rpc.grpc_address(_raft_leader_addr(env)))
    if op == "add":
        stub.RaftAddServer(master_pb2.RaftAddServerRequest(
            id=opts["id"], address=opts["id"], voter=True), timeout=10)
    else:
        stub.RaftRemoveServer(master_pb2.RaftRemoveServerRequest(
            id=opts["id"]), timeout=10)
    verb = "added" if op == "add" else "removed"
    members = sorted(s.id for s in _raft_servers(env))
    print(f"{verb} {opts['id']}; members: {members}", file=out)


@command("cluster.raft.add", "cluster.raft.add -id=<master-address>")
def cluster_raft_add(env, args, out):
    """command_cluster_raft_add.go: add a voter to the master Raft group
    (the new master should be started with matching -peers)."""
    _raft_member_op(env, args, out, "add")


@command("cluster.raft.remove", "cluster.raft.remove -id=<master-address>")
def cluster_raft_remove(env, args, out):
    """command_cluster_raft_remove.go: remove a server from the master
    Raft group."""
    _raft_member_op(env, args, out, "remove")
