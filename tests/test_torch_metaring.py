"""The port's metadata ring against the JAX package's, on the CPU.

For seeded shard sets of 1 to 8 addresses and 10,000 seeded paths, both
packages' `cluster/metaring.py` give the same owner for every entry key
and every listing key, at the default 64 virtual nodes and at 8. The
reference's golden layout holds in the port. Join and leave churn moves
the same keys in both, and only to (or from) the shard that changed. The
ring fields of a `MetaRingResponse` are the same bytes, through
`fill_response`, through each package's master (`JoinMetaRing`,
`GetMetaRing`), and through a port filer's `GetMetaRing` proxy. The
`MetaRingClient` of each package routes the same over the port master's
published ring, with the one stale-ring retry. And two port filers in
shard mode (`SWFS_META_SHARD=1`) join the port master's ring: each
answers 410 with the ring epoch for keys the other owns, over HTTP and
gRPC. Comparisons are exact."""

import os
import random
import socket
import time

import grpc
import numpy as np
import pytest
import requests

from seaweedfs_tpu.cluster import metaring as ref_metaring
from seaweedfs_tpu.pb import meta_ring_pb2 as ref_ring_pb2
from seaweedfs_tpu.pb import rpc as ref_rpc
from seaweedfs_tpu.server.master import MasterServer as RefMaster
from seaweedfs_tpu.wdclient import MasterClient as RefMasterClient
from seaweedfs_tpu.wdclient import MetaRingClient as RefMetaRingClient
from seaweedfs_tpu_torch.cluster import metaring
from seaweedfs_tpu_torch.pb import filer_pb2
from seaweedfs_tpu_torch.pb import meta_ring_pb2
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.server.filer import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.wdclient import MasterClient, MetaRingClient
from tests import torch_ports

N_PATHS = 10_000
_PORTS = random.Random(os.getpid() + 29)
_RESERVED = {p + d for p in (8888, 9333, 8080) for d in (0, 10000, 11000)}


def _free_port_pair(taken=()) -> int:
    """A free HTTP port and its gRPC twin (+10000), below the kernel's
    ephemeral range, never a reference default or its twins."""
    for _ in range(400):
        port = torch_ports.draw(_PORTS, 12000, 21000)
        if port in taken or {port, port + 10000, port + 11000} & _RESERVED:
            continue
        try:
            for p in (port, port + 10000):
                with socket.socket() as s:
                    s.bind(("", p))
        except OSError:
            continue
        return port
    raise RuntimeError("no free port pair")


def _shards(n: int, seed: int) -> list[str]:
    rng = random.Random(seed)
    return [f"10.{rng.randrange(256)}.{rng.randrange(256)}."
            f"{rng.randrange(1, 255)}:{rng.randrange(1024, 65536)}"
            for _ in range(n)]


def _paths(seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    words = ["buckets", "data", "logs", "2026", "a", "b_c", "%x", "üñí",
             "deep", "tmp", "topics", ".system"]
    out = []
    for _ in range(N_PATHS):
        depth = int(rng.integers(1, 7))
        parts = [words[int(i)] if rng.random() < 0.6
                 else f"n{int(rng.integers(0, 1 << 20)):x}"
                 for i in rng.integers(0, len(words), depth)]
        out.append("/" + "/".join(parts) + ("/" if rng.random() < 0.1
                                             else ""))
    return out


def _routes(mod, shards, paths, replicas=None) -> tuple:
    ring = mod.MetaRing(shards, epoch=3, replicas=replicas)
    return ([ring.shard_for_entry(p) for p in paths],
            [ring.shard_for_directory(p) for p in paths])


@pytest.mark.parametrize("replicas", [None, 8])
@pytest.mark.parametrize("n", range(1, 9))
def test_every_key_has_the_same_owner(n, replicas):
    shards = _shards(n, 100 + n)
    paths = _paths(n)
    got = _routes(metaring, shards, paths, replicas)
    assert got == _routes(ref_metaring, shards, paths, replicas)
    assert set(got[0]) <= set(shards)


def test_the_reference_golden_layout_holds():
    shards = [f"localhost:888{i}" for i in range(1, 5)]
    keys = ["/", "/a", "/a/b", "/a/b/c", "/buckets/b1", "/buckets/b2",
            "/deep/p0", "/deep/p1", "/deep/p2", "/deep/p3", "/deep/p4",
            "/x", "/y", "/z", "/tmp/scratch", "/logs/2026/08/07"]
    port = metaring.MetaRing(shards, epoch=7, replicas=8)
    ref = ref_metaring.MetaRing(shards, epoch=7, replicas=8)
    assert [port.shard_for_key(k) for k in keys] == \
        [ref.shard_for_key(k) for k in keys]
    assert port.shard_for_key("/a/b") == "localhost:8881"  # the golden pin
    assert [metaring.hash64(k) for k in keys] == \
        [ref_metaring.hash64(k) for k in keys]
    assert port._points == ref._points
    assert port.describe() == ref.describe()


@pytest.mark.parametrize("seed", range(4))
def test_churn_moves_the_same_keys(seed):
    rng = random.Random(seed)
    shards = _shards(rng.randrange(2, 8), seed)
    newcomer = _shards(1, 1000 + seed)[0]
    paths = _paths(50 + seed)[:3000]
    moved = {}
    for name, mod in (("port", metaring), ("ref", ref_metaring)):
        ring = mod.MetaRing(shards, epoch=1)
        grown = ring.with_shard(newcomer)
        shrunk = ring.without_shard(shards[0])
        assert (grown.epoch, shrunk.epoch) == (2, 2)
        before = [ring.shard_for_entry(p) for p in paths]
        after_join = [grown.shard_for_entry(p) for p in paths]
        after_leave = [shrunk.shard_for_entry(p) for p in paths]
        joined = [i for i, (a, b) in enumerate(zip(before, after_join))
                  if a != b]
        left = [i for i, (a, b) in enumerate(zip(before, after_leave))
                if a != b]
        assert all(after_join[i] == newcomer for i in joined)
        assert all(before[i] == shards[0] for i in left)
        moved[name] = (joined, left)
    assert moved["port"] == moved["ref"]


def test_wrong_shard_details_cross_packages():
    err = metaring.WrongShardError(9, "10.0.0.1:8888")
    back = ref_metaring.WrongShardError.from_details(str(err))
    assert (back.epoch, back.owner) == (9, "10.0.0.1:8888")
    err = ref_metaring.WrongShardError(4, "h:1")
    back = metaring.WrongShardError.from_details(str(err))
    assert (back.epoch, back.owner) == (4, "h:1")


def test_ring_responses_are_the_same_bytes():
    for shards in ([], _shards(1, 7), _shards(5, 8)):
        port, ref = meta_ring_pb2.MetaRingResponse(), \
            ref_ring_pb2.MetaRingResponse()
        metaring.MetaRing(shards, epoch=12).fill_response(port)
        ref_metaring.MetaRing(shards, epoch=12).fill_response(ref)
        assert port.SerializeToString(deterministic=True) == \
            ref.SerializeToString(deterministic=True)
        assert metaring.MetaRing.from_response(ref) == \
            metaring.MetaRing(shards, epoch=12)


# -- through the masters, the filer proxy and the clients ----------------------


def _start_master(cls, port):
    ms = cls(ip="127.0.0.1", port=port, allocate_fn=lambda *a: None)
    ms.start(vacuum_interval=3600)
    return ms


def _stop(server) -> None:
    server.stop()
    server._http_server.server_close()
    server._grpc_server.stop(None).wait(10)


def _ring_answers(cls, ring_pb, rpc_mod, port) -> list:
    ms = _start_master(cls, port)
    try:
        stub = rpc_mod.master_stub(f"127.0.0.1:{port + 10000}")
        out = []
        for addr, leave in (("127.0.0.1:3", False), ("127.0.0.1:1", False),
                            ("127.0.0.1:2", False), ("127.0.0.1:1", False),
                            ("127.0.0.1:2", True), ("127.0.0.1:9", True)):
            out.append(stub.JoinMetaRing(ring_pb.JoinMetaRingRequest(
                address=addr, leave=leave), timeout=30).SerializeToString(
                    deterministic=True))
            out.append(stub.GetMetaRing(ring_pb.GetMetaRingRequest(),
                                        timeout=30).SerializeToString(
                deterministic=True))
        out.append(requests.get(f"http://127.0.0.1:{port}/cluster/status",
                                timeout=30).json()["MetaRing"])
    finally:
        _stop(ms)
        rpc_mod.reset_channels()
    return out


def test_the_masters_publish_the_same_ring():
    port = _free_port_pair()
    assert _ring_answers(MasterServer, meta_ring_pb2, rpc, port) == \
        _ring_answers(RefMaster, ref_ring_pb2, ref_rpc, port)


@pytest.fixture
def master():
    port = _free_port_pair()
    ms = _start_master(MasterServer, port)
    yield ms
    _stop(ms)
    rpc.reset_channels()
    ref_rpc.reset_channels()


def test_both_clients_route_the_same_over_the_port_master(master):
    shards = _shards(4, 77)
    for s in shards:
        master.meta_ring_join(s)
    paths = _paths(3)[:2000]
    clients = [MetaRingClient(master=MasterClient(master.address), ttl=60),
               RefMetaRingClient(master=RefMasterClient(master.address),
                                 ttl=60)]
    routes = [([c.route_entry(p) for p in paths],
               [c.route_directory(p) for p in paths]) for c in clients]
    assert routes[0] == routes[1]
    assert clients[0].ring().epoch == 4
    # a 410 from a shard at a newer epoch: one refresh, one retry
    master.meta_ring_join(shards[0], leave=True)
    calls = []

    def fn(addr):
        calls.append(addr)
        if len(calls) == 1:
            raise metaring.WrongShardError(5, "")
        return addr

    key = next(p for p in paths
               if clients[0].route_entry(p) == shards[0])
    owner = clients[0].call_routed(key, fn)
    assert calls == [shards[0], owner] and owner != shards[0]
    assert clients[0].ring().epoch == 5


def _wait(pred, what: str, timeout: float = 30.0) -> None:
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, what
        time.sleep(0.05)


def test_shard_mode_filers_join_and_answer_wrong_shard(master, tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("SWFS_META_SHARD", "1")
    monkeypatch.setattr(FilerServer, "META_RING_RENEW_S", 0.2)
    ports = [_free_port_pair([master.port])]
    ports.append(_free_port_pair([master.port] + ports))
    filers = [FilerServer(ip="127.0.0.1", port=p, master=master.address,
                          store="memory") for p in ports]
    http = requests.Session()
    http.trust_env = False
    try:
        for f in filers:
            f.start()
        _wait(lambda: all(f.ring_snapshot() is not None
                          and len(f.ring_snapshot()) == 2 for f in filers),
              "both shards in both rings")
        ring = filers[0].ring_snapshot()
        assert ring == master.meta_ring
        assert sorted(ring.shards) == sorted(f.address for f in filers)
        # the filer proxies the master's ring to gateways
        proxied = rpc.filer_stub(f"127.0.0.1:{ports[1] + 10000}").GetMetaRing(
            meta_ring_pb2.GetMetaRingRequest(), timeout=30)
        assert metaring.MetaRing.from_response(proxied) == ring
        # a directory whose entry and listing keys one shard owns; the
        # other shard is wrong for both
        home = ring.shard_for_directory("/dirs")
        d = next(f"/dirs/d{i}" for i in range(100)
                 if ring.shard_for_directory(f"/dirs/d{i}") == home)
        right, wrong = sorted(filers, key=lambda f: f.address != home)
        r = http.get(f"http://{wrong.address}{d}/?limit=5", timeout=30)
        assert r.status_code == metaring.WRONG_SHARD_STATUS
        assert r.headers[metaring.EPOCH_HEADER] == str(ring.epoch)
        assert r.json()["owner"] == right.address
        stub = rpc.filer_stub(f"127.0.0.1:{wrong.grpc_port}")
        with pytest.raises(grpc.RpcError) as e:
            list(stub.ListEntries(filer_pb2.ListEntriesRequest(
                directory=d), timeout=30))
        assert e.value.code() == grpc.StatusCode.FAILED_PRECONDITION
        err = metaring.wrong_shard_of(e.value)
        assert (err.epoch, err.owner) == (ring.epoch, right.address)
        ok = rpc.filer_stub(f"127.0.0.1:{right.grpc_port}")
        entry = filer_pb2.Entry(name="x", is_directory=True)
        assert not ok.CreateEntry(filer_pb2.CreateEntryRequest(
            directory=d, entry=entry), timeout=30).error
        assert [r.entry.name for r in ok.ListEntries(
            filer_pb2.ListEntriesRequest(directory=d), timeout=30)] == ["x"]
    finally:
        http.close()
        for f in filers:
            if f._grpc_server is not None:
                _stop(f)
    # a polite leave on stop: the master's ring is empty again
    assert len(master.meta_ring) == 0
