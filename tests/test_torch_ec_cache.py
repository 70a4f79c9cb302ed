"""The port's volume servers and the master's EC shard map, on the CPU.

A volume server keeps the master's map of where an EC volume's shards
live (`_lookup_ec_shards`, cachedLookupEcShardLocations in SeaweedFS).
The reference keeps every answer for 10 s, an empty answer after a
failed lookup too, so that for 10 s after a master hiccup, a lost
server, or a rebuild, a degraded read fails and a scrub verifies nothing
without a word. The port keeps a failed or empty answer 1 s, and a read
or a scrub that cannot be served from a cached map asks the master
again.

One port cluster in process (a master, four volume servers in two racks,
RSCodecTorch on the CPU): seeded needles, `ec.encode`, the server holding
the most shards stopped. Then, with no cache cleared and no sleep: a
server whose EC lookup failed serves every needle by GET and HEAD as soon
as the master answers it again; and `volume.scrub -full` run on every
shard holder right after `ec.rebuild` onto a fresh server verifies every
holder's shards."""

import io
import os
import random
import re
import socket
import time

import numpy as np
import pytest
import requests
import torch

from seaweedfs_tpu_torch.operation import submit
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.shell.registry import run_command
from seaweedfs_tpu_torch.storage.ec_locate import Geometry
from seaweedfs_tpu_torch.wdclient import pool
from tests import torch_ports

GEO = dict(large_block=10000, small_block=100)
N_NEEDLES = 30
RACKS = ("r0", "r0", "r1", "r1")

_PORTS = random.Random(os.getpid() + 29)


def _free_port_pair(taken=()) -> int:
    """A free HTTP port and its gRPC twin (+10000), below the kernel's
    ephemeral range."""
    for _ in range(400):
        port = torch_ports.draw(_PORTS, 12000, 21000)
        if port in taken:
            continue
        try:
            for p in (port, port + 10000):
                with socket.socket() as s:
                    s.bind(("", p))
        except OSError:
            continue
        return port
    raise RuntimeError("no free port pair")


class _Cluster:
    def __init__(self, root: str):
        self.root = root
        ports: list[int] = []
        for _ in range(6):  # the master, four servers, the fresh one
            ports.append(_free_port_pair(ports))
        self.ports = ports
        self.master = MasterServer(ip="127.0.0.1", port=ports[0],
                                   volume_size_limit_mb=64,
                                   placement_seed=3)
        self.master.start(vacuum_interval=3600)
        self.servers: dict[str, VolumeServer] = {}
        for i, rack in enumerate(RACKS):
            self.add(ports[1 + i], rack)

    def add(self, port: int, rack: str) -> VolumeServer:
        d = os.path.join(self.root, f"v{port}")
        os.mkdir(d)
        srv = VolumeServer(directories=[d], master=self.master.address,
                           ip="127.0.0.1", port=port, rack=rack,
                           pulse_seconds=1,
                           coder=RSCodecTorch(10, 4, device="cpu"),
                           ec_geometry=Geometry(**GEO))
        srv.start()
        self.servers[srv.address] = srv
        self.settle()
        return srv

    def stop(self, address: str) -> None:
        srv = self.servers.pop(address)
        srv.stop()
        srv._http_server.server_close()
        srv._grpc_server.stop(None).wait(10)
        self.settle()

    def close(self) -> None:
        for address in list(self.servers):
            srv = self.servers.pop(address)
            srv.stop()
            srv._http_server.server_close()
            srv._grpc_server.stop(None).wait(10)
        self.master.stop()
        self.master._http_server.server_close()
        self.master._grpc_server.stop(None).wait(10)
        rpc.reset_channels()
        pool.POOL.clear()

    def settle(self, timeout: float = 30.0) -> None:
        """Heartbeat now, and wait until the master's view of every
        node's EC shards is what the node holds."""
        deadline = time.time() + timeout
        while True:
            for srv in self.servers.values():
                srv.trigger_heartbeat()
            want = {a: sorted((e.id, e.ec_index_bits) for e in
                              s.store.collect_heartbeat().ec_shards)
                    for a, s in self.servers.items()}
            with self.master.topo._lock:
                got = {url: sorted((e.volume_id, e.bits)
                                   for e in dn.ec_shards.values())
                       for url, dn in self.master.topo.nodes.items()}
            if got == want:
                return
            assert time.time() < deadline, (got, want)
            time.sleep(0.05)

    def holders(self, vid: int) -> dict[str, list[int]]:
        return {a: sorted(s.store.find_ec_volume(vid).shard_files)
                for a, s in self.servers.items()
                if s.store.find_ec_volume(vid) is not None}


def _sh(env, line: str) -> str:
    out = io.StringIO()
    code = run_command(env, line, out)
    assert code == 0, f"{line!r} failed:\n{out.getvalue()}"
    return out.getvalue()


@pytest.fixture(scope="module")
def degraded(tmp_path_factory):
    """A cluster whose EC volume lost the server holding the most shards;
    -> (cluster, shell env, vid, {fid: bytes})."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    c = _Cluster(str(tmp_path_factory.mktemp("ec-cache")))
    try:
        env = CommandEnv(c.master.address)
        _sh(env, "volume.grow -collection c -count 1")
        rng = np.random.default_rng(13)
        blobs = {}
        for _ in range(N_NEEDLES):
            data = rng.integers(0, 256, int(rng.integers(300, 3000)),
                                dtype=np.uint8).tobytes()
            r = submit(c.master.address, data, collection="c")
            blobs[r["fid"]] = data
        vid = int(next(iter(blobs)).split(",")[0])
        assert {int(f.split(",")[0]) for f in blobs} == {vid}
        for line in ("lock", f"ec.encode -volumeId {vid}", "unlock"):
            _sh(env, line)
        c.settle()
        held = c.holders(vid)
        victim = max(sorted(held), key=lambda a: len(held[a]))
        assert len(held[victim]) == 4
        c.stop(victim)
        yield c, env, vid, blobs
    finally:
        c.close()
        torch.set_num_threads(n)


def _read_all(http, address: str, blobs: dict) -> tuple[list, list]:
    gets = [(http.get(f"http://{address}/{fid}", timeout=60), data)
            for fid, data in blobs.items()]
    heads = [http.head(f"http://{address}/{fid}", timeout=60)
             for fid in blobs]
    return ([r.status_code == 200 and r.content == data
             for r, data in gets], [r.status_code for r in heads])


def test_a_server_whose_lookup_failed_reads_once_the_master_answers(
        degraded):
    """The EC lookup of one server fails (its master address points
    nowhere) while it serves the degraded volume, so reads that need
    another server's shards fail; once the master answers again, the
    very next GET and HEAD of every needle succeed."""
    c, _env, vid, blobs = degraded
    http = requests.Session()
    http.trust_env = False
    srv = min(c.servers.values(),
              key=lambda s: len(c.holders(vid).get(s.address, [])))
    good = srv.master_grpc
    try:
        srv._ec_loc_cache.pop(vid, None)  # the read below asks the master
        srv.master_grpc = f"127.0.0.1:{_free_port_pair(c.ports) + 10000}"
        failed = 0
        for fid in blobs:  # until a read needs the master's map
            r = http.get(f"http://{srv.address}/{fid}", timeout=60)
            if r.status_code != 200:
                failed += 1
                break
        assert failed, "no needle needed the master's map"
        srv.master_grpc = good
        ok, heads = _read_all(http, srv.address, blobs)
        assert all(ok)
        assert heads == [200] * len(blobs)
    finally:
        srv.master_grpc = good
        http.close()


def test_a_scrub_right_after_a_rebuild_verifies_every_holder(degraded):
    """A degraded read through one shard holder leaves it a map that
    lacks the lost shards; `ec.rebuild` puts them on a fresh server; a full
    scrub of every holder right away, that one first, verifies bytes on
    each of them, the fresh one included, and finds nothing."""
    c, env, vid, blobs = degraded
    c.add(c.ports[5], "r0")
    node = sorted(c.holders(vid))[0]
    srv = c.servers[node]
    srv._ec_loc_cache.pop(vid, None)  # the read below takes the map now
    http = requests.Session()
    http.trust_env = False
    try:
        for fid, data in blobs.items():  # until one read took the map
            r = http.get(f"http://{node}/{fid}", timeout=60)
            assert r.status_code == 200 and r.content == data
            if vid in srv._ec_loc_cache:
                break
        assert len(srv._ec_loc_cache[vid][1]) == 10
    finally:
        http.close()
    for line in ("lock", f"ec.rebuild -volumeId {vid}", "unlock"):
        _sh(env, line)
    c.settle()
    held = c.holders(vid)
    assert sorted(s for shards in held.values() for s in shards) == \
        list(range(14))
    for holder in [node] + sorted(set(held) - {node}):
        report = _sh(env, f"volume.scrub -node={holder} -volumeId {vid} "
                          f"-full")
        m = re.search(r"(\d+) bytes, (\d+) finding\(s\)", report)
        assert m, report
        assert int(m.group(1)) > 0, f"{holder} verified nothing:\n{report}"
        assert int(m.group(2)) == 0, report
