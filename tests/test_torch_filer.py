"""The port's filer against the JAX package's, on the CPU.

The building blocks first: `filechunks` over seeded, overlapping and
out-of-order chunk lists; the memory, sqlite and leveldb stores over one
seeded sequence of inserts, updates, deletes and paged prefix listings;
each package's filer opening a store directory the other package's filer
wrote (its sqlite file or leveldb directory, with the metadata log kept in
the store).

Then the running filer. One script runs four times on the same addresses,
one run after the other: the reference filer on a reference cluster (a
master and four volume servers in two racks, numpy coder), the port's
filer on a port cluster (RSCodecTorch on the CPU), and each package's
filer on the other package's cluster. A cluster has four volume servers
where two would lose the EC volume with one of them: RS(10,4) spreads 14
shards 4+4+3+3, and the degraded GETs need ten. The script PUTs small and
multi-chunk files (the filer at 1 MiB chunks), GETs them whole, by ranges
across chunk boundaries, conditionally and by HEAD, pages a listing,
renames through `fs.mv`, deletes recursively, runs the shell's `ec.encode`
on the filer's collection, stops the server holding the most shards and
GETs every file again: the lost chunks are reconstructed by the volume
servers. Status codes, bodies, ETags, listings, the EC files' sha256 and
the `fs.*` output of both packages' shells on the same filer must be
equal in all four runs (tolerance 0: storage is exact). Every run pins
both packages' needle, entry and filer clocks to one fake clock, the
cookie source and the placement generator to fixed seeds, flushes the
metadata log only at close (its timer runs on the wall clock), and turns
the chunk pipeline and the filer's chunk cache off so that uploads are
sequential and every GET reaches the volume servers. A second, shorter
script runs with both left at their defaults, on each package's own
cluster: files overwritten, read, deleted and read again through the
filer's chunk cache, with the same answers and cache hits in both.

Then `python -m seaweedfs_tpu_torch filer`, `server -filer` and `shell
-filer` as processes without JAX; every network store opened over its
fake server, a filer on redis2 and a `server -filer` on mysql2 through
filer.toml, and a store whose address refuses stopping the filer at
start. Servers bind ports below the kernel's ephemeral range,
never the reference's defaults (8888, 9333, 8080) or their +10000 and
+11000 twins."""

import hashlib
import io
import os
import random
import re
import secrets
import signal
import socket
import subprocess
import sys
import time

import grpc
import numpy as np
import pytest
import requests
import torch

from seaweedfs_tpu.filer import chunk_pipeline as ref_chunk_pipeline
from seaweedfs_tpu.filer import entry as ref_entry
from seaweedfs_tpu.filer import filechunks as ref_filechunks
from seaweedfs_tpu.filer import filer as ref_filer_core
from seaweedfs_tpu.filer import meta_log as ref_meta_log
from seaweedfs_tpu.filer.filerstore import get_store as ref_get_store
from seaweedfs_tpu.models.coder import new_coder as ref_new_coder
from seaweedfs_tpu.pb import filer_pb2 as ref_filer_pb2
from seaweedfs_tpu.pb import rpc as ref_rpc
from seaweedfs_tpu.server import filer as ref_filer_server
from seaweedfs_tpu.server.master import MasterServer as RefMaster
from seaweedfs_tpu.server.volume import VolumeServer as RefVolume
from seaweedfs_tpu.shell.env import CommandEnv as RefEnv
from seaweedfs_tpu.shell.registry import run_command as ref_run_command
from seaweedfs_tpu.storage import needle as ref_needle
from seaweedfs_tpu.storage.ec_locate import Geometry as RefGeometry
from seaweedfs_tpu.utils import trace as ref_trace
from seaweedfs_tpu.wdclient import pool as ref_pool
from seaweedfs_tpu_torch import command
from seaweedfs_tpu_torch.filer import chunk_pipeline
from seaweedfs_tpu_torch.filer import entry as port_entry
from seaweedfs_tpu_torch.filer import filechunks
from seaweedfs_tpu_torch.filer import filer as filer_core
from seaweedfs_tpu_torch.filer import meta_log
from seaweedfs_tpu_torch.filer.filerstore import get_store
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
from seaweedfs_tpu_torch.pb import filer_pb2
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.server import filer as filer_server
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.shell.registry import run_command
from seaweedfs_tpu_torch.storage import needle, recovery
from seaweedfs_tpu_torch.storage.ec_locate import Geometry
from seaweedfs_tpu_torch.utils import trace
from seaweedfs_tpu_torch.wdclient import pool
from tests import test_torch_stores as store_fakes
from tests import torch_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# EC blocks of the test geometry: a volume of a few MiB is all small
# blocks, and a 1 MiB chunk spans two of them
LARGE, SMALL = 64 * (1 << 20), 1 << 19
MIB = 1 << 20
PLACEMENT_SEED = 21
COOKIE_SEED = 22
RACKS = ("r0", "r0", "r1", "r1")
COLLECTION = "f"


# -- ports ---------------------------------------------------------------------

_PORTS = random.Random(os.getpid() + 17)
# the reference's default ports and the gRPC (+10000) and admin (+11000)
# ports derived from them
_RESERVED = {p + d for p in (8888, 9333, 8080) for d in (0, 10000, 11000)}


def _free_port_pair(taken=()) -> int:
    """A free HTTP port whose +10000 and +11000 twins are free too, all
    below the kernel's ephemeral range, so no other test's port-0 bind can
    take one between this pick and the server's bind."""
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


def _ports() -> list[int]:
    out: list[int] = []
    for _ in range(6):  # the master, four volume servers, the filer
        out.append(_free_port_pair(out))
    return out


PORTS = _ports()
FILER_PORT = PORTS[5]


# -- the building blocks -------------------------------------------------------


def _chunk_list(pb, seed: int) -> list:
    """A seeded chunk list: overlapping extents, out of order, some
    rewritten later (a newer modified_ts_ns shadows older bytes)."""
    rng = np.random.default_rng(seed)
    chunks = []
    for i in range(int(rng.integers(1, 24))):
        off = int(rng.integers(0, 5000))
        size = int(rng.integers(1, 3000))
        chunks.append(pb.FileChunk(
            file_id=f"{int(rng.integers(1, 9))},{i:x}{int(rng.integers(0, 1 << 32)):08x}",
            offset=off, size=size,
            modified_ts_ns=int(rng.integers(1, 1 << 40)),
            e_tag=f"{int(rng.integers(0, 1 << 32)):08x}"))
    return chunks


def _views(mod, chunks, offset, size) -> list:
    return [(v.file_id, v.logical_offset, v.size, v.chunk_offset,
             v.is_full_chunk)
            for v in mod.view_from_chunks(chunks, offset, size)]


@pytest.mark.parametrize("seed", range(8))
def test_filechunks_resolve_like_the_reference(seed):
    ref_chunks = _chunk_list(ref_filer_pb2, seed)
    chunks = _chunk_list(filer_pb2, seed)
    assert filechunks.total_size(chunks) == \
        ref_filechunks.total_size(ref_chunks)
    assert filechunks.etag(chunks) == ref_filechunks.etag(ref_chunks)
    total = filechunks.total_size(chunks)
    rng = np.random.default_rng(100 + seed)
    spans = [(0, None), (0, total)] + [
        (int(a), int(b)) for a, b in zip(rng.integers(0, total + 10, 6),
                                         rng.integers(0, 4000, 6))]
    for offset, size in spans:
        assert _views(filechunks, chunks, offset, size) == \
            _views(ref_filechunks, ref_chunks, offset, size)


def _store_kwargs(kind: str, root: str) -> dict:
    if kind == "sqlite":
        return {"db_path": os.path.join(root, "filer.db")}
    if kind == "leveldb":
        return {"directory": root}
    return {}


def _store_ops(entry_mod, pb, store, seed: int) -> list:
    """One seeded sequence of store operations -> every answer."""
    rng = random.Random(seed)
    dirs = ["/a", "/a/b", "/a/b/c", "/x_1", "/x%y"]
    names = [f"n{i:02d}" for i in range(30)] + ["_", "%", "a_b", "ab"]
    answers = []
    live = set()
    for step in range(300):
        op = rng.random()
        d = rng.choice(dirs)
        path = f"{d}/{rng.choice(names)}"
        if op < 0.5:
            e = entry_mod.Entry(full_path=path, attr=entry_mod.Attr(
                mtime=step, crtime=step, mode=0o660,
                mime=rng.choice(["", "text/plain"])),
                chunks=[pb.FileChunk(file_id=f"3,{step:x}01020304",
                                     size=step + 1)])
            store.insert_entry(e)
            live.add(path)
        elif op < 0.6 and live:
            p = rng.choice(sorted(live))
            e = store.find_entry(p)
            e.attr.mode = 0o600
            store.update_entry(e)
        elif op < 0.75:
            store.delete_entry(path)
            live.discard(path)
        elif op < 0.77:
            store.delete_folder_children(d)
            live = {p for p in live if not p.startswith(d + "/")}
        elif op < 0.85:
            e = store.find_entry(path)
            answers.append(("find", path,
                            None if e is None else e.to_pb()
                            .SerializeToString(deterministic=True)))
        else:
            start = rng.choice(["", "n05", "n10", "a_b"])
            prefix = rng.choice(["", "n1", "a_", "%"])
            listed = list(store.list_directory_entries(
                d, start, rng.random() < 0.5, rng.randrange(1, 12), prefix))
            answers.append(("list", d, start, prefix,
                            [e.full_path for e in listed]))
    store.kv_put(b"k1", b"v1")
    answers.append(("kv", store.kv_get(b"k1"), store.kv_get(b"nope")))
    return answers


@pytest.mark.parametrize("kind", ["memory", "sqlite", "leveldb"])
def test_stores_answer_like_the_reference(kind, tmp_path):
    ref_root, port_root = tmp_path / "ref", tmp_path / "port"
    ref_root.mkdir()
    port_root.mkdir()
    ref_store = ref_get_store(kind, **_store_kwargs(kind, str(ref_root)))
    port_store = get_store(kind, **_store_kwargs(kind, str(port_root)))
    try:
        assert _store_ops(port_entry, filer_pb2, port_store, 7) == \
            _store_ops(ref_entry, ref_filer_pb2, ref_store, 7)
    finally:
        ref_store.close()
        port_store.close()


def _fill_filer(core, entry_mod, pb, store) -> None:
    f = core.Filer(store)
    for i in range(40):
        f.create_entry(entry_mod.Entry(
            full_path=f"/data/d{i % 4}/f{i:02d}",
            attr=entry_mod.Attr(mtime=1000 + i, crtime=1000 + i, mode=0o660),
            chunks=[pb.FileChunk(file_id=f"5,{i:x}0a0b0c0d", size=100 + i,
                                 modified_ts_ns=i)]))
    f.rename("/data/d0/f00", "/data/d1/moved")
    f.delete_entry("/data/d3", recursive=True)
    f.store.kv_put(b"meta.rename.intents", b"{}")
    f.meta_log.close()  # flush the metadata log into the store
    store.close()


def _read_filer(core, store) -> dict:
    f = core.Filer(store, persist_meta_log=True)
    try:
        out = {d: [(e.full_path, e.to_pb().SerializeToString(
            deterministic=True)) for e in f.list_entries(d, limit=100)]
            for d in ("/", "/data", "/data/d0", "/data/d1", "/data/d2",
                      "/data/d3")}
        events, _ = f.read_events(0, timeout=0)
        out["events"] = [(m.directory, m.event_notification.old_entry.name,
                          m.event_notification.new_entry.name)
                         for m in events]
        out["kv"] = f.store.kv_get(b"meta.rename.intents")
    finally:
        f.meta_log.close()
        store.close()
    return out


@pytest.mark.parametrize("kind", ["sqlite", "leveldb"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_opens_the_others_store_directory(kind, writer,
                                                       tmp_path):
    """A directory one package's filer wrote (entries, renames, a
    recursive delete, the KV table and the metadata log) lists and
    replays the same in both packages."""
    kwargs = _store_kwargs(kind, str(tmp_path))
    pkgs = {"ref": (ref_filer_core, ref_entry, ref_filer_pb2, ref_get_store),
            "port": (filer_core, port_entry, filer_pb2, get_store)}
    core, entry_mod, pb, get = pkgs[writer]
    _fill_filer(core, entry_mod, pb, get(kind, **kwargs))
    read = {name: _read_filer(c, g(kind, **kwargs))
            for name, (c, _e, _pb, g) in pkgs.items()}
    assert read["port"] == read["ref"]
    assert len(read["port"]["/data/d1"]) == 11
    assert read["port"]["/data/d3"] == []
    assert len(read["port"]["events"]) >= 40


# -- the running filer ---------------------------------------------------------


class Clock:
    """A stand-in for the `time` module the needle, entry and filer
    modules read: every call moves it on by one microsecond."""

    def __init__(self):
        self.ns = 1_700_000_000_000_000_000

    def time_ns(self) -> int:
        self.ns += 1000
        return self.ns

    def time(self) -> float:
        return self.time_ns() / 1e9

    def perf_counter(self) -> float:
        return time.perf_counter()

    def monotonic(self) -> float:
        return time.monotonic()

    def strftime(self, *a):
        return time.strftime(*a)

    def gmtime(self, *a):
        return time.gmtime(*a)

    def sleep(self, s):
        time.sleep(s)


REF = dict(Master=RefMaster, master_kw={}, Volume=RefVolume,
           Filer=ref_filer_server.FilerServer, Env=RefEnv,
           run_command=ref_run_command, Geometry=RefGeometry,
           coder=lambda: ref_new_coder(10, 4, "cpu"))
PORT = dict(Master=MasterServer,
            master_kw=dict(placement_seed=PLACEMENT_SEED),
            Volume=VolumeServer, Filer=filer_server.FilerServer,
            Env=CommandEnv, run_command=run_command, Geometry=Geometry,
            coder=lambda: RSCodecTorch(10, 4, device="cpu"))
PKGS = {"ref": REF, "port": PORT}
# (cluster package, filer package) of each run
RUNS = {"ref": ("ref", "ref"), "port": ("port", "port"),
        "port-filer-on-ref": ("ref", "port"),
        "ref-filer-on-port": ("port", "ref")}
OTHERS = ("port", "port-filer-on-ref", "ref-filer-on-port")
KEPT_EXTS = (".dat", ".idx", ".ecx", ".ecj", ".vif")


def _files() -> dict:
    rng = np.random.default_rng(41)
    out = {}
    for i in range(16):
        out[f"/data/d{i % 4}/small{i:02d}.bin"] = rng.integers(
            0, 256, int(rng.integers(1000, 9000)), dtype=np.uint8).tobytes()
    for j, size in enumerate((int(2.5 * MIB) + 17, 3 * MIB)):
        out[f"/data/big/b{j}.bin"] = rng.integers(
            0, 256, size, dtype=np.uint8).tobytes()
    for k in range(23):
        out[f"/data/list/e{k:03d}"] = f"entry {k}\n".encode()
    return out


FILES = _files()


def _reset_clients() -> None:
    for mod in (rpc, ref_rpc):
        mod.reset_channels()
    for mod in (pool, ref_pool):
        mod.POOL.clear()


class _Cluster:
    """One package's master and volume servers on PORTS, in process."""

    def __init__(self, mods, root: str):
        self.mods = mods
        self.root = root
        self.master = mods["Master"](ip="127.0.0.1", port=PORTS[0],
                                     volume_size_limit_mb=64,
                                     **mods["master_kw"])
        self.master.start(vacuum_interval=3600)
        self.servers = {}
        for i, rack in enumerate(RACKS):
            self.add(PORTS[1 + i], rack)

    @property
    def address(self) -> str:
        return self.master.address

    def add(self, port: int, rack: str) -> None:
        d = os.path.join(self.root, f"v{port}")
        os.mkdir(d)
        srv = self.mods["Volume"](
            directories=[d], master=self.address, ip="127.0.0.1", port=port,
            rack=rack, pulse_seconds=1, coder=self.mods["coder"](),
            ec_geometry=self.mods["Geometry"](large_block=LARGE,
                                              small_block=SMALL))
        srv.start()
        self.servers[srv.address] = (srv, d)
        self.settle()

    def stop(self, address: str) -> None:
        srv, _ = self.servers.pop(address)
        srv.stop()
        srv._http_server.server_close()
        srv._grpc_server.stop(None).wait(10)
        self.settle()

    def close(self) -> None:
        for address in list(self.servers):
            srv, _ = self.servers.pop(address)
            srv.stop()
            srv._http_server.server_close()
            srv._grpc_server.stop(None).wait(10)
        self.master.stop()
        self.master._http_server.server_close()
        self.master._grpc_server.stop(None).wait(10)

    def settle(self, timeout: float = 30.0) -> None:
        """Heartbeat now, and wait until the master's view of every node
        is what the node's store holds."""
        for srv, _ in self.servers.values():
            srv.trigger_heartbeat()
        deadline = time.time() + timeout
        while True:
            want = {}
            for addr, (srv, _) in self.servers.items():
                hb = srv.store.collect_heartbeat()
                want[addr] = (
                    sorted((v.id, v.size, v.file_count, v.read_only)
                           for v in hb.volumes),
                    sorted((e.id, e.ec_index_bits) for e in hb.ec_shards))
            topo = self.master.topo
            with topo._lock:
                got = {url: (
                    sorted((v.id, v.size, v.file_count, v.read_only)
                           for v in dn.volumes.values()),
                    sorted((e.volume_id, e.bits)
                           for e in dn.ec_shards.values()))
                    for url, dn in topo.nodes.items()}
            if got == want:
                return
            assert time.time() < deadline, (got, want)
            for srv, _ in self.servers.values():
                srv.trigger_heartbeat()
            time.sleep(0.05)

    def files(self) -> dict:
        """{server: {file name: sha256}} of the volume and EC files."""
        return {addr: {
            name: hashlib.sha256(open(os.path.join(d, name),
                                      "rb").read()).hexdigest()
            for name in sorted(os.listdir(d))
            if name.endswith(KEPT_EXTS) or ".ec" in name
            and name[-2:].isdigit()}
            for addr, (_, d) in sorted(self.servers.items())}


def _sh(mods, env, line: str) -> str:
    """One shell command; its output without the (sampled) trace line and
    with the streamed encode's one timing figure masked."""
    out = io.StringIO()
    code = mods["run_command"](env, line, out)
    text = "\n".join(x for x in out.getvalue().splitlines()
                     if not x.startswith("trace "))
    assert code == 0, f"{line!r} failed:\n{text}"
    return re.sub(r"overlap ratio \d+\.\d+", "overlap ratio <measured>",
                  text)


FS_LINES = ("fs.pwd", "fs.ls /data", "fs.ls -l /data/d1", "fs.du /data",
            "fs.tree /data", "fs.cat /data/list/e007",
            "fs.meta.cat /data/big/b0.bin", "fs.verify /data",
            "volume.fsck", "volume.fsck -verbose",
            "fs.cd /data/d2", "fs.ls -l", "fs.cd /")


def _fs(env_of, lines=FS_LINES) -> dict:
    """The fs.* lines through both packages' shells on one filer."""
    out = {}
    for name, (mods, env) in env_of.items():
        out[name] = [_sh(mods, env, line) for line in lines]
    return out


_HEADERS = ("ETag", "Content-Range", "Content-Length", "Content-MD5",
            "Last-Modified", "Content-Type")


def _answer(r) -> tuple:
    body = r.content
    if body and r.headers.get("Content-Type") == "application/json":
        body = r.json()
    elif len(body) > 256:
        body = hashlib.sha256(body).hexdigest()
    return (r.status_code, body,
            {h: r.headers[h] for h in _HEADERS if h in r.headers})


def _script(cluster_pkg: str, filer_pkg: str, root: str) -> dict:
    """The operator's path through a filer of one package on a cluster of
    one package; -> every observable, for comparison."""
    cm, fm = PKGS[cluster_pkg], PKGS[filer_pkg]
    out: dict = {}
    http = requests.Session()  # keep-alive: no ephemeral port per request
    http.trust_env = False
    base = f"http://127.0.0.1:{FILER_PORT}"
    with pytest.MonkeyPatch.context() as mp:
        clock = Clock()
        for mod in (ref_needle, needle, ref_entry, port_entry,
                    ref_filer_core, filer_core, ref_filer_server,
                    filer_server):
            mp.setattr(mod, "time", clock)
        mp.setattr(secrets, "randbits", random.Random(COOKIE_SEED).getrandbits)
        # both packages' trace sampling draws from the global generator
        # too: give each its own, so that the global stream feeds only
        # the reference master's placement picks
        for mod in (ref_trace, trace):
            mp.setattr(mod, "random", random.Random(0))
        # the metadata log flushes every 2 s of wall time, and its first
        # flush creates directories on the fake clock: flush at close only
        for mod in (ref_meta_log, meta_log):
            mp.setattr(mod.MetaLog, "_flush_loop",
                       lambda self: self._stop.wait())
        mp.setenv("SWFS_CHUNK_PIPELINE", "0")
        mp.setenv("SWFS_FILER_CACHE_MB", "0")
        for mod in (chunk_pipeline, ref_chunk_pipeline):
            mod.refresh_config()
        random.seed(PLACEMENT_SEED)  # the reference's placement picks
        c = _Cluster(cm, root)
        fs = None
        try:
            fs = fm["Filer"](ip="127.0.0.1", port=FILER_PORT,
                             master=c.address, collection=COLLECTION,
                             store_dir=os.path.join(root, "filer"),
                             chunk_size=MIB)
            fs.start()
            filer = f"127.0.0.1:{FILER_PORT}"
            envs = {name: (mods, mods["Env"](c.address, filer=filer))
                    for name, mods in PKGS.items()}

            out["put"] = [_answer(http.put(base + path, data=data))
                          for path, data in FILES.items()]
            out["get"] = [_answer(http.get(base + path)) for path in FILES]
            big = "/data/big/b0.bin"
            etag = http.head(base + big).headers["ETag"]
            out["conditional"] = [_answer(r) for r in (
                http.head(base + big),
                http.get(base + big, headers={"If-None-Match": etag}),
                http.get(base + big, headers={"Range": f"bytes={MIB - 100}-"
                                              f"{2 * MIB + 99}"}),
                http.get(base + big, headers={"Range": "bytes=-4097"}),
                http.get(base + big, headers={"Range": f"bytes={9 * MIB}-"}),
                http.get(base + "/data/nowhere"))]
            pages, last = [], ""
            while True:
                r = http.get(base + "/data/list/",
                             params={"limit": 7, "lastFileName": last})
                page = r.json()
                pages.append((r.status_code, page))
                if not page["ShouldDisplayLoadMore"]:
                    break
                last = page["Entries"][-1]["FullPath"].rsplit("/", 1)[1]
            out["pages"] = pages
            out["fs"] = _fs(envs)
            out["mv"] = {name: _sh(mods, env, line) for name, (mods, env)
                         in envs.items() for line in (
                f"fs.mv /data/d0/small{0 if name == 'ref' else 4:02d}.bin "
                f"/data/big",)}
            out["delete"] = [
                _answer(http.delete(base + "/data/d3")),
                _answer(http.delete(base + "/data/d3?recursive=true")),
                _answer(http.get(base + "/data/d3/small03.bin")),
                _answer(http.get(base + "/data/big/small00.bin")),
                _answer(http.get(base + "/data/"))]
            c.settle()
            out["files_written"] = c.files()

            fsh = envs[filer_pkg]
            out["encode"] = [_sh(fsh[0], fsh[1], line) for line in (
                "lock", f"ec.encode -collection {COLLECTION} -fullPercent 1 "
                "-parallelEncode 1", "unlock")]
            c.settle()
            out["encoded"] = c.files()
            holders = {a: [n for n in names if n[-2:].isdigit()]
                       for a, names in out["encoded"].items()}
            victim = max(sorted(holders), key=lambda a: len(holders[a]))
            out["victim"] = (victim, len(holders[victim]))
            c.stop(victim)
            alive = [p for p in FILES if not p.startswith(
                ("/data/d3/", "/data/d0/small00", "/data/d0/small04"))]
            out["degraded"] = [_answer(http.get(base + p)) for p in alive]
            out["degraded_range"] = _answer(http.get(
                base + big, headers={"Range": f"bytes={MIB - 5}-{MIB + 5}"}))
            out["fs_degraded"] = _fs(envs, ("fs.du /data",
                                            "fs.cat /data/d1/small01.bin",
                                            "volume.fsck"))
        finally:
            if fs is not None:
                fs.stop()
                fs._http_server.server_close()
                fs._grpc_server.stop(None).wait(10)
            c.close()
            http.close()
            _reset_clients()
    return out


_DONE: dict = {}


def _run(name: str, tmp_path_factory) -> dict:
    if name not in _DONE:
        cluster_pkg, filer_pkg = RUNS[name]
        root = str(tmp_path_factory.mktemp(f"filer-{name}"))
        _DONE[name] = _script(cluster_pkg, filer_pkg, root)
    return _DONE[name]


@pytest.fixture(autouse=True)
def _global_random_restored():
    """The reference draws placements from the global generator, which
    these tests seed: leave it to the next test as it was."""
    state = random.getstate()
    yield
    random.setstate(state)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return _run("ref", tmp_path_factory)


@pytest.fixture(scope="module", params=OTHERS)
def other(request, tmp_path_factory):
    """(name, run) of the port's filer on the port's cluster, or of one
    package's filer on the other package's cluster."""
    return request.param, _run(request.param, tmp_path_factory)


def test_the_reference_run_takes_the_operators_path(ref):
    assert [a[0] for a in ref["put"]] == [201] * len(FILES)
    for (status, body, headers), data in zip(ref["get"], FILES.values()):
        assert status == 200
        want = data if len(data) <= 256 else hashlib.sha256(data).hexdigest()
        assert body == want
        assert headers["ETag"] == f'"{hashlib.md5(data).hexdigest()}"'
    head, cond, rng, suffix, bad, missing = ref["conditional"]
    assert cond[0] == 304 and rng[0] == 206 and suffix[0] == 206
    assert bad[0] == 416 and missing[0] == 404
    assert [p[1]["ShouldDisplayLoadMore"] for p in ref["pages"]] == \
        [True, True, True, False]
    assert sum(len(p[1]["Entries"]) for p in ref["pages"]) == 23
    assert [d[0] for d in ref["delete"]] == [409, 204, 404, 200, 200]
    assert ref["victim"][1] == 4
    shards = sorted(n for names in ref["encoded"].values() for n in names
                    if n[-2:].isdigit())
    assert len(shards) == 14
    assert all(a[0] == 200 for a in ref["degraded"])


def test_the_reference_shell_and_the_ports_print_the_same(ref, other):
    """On one filer, the port's fs.* output equals the reference's."""
    name, run = other
    for r in (ref, run):
        assert r["fs"]["port"] == r["fs"]["ref"]
        assert r["fs_degraded"]["port"] == r["fs_degraded"]["ref"]


KEYS = ("put", "get", "conditional", "pages", "fs", "mv", "delete",
        "files_written", "encode", "encoded", "victim", "degraded",
        "degraded_range", "fs_degraded")


@pytest.mark.parametrize("key", KEYS)
def test_runs_are_byte_identical_to_the_reference(ref, other, key):
    name, run = other
    assert run[key] == ref[key], f"{name}: {key}"


# -- the filer's chunk cache at its default --------------------------------------


def _cache_versions() -> dict:
    """Three versions of a small file (the third of another size) and two
    of a three-chunk file at the filer's 1 MiB chunks."""
    rng = np.random.default_rng(43)

    def blob(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    return {"/cache/s.txt": [blob(3000), blob(3000), blob(5000)],
            "/cache/b.bin": [blob(int(2.5 * MIB)), blob(int(2.5 * MIB))]}


CACHE_VERSIONS = _cache_versions()
# crosses the first chunk boundary of the large file, and covers all of
# the small one but its first and last byte
CACHE_RANGES = {"/cache/s.txt": "bytes=1-2998",
                "/cache/b.bin": f"bytes={MIB - 100}-{MIB + 99}"}


def _cache_script(pkg: str, root: str) -> dict:
    """Each version of each file PUT over the last, then GET twice whole
    and once by a range; then a DELETE and a GET. The filer's chunk cache
    and chunk pipeline at their defaults. -> per file, the answers in
    order, with per step the cache hits it took and whether the cache
    held a fid that no live entry references."""
    mods = PKGS[pkg]
    out: dict = {}
    http = requests.Session()
    http.trust_env = False
    base = f"http://127.0.0.1:{FILER_PORT}"
    with pytest.MonkeyPatch.context() as mp:
        for var in ("SWFS_FILER_CACHE_MB", "SWFS_CHUNK_PIPELINE"):
            mp.delenv(var, raising=False)
        for mod in (chunk_pipeline, ref_chunk_pipeline):
            mod.refresh_config()
        random.seed(PLACEMENT_SEED)
        c = _Cluster(mods, root)
        fs = None
        try:
            fs = mods["Filer"](ip="127.0.0.1", port=FILER_PORT,
                               master=c.address, collection=COLLECTION,
                               store_dir=os.path.join(root, "filer"),
                               chunk_size=MIB)
            fs.start()
            cache = fs.chunk_cache
            assert cache is not None
            hits = [0]
            get = cache.get

            def counted(fid):
                v = get(fid)
                hits[0] += v is not None
                return v

            mp.setattr(cache, "get", counted)

            def stale(path) -> bool:
                entry = fs.filer.store.find_entry(path)
                live = {ch.file_id for ch in entry.chunks} if entry else set()
                return bool(set(cache.mem._data) - live)

            def step(path, r) -> tuple:
                n, hits[0] = hits[0], 0
                return _answer(r)[:2] + (r.headers.get("ETag"), n,
                                         stale(path))

            for path, versions in CACHE_VERSIONS.items():
                url = base + path
                answers = []
                for data in versions:
                    answers.append(step(path, http.put(url, data=data)))
                    for _ in range(2):
                        answers.append(step(path, http.get(url)))
                    answers.append(step(path, http.get(
                        url, headers={"Range": CACHE_RANGES[path]})))
                answers.append(step(path, http.delete(url)))
                answers.append(step(path, http.get(url)))
                out[path] = answers
        finally:
            if fs is not None:
                fs.stop()
                fs._http_server.server_close()
                fs._grpc_server.stop(None).wait(10)
            c.close()
            http.close()
            _reset_clients()
            for mod in (chunk_pipeline, ref_chunk_pipeline):
                mod.refresh_config()
    return out


_CACHE_DONE: dict = {}


@pytest.fixture(scope="module")
def cache_runs(tmp_path_factory):
    for pkg in PKGS:
        if pkg not in _CACHE_DONE:
            _CACHE_DONE[pkg] = _cache_script(
                pkg, str(tmp_path_factory.mktemp(f"cache-{pkg}")))
    return _CACHE_DONE


@pytest.mark.parametrize("path", sorted(CACHE_VERSIONS))
def test_the_cached_filer_serves_each_version_and_no_deleted_one(cache_runs,
                                                                  path):
    """With its chunk cache on, as by default, the port's filer serves the
    bytes of the newest version after each overwrite and 404 after the
    delete, takes its later GETs from the cache, keeps no chunk of an
    overwritten or deleted version cached, and answers as the reference
    filer does: status codes, bodies, ETags and cache hits equal."""
    run = cache_runs["port"][path]
    lo, hi = (int(x) for x in CACHE_RANGES[path][6:].split("-"))
    i = 0
    for data in CACHE_VERSIONS[path]:
        put, get1, get2, rng = run[i:i + 4]
        i += 4
        assert put[0] == 201 and not put[4]
        whole = data if len(data) <= 256 else hashlib.sha256(data).hexdigest()
        for g in (get1, get2):
            assert g[:3] == (200, whole, f'"{hashlib.md5(data).hexdigest()}"')
            assert not g[4]
        part = data[lo:hi + 1]
        assert rng[0] == 206 and rng[1] == (
            part if len(part) <= 256 else hashlib.sha256(part).hexdigest())
        assert get2[3] > 0, "the second GET took nothing from the cache"
    delete, gone = run[i:]
    assert delete[0] == 204 and not delete[4]
    assert gone[0] == 404 and gone[3] == 0
    assert run == cache_runs["ref"][path]


# -- the CLI as processes ------------------------------------------------------

_WRAPPER = """
import atexit, runpy, sys
out = sys.argv[1]


def dump():
    with open(out, "w") as f:
        f.write("\\n".join(sorted(sys.modules)))


atexit.register(dump)
sys.argv = ["seaweedfs_tpu_torch"] + sys.argv[2:]
runpy.run_module("seaweedfs_tpu_torch", run_name="__main__", alter_sys=True)
"""


class _Procs:
    """Processes of `python -m seaweedfs_tpu_torch`, each recording the
    modules it imported."""

    def __init__(self, tmp_path):
        self.tmp = tmp_path
        self.env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        self.env["SWFS_SCRUB_MAX_MBPS"] = "0"
        self.procs = []
        self.module_files = []
        self.http = requests.Session()
        self.http.trust_env = False

    def _cmd(self, name: str, args) -> list:
        mods = self.tmp / f"{name}.modules"
        self.module_files.append(mods)
        return [sys.executable, "-c", _WRAPPER, str(mods)] + args

    def spawn(self, name: str, args):
        f = open(self.tmp / f"{name}.log", "wb")
        proc = subprocess.Popen(self._cmd(name, args), cwd=REPO,
                                env=self.env, stdout=f,
                                stderr=subprocess.STDOUT)
        self.procs.append((name, proc, f))

    def run(self, name: str, args, stdin: bytes = b"") -> tuple:
        r = subprocess.run(self._cmd(name, args), cwd=REPO, env=self.env,
                           input=stdin, capture_output=True, timeout=120)
        return r.returncode, r.stdout.decode(), r.stderr.decode()

    def wait_for(self, port: int, path: str, name: str) -> None:
        deadline = time.time() + 90
        while True:
            proc = next(p for n, p, _ in self.procs if n == name)
            assert proc.poll() is None, \
                (self.tmp / f"{name}.log").read_text()
            try:
                if self.http.get(f"http://127.0.0.1:{port}{path}",
                                 timeout=5).status_code == 200:
                    return
            except requests.RequestException:
                pass
            assert time.time() < deadline, f"{name}: no {path}"
            time.sleep(0.2)

    def wait_registered(self, mport: int, vport: int) -> None:
        deadline = time.time() + 60
        while str(vport) not in self.http.get(
                f"http://127.0.0.1:{mport}/cluster/status", timeout=5).text:
            assert time.time() < deadline, "the volume never registered"
            time.sleep(0.2)

    def stop_all(self) -> list:
        """SIGTERM to every process -> their exit codes."""
        for _name, proc, _f in self.procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        rcs = []
        for _name, proc, f in self.procs:
            try:
                rcs.append(proc.wait(timeout=60))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                rcs.append("killed")
            f.close()
        self.procs = []
        self.http.close()
        return rcs

    def assert_no_jax(self) -> None:
        for path in self.module_files:
            mods = path.read_text().split("\n")
            assert "seaweedfs_tpu_torch" in mods, path
            assert not [m for m in mods if m in ("jax", "seaweedfs_tpu")
                        or m.startswith(("jax.", "seaweedfs_tpu."))], path


def test_filer_and_shell_processes_run_without_jax(tmp_path):
    """`master`, `volume -coder cpu` and `filer` as processes: a PUT and a
    GET through the filer, `shell -filer` lists and cats the file, the
    filer reloads its sqlite store after SIGTERM and a restart, and every
    process exits 0 on SIGTERM without importing jax or seaweedfs_tpu."""
    mport, vport, fport = PORTS[0], PORTS[1], PORTS[5]
    d = tmp_path / "data"
    d.mkdir()
    p = _Procs(tmp_path)
    master = f"127.0.0.1:{mport}"
    filer_args = ["filer", "-ip", "127.0.0.1", "-port", str(fport),
                  "-master", master, "-dir", str(tmp_path / "filer"),
                  "-maxMB", "1"]
    data = FILES["/data/big/b0.bin"]
    try:
        p.spawn("master", ["master", "-ip", "127.0.0.1", "-port",
                           str(mport), "-volumeSizeLimitMB", "64"])
        p.spawn("volume", ["volume", "-dir", str(d), "-ip", "127.0.0.1",
                           "-port", str(vport), "-mserver", master,
                           "-coder", "cpu"])
        p.spawn("filer", filer_args)
        p.wait_for(mport, "/cluster/status", "master")
        p.wait_for(vport, "/status", "volume")
        p.wait_registered(mport, vport)
        p.wait_for(fport, "/healthz", "filer")
        url = f"http://127.0.0.1:{fport}/docs/b0.bin"
        assert p.http.put(url, data=data, timeout=60).status_code == 201
        assert p.http.get(url, timeout=60).content == data
        rc, out, err = p.run("shell", ["shell", "-master", master, "-filer",
                                       f"127.0.0.1:{fport}"],
                             b"fs.ls -l /docs\nfs.du /docs\n")
        assert rc == 0 and "error" not in out, out + err
        assert f"{len(data):>12d} b0.bin" in out
        proc = next(pr for n, pr, _ in p.procs if n == "filer")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        p.spawn("filer2", filer_args)
        p.wait_for(fport, "/healthz", "filer2")
        assert p.http.get(url, timeout=60).content == data
    finally:
        rcs = p.stop_all()
        rpc.reset_channels()
    assert rcs == [0, 0, 0, 0]
    assert not os.path.exists(recovery.marker_path(str(d)))
    p.assert_no_jax()


def test_server_filer_serves_a_put_and_a_get(tmp_path):
    """`server -filer -coder cpu`: master, volume server and filer in one
    process; SIGTERM stops all three with exit 0."""
    mport, vport, fport = PORTS[0], PORTS[1], PORTS[5]
    p = _Procs(tmp_path)
    data = FILES["/data/big/b1.bin"]
    try:
        p.spawn("server", ["server", "-dir", str(tmp_path), "-ip",
                           "127.0.0.1", "-master.port", str(mport),
                           "-volume.port", str(vport), "-filer",
                           "-filer.port", str(fport), "-coder", "cpu"])
        p.wait_for(mport, "/cluster/status", "server")
        p.wait_for(vport, "/status", "server")
        p.wait_registered(mport, vport)
        p.wait_for(fport, "/healthz", "server")
        url = f"http://127.0.0.1:{fport}/x/b1.bin"
        assert p.http.put(url, data=data, timeout=60).status_code == 201
        assert p.http.get(url, timeout=60).content == data
    finally:
        rcs = p.stop_all()
        rpc.reset_channels()
    assert rcs == [0]
    assert os.path.exists(tmp_path / "filer" / "filer.db")
    p.assert_no_jax()


# -- the network stores ----------------------------------------------------------


@pytest.mark.parametrize("kind", store_fakes.NETWORK_STORES)
def test_each_network_store_opens_over_its_fake(kind):
    """get_store opens every registered network store over its fake
    server, and an entry and a kv pair make the round trip."""
    srv = store_fakes.open_fake(kind)
    try:
        store = get_store(kind, **store_fakes.store_kwargs(kind, srv.port))
        try:
            e = port_entry.Entry(full_path=f"/rt/{kind}/a.bin",
                                 content=b"round trip",
                                 attr=port_entry.Attr(mtime=7, crtime=7))
            store.insert_entry(e)
            got = store.find_entry(e.full_path)
            assert got.content == b"round trip" and got.attr.mtime == 7
            assert [x.name for x in store.list_directory_entries(
                f"/rt/{kind}")] == ["a.bin"]
            store.kv_put(b"rt-key", b"rt-value")
            assert store.kv_get(b"rt-key") == b"rt-value"
            store.delete_entry(e.full_path)
            assert store.find_entry(e.full_path) is None
        finally:
            store.close()
        assert store_fakes.fake_state(kind, srv)  # it reached the fake
    finally:
        srv.stop()


def _close_filer(fs) -> None:
    fs.stop()
    fs._http_server.server_close()
    fs._grpc_server.stop(None).wait(10)


def test_a_filer_toml_on_redis2_serves_a_put_and_a_get(tmp_path,
                                                      monkeypatch):
    """filer.toml's [redis2] section puts the filer on a RESP server: a
    PUT and a GET through it, the entry in the server, no filer.db."""
    from seaweedfs_tpu_torch.filer.stores.redis import RedisStore

    srv = store_fakes.open_fake("redis2")
    (tmp_path / "filer.toml").write_text(
        f'[redis2]\nenabled = true\naddress = "127.0.0.1:{srv.port}"\n')
    monkeypatch.chdir(tmp_path)
    # ports of its own: the cluster script reuses PORTS after this test
    mport = _free_port_pair(PORTS)
    vport = _free_port_pair(PORTS + [mport])
    master = MasterServer(ip="127.0.0.1", port=mport,
                          volume_size_limit_mb=64)
    master.start(vacuum_interval=3600)
    vol = VolumeServer(directories=[str(tmp_path / "v")],
                       master=f"127.0.0.1:{mport}", ip="127.0.0.1",
                       port=vport, pulse_seconds=1,
                       coder=RSCodecTorch(10, 4, device="cpu"))
    vol.start()
    fs = filer_server.FilerServer(ip="127.0.0.1", port=FILER_PORT,
                                  master=f"127.0.0.1:{mport}",
                                  store_dir=str(tmp_path / "f"))
    http = requests.Session()
    http.trust_env = False
    try:
        assert isinstance(fs.filer.store.store, RedisStore)
        fs.start()
        deadline = time.time() + 30
        while not master.topo.nodes:
            assert time.time() < deadline, "the volume never registered"
            time.sleep(0.05)
        url = f"http://127.0.0.1:{FILER_PORT}/r2/x.bin"
        data = FILES["/data/big/b0.bin"][:100_000]
        assert http.put(url, data=data, timeout=60).status_code == 201
        assert http.get(url, timeout=60).content == data
        assert b"/r2/x.bin" in srv.kv
    finally:
        http.close()
        _close_filer(fs)
        vol.stop()
        master.stop()
        srv.stop()
        rpc.reset_channels()
    assert not os.path.exists(tmp_path / "f" / "filer.db")


def test_server_filer_on_mysql2_serves_a_file(tmp_path):
    """`server -filer` whose filer.toml enables [mysql2]: a PUT and a GET
    through the filer, the entry's row in the MySQL server, exit 0 on
    SIGTERM, no filer.db, and neither jax nor seaweedfs_tpu loaded."""
    srv = store_fakes.open_fake("mysql2")
    conf = tmp_path / "home" / ".seaweedfs-tpu"
    conf.mkdir(parents=True)
    (conf / "filer.toml").write_text(
        f'[mysql2]\nenabled = true\nhost = "127.0.0.1"\n'
        f"port = {srv.port}\n")
    mport, vport, fport = PORTS[0], PORTS[1], PORTS[5]
    p = _Procs(tmp_path)
    p.env["HOME"] = str(tmp_path / "home")  # where its filer.toml is
    data = FILES["/data/big/b1.bin"]
    try:
        p.spawn("server", ["server", "-dir", str(tmp_path), "-ip",
                           "127.0.0.1", "-master.port", str(mport),
                           "-volume.port", str(vport), "-filer",
                           "-filer.port", str(fport), "-coder", "cpu"])
        p.wait_for(mport, "/cluster/status", "server")
        p.wait_for(vport, "/status", "server")
        p.wait_registered(mport, vport)
        p.wait_for(fport, "/healthz", "server")
        url = f"http://127.0.0.1:{fport}/my/b1.bin"
        assert p.http.put(url, data=data, timeout=60).status_code == 201
        assert p.http.get(url, timeout=60).content == data
        with srv._dblock:
            rows = srv.db.execute("SELECT directory, name FROM filemeta "
                                  "WHERE name = 'b1.bin'").fetchall()
        assert rows == [("/my", "b1.bin")]
    finally:
        rcs = p.stop_all()
        srv.stop()
        rpc.reset_channels()
    assert rcs == [0]
    assert not os.path.exists(tmp_path / "filer" / "filer.db")
    p.assert_no_jax()


@pytest.mark.parametrize("entry", ["FilerServer", "filer", "server -filer"])
def test_a_store_whose_address_refuses_stops_the_filer(entry, tmp_path,
                                                       monkeypatch):
    """A network store whose server does not answer stops the filer at
    start, through each entry point: no fallback, no filer.db written;
    `server -filer` closes the volume store it opened (its dirty marker
    lifted) before the master binds."""
    (tmp_path / "filer.toml").write_text(
        '[postgres2]\nenabled = true\nhost = "127.0.0.1"\nport = 1\n')
    monkeypatch.chdir(tmp_path)
    store_dir = tmp_path / "filer"
    if entry == "FilerServer":
        with pytest.raises(RuntimeError, match="postgres2.*did not open"):
            filer_server.FilerServer(ip="127.0.0.1", port=FILER_PORT,
                                     master="127.0.0.1:1",
                                     store_dir=str(store_dir))
    elif entry == "filer":
        with pytest.raises(SystemExit) as e:
            command.main(["filer", "-ip", "127.0.0.1", "-port",
                          str(FILER_PORT), "-master", "127.0.0.1:1",
                          "-dir", str(store_dir)])
        assert "postgres2" in str(e.value.code)
    else:
        data = tmp_path / "data"
        data.mkdir()
        mport = _free_port_pair(PORTS)
        with pytest.raises(SystemExit) as e:
            command.main(["server", "-dir", str(data), "-ip", "127.0.0.1",
                          "-master.port", str(mport), "-volume.port",
                          str(PORTS[1]), "-filer", "-filer.port",
                          str(FILER_PORT), "-coder", "cpu"])
        assert "postgres2" in str(e.value.code)
        assert not os.path.exists(recovery.marker_path(str(data)))
        with socket.socket() as s:
            s.bind(("", mport))  # the master never bound its port
        store_dir = data / "filer"
    assert not os.path.exists(store_dir / "filer.db")  # no fallback


@pytest.mark.parametrize("name,text", [("filer", "[sqlite\n"),
                                        ("notification", "[notification\n")])
def test_a_config_file_that_does_not_parse_is_ignored(name, text, tmp_path,
                                                      monkeypatch):
    """A filer.toml or notification.toml that is no TOML: both packages'
    filers warn and start on the -store default (sqlite in store_dir)."""
    (tmp_path / f"{name}.toml").write_text(text)
    monkeypatch.chdir(tmp_path)
    for pkg, mod in (("ref", ref_filer_server), ("port", filer_server)):
        store_dir = tmp_path / pkg
        fs = mod.FilerServer(ip="127.0.0.1", port=FILER_PORT,
                             master="127.0.0.1:1", store_dir=str(store_dir))
        assert os.path.exists(store_dir / "filer.db"), pkg
        fs.filer.create_entry(port_entry.Entry(
            full_path="/a", attr=port_entry.Attr(mtime=1, crtime=1))
            if pkg == "port" else ref_entry.Entry(
                full_path="/a", attr=ref_entry.Attr(mtime=1, crtime=1)))
        assert fs.filer.find_entry("/a") is not None, pkg


def test_the_status_keys_equal_the_references():
    """/status of a started filer carries the reference's keys, the
    NativeHotPlane key (null without a hot plane) among them."""
    keys = {}
    for pkg, mod in (("ref", ref_filer_server), ("port", filer_server)):
        fs = mod.FilerServer(ip="127.0.0.1", port=FILER_PORT,
                             master="127.0.0.1:1", store="memory")
        fs.start()
        http = requests.Session()
        http.trust_env = False
        try:
            r = http.get(f"http://127.0.0.1:{FILER_PORT}/status", timeout=30)
            assert r.status_code == 200
            keys[pkg] = set(r.json())
            assert r.json()["NativeHotPlane"] is None
        finally:
            http.close()
            fs.stop()
            fs._http_server.server_close()
            fs._grpc_server.stop(None).wait(10)
            rpc.reset_channels()
            ref_rpc.reset_channels()
    assert keys["port"] == keys["ref"]


@pytest.fixture(scope="module")
def hot_stack(tmp_path_factory):
    """A port master, a volume server on the C++ plane and a filer with
    the hot plane over it (tests/test_torch_native_filer.py)."""
    from tests.test_torch_native_filer import _stack, _teardown

    stack = _stack("seaweedfs_tpu_torch", tmp_path_factory.mktemp("hs"),
                   "hs")
    yield stack
    _teardown("seaweedfs_tpu_torch", *stack)


def test_the_native_hot_plane_serves(hot_stack):
    """`native_volume_plane=` starts the C++ hot plane on the filer's
    public port: a whole-object PUT and GET under /buckets/ never leave
    C++, and /status reports the plane's counters."""
    _, vsrv, fs = hot_stack
    assert fs.native_volume_plane is vsrv.native_plane
    assert fs.hot_plane is not None and fs.admin_port != fs.port
    before = fs.hot_plane.stats()
    url = f"http://127.0.0.1:{fs.port}/buckets/hs/a.bin"
    data = FILES["/data/big/b1.bin"][:100_000]
    http = requests.Session()
    http.trust_env = False
    assert http.put(url, data=data, timeout=60).status_code == 201
    assert http.get(url, timeout=60).content == data
    after = fs.hot_plane.stats()
    assert after["native_puts"] == before["native_puts"] + 1
    assert after["native_gets"] == before["native_gets"] + 1
    assert after["redirects"] == before["redirects"]
    st = http.get(f"http://127.0.0.1:{fs.port}/status", timeout=60).json()
    assert st["NativeHotPlane"]["native_puts"] == after["native_puts"]


@pytest.mark.parametrize("argv", [
    ["benchmark", "-nativeClient"],
    ["-vmodule", "filer=1", "benchmark", "-filer", "FILER"],
    ["benchmark", "-filer", "FILER"],
], ids=lambda a: "-".join(x.strip("-") for x in a[:2]))
def test_the_cli_benchmarks_run_the_compiled_client(argv, hot_stack,
                                                    capsys):
    """`benchmark -nativeClient` (volume servers, batched assigns) and
    `benchmark -filer` (the filer's hot plane) drive the compiled loop
    and lose no request."""
    master, _, fs = hot_stack
    argv = [f"127.0.0.1:{fs.port}" if a == "FILER" else a for a in argv]
    assert command.main(argv + ["-master", master.address, "-n", "64",
                                "-size", "1024", "-c", "4"]) == 0
    out = capsys.readouterr().out
    assert out.count(" 0 failed") == 2, out  # the writes and the reads
    assert "req/s" in out


@pytest.mark.parametrize("argv", [
    ["-v", "1", "backup"], ["master.follower"],
], ids=lambda a: "-".join(x.strip("-") for x in a[:2]))
def test_cli_commands_parse_as_the_references(argv, tmp_path, capsys):
    """`backup` and `master.follower` without their required flags stop
    with the reference's usage error (the commands themselves run in
    tests/test_torch_tools.py and tests/test_torch_raft.py)."""
    from seaweedfs_tpu import command as ref_command

    got = []
    for mod in (ref_command, command):
        with pytest.raises(SystemExit) as e:
            mod.main(argv)
        # the usage lines wrap at the program's name, which differs
        got.append((e.value.code, capsys.readouterr().err.replace(
            "weed-tpu-torch", "weed-tpu").splitlines()[-1]))
    assert got[1] == got[0] and got[0][0] == 2


@pytest.mark.parametrize("line", [
    "volume.tier.upload -volumeId=1",
    "volume.tier.download -volumeId=1", "volume.tier.move",
    "cluster.raft.add -id=127.0.0.1:2", "cluster.raft.remove -id=127.0.0.1:2"])
def test_shell_commands_fail_as_the_references(line, capsys):
    """Without their required flags, or without a master to ask, the
    tier and Raft commands fail with the reference's message: argparse's
    usage error, or the master's gRPC error."""
    got = []
    for env_cls, run in ((RefEnv, ref_run_command), (CommandEnv, run_command)):
        out = io.StringIO()
        env = env_cls("127.0.0.1:1", filer="127.0.0.1:1")
        env._lock_token = 1  # as after `lock`
        try:
            rc = run(env, line, out)
        except SystemExit as e:
            rc = ("exit", e.code)
        got.append((rc, re.sub(r"\tdebug_error_string = .*\n", "",
                               out.getvalue()), capsys.readouterr().err))
    assert got[1] == got[0] and got[0][0] in (1, ("exit", 2))
    assert "ROADMAP.md" not in got[1][1] + got[1][2]
