"""The port's FUSE mount against the JAX package's, on the CPU.

The building blocks first, on seeded inputs: the inode map (lookups, hard
links, renames of files and of directories with their subtrees, forgets),
MemChunk's intervals and reads, the upload pipeline (seal on a full
chunk, flush, read-your-writes, spill to the swap file past its memory
budget, one budget shared by several pipelines), the metadata cache fed
a seeded stream of SubscribeMetadata events, and the chunk cache's disk
tier. Each answer of the port must equal the reference's.

Then WFS over a running cluster. One seeded script of the operations the
FUSE callbacks make (mkdir, create, out-of-order writes, reads of dirty
and of uploaded pages, flush, release, getattr with dirty sizes, readdir,
rename with an open handle, unlink, rmdir of a non-empty directory,
truncate, symlink, hard link, xattrs, statfs, a write past the mount's
memory budget) runs through the reference's WFS over a reference stack (a
master, a volume server with the numpy coder, a filer) and through the
port's WFS over a port stack (RSCodecTorch on the CPU). The bytes read,
sizes, modes, listings, xattrs and errnos, and the filer entries' chunk
offsets and sizes, must be equal (tolerance 0).

Then kernel mounts, where /dev/fuse exists: each package's WFS mounted
through its own shim, the same plain `os` script on both mountpoints; a
hard link and an xattr through the port's mount, which the reference's
shim leaves unimplemented (ROADMAP.md C); and `python -m
seaweedfs_tpu_torch mount` and `fuse` as processes without JAX, with the
shell's `mount.configure` setting and lifting a quota on the live mount.
Servers bind ports below the kernel's ephemeral range, never the
reference's defaults or their +10000 and +11000 twins."""

import errno
import os
import random
import signal
import socket
import stat
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu import mount as ref_mount
from seaweedfs_tpu.filer.entry import Entry as RefEntry
from seaweedfs_tpu.models.coder import new_coder as ref_new_coder
from seaweedfs_tpu.mount import fuse_binding as ref_fuse
from seaweedfs_tpu.mount import meta_cache as ref_meta_cache
from seaweedfs_tpu.mount import page_writer as ref_page_writer
from seaweedfs_tpu.pb import filer_pb2 as ref_filer_pb2
from seaweedfs_tpu.pb import rpc as ref_rpc
from seaweedfs_tpu.server.filer import FilerServer as RefFiler
from seaweedfs_tpu.server.master import MasterServer as RefMaster
from seaweedfs_tpu.server.volume import VolumeServer as RefVolume
from seaweedfs_tpu.utils import chunk_cache as ref_chunk_cache
from seaweedfs_tpu.wdclient import pool as ref_pool
from seaweedfs_tpu_torch import mount
from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.mount import control
from seaweedfs_tpu_torch.mount import fuse_binding
from seaweedfs_tpu_torch.mount import meta_cache
from seaweedfs_tpu_torch.mount import page_writer
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
from seaweedfs_tpu_torch.pb import filer_pb2, rpc
from seaweedfs_tpu_torch.server.filer import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.shell.registry import run_command
from seaweedfs_tpu_torch.utils import chunk_cache
from seaweedfs_tpu_torch.wdclient import pool
from tests import torch_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 32 * 1024  # the mounts' chunk size (the reference's tests' value)

# -- ports ---------------------------------------------------------------------

_PORTS = random.Random(os.getpid() + 61)
_RESERVED = {p + d for p in (8888, 9333, 8080) for d in (0, 10000, 11000)}


def _free_port_pair(taken=()) -> int:
    """A free HTTP port whose +10000 and +11000 twins are free too, all
    below the kernel's ephemeral range."""
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


def _reset_clients() -> None:
    for mod in (rpc, ref_rpc):
        mod.reset_channels()
    for mod in (pool, ref_pool):
        mod.POOL.clear()


# -- the building blocks -------------------------------------------------------

PKG = {"ref": dict(mount=ref_mount, pw=ref_page_writer,
                   cache=ref_chunk_cache, meta=ref_meta_cache,
                   Entry=RefEntry, pb=ref_filer_pb2),
       "port": dict(mount=mount, pw=page_writer, cache=chunk_cache,
                    meta=meta_cache, Entry=Entry, pb=filer_pb2)}


def _inode_answers(mod, seed: int) -> list:
    rng = random.Random(seed)
    m = mod.InodeToPath()
    dirs = ["/a", "/a/b", "/c"]
    files = [f"{d}/f{i}" for d in dirs for i in range(4)]
    out = []
    for d in dirs:
        out.append(("dir", m.lookup(d, True)))
    for _ in range(60):
        op = rng.choice(["lookup", "lookup", "add", "remove", "move",
                         "movedir", "forget", "path"])
        p = rng.choice(files)
        try:
            if op == "lookup":
                out.append((op, p, m.lookup(p)))
            elif op == "add":
                ino = m.get_inode(p)
                q = rng.choice(files)
                if ino is not None:
                    m.add_path(ino, q)
                out.append((op, p, q, ino))
            elif op == "remove":
                m.remove_path(p)
                out.append((op, p))
            elif op == "move":
                q = rng.choice(files)
                m.move_path(p, q)
                out.append((op, p, q, m.get_inode(q)))
            elif op == "movedir":
                m.move_path("/a/b", "/c/b")
                m.move_path("/c/b", "/a/b")
                out.append((op, m.get_inode("/a/b/f1")))
            elif op == "forget":
                ino = m.get_inode(p)
                if ino is not None:
                    m.forget(ino, rng.randint(1, 2))
                out.append((op, p, ino, m.has_path(p)))
            else:
                ino = m.get_inode(p)
                out.append((op, p, ino, m.get_path(ino) if ino else None))
        except KeyError as e:
            out.append((op, "KeyError", str(e)))
    out.append(("len", len(m)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_the_inode_map_answers_like_the_reference(seed):
    assert _inode_answers(mount, seed) == _inode_answers(ref_mount, seed)


def _mem_chunk_answers(mod, seed: int) -> list:
    rng = np.random.default_rng(seed)
    c = mod.MemChunk(3, 256)
    out = []
    for ts in range(1, 12):
        off = int(rng.integers(0, 250))
        n = int(rng.integers(1, 256 - off + 1))
        c.write(bytes([65 + ts]) * n, off, ts)
        buf = memoryview(bytearray(int(rng.integers(1, 64))))
        at = int(rng.integers(0, 256 - len(buf) + 1))
        covered = c.read_at(buf, at, min_ts_ns=int(rng.integers(0, 4)))
        out.append((c.continuous_intervals(), c.written_size(),
                    c.is_complete(), covered, bytes(buf)))
    c.write(b"z" * 256, 0, 99)
    out.append((c.is_complete(), c.read_interval(10, 20)))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_mem_chunk_intervals_like_the_reference(seed):
    assert _mem_chunk_answers(mount, seed) == \
        _mem_chunk_answers(ref_mount, seed)


def _pipeline_answers(mod, pw, seed: int, swap_dir: str) -> list:
    """Seeded writes through an UploadPipeline whose uploads wait behind a
    gate (sealed chunks pile up and spill past a 2-chunk budget): dirty
    reads before the uploads, then what was uploaded."""
    rng = np.random.default_rng(seed)
    gate = threading.Event()
    saved = []
    lock = threading.Lock()

    def save(data, offset, ts):
        gate.wait(10)
        with lock:
            saved.append((offset, data, ts))

    p = mod.UploadPipeline(64, save, concurrency=2, memory_chunk_limit=2,
                           swap_dir=swap_dir)
    out = []
    try:
        for ts in range(1, 40):
            off = int(rng.integers(0, 900))
            n = int(rng.integers(1, 200))
            p.save_data_at(bytes([33 + ts % 90]) * n, off, ts)
        for _ in range(10):
            buf = memoryview(bytearray(int(rng.integers(1, 150))))
            at = int(rng.integers(0, 1000))
            out.append((p.maybe_read_data_at(buf, at), bytes(buf)))
        out.append((p.swapped_out, p.max_written_offset(), p.dirty_size()))
        gate.set()
        p.flush()
        out.append(sorted(saved))
        out.append(p.max_written_offset())
    finally:
        gate.set()
        p.close()
    return out


@pytest.mark.parametrize("seed", range(4))
def test_the_upload_pipeline_seals_spills_and_flushes_like_the_reference(
        seed, tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    got = _pipeline_answers(mount, page_writer, seed, str(tmp_path / "port"))
    want = _pipeline_answers(ref_mount, ref_page_writer, seed,
                             str(tmp_path / "ref"))
    assert got == want
    assert got[-3][0] > 0  # chunks did spill to the swap file


def _budget_answers(mod, pw, swap_dir: str) -> list:
    budget = pw.MemBudget(2)
    saved = {}
    p1 = mod.UploadPipeline(100, lambda d, o, t: saved.__setitem__(
        (1, o), d), concurrency=1, budget=budget, swap_dir=swap_dir)
    p2 = mod.UploadPipeline(100, lambda d, o, t: saved.__setitem__(
        (2, o), d), concurrency=1, budget=budget, swap_dir=swap_dir)
    p1.save_data_at(b"a" * 10, 0, 1)
    p1.save_data_at(b"b" * 10, 100, 2)
    p2.save_data_at(b"c" * 10, 0, 3)
    out = [p1.swapped_out, p2.swapped_out]
    p1.flush()
    p2.flush()
    out.append(sorted(saved.items()))
    p1.close()
    p2.close()
    out.append([budget.try_take() for _ in range(3)])
    return out


def test_one_memory_budget_is_shared_like_the_reference(tmp_path):
    assert _budget_answers(mount, page_writer, str(tmp_path)) == \
        _budget_answers(ref_mount, ref_page_writer, str(tmp_path)) == \
        [0, 1, [((1, 0), b"a" * 10), ((1, 100), b"b" * 10),
                ((2, 0), b"c" * 10)], [True, True, False]]


def test_the_pipeline_releases_completed_chunks():
    """Completed uploads must not pin their MemChunk buffers until flush:
    the next seal prunes them (as in the reference)."""
    import gc
    import weakref

    gate = threading.Event()
    p = mount.UploadPipeline(64, lambda d, o, t: gate.wait(10),
                             concurrency=2)
    p.save_data_at(b"x" * 64, 0, 1)
    with p._lock:
        ref = weakref.ref(next(iter(p._sealed.values())))
    gate.set()
    deadline = time.time() + 5
    while time.time() < deadline and p._sealed:
        time.sleep(0.01)
    p.save_data_at(b"y" * 64, 64, 2)
    deadline = time.time() + 5
    while time.time() < deadline and ref() is not None:
        gc.collect()
        time.sleep(0.05)
    assert ref() is None
    p.flush()
    p.close()


def _events(pb, seed: int) -> list:
    """A seeded stream of SubscribeMetadata events: creates, updates,
    renames across directories and deletes."""
    rng = random.Random(seed)
    names = [f"n{i}" for i in range(8)]
    dirs = ["/m", "/m/a", "/m/b"]
    out = []
    for ts in range(1, 50):
        d = rng.choice(dirs)
        e = pb.Entry(name=rng.choice(names))
        e.attributes.file_size = rng.randint(0, 9999)
        e.attributes.file_mode = 0o644
        kind = rng.choice(["create", "update", "rename", "delete"])
        ev = pb.EventNotification()
        if kind in ("update", "rename", "delete"):
            ev.old_entry.CopyFrom(pb.Entry(name=e.name))
        if kind != "delete":
            ev.new_entry.CopyFrom(e)
        if kind == "rename":
            ev.new_parent_path = rng.choice(dirs)
        out.append(pb.SubscribeMetadataResponse(
            directory=d, event_notification=ev, ts_ns=ts))
    return out


def _meta_answers(name: str, seed: int) -> list:
    k = PKG[name]
    mc = k["meta"].MetaCache()
    for d in ("/m", "/m/a"):  # listed: events mirror into them
        mc.mark_visited(d)
    mc.insert(k["Entry"](full_path="/m/b/n1"))  # known: updated in place
    out = []
    for resp in _events(k["pb"], seed):
        mc.apply_event(resp)
        out.append([(e.full_path, e.attr.file_size)
                    for d in ("/m", "/m/a", "/m/b")
                    for e in mc.list_dir(d)])
    mc.invalidate("/m/a")
    out.append((mc.is_visited("/m"), mc.is_visited("/m/a")))
    found = mc.find("/m/a/n2")
    out.append(found and (found.full_path, found.attr.file_size))
    mc.delete("/m")
    out.append([mc.find(p) is None for p in ("/m/n1", "/m/a/n2")]
               + [mc.is_visited("/m")])
    mc.close()
    return out


@pytest.mark.parametrize("seed", range(4))
def test_the_metadata_cache_follows_events_like_the_reference(seed):
    assert _meta_answers("port", seed) == _meta_answers("ref", seed)


def _cache_answers(mod, root: str, seed: int) -> list:
    """The tiered cache with a disk tier of 20 KiB: chunks above the 1 KiB
    memory threshold go to disk and are evicted oldest-first."""
    rng = np.random.default_rng(seed)
    c = mod.TieredChunkCache(mem_bytes=8 * 1024, disk_dir=root,
                             disk_bytes=20 * 1024, mem_threshold=1024)
    out = []
    fids = [f"3,{i:02x}0000beef" for i in range(12)]
    for _ in range(60):
        fid = fids[int(rng.integers(0, len(fids)))]
        op = int(rng.integers(0, 4))
        if op < 2:
            c.put(fid, bytes([int(rng.integers(0, 256))])
                  * int(rng.integers(1, 6000)))
            time.sleep(0.002)  # distinct atimes order the disk eviction
            out.append(("put", fid))
        elif op == 2:
            out.append(("get", fid, c.get(fid)))
        else:
            out.append(("delete", fid, c.delete(fid)))
    out.append(sorted((f, c.get(f)) for f in fids))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_the_chunk_caches_disk_tier_answers_like_the_reference(seed,
                                                               tmp_path):
    got = _cache_answers(chunk_cache, str(tmp_path / "port"), seed)
    want = _cache_answers(ref_chunk_cache, str(tmp_path / "ref"), seed)
    assert got == want
    assert any(a[0] == "get" and a[2] and len(a[2]) >= 1024 for a in got)


# -- WFS over a running cluster ------------------------------------------------

STACK = {
    "ref": dict(Master=RefMaster, Volume=RefVolume, Filer=RefFiler,
                coder=lambda: ref_new_coder(10, 4, "cpu"), rpc=ref_rpc,
                pb=ref_filer_pb2, mount=ref_mount, fuse=ref_fuse),
    "port": dict(Master=MasterServer, Volume=VolumeServer,
                 Filer=FilerServer, coder=lambda: RSCodecTorch(
                     10, 4, device="cpu"), rpc=rpc, pb=filer_pb2,
                 mount=mount, fuse=fuse_binding),
}


class _Stack:
    """One package's master, volume server and filer on their own
    ports."""

    def __init__(self, name: str, root: str, taken: list):
        k = STACK[name]
        self.name = name
        ports = []
        for _ in range(3):
            ports.append(_free_port_pair(taken + ports))
        taken += ports
        self.master = k["Master"](ip="127.0.0.1", port=ports[0],
                                  volume_size_limit_mb=64)
        self.master.start(vacuum_interval=3600)
        self.volume = k["Volume"](
            directories=[os.path.join(root, "v")],
            master=self.master.address, ip="127.0.0.1", port=ports[1],
            pulse_seconds=1, coder=k["coder"]())
        self.volume.start()
        self.filer = k["Filer"](ip="127.0.0.1", port=ports[2],
                                master=self.master.address,
                                store_dir=os.path.join(root, "f"),
                                chunk_size=64 * 1024)
        self.filer.start()
        deadline = time.time() + 30
        while not self.master.topo.nodes:
            assert time.time() < deadline, "the volume never registered"
            time.sleep(0.05)
        self.filer_address = f"127.0.0.1:{ports[2]}"

    def wfs(self, **kw):
        k = STACK[self.name]
        return k["mount"].WFS(k["rpc"].grpc_address(self.filer_address),
                              chunk_size=CHUNK, subscribe=False, **kw)

    def entries(self, directory: str) -> list:
        """(name, dir?, mode, size, symlink, xattr keys, sorted chunk
        (offset, size)) of every entry under `directory`, recursively,
        as the filer holds them."""
        k = STACK[self.name]
        stub = k["rpc"].filer_stub(k["rpc"].grpc_address(
            self.filer_address))
        out = []
        for r in stub.ListEntries(k["pb"].ListEntriesRequest(
                directory=directory, limit=10000), timeout=30):
            e = r.entry
            path = f"{directory.rstrip('/')}/{e.name}"
            out.append((path, e.is_directory, e.attributes.file_mode,
                        e.attributes.file_size, e.attributes.symlink_target,
                        sorted(e.extended), e.hard_link_counter,
                        sorted((c.offset, c.size) for c in e.chunks)))
            if e.is_directory:
                out += self.entries(path)
        return out

    def close(self) -> None:
        for srv in (self.filer, self.volume, self.master):
            srv.stop()


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    taken: list = []
    out = {}
    try:
        for name in ("ref", "port"):
            out[name] = _Stack(name, str(tmp_path_factory.mktemp(name)),
                               taken)
        yield out
    finally:
        for s in out.values():
            s.close()
        _reset_clients()


def _attrs(e) -> tuple:
    return (e.name, e.is_directory, e.attr.mode, e.size(),
            e.attr.symlink_target)


def _wfs_script(name: str, w, top: str, seed: int) -> list:
    """The FUSE callbacks' operations on `w` under /`top`; every answer
    (bytes, sizes, modes, listings, xattrs, errnos, inode numbers)."""
    k = STACK[name]
    mod = k["mount"]
    rng = np.random.default_rng(seed)
    out = []

    def call(what, fn, *a):
        try:
            r = fn(*a)
        except mod.FuseError as e:
            out.append((what, "errno", e.errno))
            return None
        except OSError as e:
            out.append((what, "oserror", e.errno))
            return None
        out.append((what, r if isinstance(r, (bytes, str, int, list,
                                              type(None))) else "ok"))
        return r

    root = mod.ROOT_INODE
    dino, _ = w.mkdir(root, top)
    sub, _ = w.mkdir(dino, "sub")
    out.append(("inodes", dino, sub))
    payloads = {}
    for i in range(5):
        n = int(rng.integers(1, 3 * CHUNK))
        payloads[f"f{i}"] = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    for fname, data in payloads.items():
        ino, e, fh = w.create(dino if fname != "f4" else sub, fname, 0o640)
        out.append(("create", ino, _attrs(e)))
        # out of order, in odd-sized pieces
        offs = list(range(0, len(data), 7001))
        rng.shuffle(offs)
        for off in offs:
            w.write(fh, int(off), data[off:off + 7001])
        out.append(("dirty", w.entry_size(ino, w.getattr(ino)),
                    w.read(fh, 100, 5000) == data[100:5100]))
        w.flush(fh)
        w.release(fh)
        fh = w.open(ino)
        out.append(("read", w.read(fh, 0, len(data) + 10) == data,
                    w.read(fh, len(data) // 3, 999)))
        w.release(fh)
    out.append(("readdir", sorted(_attrs(e) for e in w.readdir(dino))))
    call("lookup-missing", w.lookup, dino, "nope")
    call("rmdir-nonempty", w.rmdir, dino, "sub")
    call("unlink-dir", w.unlink, dino, "sub")
    call("rmdir-file", w.rmdir, dino, "f0")
    # rename while a handle is open, then write through that handle
    ino = w.path_inode(f"/{top}/f1")
    fh = w.open(ino)
    w.rename(dino, "f1", sub, "moved")
    w.write(fh, 0, b"after-rename")
    w.flush(fh)
    w.release(fh)
    fh = w.open(w.path_inode(f"/{top}/sub/moved"))
    out.append(("moved", w.read(fh, 0, 20)))
    w.release(fh)
    call("old-name", w.lookup, dino, "f1")
    # truncate, chmod, symlink, hard link, xattrs
    ino2 = w.path_inode(f"/{top}/f2")
    w.setattr(ino2, size=1000)
    w.setattr(ino2, mode=0o600)
    fh = w.open(ino2)
    out.append(("truncated", w.read(fh, 0, 5000) == payloads["f2"][:1000],
                _attrs(w.getattr(ino2))))
    w.release(fh)
    sino, _ = w.symlink(dino, "lnk", f"/{top}/f2")
    out.append(("symlink", sino, w.readlink(sino)))
    call("readlink-file", w.readlink, ino2)
    lino, linked = w.link(ino2, sub, "hard")
    out.append(("link", lino == ino2, _attrs(linked),
                linked.hard_link_counter))
    call("link-dir", w.link, sub, dino, "dirlink")
    w.setxattr(ino2, "user.a", b"1")
    w.setxattr(ino2, "user.b", b"22")
    out.append(("xattrs", sorted(w.listxattr(ino2)),
                w.getxattr(ino2, "user.b")))
    w.removexattr(ino2, "user.a")
    call("getxattr-removed", w.getxattr, ino2, "user.a")
    call("removexattr-missing", w.removexattr, ino2, "user.zz")
    w.unlink(dino, "f3")
    call("unlink-again", w.unlink, dino, "f3")
    out.append(("readdir-end", sorted(_attrs(e) for e in w.readdir(dino))))
    out.append(("statfs", sorted(w.statfs())))
    return out


def test_wfs_answers_like_the_reference(stacks):
    got, want = [], []
    for name, out in (("port", got), ("ref", want)):
        w = stacks[name].wfs()
        try:
            out += _wfs_script(name, w, "script", 7)
        finally:
            w.close()
        out.append(stacks[name].entries("/script"))
    assert got == want
    assert ("rmdir-nonempty", "errno", errno.ENOTEMPTY) in got
    assert ("lookup-missing", "errno", errno.ENOENT) in got


def _spill(name: str, stack, top: str) -> list:
    """A file ten chunks long written by a mount whose memory budget is
    two chunks: every chunk touched first, so eight spill to the swap
    file, then filled in reverse; dirty reads from the swap file."""
    k = STACK[name]
    w = stack.wfs()
    w.mem_budget = PKG[name]["pw"].MemBudget(2)
    rng = np.random.default_rng(42)
    payload = rng.integers(0, 256, 10 * CHUNK, dtype=np.uint8).tobytes()
    try:
        dino, _ = w.mkdir(k["mount"].ROOT_INODE, top)
        ino, _, fh = w.create(dino, "big.bin", 0o644)
        for i in range(10):
            w.write(fh, i * CHUNK, payload[i * CHUNK:i * CHUNK + 1])
        swapped = w._handle(fh).pages.swapped_out
        for i in reversed(range(10)):
            w.write(fh, i * CHUNK, payload[i * CHUNK:(i + 1) * CHUNK])
        dirty = w.read(fh, 3 * CHUNK, 100) == \
            payload[3 * CHUNK:3 * CHUNK + 100]
        w.flush(fh)
        w.release(fh)
        fh = w.open(ino)
        back = w.read(fh, 0, len(payload)) == payload
        w.release(fh)
    finally:
        w.close()
    return [swapped, dirty, back, stack.entries(f"/{top}")]


def test_a_write_past_the_memory_budget_spills_like_the_reference(stacks):
    got = _spill("port", stacks["port"], "spill")
    assert got == _spill("ref", stacks["ref"], "spill")
    assert got[0] >= 8 and got[1] and got[2]


# -- kernel mounts -------------------------------------------------------------


def _needs_fuse():
    if not os.path.exists("/dev/fuse"):
        pytest.skip("no /dev/fuse in this environment")


class _Mounted:
    """`wfs` mounted at `mnt` in a thread through its package's shim."""

    def __init__(self, name: str, wfs, mnt: str):
        self.fuse = STACK[name]["fuse"]
        self.mnt = mnt
        os.makedirs(mnt)
        self.thread = threading.Thread(target=self.fuse.mount,
                                       args=(wfs, mnt), daemon=True)
        self.thread.start()
        deadline = time.time() + 30
        while not os.path.ismount(mnt):
            assert self.thread.is_alive(), f"the mount of {mnt} failed"
            assert time.time() < deadline, f"{mnt} never mounted"
            time.sleep(0.05)

    def close(self) -> None:
        self.fuse.unmount(self.mnt)
        self.thread.join(timeout=20)
        assert not self.thread.is_alive()


def _os_script(mnt: str, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []

    def call(what, fn, *a):
        try:
            out.append((what, fn(*a)))
        except OSError as e:
            out.append((what, "errno", e.errno))

    os.makedirs(f"{mnt}/kd/deep")
    files = {}
    for i in range(6):
        n = int(rng.integers(1, 200_000))
        files[f"kd/f{i}"] = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    files["kd/deep/big"] = rng.integers(0, 256, 3 << 20,
                                        dtype=np.uint8).tobytes()
    for rel, data in files.items():
        with open(f"{mnt}/{rel}", "wb") as f:
            f.write(data)
    for rel, data in sorted(files.items()):
        st = os.stat(f"{mnt}/{rel}")
        with open(f"{mnt}/{rel}", "rb") as f:
            back = f.read()
        with open(f"{mnt}/{rel}", "rb") as f:
            f.seek(len(data) // 2)
            part = f.read(4096)
        out.append((rel, st.st_size, stat.S_IFMT(st.st_mode), back == data,
                    part == data[len(data) // 2:len(data) // 2 + 4096]))
    os.rename(f"{mnt}/kd/f0", f"{mnt}/kd/deep/g0")
    os.symlink("deep/g0", f"{mnt}/kd/lnk")
    with open(f"{mnt}/kd/lnk", "rb") as f:
        out.append(("via-symlink", f.read() == files["kd/f0"]))
    out.append(("readlink", os.readlink(f"{mnt}/kd/lnk")))
    os.truncate(f"{mnt}/kd/f1", 777)
    out.append(("truncated", os.stat(f"{mnt}/kd/f1").st_size))
    with open(f"{mnt}/kd/f2", "r+b") as f:  # overwrite in place
        f.seek(10)
        f.write(b"patched")
    with open(f"{mnt}/kd/f2", "rb") as f:
        out.append(("patched", f.read(30)))
    out.append(("listdir", sorted(os.listdir(f"{mnt}/kd")),
                sorted(os.listdir(f"{mnt}/kd/deep"))))
    call("rmdir-nonempty", os.rmdir, f"{mnt}/kd")
    call("open-missing", open, f"{mnt}/kd/none", "rb")
    os.remove(f"{mnt}/kd/lnk")
    os.remove(f"{mnt}/kd/f3")
    out.append(("listdir-end", sorted(os.listdir(f"{mnt}/kd"))))
    return out


def test_a_kernel_mount_of_each_package_answers_alike(stacks, tmp_path):
    _needs_fuse()
    got, want = [], []
    for name, out in (("port", got), ("ref", want)):
        w = stacks[name].wfs()
        m = _Mounted(name, w, str(tmp_path / name))
        try:
            out += _os_script(m.mnt, 11)
        finally:
            m.close()
            w.close()
        out.append(stacks[name].entries("/kd"))
    assert got == want
    assert ("rmdir-nonempty", "errno", errno.ENOTEMPTY) in got


def test_the_kernel_mount_forwards_link_and_xattrs(stacks, tmp_path):
    """ROADMAP.md C: the reference's shim leaves link and the xattr
    operations out of its table, so a kernel mount refuses `ln` and
    `setfattr` that WFS implements (EPERM / EOPNOTSUPP: the kernel's
    answers to libfuse's ENOSYS); the port's forwards them (the user.*
    namespace)."""
    _needs_fuse()
    said = {}
    for name in ("ref", "port"):
        w = stacks[name].wfs()
        m = _Mounted(name, w, str(tmp_path / name))
        try:
            os.makedirs(f"{m.mnt}/lx")
            with open(f"{m.mnt}/lx/a", "wb") as f:
                f.write(b"linked bytes")
            out = []
            for what, fn in (
                    ("link", lambda: os.link(f"{m.mnt}/lx/a",
                                             f"{m.mnt}/lx/b")),
                    ("setxattr", lambda: os.setxattr(
                        f"{m.mnt}/lx/a", "user.tag", b"v1"))):
                try:
                    fn()
                    out.append((what, "ok"))
                except OSError as e:
                    out.append((what, e.errno))
            if name == "port":
                with open(f"{m.mnt}/lx/b", "rb") as f:
                    out.append(("read-link", f.read()))
                out.append(("nlink", os.stat(f"{m.mnt}/lx/a").st_nlink))
                out.append(("getxattr", os.getxattr(f"{m.mnt}/lx/a",
                                                    "user.tag")))
                out.append(("listxattr", os.listxattr(f"{m.mnt}/lx/a")))
                os.removexattr(f"{m.mnt}/lx/a", "user.tag")
                try:
                    os.getxattr(f"{m.mnt}/lx/a", "user.tag")
                except OSError as e:
                    out.append(("removed", e.errno))
                try:
                    os.setxattr(f"{m.mnt}/lx/a", "trusted.x", b"1")
                except OSError as e:
                    out.append(("trusted", e.errno))
            said[name] = out
        finally:
            m.close()
            w.close()
    assert said["ref"] == [("link", errno.EPERM),
                           ("setxattr", errno.EOPNOTSUPP)]
    assert said["port"] == [
        ("link", "ok"), ("setxattr", "ok"), ("read-link", b"linked bytes"),
        ("nlink", 2), ("getxattr", b"v1"), ("listxattr", ["user.tag"]),
        ("removed", errno.ENODATA), ("trusted", errno.EOPNOTSUPP)]


def test_the_shim_is_built_at_first_use_into_the_build_directory():
    path = fuse_binding.library_path()
    assert path.parent.name == "_build" and path.parent.parent.name == "ops"
    assert path.name.startswith("libswfs_fuse-")
    src = os.path.join(REPO, "seaweedfs_tpu_torch", "mount")
    assert not [n for n in os.listdir(src) if n.endswith(".so")]
    r = subprocess.run(["git", "check-ignore", "-q", str(path)], cwd=REPO)
    assert r.returncode == 0, f"{path} is not listed in .gitignore"


def test_what_a_kernel_mount_lacks_is_named(monkeypatch):
    monkeypatch.setattr(fuse_binding.os.path, "exists",
                        lambda p: p != "/dev/fuse")
    monkeypatch.setattr(fuse_binding, "_has_libfuse", lambda: False)
    monkeypatch.setattr(fuse_binding.shutil, "which", lambda n: None)
    assert fuse_binding.fuse_missing() == ["/dev/fuse", "libfuse.so.2",
                                           "gcc"]


def test_a_failed_shim_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "fuse_shim.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(fuse_binding, "_SRC", bad)
    monkeypatch.setattr(fuse_binding, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(fuse_binding, "_lib", None)
    if fuse_binding.shutil.which("gcc") is None:
        pytest.skip("no gcc")
    with pytest.raises(RuntimeError, match="building fuse_shim.c failed"):
        fuse_binding._load_shim()
    assert not list((tmp_path / "_build").glob("*.so"))


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


def test_mount_configure_without_a_live_mount_writes_the_reference_file(
        stacks):
    """No mount listens at -dir: the config is persisted and printed as
    the reference's command does, and nothing else is said."""
    import io

    from seaweedfs_tpu.shell.env import CommandEnv as RefEnv
    from seaweedfs_tpu.shell.registry import run_command as ref_run

    outs = []
    for name, Env, run in (("port", CommandEnv, run_command),
                           ("ref", RefEnv, ref_run)):
        st = stacks[name]
        out = io.StringIO()
        env = Env(st.master.address, filer=st.filer_address)
        assert run(env, "mount.configure -dir=/nowhere/mnt -quotaMB=7",
                   out) == 0
        assert run(env, "mount.configure", out) == 0
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert '"quotaMB": 7' in outs[0]


def _spawn_mount(tmp_path, name: str, args: list, mnt: str):
    os.makedirs(mnt)
    mods = tmp_path / f"{name}.modules"
    log = open(tmp_path / f"{name}.log", "wb")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-c", _WRAPPER, str(mods)]
                            + args, cwd=REPO, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    deadline = time.time() + 60
    while not os.path.ismount(mnt):
        if proc.poll() is not None or time.time() > deadline:
            proc.kill()
            log.close()
            raise AssertionError((tmp_path / f"{name}.log").read_text())
        time.sleep(0.1)
    return proc, log, mods


def _stopped_without_jax(proc, log, mods, sig) -> None:
    proc.send_signal(sig)
    try:
        rc = proc.wait(timeout=60)
    finally:
        log.close()
    assert rc == 0
    names = mods.read_text().split("\n")
    assert "seaweedfs_tpu_torch.mount.weedfs" in names
    assert not [m for m in names if m in ("jax", "seaweedfs_tpu")
                or m.startswith(("jax.", "seaweedfs_tpu."))]


def test_the_mount_command_serves_and_takes_its_quota_from_the_shell(
        stacks, tmp_path):
    _needs_fuse()
    st = stacks["port"]
    mnt = str(tmp_path / "climnt")
    proc, log, mods = _spawn_mount(
        tmp_path, "mount", ["mount", "-filer", st.filer_address, "-dir",
                            mnt, "-memoryLimitMB", "1", "-cacheDir",
                            str(tmp_path / "cache"), "-chunkSizeLimitMB",
                            "1"], mnt)
    env = CommandEnv(st.master.address, filer=st.filer_address)
    try:
        assert os.path.exists(control.control_socket(mnt))
        payload = np.random.default_rng(5).integers(
            0, 256, 3 << 20, dtype=np.uint8).tobytes()
        with open(f"{mnt}/cli.bin", "wb") as f:  # past the 1 MiB budget
            f.write(payload)
        with open(f"{mnt}/cli.bin", "rb") as f:
            assert f.read() == payload
        stub = rpc.filer_stub(rpc.grpc_address(st.filer_address))
        deadline = time.time() + 30
        while stub.Statistics(filer_pb2.StatisticsRequest(),
                              timeout=10).used_size < 2 << 20:
            # the master learns the used size by heartbeat
            assert time.time() < deadline
            time.sleep(0.2)
        out = _shell(env, f"mount.configure -dir={mnt} -quotaMB=1")
        assert f"quota 1 MB set on the mount at {mnt}" in out
        with pytest.raises(OSError) as e:
            with open(f"{mnt}/over.bin", "wb") as f:
                f.write(b"x" * 10000)
        assert e.value.errno == errno.ENOSPC
        out = _shell(env, f"mount.configure -dir={mnt} -quotaMB=0")
        assert f"quota 0 MB set on the mount at {mnt}" in out
        with open(f"{mnt}/after.bin", "wb") as f:
            f.write(b"y" * 10000)
        with open(f"{mnt}/after.bin", "rb") as f:
            assert f.read() == b"y" * 10000
    finally:
        _stopped_without_jax(proc, log, mods, signal.SIGINT)
    assert not os.path.ismount(mnt)
    assert not os.path.exists(control.control_socket(mnt))


def _shell(env, line: str) -> str:
    import io

    out = io.StringIO()
    assert run_command(env, line, out) == 0, out.getvalue()
    return out.getvalue()


def test_the_fuse_command_mounts_and_stops_on_sigterm(stacks, tmp_path):
    _needs_fuse()
    st = stacks["port"]
    mnt = str(tmp_path / "fusemnt")
    proc, log, mods = _spawn_mount(
        tmp_path, "fuse", ["fuse", mnt, "-o",
                           f"filer={st.filer_address},chunkSizeLimitMB=1"],
        mnt)
    try:
        with open(f"{mnt}/f.txt", "wb") as f:
            f.write(b"through weed fuse")
        with open(f"{mnt}/f.txt", "rb") as f:
            assert f.read() == b"through weed fuse"
    finally:
        _stopped_without_jax(proc, log, mods, signal.SIGTERM)
    assert not os.path.ismount(mnt)
