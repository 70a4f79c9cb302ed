"""The port's replication and filer tools against the JAX package's, on
the CPU.

Each package runs one script over two stacks of its own, A and B (each a
master, a volume server with the numpy coder or RSCodecTorch on the CPU,
and a filer at 64 KiB chunks), with an S3 gateway of the same package over
B; the reference's run and the port's follow each other on their own
ports. The script covers:

- the metadata events of a seeded tree written to A (PUTs with their
  MIME types, an overwrite, a rename, a delete) replayed by a Replicator
  into a local sink and into an S3 sink through the package's own
  gateway (anonymous, as the reference's `filer.replicate -sink s3`);
- `filer.sync` one way (FilerSyncLoop, with its cursor in the target's
  KV) and active-active, with writes, a rename and a delete on both
  sides: every file applied once and none bounced back;
- the CLI's `filer.backup`, `filer.copy` and `filer.cat`, in process;
- `filer.meta.tail` and `filer.meta.backup` as processes, the latter
  stopped, its file given a torn tail, and started again.

Compared with tolerance 0: the mirrored and backed-up trees (paths,
bytes, sizes, MIME types, modes), the S3 objects, the sinks' applies per
path, the CLI's output, and the recorded events. Events carry wall-clock
times, fids and filer signatures, so these are masked: an event is
compared as its directory, its old and new entries (name, kind, size,
MIME type, mode, md5, chunk extents and ETags, content, extended
attributes), its new parent, and its flags; timestamps are checked to
be unique and increasing instead.

Where the reference is at fault (ROADMAP.md C), a test shows both
answers: `filer.backup` of a file mounted from remote storage and not
cached. Then the sinks' retries, the nine commands' flags, and
`filer.sync -isActiveActive` as a process without JAX that exits 0 on
SIGTERM."""

import contextlib
import hashlib
import io
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time

import grpc
import numpy as np
import pytest
import requests
from google.protobuf.json_format import ParseDict

from seaweedfs_tpu import command as ref_command
from seaweedfs_tpu import replication as ref_replication
from seaweedfs_tpu.models.coder import new_coder as ref_new_coder
from seaweedfs_tpu.pb import filer_pb2 as ref_filer_pb2
from seaweedfs_tpu.pb import rpc as ref_rpc
from seaweedfs_tpu.replication import sink as ref_sink
from seaweedfs_tpu.s3api.server import S3Server as RefS3
from seaweedfs_tpu.server.filer import FilerServer as RefFiler
from seaweedfs_tpu.server.master import MasterServer as RefMaster
from seaweedfs_tpu.server.volume import VolumeServer as RefVolume
from seaweedfs_tpu.shell.env import CommandEnv as RefEnv
from seaweedfs_tpu.shell.registry import run_command as ref_run_command
from seaweedfs_tpu.wdclient import pool as ref_pool
from seaweedfs_tpu_torch import command, replication
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
from seaweedfs_tpu_torch.pb import filer_pb2, rpc
from seaweedfs_tpu_torch.replication import sink
from seaweedfs_tpu_torch.s3api.server import S3Server
from seaweedfs_tpu_torch.server.filer import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.shell.registry import run_command
from seaweedfs_tpu_torch.wdclient import pool
from tests import torch_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {
    "ref": dict(Master=RefMaster, Volume=RefVolume, Filer=RefFiler,
                S3=RefS3, coder=lambda: ref_new_coder(10, 4, "cpu"),
                rpc=ref_rpc, pb=ref_filer_pb2, repl=ref_replication,
                sink=ref_sink, command=ref_command, Env=RefEnv,
                run=ref_run_command, module="seaweedfs_tpu"),
    "port": dict(Master=MasterServer, Volume=VolumeServer,
                 Filer=FilerServer, S3=S3Server, coder=lambda: RSCodecTorch(
                     10, 4, device="cpu"), rpc=rpc, pb=filer_pb2,
                 repl=replication, sink=sink, command=command,
                 Env=CommandEnv, run=run_command,
                 module="seaweedfs_tpu_torch"),
}
TOOLS = ("filer.sync", "filer.replicate", "filer.backup", "filer.cat",
         "filer.copy", "filer.meta.tail", "filer.meta.backup",
         "filer.remote.sync", "filer.remote.gateway")
DRAIN_S = 2.0
OVERWRITE = np.random.default_rng(17).integers(
    0, 256, 36_000, dtype=np.uint8).tobytes()

# -- ports ---------------------------------------------------------------------

_PORTS = random.Random(os.getpid() + 37)
_RESERVED = {p + d for p in (8888, 9333, 8080, 8333)
             for d in (0, 10000, 11000)}


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


def _session() -> requests.Session:
    s = requests.Session()
    s.trust_env = False
    return s


# -- stacks --------------------------------------------------------------------


class _Stack:
    """One package's master, volume server and filer."""

    def __init__(self, name: str, root: str, taken: list):
        k = PKG[name]
        self.name = name
        self.k = k
        self.taken = taken
        m, v, f = (self.port() for _ in range(3))
        self.master = k["Master"](ip="127.0.0.1", port=m,
                                  volume_size_limit_mb=64)
        self.master.start(vacuum_interval=3600)
        self.volume = k["Volume"](
            directories=[os.path.join(root, "v")],
            master=self.master.address, ip="127.0.0.1", port=v,
            pulse_seconds=1, coder=k["coder"]())
        self.volume.start()
        self.filer = k["Filer"](ip="127.0.0.1", port=f,
                                master=self.master.address,
                                store_dir=os.path.join(root, "f"),
                                chunk_size=64 * 1024)
        self.filer.start()
        deadline = time.time() + 30
        while not self.master.topo.nodes:
            assert time.time() < deadline, "the volume never registered"
            time.sleep(0.05)
        self.address = f"127.0.0.1:{f}"
        self.base = f"http://{self.address}"

    def port(self) -> int:
        p = _free_port_pair(self.taken)
        self.taken.append(p)
        return p

    def stub(self):
        return self.k["rpc"].filer_stub(
            self.k["rpc"].grpc_address(self.address))

    def close(self) -> None:
        for srv in (self.filer, self.volume, self.master):
            srv.stop()


def _tree(http, st, top: str) -> dict:
    """{path: (size, MIME type, mode, sha256 of a GET)} of every file under
    `top`, through the filer's HTTP listing; directories map to None."""
    out = {}

    def walk(d):
        r = http.get(st.base + d + "/", params={"limit": 10000}, timeout=30)
        if r.status_code == 404:
            return
        for e in r.json()["Entries"] or []:
            p = e["FullPath"]
            if e["IsDirectory"]:
                out[p] = None
                walk(p)
            else:
                body = http.get(st.base + p, timeout=60).content
                out[p] = (e["FileSize"], e["Mime"], e["Mode"],
                          hashlib.sha256(body).hexdigest())

    walk(top)
    return out


def _local_tree(root: str) -> dict:
    out = {}
    for d, dirs, files in os.walk(root):
        for name in dirs:
            out[os.path.relpath(os.path.join(d, name), root)] = None
        for name in files:
            full = os.path.join(d, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root)] = (
                    os.path.getsize(full),
                    hashlib.sha256(f.read()).hexdigest())
    return out


def _entry_view(e) -> tuple | None:
    if not e.name:
        return None
    a = e.attributes
    return (e.name, e.is_directory, a.file_size, a.mime, a.file_mode,
            a.md5.hex(), [(c.offset, c.size, c.e_tag) for c in e.chunks],
            hashlib.sha256(e.content).hexdigest() if e.content else "",
            sorted(e.extended.items()))


def _event_view(resp) -> tuple:
    """An event without its times, fids and signatures."""
    ev = resp.event_notification
    return (resp.directory, _entry_view(ev.old_entry),
            _entry_view(ev.new_entry), ev.new_parent_path,
            ev.delete_chunks, ev.is_from_other_cluster)


def _drain(st, prefix: str, since_ns: int = 0) -> list:
    """A's events under `prefix` until the stream is idle."""
    out = []
    try:
        for resp in st.stub().SubscribeMetadata(
                st.k["pb"].SubscribeMetadataRequest(
                    client_name="test", path_prefix=prefix,
                    since_ns=since_ns), timeout=DRAIN_S):
            out.append(resp)
    except grpc.RpcError as e:
        assert e.code() == grpc.StatusCode.DEADLINE_EXCEEDED, e
    return out


class _Counted:
    """A sink whose applies are counted by path."""

    def __init__(self, inner, counts: dict):
        self.inner = inner
        self.name = inner.name
        self.counts = counts

    def create_entry(self, path, entry, data):
        self.counts[("create", path)] = self.counts.get(("create", path),
                                                        0) + 1
        self.inner.create_entry(path, entry, data)

    update_entry = create_entry

    def delete_entry(self, path, is_directory):
        self.counts[("delete", path)] = self.counts.get(("delete", path),
                                                        0) + 1
        self.inner.delete_entry(path, is_directory)


def _files(seed: int, top: str, n: int) -> dict:
    """{path: (bytes, MIME type)}: files of 1 B-150 KiB (up to three 64 KiB
    chunks) in nested directories."""
    rng = np.random.default_rng(seed)
    mimes = ("", "text/plain", "application/x-test", "image/png")
    out = {}
    for i in range(n):
        size = int(rng.integers(1, 150 * 1024))
        out[f"{top}/d{i % 3}/s{i % 2}/f{i:02d}.bin" if i % 4 else
            f"{top}/f{i:02d}.bin"] = (
            rng.integers(0, 256, size, dtype=np.uint8).tobytes(),
            mimes[i % 4])
    return out


def _put_all(http, st, files: dict) -> None:
    for path, (data, mime) in files.items():
        r = http.put(st.base + path, data=data, timeout=60,
                     headers={"Content-Type": mime} if mime else {})
        assert r.status_code in (200, 201), (path, r.status_code)


def _rename(st, old: str, new: str) -> None:
    (od, on), (nd, nn) = old.rsplit("/", 1), new.rsplit("/", 1)
    st.stub().AtomicRenameEntry(st.k["pb"].AtomicRenameEntryRequest(
        old_directory=od, old_name=on, new_directory=nd, new_name=nn),
        timeout=30)


class _Captured:
    value = b""

    def getvalue(self) -> bytes:
        return self.value


@contextlib.contextmanager
def _stdout():
    """sys.stdout (and its buffer) into bytes, read after the block."""
    buf = io.BytesIO()
    wrapper = io.TextIOWrapper(buf, encoding="utf-8")
    got = _Captured()
    with contextlib.redirect_stdout(wrapper):
        yield got
    wrapper.flush()
    got.value = buf.getvalue()
    wrapper.detach()


# -- the tools as processes ----------------------------------------------------

_WRAPPER = """
import atexit, runpy, sys
out = sys.argv[1]
package = sys.argv[2]


def dump():
    with open(out, "w") as f:
        f.write("\\n".join(sorted(sys.modules)))


atexit.register(dump)
sys.argv = [package] + sys.argv[3:]
runpy.run_module(package, run_name="__main__", alter_sys=True)
"""


class _Proc:
    """`python -m <package> <args>` with its output in a file."""

    def __init__(self, root, name: str, package: str, args: list):
        self.name = name
        self.mods = os.path.join(root, f"{name}.modules")
        self.out_path = os.path.join(root, f"{name}.out")
        self.out = open(self.out_path, "wb")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["JAX_PLATFORMS"] = "cpu"
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _WRAPPER, self.mods, package] + args,
            cwd=REPO, env=env, stdout=self.out, stderr=subprocess.PIPE)

    def output(self) -> bytes:
        with open(self.out_path, "rb") as f:
            return f.read()

    def wait_for(self, ready, timeout: float = 60) -> None:
        deadline = time.time() + timeout
        while not ready():
            assert self.proc.poll() is None, self.proc.stderr.read()
            assert time.time() < deadline, f"{self.name} not ready"
            time.sleep(0.1)

    def stop(self) -> int:
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=60)
        finally:
            self.out.close()
        return rc

    def modules(self) -> list[str]:
        with open(self.mods) as f:
            return f.read().split("\n")


def _clean_exit(p: _Proc, rc: int) -> None:
    """The port's tool exits 0 on SIGTERM with no JAX in its process."""
    assert rc == 0, p.proc.stderr.read()
    names = p.modules()
    assert "seaweedfs_tpu_torch.command" in names
    assert not [m for m in names if m in ("jax", "seaweedfs_tpu")
                or m.startswith(("jax.", "seaweedfs_tpu."))]


def _meta_tail(root, st, http) -> list:
    """filer.meta.tail -pathPrefix /mt through a burst of writes; -> the
    events it printed (masked)."""
    p = _Proc(root, f"tail-{st.name}", st.k["module"],
              ["filer.meta.tail", "-filer", st.address, "-pathPrefix",
               "/mt"])
    tries = []

    def ready():
        tries.append(1)
        http.put(f"{st.base}/mt/ready{len(tries):03d}", data=b"r",
                 timeout=30)
        return b"/mt/ready" in p.output() or b'"ready' in p.output()

    p.wait_for(ready)
    files = _files(41, "/mt/w", 8)
    _put_all(http, st, files)
    _rename(st, "/mt/w/f00.bin", "/mt/w/moved.bin")
    assert http.delete(f"{st.base}/mt/w/d2", params={"recursive": "true"},
                       timeout=30).status_code in (200, 202, 204)
    http.put(f"{st.base}/mt/zz-done", data=b"z", timeout=30)
    p.wait_for(lambda: b"zz-done" in p.output())
    rc = p.stop()
    if st.name == "port":
        _clean_exit(p, rc)
    events = []
    for line in p.output().decode().splitlines():
        resp = ParseDict(json.loads(line),
                         st.k["pb"].SubscribeMetadataResponse())
        ev = resp.event_notification
        if "ready" in (ev.new_entry.name or ev.old_entry.name):
            continue
        events.append(resp)
    ts = [e.ts_ns for e in events]
    assert ts == sorted(ts) and len(set(ts)) == len(ts)
    return [_event_view(e) for e in events]


def _records(path: str, pb) -> list:
    out = []
    with open(path, "rb") as f:
        blob = f.read()
    off = 0
    while off < len(blob):
        (n,) = __import__("struct").unpack_from(">I", blob, off)
        out.append(pb.SubscribeMetadataResponse.FromString(
            blob[off + 4:off + 4 + n]))
        off += 4 + n
    assert off == len(blob)
    return out


def _meta_backup(root, st, http) -> tuple:
    """filer.meta.backup through writes, stopped, given a torn tail,
    started again; -> (its records under /mb, masked; the stop codes)."""
    path = os.path.join(root, f"meta-{st.name}.backup")
    pb = st.k["pb"]

    def recorded(name: str):
        return lambda: os.path.exists(path) and name.encode() in \
            open(path, "rb").read()

    args = ["filer.meta.backup", "-filer", st.address, "-o", path]
    p = _Proc(root, f"backup-{st.name}", st.k["module"], args)
    _put_all(http, st, _files(51, "/mb/one", 5))
    http.put(f"{st.base}/mb/mb-one-done", data=b"z", timeout=30)
    p.wait_for(recorded("mb-one-done"))
    rc1 = p.stop()
    if st.name == "port":
        _clean_exit(p, rc1)
    with open(path, "ab") as f:  # a record cut short by a crash
        f.write(b"\x00\x00\x04\x00" + b"torn" * 20)
    _put_all(http, st, _files(52, "/mb/two", 4))  # while it is down
    p = _Proc(root, f"backup2-{st.name}", st.k["module"], args)
    p.wait_for(recorded("/mb/two"))
    _rename(st, "/mb/one/f00.bin", "/mb/one/back.bin")
    http.put(f"{st.base}/mb/mb-end", data=b"z", timeout=30)
    p.wait_for(recorded("mb-end"))
    rc2 = p.stop()
    if st.name == "port":
        _clean_exit(p, rc2)
    records = _records(path, pb)  # the torn tail is gone
    ts = [r.ts_ns for r in records]
    assert len(set(ts)) == len(ts), "a record was written twice"
    assert ts == sorted(ts)
    return [_event_view(r) for r in records if r.directory.startswith("/mb")]


# -- the script ----------------------------------------------------------------


def _script(name: str, root: str, taken: list) -> dict:
    k = PKG[name]
    a = _Stack(name, os.path.join(root, "a"), taken)
    b = _Stack(name, os.path.join(root, "b"), taken)
    s3 = k["S3"](port=a.port(), filer=b.address)
    s3.start()
    http = _session()
    out: dict = {}
    try:
        repl = k["repl"]
        # -- the source tree on A, its events into a local and an S3 sink
        # (each batch of events is applied before the next batch is
        # written, as a live subscriber applies them: an overwrite frees
        # the chunks of the version before it)
        src = _files(11, "/src", 14)
        first = next(iter(src))
        local_dir = os.path.join(root, "mirror")
        counts: dict = {}
        r1 = repl.Replicator(repl.FilerSource(a.address), _Counted(
            k["sink"].LocalSink(local_dir), counts), source_prefix="/src")
        gw = f"http://127.0.0.1:{s3.port}"
        assert http.put(f"{gw}/mirror", timeout=30).status_code == 200
        r2 = repl.Replicator(repl.FilerSource(a.address), k["sink"].S3Sink(
            gw, "mirror", directory="m"), source_prefix="/src")
        out["events"], out["local_applied"], out["s3_applied"] = [], [], []
        since = 0
        for step in range(2):
            if step == 0:
                _put_all(http, a, src)
            else:
                # incompressible: a chunk the filer gzips carries the
                # wall clock in its gzip header, and so in its ETag
                _put_all(http, a, {first: (OVERWRITE, "text/plain")})
                _rename(a, "/src/d1/s1/f01.bin", "/src/d1/s1/renamed.bin")
                assert http.delete(a.base + "/src/d2/s0/f02.bin",
                                   timeout=30).status_code in (200, 202, 204)
            events = _drain(a, "/src", since)
            since = events[-1].ts_ns
            out["events"] += [_event_view(e) for e in events]
            out["local_applied"] += [r1.replicate(e) for e in events]
            out["s3_applied"] += [r2.replicate(e) for e in events]
        out["local"] = (_local_tree(local_dir), sorted(counts.items()))
        objects = {}
        for path, v in sorted(_tree(http, b, "/buckets/mirror").items()):
            if v is None:
                continue
            key = path[len("/buckets/mirror/"):]
            g = http.get(f"{gw}/mirror/{key}", timeout=30)
            objects[key] = (g.status_code, g.headers.get("Content-Type"),
                            hashlib.sha256(g.content).hexdigest())
        out["s3"] = objects

        # -- filer.sync one way, the cursor kept in B's KV
        _put_all(http, a, _files(12, "/docs", 6))
        loop = repl.FilerSyncLoop(a.address, b.address, source_path="/docs")
        loop.run_once(since_ns=0, drain_timeout=DRAIN_S)
        first_pass = loop.replicated
        loop.run_once(drain_timeout=DRAIN_S)  # from the saved cursor
        http.delete(a.base + "/docs/f00.bin", timeout=30)
        loop.run_once(drain_timeout=DRAIN_S)
        out["sync"] = (first_pass, loop.replicated,
                       _tree(http, a, "/docs"), _tree(http, b, "/docs"))

        # -- active-active: writes on both sides, each applied once
        ab_counts, ba_counts = {}, {}
        ab = repl.FilerSyncLoop(a.address, b.address, source_path="/aa")
        ba = repl.FilerSyncLoop(b.address, a.address, source_path="/aa")
        ab.replicator.sink = _Counted(ab.replicator.sink, ab_counts)
        ba.replicator.sink = _Counted(ba.replicator.sink, ba_counts)
        _put_all(http, a, _files(13, "/aa/a", 5))
        _put_all(http, b, _files(14, "/aa/b", 3))
        for _ in range(2):
            ab.run_once(drain_timeout=DRAIN_S)
            ba.run_once(drain_timeout=DRAIN_S)
        _rename(a, "/aa/a/f00.bin", "/aa/a/moved.bin")
        http.delete(b.base + "/aa/b/d1/s1/f01.bin", timeout=30)
        for _ in range(2):
            ab.run_once(drain_timeout=DRAIN_S)
            ba.run_once(drain_timeout=DRAIN_S)
        out["active_active"] = (
            sorted(ab_counts.items()), sorted(ba_counts.items()),
            ab.replicated, ba.replicated, _tree(http, a, "/aa"),
            _tree(http, b, "/aa"))

        # -- the one-shot CLI tools, in process
        backup_dir = os.path.join(root, "backup")
        with _stdout() as buf:
            assert k["command"].main(["filer.backup", "-filer", a.address,
                                      "-path", "/src", "-target",
                                      backup_dir]) == 0
        out["backup"] = (buf.getvalue().decode().replace(root, "<root>"),
                         _local_tree(backup_dir))
        copy_src = os.path.join(COPY_ROOT[name], "copy-src")
        with _stdout() as buf:
            assert k["command"].main(["filer.copy", "-filer", a.address,
                                      copy_src, "/copied"]) == 0
        out["copy"] = (buf.getvalue().decode(), _tree(http, a, "/copied"))
        kept = [p for p in src if p not in (first, "/src/d1/s1/f01.bin",
                                             "/src/d2/s0/f02.bin")]
        big = max(kept, key=lambda p: len(src[p][0]))
        with _stdout() as buf:
            assert k["command"].main(["filer.cat", "-filer", a.address,
                                      big]) == 0
        out["cat"] = buf.getvalue() == src[big][0]
        with _stdout() as buf:
            assert k["command"].main(["filer.cat", "-filer", a.address,
                                      "/src/nowhere"]) == 1

        # -- the streaming tools, as processes
        out["meta_tail"] = _meta_tail(root, a, http)
        out["meta_backup"] = _meta_backup(root, a, http)
    finally:
        http.close()
        s3.stop()
        for st in (a, b):
            st.close()
        for mod in (rpc, ref_rpc):
            mod.reset_channels()
        for mod in (pool, ref_pool):
            mod.POOL.clear()
    return out


COPY_ROOT: dict = {}
_DONE: dict = {}


def _copy_source(root: str) -> None:
    rng = np.random.default_rng(61)
    for i in range(12):
        d = os.path.join(root, "copy-src", f"c{i % 3}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"x{i:02d}"), "wb") as f:
            f.write(rng.integers(0, 256, int(rng.integers(1, 90_000)),
                                 dtype=np.uint8).tobytes())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not _DONE:
        taken: list = []
        for name in ("ref", "port"):
            COPY_ROOT[name] = str(tmp_path_factory.mktemp(f"copy-{name}"))
            _copy_source(COPY_ROOT[name])
            _DONE[name] = _script(name, str(tmp_path_factory.mktemp(name)),
                                  taken)
    return _DONE


@pytest.mark.parametrize("key", ["events", "local_applied", "local",
                                 "s3_applied", "s3", "sync",
                                 "active_active", "backup", "copy", "cat",
                                 "meta_tail", "meta_backup"])
def test_the_tools_answer_like_the_reference(runs, key):
    assert runs["port"][key] == runs["ref"][key]


def test_the_sinks_mirror_the_source(runs):
    out = runs["port"]
    local, counts = out["local"]
    files = {p: v for p, v in local.items() if v is not None}
    assert len(files) == 13  # 14 written, one deleted (one renamed)
    assert "d1/s1/renamed.bin" in files and "d1/s1/f01.bin" not in files
    assert all(n == 1 for (verb, _), n in counts if verb == "delete")
    s3 = out["s3"]
    assert len(s3) == 13 and all(v[0] == 200 for v in s3.values())
    assert s3["m/d1/s1/renamed.bin"][1] == "text/plain"  # the MIME type kept
    assert out["cat"]


def test_filer_sync_converges_without_a_loop(runs):
    first_pass, total, tree_a, tree_b = runs["port"]["sync"]
    assert first_pass == 6 and total == 7  # the second pass replayed none
    assert {p: v[3] for p, v in tree_a.items() if v} == \
        {p: v[3] for p, v in tree_b.items() if v}
    ab, ba, n_ab, n_ba, aa_a, aa_b = runs["port"]["active_active"]
    assert {p: v[3] for p, v in aa_a.items() if v} == \
        {p: v[3] for p, v in aa_b.items() if v}
    # each write applied once, in its own direction only
    assert all(n == 1 for _, n in ab + ba)
    assert {p for (_, p), _ in ab} & {p for (_, p), _ in ba} == set()
    assert all(p.startswith("/a/") for (_, p), _ in ab)
    assert all(p.startswith("/b/") for (_, p), _ in ba)


def test_meta_backup_resumes_after_a_torn_tail(runs):
    names = [(e[2] or e[1])[0] for e in runs["port"]["meta_backup"]]
    # every write once: five, the four made while it was down, a rename
    assert sum(n.startswith("f") for n in names) == 9
    assert names.count("back.bin") == 1 and names.count("mb-end") == 1
    assert names.count("mb-one-done") == 1


# -- a rename across directories -----------------------------------------------


def _renamed_across(name: str, port: int, mirror: str) -> dict:
    """An inline file created under /src and renamed to /dst on a filer
    of the package (no volume needed); -> the rename event's directory,
    which prefixes see it, the shell's fs.meta.tail lines (times cut
    off), and a local sink's tree after the events."""
    k = PKG[name]
    fs = k["Filer"](ip="127.0.0.1", port=port, master="127.0.0.1:1",
                    store="memory")
    fs.start()
    try:
        stub = k["rpc"].filer_stub(f"127.0.0.1:{port + 10000}")
        pb = k["pb"]
        stub.CreateEntry(pb.CreateEntryRequest(
            directory="/src", entry=pb.Entry(name="x", content=b"moved")),
            timeout=10)
        stub.AtomicRenameEntry(pb.AtomicRenameEntryRequest(
            old_directory="/src", old_name="x", new_directory="/dst",
            new_name="x"), timeout=10)

        class St:
            pass

        st = St()
        st.k, st.stub = k, lambda: stub
        seen = {p: [(e.directory, e.event_notification.old_entry.name)
                    for e in _drain(st, p)] for p in ("/src", "/dst")}
        out = io.StringIO()
        assert k["run"](k["Env"]("127.0.0.1:1", filer=f"127.0.0.1:{port}"),
                        "fs.meta.tail -timeAgo=60s -pathPrefix=/", out) == 0
        tail = [line.split(" ", 1)[1] for line in out.getvalue().splitlines()]
        r = k["repl"].Replicator(k["repl"].FilerSource(f"127.0.0.1:{port}"),
                                 k["sink"].LocalSink(mirror))
        for e in _drain(st, "/"):
            r.replicate(e)
        return {"seen": seen, "tail": tail, "mirror": _local_tree(mirror)}
    finally:
        fs.stop()
        fs._http_server.server_close()
        fs._grpc_server.stop(None).wait(10)
        for mod in (rpc, ref_rpc):
            mod.reset_channels()


def test_a_rename_across_directories_leaves_nothing_behind(tmp_path):
    """/src/x renamed to /dst/x. The reference files the event under the
    new directory, /dst, so a replicator deletes /dst/x, which never
    existed, and every mirror keeps /src/x; a subscriber of /src never
    hears of the move. The port files it under /src, where the entry
    was, as SeaweedFS does, and a prefix sees a rename on either side.
    fs.meta.tail prints where the entry went in both."""
    port = _free_port_pair()
    got = {name: _renamed_across(name, port, str(tmp_path / name))
           for name in PKG}
    moved = (5, hashlib.sha256(b"moved").hexdigest())
    tail = ["create /src/x", "update /dst/x"]
    assert got["ref"] == {
        "seen": {"/src": [("/src", "")], "/dst": [("/dst", "x")]},
        "tail": tail,
        "mirror": {"src": None, "src/x": moved, "dst": None,
                   "dst/x": moved}}
    assert got["port"] == {
        "seen": {"/src": [("/src", ""), ("/src", "x")],
                 "/dst": [("/src", "x")]},
        "tail": tail,
        "mirror": {"src": None, "dst": None, "dst/x": moved}}


# -- an event whose version was replaced ---------------------------------------


def _overwritten(name: str, root: str, taken: list) -> dict:
    """/ov/f written, then overwritten before a replicator applies the
    first event: that event's chunk is gone. -> what a Replicator into a
    local sink and a FilerSyncLoop each make of the events."""
    k = PKG[name]
    st = _Stack(name, root, taken)
    b = _Stack(name, root + "-b", taken)
    http = _session()
    out = {}
    try:
        first = _files(71, "/ov", 1)
        path, (data, _) = next(iter(first.items()))
        _put_all(http, st, first)
        old_fid = st.stub().LookupDirectoryEntry(k["pb"].LookupDirectoryEntryRequest(
            directory="/ov", name=path.rsplit("/", 1)[1]),
            timeout=10).entry.chunks[0].file_id
        _put_all(http, st, {path: (OVERWRITE, "")})
        deadline = time.time() + 30
        while http.get(f"http://{st.volume.address}/{old_fid}",
                       timeout=10).status_code != 404:
            assert time.time() < deadline, "the old chunk was never freed"
            time.sleep(0.1)
        events = _drain(st, "/ov")
        mirror = os.path.join(root, "mirror")
        r = k["repl"].Replicator(k["repl"].FilerSource(st.address),
                                 k["sink"].LocalSink(mirror))
        applied = []
        try:
            for e in events:
                applied.append(r.replicate(e))
        except IOError as e:
            applied.append(type(e).__name__)
        out["replicator"] = (applied, _local_tree(mirror))
        loop = k["repl"].FilerSyncLoop(st.address, b.address,
                                       source_path="/ov")
        loop.run_once(since_ns=0, drain_timeout=DRAIN_S)
        got = http.get(b.base + path, timeout=30)
        out["sync"] = (loop.replicated, got.status_code,
                       got.content == OVERWRITE)
    finally:
        http.close()
        for x in (st, b):
            x.close()
        for mod in (rpc, ref_rpc):
            mod.reset_channels()
        for mod in (pool, ref_pool):
            mod.POOL.clear()
    return out


def test_an_event_whose_version_was_replaced_does_not_stall(tmp_path):
    """A file overwritten before its create event is applied: the event's
    chunk is freed. The reference's Replicator raises on the 404, so its
    FilerSyncLoop stops at that event every time and the file never
    reaches the target; the port skips the replaced version, as
    SeaweedFS's filer sink does, and applies the overwrite."""
    taken: list = []
    got = {name: _overwritten(name, str(tmp_path / name), taken)
           for name in PKG}
    sha = hashlib.sha256(OVERWRITE).hexdigest()
    assert got["ref"]["replicator"] == (["OSError"], {})
    assert got["ref"]["sync"] == (0, 404, False)
    assert got["port"]["replicator"] == (
        [False, True], {"ov": None, "ov/f00.bin": (len(OVERWRITE), sha)})
    assert got["port"]["sync"] == (1, 200, True)


# -- a filer restarted under a streaming tool ----------------------------------


def _under_a_restart(name: str, root: str, port: int) -> tuple:
    """filer.meta.backup of a filer that restarts on its store; -> (the
    tool's exit code, the names of the entries it recorded)."""
    k = PKG[name]
    store = os.path.join(root, "store")

    def filer():
        fs = k["Filer"](ip="127.0.0.1", port=port, master="127.0.0.1:1",
                        store_dir=store)
        fs.start()
        return fs

    def create(n):
        stub = k["rpc"].filer_stub(f"127.0.0.1:{port + 10000}")
        stub.CreateEntry(k["pb"].CreateEntryRequest(
            directory="/r", entry=k["pb"].Entry(name=n, content=b"x")),
            timeout=10)

    def stopped(fs):
        fs.stop()
        fs._http_server.server_close()
        fs._grpc_server.stop(None).wait(10)
        for mod in (rpc, ref_rpc):
            mod.reset_channels()

    path = os.path.join(root, "meta.backup")
    fs = filer()
    p = _Proc(root, f"restart-{name}", k["module"],
              ["filer.meta.backup", "-filer", f"127.0.0.1:{port}", "-o",
               path])
    try:
        create("before")
        p.wait_for(lambda: os.path.exists(path) and
                   b"before" in open(path, "rb").read())
        stopped(fs)
        time.sleep(1.5)
        fs = filer()
        create("after")
        deadline = time.time() + 20
        while p.proc.poll() is None and time.time() < deadline and \
                b"after" not in open(path, "rb").read():
            time.sleep(0.2)
        rc = p.proc.poll() if p.proc.poll() is not None else p.stop()
    finally:
        if p.proc.poll() is None:
            p.proc.kill()
        stopped(fs)
    names = [r.event_notification.new_entry.name
             for r in _records(path, k["pb"])]
    return rc, names


def test_a_streaming_tool_follows_a_filer_across_its_restart(tmp_path):
    """The filer under filer.meta.backup restarts on its store. The
    reference's tool exits on the dropped stream (UNAVAILABLE), and the
    events after the restart are never recorded; the port's follows the
    filer again from the last event it recorded: each event once."""
    port = _free_port_pair()
    got = {name: _under_a_restart(name, str(tmp_path / name), port)
           for name in PKG}
    assert got["ref"][0] != 0 and got["ref"][1] == ["before"]
    assert got["port"] == (0, ["before", "after"])


# -- a file mounted from remote storage ----------------------------------------


def test_a_remote_only_file_is_backed_up_with_its_bytes(tmp_path):
    """filer.backup of a file mounted from remote storage and not cached:
    it has no chunks, and the reference's FilerSource returns b"" for it,
    so the backup holds an empty file. The port reads it through the
    filer's remote read-through."""
    remote_dir = tmp_path / "remote"
    remote_dir.mkdir()
    data = os.urandom(70_000)
    (remote_dir / "obj.bin").write_bytes(data)
    taken: list = []
    got = {}
    for name, k in PKG.items():
        st = _Stack(name, str(tmp_path / name), taken)
        try:
            env = k["Env"](st.master.address, filer=st.address)
            for line in (f"remote.configure -name=r -type=local "
                         f"-root={remote_dir}",
                         "remote.mount -dir=/rmt -remote=r"):
                out = io.StringIO()
                assert k["run"](env, line, out) == 0, out.getvalue()
            target = tmp_path / f"backup-{name}"
            with _stdout():
                assert k["command"].main(["filer.backup", "-filer",
                                          st.address, "-path", "/rmt",
                                          "-target", str(target)]) == 0
            got[name] = (target / "obj.bin").read_bytes()
        finally:
            st.close()
            for mod in (rpc, ref_rpc):
                mod.reset_channels()
    assert got["ref"] == b""
    assert got["port"] == data


# -- the sinks' retries, the commands' flags -----------------------------------


class _Flaky:
    name = "flaky"

    def __init__(self, exc):
        self.exc = exc
        self.calls = 0

    def create_entry(self, path, entry, data):
        self.calls += 1
        raise self.exc

    delete_entry = create_entry


@pytest.mark.parametrize("kind,calls", [("unavailable", 4), ("refused", 1)])
def test_a_failing_sink_is_retried_then_raised(kind, calls):
    got = {}
    for name, k in PKG.items():
        exc = (k["sink"].SinkUnavailable("503") if kind == "unavailable"
               else IOError("403"))
        flaky = _Flaky(exc)
        r = k["repl"].Replicator(k["repl"].FilerSource("127.0.0.1:1"),
                                 flaky, sink_wait_init=0.001)
        resp = k["pb"].SubscribeMetadataResponse(directory="/d")
        resp.event_notification.new_entry.name = "x"
        resp.event_notification.new_entry.is_directory = True
        with pytest.raises(IOError):
            r.replicate(resp)
        got[name] = flaky.calls
    assert got == {"ref": calls, "port": calls}


def _help_exits_0(mod, cmd: str) -> bool:
    """The command runs: its help parses and exits 0."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        mod.main([cmd, "-h"])
    return e.value.code == 0 and bool(out.getvalue())


def _flags(mod, cmd: str) -> list[str]:
    import re

    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        mod.main([cmd, "-h"])
    return sorted(set(re.findall(r"(?m)^\s+(-[\w.]+)", out.getvalue())))


@pytest.mark.parametrize("cmd", TOOLS)
def test_the_tools_take_the_references_flags(cmd):
    assert _flags(command, cmd) == _flags(ref_command, cmd)
    assert _help_exits_0(command, cmd)


def test_filer_sync_runs_as_a_process_and_stops_cleanly(tmp_path):
    taken: list = []
    a = _Stack("port", str(tmp_path / "a"), taken)
    b = _Stack("port", str(tmp_path / "b"), taken)
    http = _session()
    p = _Proc(str(tmp_path), "sync", "seaweedfs_tpu_torch",
              ["filer.sync", "-a", a.address, "-b", b.address, "-a.path",
               "/live", "-isActiveActive"])
    try:
        http.put(a.base + "/live/from-a", data=b"a" * 1000, timeout=30)
        http.put(b.base + "/live/from-b", data=b"b" * 2000, timeout=30)
        p.wait_for(lambda: http.get(b.base + "/live/from-a",
                                    timeout=30).content == b"a" * 1000)
        p.wait_for(lambda: http.get(a.base + "/live/from-b",
                                    timeout=30).content == b"b" * 2000)
        _clean_exit(p, p.stop())
        assert set(_tree(http, a, "/live")) == set(_tree(http, b, "/live"))
    finally:
        if p.proc.poll() is None:
            p.proc.kill()
        http.close()
        for st in (a, b):
            st.close()
        for mod in (rpc, ref_rpc):
            mod.reset_channels()

