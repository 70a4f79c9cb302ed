"""The port's remote storage against the JAX package's, on the CPU.

First the building blocks: `LocalRemoteStorage` over a seeded tree
(traverse with and without a prefix, ranged reads, deletes), the mount
table's wire forms (`conf_to_pb`, `mapping_to_pb`), and the GCS, Azure
and B2 clients, storages and sinks, each package's against a fake of its
own (tests/fake_cloud.py; the Azure fake recomputes every SharedKey
signature and refuses a wrong one). What the clients return and what the
fakes hold are compared with tolerance 0.

Then the remote plane on a running stack of each package (a master, a
volume server with the numpy coder or RSCodecTorch on the CPU, a filer at
64 KiB chunks), both over copies of one seeded local remote whose files
carry the same mtimes: the shell's `remote.configure`, `remote.mount`,
`remote.meta.sync`, `remote.cache`, `remote.uncache`, `remote.unmount`
and `remote.mount.buckets`; reads through the filer of uncached files
(the read-through, whole and by ranges) and of cached ones; a change on
the remote followed by `filer.remote.sync`, which keeps the cache of the
unchanged objects. The shells' output, the remote markers (the JSON
under REMOTE_ENTRY_KEY), the entries' sizes and chunk extents, and every
byte read back are compared. A remote object truncated under a read, or
a remote that is gone, fails the read in both packages: no short body is
served as whole. `CacheRemoteObjectToLocalCluster` and the volume
server's `FetchAndWriteNeedle` answer alike, and the needle the latter
writes reads back with the same bytes and ETag. Where the reference is at
fault (ROADMAP.md C) a test shows both answers: a mount table that
cannot be read is not an empty one; a fetch or a local remote's path
stays under its root."""

import hashlib
import io
import os
import random
import shutil
import socket
import time

import grpc
import numpy as np
import pytest
import requests

from seaweedfs_tpu import cloud as ref_cloud
from seaweedfs_tpu import command as ref_command
from seaweedfs_tpu import remote_storage as ref_remote
from seaweedfs_tpu.models.coder import new_coder as ref_new_coder
from seaweedfs_tpu.pb import filer_pb2 as ref_filer_pb2
from seaweedfs_tpu.pb import remote_pb2 as ref_remote_pb2
from seaweedfs_tpu.pb import rpc as ref_rpc
from seaweedfs_tpu.pb import volume_server_pb2 as ref_vs
from seaweedfs_tpu.replication import sink as ref_sink
from seaweedfs_tpu.server.filer import FilerServer as RefFiler
from seaweedfs_tpu.server.master import MasterServer as RefMaster
from seaweedfs_tpu.server.volume import VolumeServer as RefVolume
from seaweedfs_tpu.shell.env import CommandEnv as RefEnv
from seaweedfs_tpu.shell.registry import run_command as ref_run_command
from seaweedfs_tpu.wdclient import pool as ref_pool
from seaweedfs_tpu_torch import cloud, command
from seaweedfs_tpu_torch import remote_storage as remote
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
from seaweedfs_tpu_torch.pb import filer_pb2, remote_pb2, rpc
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs
from seaweedfs_tpu_torch.replication import sink
from seaweedfs_tpu_torch.server.filer import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.shell.registry import run_command
from seaweedfs_tpu_torch.wdclient import pool

from .fake_cloud import FakeAzure, FakeB2, FakeGcs
from tests import torch_ports

PKG = {
    "ref": dict(Master=RefMaster, Volume=RefVolume, Filer=RefFiler,
                coder=lambda: ref_new_coder(10, 4, "cpu"), rpc=ref_rpc,
                pb=ref_filer_pb2, vs=ref_vs, remote_pb=ref_remote_pb2,
                remote=ref_remote, cloud=ref_cloud, sink=ref_sink,
                Env=RefEnv, run=ref_run_command, command=ref_command),
    "port": dict(Master=MasterServer, Volume=VolumeServer,
                 Filer=FilerServer, coder=lambda: RSCodecTorch(
                     10, 4, device="cpu"), rpc=rpc, pb=filer_pb2, vs=vs,
                 remote_pb=remote_pb2, remote=remote, cloud=cloud,
                 sink=sink, Env=CommandEnv, run=run_command,
                 command=command),
}
MTIME = 1_700_000_000

# -- ports ---------------------------------------------------------------------

_PORTS = random.Random(os.getpid() + 29)
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


def _session() -> requests.Session:
    s = requests.Session()
    s.trust_env = False
    return s


# -- the building blocks -------------------------------------------------------


def _seeded_tree(root, seed: int = 7, n: int = 24) -> dict[str, bytes]:
    """Files of 0-200 KiB in nested directories, every mtime MTIME."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        size = int(rng.integers(0, 200 * 1024)) if i % 5 else \
            int(rng.integers(0, 64))
        path = f"/b{i % 3}/d{i % 4}/o{i:02d}.bin" if i % 2 else \
            f"/b{i % 3}/o{i:02d}.bin"
        out[path] = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    for path, data in out.items():
        full = os.path.join(root, path.lstrip("/"))
        os.makedirs(os.path.dirname(full), exist_ok=True)
        with open(full, "wb") as f:
            f.write(data)
        os.utime(full, (MTIME, MTIME))
    return out


def test_local_remote_storage_answers_like_the_reference(tmp_path):
    got = {}
    for name, k in PKG.items():
        root = tmp_path / name
        files = _seeded_tree(root)
        s = k["remote"].LocalRemoteStorage(str(root))
        out = [[vars(e) for e in s.traverse(p)] for p in ("", "/b1", "b2/d",
                                                        "/none")]
        out.append([s.read_file(p, off, size) for p in sorted(files)[:6]
                    for off, size in ((0, -1), (5, 10), (1000, 0))])
        s.delete_file("/b0/o00.bin")
        s.delete_file("/b0/never")
        out.append([e.path for e in s.traverse()])
        got[name] = out
    assert got["port"] == got["ref"]
    assert len(got["port"][0]) == 24 and len(got["port"][-1]) == 23


@pytest.mark.parametrize("conf,mounts", [
    ({"type": "local", "root": "/srv/r"}, {"/m": ("r", "/")}),
    ({"type": "s3", "endpoint": "http://e", "access_key": "a",
      "secret_key": "s", "region": "eu"}, {"/m": ("r", "bkt/sub/x"),
                                           "/n": ("r", "bkt")}),
    ({"type": "gcs", "token": "t", "project_id": "p", "endpoint": "http://g"},
     {"/g": ("r", "bkt/sub")}),
    ({"type": "azure", "account": "acct", "key": "a2V5",
      "endpoint": "http://a"}, {"/w": ("r", "ctr")}),
    ({"type": "b2", "key_id": "k", "application_key": "ak"},
     {"/b": ("r", "/bkt/p")}),
])
def test_the_mount_tables_wire_forms_equal_the_references(conf, mounts):
    table = {"storages": {"r": conf},
             "mounts": {d: {"storage": s, "remote_path": p}
                        for d, (s, p) in mounts.items()}}
    assert remote.conf_to_pb("r", conf) == ref_remote.conf_to_pb("r", conf)
    got = remote_pb2.RemoteStorageMapping.FromString(
        remote.mapping_to_pb(table))
    want = ref_remote_pb2.RemoteStorageMapping.FromString(
        ref_remote.mapping_to_pb(table))
    assert {d: (m.name, m.bucket, m.path) for d, m in got.mappings.items()} \
        == {d: (m.name, m.bucket, m.path) for d, m in want.mappings.items()}


def _cloud_script(k, fake_kind: str) -> tuple[list, object]:
    """One seeded script through a package's client, storage and sink for
    one cloud kind, against a fake of its own; -> (answers, fake)."""
    rng = np.random.default_rng(13)
    blobs = {f"dir/f{i}": rng.integers(0, 256, int(rng.integers(1, 5000)),
                                       dtype=np.uint8).tobytes()
             for i in range(5)}
    out = []
    if fake_kind == "gcs":
        fake = FakeGcs()
        c = k["cloud"].GcsClient("bkt", endpoint=fake.endpoint, token="tkn")
        conf = {"type": "gcs", "bucket": "bkt", "endpoint": fake.endpoint}
        sk = k["sink"].new_sink("gcs", bucket="bkt", directory="backup",
                                endpoint=fake.endpoint)
    elif fake_kind == "azure":
        fake = FakeAzure()
        c = k["cloud"].AzureBlobClient("ctr", account=fake.account,
                                       key=fake.key, endpoint=fake.endpoint)
        conf = {"type": "azure", "container": "ctr",
                "account": fake.account, "key": fake.key,
                "endpoint": fake.endpoint}
        sk = k["sink"].new_sink("azure", container="ctr",
                                account=fake.account, key=fake.key,
                                directory="backup", endpoint=fake.endpoint)
    else:
        fake = FakeB2(token_uses=4)
        c = k["cloud"].B2Client("bkt", key_id=fake.key_id,
                                application_key=fake.app_key,
                                endpoint=fake.endpoint)
        conf = {"type": "b2", "bucket": "bkt", "key_id": fake.key_id,
                "application_key": fake.app_key, "endpoint": fake.endpoint}
        sk = k["sink"].new_sink("b2", bucket="bkt", key_id=fake.key_id,
                                application_key=fake.app_key,
                                directory="backup", endpoint=fake.endpoint)
    for name, data in blobs.items():
        o = c.put(name, data, "text/plain")
        out.append((o.name, o.size))
    out.append([(o.name, o.size) for o in c.list("dir/")])
    out.append([c.get(n) for n in blobs])
    out.append([c.get(n, 3, 7) for n in blobs])
    c.remove("dir/f1")
    out.append([o.name for o in c.list("dir/")])
    with pytest.raises(IOError):
        c.get("dir/f1")
    st = k["remote"].new_client(conf)
    st.write_file("/m/a", b"AAA")
    st.write_file("/m/b", b"BBBB")
    out.append(sorted((e.path, e.size) for e in st.traverse("/m/")))
    out.append((st.read_file("/m/b"), st.read_file("/m/b", 1, 2)))
    st.delete_file("/m/a")
    out.append([e.path for e in st.traverse("/m/")])
    e = k["pb"].Entry(name="x")
    e.attributes.mime = "application/x-test"
    sk.create_entry("/s/x.bin", e, b"sunk")
    sk.update_entry("/s/x.bin", e, b"sunk again")
    sk.create_entry("/s/dir", k["pb"].Entry(name="dir", is_directory=True),
                    None)
    out.append(c.get("backup/s/x.bin"))
    sk.delete_entry("/s/x.bin", False)
    out.append([o.name for o in c.list("backup/")])
    return out, fake


@pytest.mark.parametrize("kind", ["gcs", "azure", "b2"])
def test_cloud_clients_storages_and_sinks_like_the_reference(kind):
    got, state = {}, {}
    for name, k in PKG.items():
        out, fake = _cloud_script(k, kind)
        try:
            got[name] = out
            if kind == "gcs":
                state[name] = {n: (o["data"], o["ctype"])
                               for n, o in fake.objects.items()}
            elif kind == "azure":
                assert fake.rejected == 0  # every signature verified
                state[name] = {n: b["data"] for n, b in fake.blobs.items()}
            else:
                assert fake.auth_calls >= 2  # a token expired on the way
                state[name] = [(f["fileName"], f["data"]) for f in fake.files]
        finally:
            fake.close()
    assert got["port"] == got["ref"]
    assert state["port"] == state["ref"]


def test_a_wrong_azure_key_is_refused():
    import base64

    fake = FakeAzure()
    try:
        c = cloud.AzureBlobClient(
            "ctr", account=fake.account,
            key=base64.b64encode(b"wrong-key").decode(),
            endpoint=fake.endpoint)
        with pytest.raises(IOError):
            c.put_blob("x", b"data")
        assert fake.rejected == 1
        sig = dict(account="acct", key_b64=fake.key, method="PUT",
                   path="/ctr/x", query={"comp": ["list"]},
                   headers={"x-ms-date": "Sun, 18 Oct 2026 00:00:00 GMT",
                            "content-length": "0"})
        assert cloud.azure_shared_key_signature(**sig) == \
            ref_cloud.azure_shared_key_signature(**sig)
    finally:
        fake.close()


# -- the remote plane on a running stack ---------------------------------------


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
        self.filer_address = f"127.0.0.1:{f}"
        self.env = k["Env"](self.master.address, filer=self.filer_address)
        self.remote_root = os.path.join(root, "remote")

    def port(self) -> int:
        p = _free_port_pair(self.taken)
        self.taken.append(p)
        return p

    def stub(self):
        return self.k["rpc"].filer_stub(
            self.k["rpc"].grpc_address(self.filer_address))

    def sh(self, line: str, ok: bool = True) -> str:
        out = io.StringIO()
        code = self.k["run"](self.env, line, out)
        assert (code == 0) == ok, f"{self.name} {line!r}: {out.getvalue()}"
        return out.getvalue()

    def entry(self, path: str):
        d, n = path.rsplit("/", 1)
        return self.stub().LookupDirectoryEntry(
            self.k["pb"].LookupDirectoryEntryRequest(directory=d or "/",
                                                     name=n),
            timeout=10).entry

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
        for mod in (rpc, ref_rpc):
            mod.reset_channels()
        for mod in (pool, ref_pool):
            mod.POOL.clear()


def _view(st, path: str) -> tuple:
    """What a client sees of an entry: its size, its mtime (the remote's,
    or the write's when it was cached), its remote marker, its chunks'
    extents and ETags."""
    e = st.entry(path)
    marker = e.extended.get(PKG[st.name]["remote"].REMOTE_ENTRY_KEY)
    mtime = e.attributes.mtime
    return (e.attributes.file_size,
            mtime if mtime < MTIME + 3600 else "<written>",
            marker and __import__("json").loads(marker),
            [(c.offset, c.size, c.e_tag) for c in e.chunks],
            bool(e.content))


def _get(http, st, path: str, rng: str | None = None):
    r = http.get(f"http://{st.filer_address}{path}",
                 headers={"Range": rng} if rng else {}, timeout=60)
    return r.status_code, hashlib.sha256(r.content).hexdigest(), \
        r.headers.get("Content-Length")


def _remote_script(st) -> dict:
    """The remote plane's operator path on one stack; -> observables."""
    files = _seeded_tree(st.remote_root)
    paths = sorted(files)
    out: dict = {}
    http = _session()
    try:
        out["configure"] = [
            st.sh(f"remote.configure -name=r1 -type=local "
                  f"-root={st.remote_root}").replace(st.remote_root, "<r>"),
            st.sh("remote.configure").replace(st.remote_root, "<r>")]
        out["mount"] = [st.sh("remote.mount -dir=/remote -remote=r1"),
                        st.sh("remote.mount")]
        out["stubs"] = [_view(st, "/remote" + p) for p in paths]
        # the read-through: whole, by ranges, a second time
        out["read"] = [_get(http, st, "/remote" + p) for p in paths]
        big = max(paths, key=lambda p: len(files[p]))
        out["ranges"] = [_get(http, st, "/remote" + big, r) for r in (
            "bytes=0-99", "bytes=70000-140000", "bytes=-5000")]
        assert [r[1] for r in out["read"]] == [
            hashlib.sha256(files[p]).hexdigest() for p in paths]
        cached = paths[::2]
        out["cache"] = [st.sh(f"remote.cache -dir=/remote{p}")
                        for p in cached]
        out["cached"] = [_view(st, "/remote" + p) for p in paths]
        out["cached_read"] = [_get(http, st, "/remote" + p) for p in paths]
        uncached = cached[:3]
        out["uncache"] = [st.sh(f"remote.uncache -dir=/remote{p}")
                          for p in uncached]
        out["uncached"] = [_view(st, "/remote" + p) for p in uncached]
        # the remote changes: two objects rewritten, one added, one gone
        changed = [cached[3], paths[1]]
        for i, p in enumerate(changed):
            full = os.path.join(st.remote_root, p.lstrip("/"))
            with open(full, "wb") as f:
                f.write(b"changed %d " % i * 1000)
            os.utime(full, (MTIME + 60, MTIME + 60))
        full = os.path.join(st.remote_root, "b9/new.bin")
        os.makedirs(os.path.dirname(full))
        with open(full, "wb") as f:
            f.write(b"new object")
        os.utime(full, (MTIME, MTIME))
        out["meta_sync"] = st.sh("remote.meta.sync -dir=/remote")
        out["resynced"] = [_view(st, "/remote" + p)
                           for p in paths + ["/b9/new.bin"]]
        out["resynced_read"] = [_get(http, st, "/remote" + p)
                                for p in paths + ["/b9/new.bin"]]
        # an unchanged cached object kept its chunks
        assert out["resynced"][paths.index(cached[4])][3]
        assert not out["resynced"][paths.index(cached[3])][3]
        out["unmount"] = [st.sh("remote.unmount -dir=/remote"),
                          st.sh("remote.mount")]
        out["buckets"] = [st.sh("remote.mount.buckets -remote=r1"),
                          st.sh("remote.mount.buckets -remote=r1 -apply"),
                          st.sh("remote.mount.buckets -remote=r1"),
                          _get(http, st, "/buckets/b2/o02.bin")]
        out["refused"] = [st.sh(line, ok=False).splitlines()[-1] for line in (
            "remote.cache -dir=/buckets/b2/nowhere",
            "remote.mount.buckets -remote=nope",
            "remote.mount -dir=/x -remote=nope/p")]
    finally:
        http.close()
    return out


_DONE: dict = {}


def _remote_run(stacks) -> dict:
    if not _DONE:
        for name, st in stacks.items():
            _DONE[name] = _remote_script(st)
    return _DONE


def test_the_remote_commands_answer_like_the_reference(stacks):
    got = _remote_run(stacks)
    for key in got["ref"]:
        assert got["port"][key] == got["ref"][key], key


def test_remote_markers_and_cached_chunks(stacks):
    got = _remote_run(stacks)["port"]
    size, mtime, marker, chunks, content = got["stubs"][0]
    assert marker == {"path": marker["path"], "size": size,
                      "mtime": MTIME, "etag": ""}
    assert (chunks, content) == ([], False)
    cached = [v for v in got["cached"] if v[3]]
    assert len(cached) == 12
    # the marker survives the cache, in the same entry write
    assert all(v[2] and v[2]["size"] == v[0] for v in cached)
    assert all(not v[3] for v in got["uncached"])
    assert got["meta_sync"].strip() == "synced 3 entries"


def test_filer_remote_sync_after_a_remote_change(stacks, capsys):
    """filer.remote.sync (the CLI) picks up a change on the remote and
    keeps what it did not change, with the same output in both."""
    got = {}
    for name, st in stacks.items():
        st.sh("remote.mount -dir=/rs -remote=r1/b1")
        full = os.path.join(st.remote_root, "b1", "o01.bin")
        st.sh("remote.cache -dir=/rs/d1/o13.bin")
        before = _view(st, "/rs/d1/o13.bin")
        with open(full, "wb") as f:
            f.write(b"resynced")
        os.utime(full, (MTIME + 120, MTIME + 120))
        capsys.readouterr()
        assert PKG[name]["command"].main(
            ["filer.remote.sync", "-filer", st.filer_address,
             "-dir", "/rs"]) == 0
        http = _session()
        got[name] = (capsys.readouterr().out, _view(st, "/rs/d1/o01.bin"),
                     _get(http, st, "/rs/d1/o01.bin"),
                     _view(st, "/rs/d1/o13.bin") == before)
        http.close()
    assert got["port"] == got["ref"]
    assert got["port"][0].strip() == "synced 1 entries"
    assert got["port"][3]


def _truncated_read(st, http) -> tuple:
    """A 200 KiB object read through; truncated on the remote before its
    read; then the remote taken away."""
    src = os.path.join(st.remote_root, "t", "big.bin")
    os.makedirs(os.path.dirname(src))
    with open(src, "wb") as f:
        f.write(os.urandom(200 * 1024))
    os.utime(src, (MTIME, MTIME))
    st.sh("remote.mount -dir=/trunc -remote=r1/t")
    url = f"http://{st.filer_address}/trunc/big.bin"
    whole = http.get(url, timeout=60)
    answers = [(whole.status_code, len(whole.content))]
    for cut in (100 * 1024, 0):
        with open(src, "r+b") as f:
            f.truncate(cut)
        try:
            r = http.get(url, timeout=60)
            answers.append((r.status_code, len(r.content)))
        except requests.RequestException as e:
            answers.append(("cut", type(e).__name__))
    shutil.rmtree(os.path.dirname(src))
    r = http.get(url, timeout=60)
    answers.append((r.status_code,))
    return tuple(answers)


def test_a_truncated_or_missing_remote_fails_the_read(stacks):
    got = {}
    for name, st in stacks.items():
        http = _session()
        try:
            got[name] = _truncated_read(st, http)
        finally:
            http.close()
    assert got["port"] == got["ref"]
    whole, shorter, empty, gone = got["port"]
    assert whole == (200, 200 * 1024)
    # a remote now shorter than the entry: the body is cut, never served
    # short as if whole
    assert shorter[0] == "cut"
    assert empty[0] == 500 and gone[0] == 500


def test_the_stream_of_a_truncated_remote_raises(stacks):
    st = stacks["port"]
    src = os.path.join(st.remote_root, "s", "obj")
    os.makedirs(os.path.dirname(src))
    with open(src, "wb") as f:
        f.write(b"x" * 5000)
    st.sh("remote.mount -dir=/stream -remote=r1/s")
    e = st.filer.filer.find_entry("/stream/obj")
    assert b"".join(st.filer.stream_file(e)) == b"x" * 5000
    assert b"".join(st.filer.stream_file(e, 4000, 1000)) == b"x" * 1000
    with open(src, "r+b") as f:
        f.truncate(3000)
    with pytest.raises(IOError, match="truncated"):
        b"".join(st.filer.stream_file(e))


def test_cache_remote_object_answers_like_the_reference(stacks):
    got = {}
    for name, st in stacks.items():
        pb = st.k["pb"]
        st.filer.write_file("/plain/file", b"not remote")
        codes = []
        for d, n in (("/plain", "file"), ("/plain", "missing")):
            with pytest.raises(grpc.RpcError) as e:
                st.stub().CacheRemoteObjectToLocalCluster(
                    pb.CacheRemoteObjectToLocalClusterRequest(
                        directory=d, name=n), timeout=30)
            codes.append(e.value.code())
        st.sh("remote.mount -dir=/grpc -remote=r1/b0")
        resp = st.stub().CacheRemoteObjectToLocalCluster(
            pb.CacheRemoteObjectToLocalClusterRequest(
                directory="/grpc", name="o06.bin"), timeout=30)
        got[name] = (codes, resp.entry.name, resp.entry.attributes.file_size,
                     [(c.offset, c.size, c.e_tag) for c in resp.entry.chunks],
                     resp.entry.extended[st.k["remote"].REMOTE_ENTRY_KEY])
    assert got["port"] == got["ref"]
    assert got["port"][0] == [grpc.StatusCode.NOT_FOUND] * 2
    assert got["port"][3]


def test_fetch_and_write_needle_like_the_reference(stacks):
    got = {}
    for name, st in stacks.items():
        k = st.k
        vstub = k["rpc"].volume_stub(
            k["rpc"].grpc_address(st.volume.address))
        vstub.AllocateVolume(k["vs"].AllocateVolumeRequest(
            volume_id=77, replication="000"), timeout=30)
        rc = k["remote_pb"].RemoteConf(type="local", name="r1",
                                       local_root=st.remote_root)
        answers = []
        for nid, (path, off, size) in enumerate((
                ("/b0/o06.bin", 0, 0), ("/b1/d3/o07.bin", 100, 5000),
                ("/b2/o02.bin", 0, 0)), start=1):
            resp = vstub.FetchAndWriteNeedle(k["vs"].FetchAndWriteNeedleRequest(
                volume_id=77, needle_id=nid, cookie=0x1234abcd, offset=off,
                size=size, remote_conf=rc,
                remote_location=k["remote_pb"].RemoteStorageLocation(
                    name="r1", path=path)), timeout=30)
            r = requests.get(f"http://{st.volume.address}/77,"
                             f"{nid:x}1234abcd", timeout=30)
            answers.append((resp.e_tag, r.status_code,
                            hashlib.md5(r.content).hexdigest()))
        with pytest.raises(grpc.RpcError) as e:
            vstub.FetchAndWriteNeedle(k["vs"].FetchAndWriteNeedleRequest(
                volume_id=77, needle_id=9, cookie=1, remote_conf=rc,
                remote_location=k["remote_pb"].RemoteStorageLocation(
                    path="/nowhere")), timeout=30)
        answers.append(e.value.code())
        got[name] = answers
    assert got["port"] == got["ref"]
    assert all(a[0] == a[2] and a[1] == 200 for a in got["port"][:3])
    assert got["port"][3] == grpc.StatusCode.INTERNAL


def test_a_fetch_reads_only_under_an_existing_root(stacks, tmp_path):
    """FetchAndWriteNeedle answers any caller. The reference reads a path
    that leaves local_root and takes "/" as a root, writing what it read
    into a needle that anyone may then GET, and makes any root it is
    given. The port's refuses each and makes nothing (ROADMAP.md C)."""
    secret = tmp_path / "secret.bin"
    secret.write_bytes(b"a file outside every remote")
    got = {}
    for name, st in stacks.items():
        k = st.k
        os.makedirs(st.remote_root, exist_ok=True)
        vstub = k["rpc"].volume_stub(
            k["rpc"].grpc_address(st.volume.address))
        if st.volume.store.find_volume(77) is None:  # this test alone
            vstub.AllocateVolume(k["vs"].AllocateVolumeRequest(
                volume_id=77, replication="000"), timeout=30)
        made = str(tmp_path / f"made-{name}")
        answers = []
        for nid, (root, path) in enumerate((
                (st.remote_root,
                 "/" + os.path.relpath(secret, st.remote_root)),
                ("/", str(secret)), ("", str(secret)), (made, "/x")),
                start=11):
            rc = k["remote_pb"].RemoteConf(type="local", name="r",
                                           local_root=root)
            try:
                vstub.FetchAndWriteNeedle(k["vs"].FetchAndWriteNeedleRequest(
                    volume_id=77, needle_id=nid, cookie=0x5eed,
                    remote_conf=rc,
                    remote_location=k["remote_pb"].RemoteStorageLocation(
                        name="r", path=path)), timeout=30)
            except grpc.RpcError as e:
                answers.append(e.code())
                continue
            r = requests.get(f"http://{st.volume.address}/77,"
                             f"{nid:x}00005eed", timeout=30)
            answers.append((r.status_code, r.content))
        answers.append(os.path.isdir(made))
        got[name] = answers
    read = (200, secret.read_bytes())
    assert got["ref"] == [read, read, grpc.StatusCode.INTERNAL,
                          grpc.StatusCode.INTERNAL, True]
    assert got["port"] == [grpc.StatusCode.PERMISSION_DENIED] + [
        grpc.StatusCode.INVALID_ARGUMENT] * 3 + [False]


def test_a_local_remote_path_cannot_leave_its_root(tmp_path):
    """A path with `..`, or a link out of the root. The reference's
    LocalRemoteStorage joins it to the root and reads or writes outside;
    the port's raises PermissionError (ROADMAP.md C)."""
    secret = tmp_path / "secret.bin"
    secret.write_bytes(b"outside the root")
    got = {}
    for name, k in PKG.items():
        root = tmp_path / name
        root.mkdir()
        os.symlink(secret, root / "link.bin")
        s = k["remote"].LocalRemoteStorage(str(root))
        answers = []
        for op in (lambda: s.read_file("/../secret.bin"),
                   lambda: s.read_file("../secret.bin", 9, 4),
                   lambda: s.read_file("/link.bin"),
                   lambda: s.write_file(f"/../written-{name}", b"w").size):
            try:
                answers.append(op())
            except PermissionError:
                answers.append("refused")
        answers.append(sorted(os.listdir(tmp_path)))
        got[name] = answers
    assert got["ref"] == [b"outside the root", b"he r", b"outside the root",
                          1, ["ref", "secret.bin", "written-ref"]]
    assert got["port"] == ["refused"] * 4 + [
        ["port", "ref", "secret.bin", "written-ref"]]


def test_a_mount_table_that_cannot_be_read_is_not_an_empty_one():
    """A filer that does not answer. The reference's RemoteConf.load reads
    the failure as an empty table, and its next save writes that over
    every storage and mount; the port's raises."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"

    def broken(directory, name):
        raise OSError("the filer's store is down")

    assert ref_remote.RemoteConf(dead).load() == {"storages": {},
                                                   "mounts": {}}
    assert ref_remote.RemoteConf(dead, entry_reader=broken).load() == \
        {"storages": {}, "mounts": {}}
    with pytest.raises(grpc.RpcError):
        remote.RemoteConf(dead).load()
    with pytest.raises(OSError):
        remote.RemoteConf(dead, entry_reader=broken).load()
    with pytest.raises(grpc.RpcError):
        remote.RemoteConf(dead).configure_storage("x", {"type": "local"})
