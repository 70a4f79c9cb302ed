"""The port's tiered storage against the JAX package's, on the CPU.

A sealed volume's `.dat` moves to a tier backend and back
(`Volume.tier_to_remote` / `tier_from_remote`, the volume server's
VolumeTierMoveDatToRemote / ...FromRemote, the shell's `volume.tier.*`).
Held with tolerance 0 on bytes:

* a `.dat` tiered by one package opens and reads in the other, and comes
  back with its original sha256; the `.tier` sidecar and the remote object
  are the same bytes in both packages;
* `S3TierBackend` sends the reference's requests (method, path, signed
  headers, body) with the SigV4 clock pinned, and leaves the same object;
* both packages' servers answer the tier RPCs alike over the same volume;
* end to end on the port's own stack: a volume server whose `-tierConfig`
  names an `s3` backend at the port's S3 gateway, the volume uploaded by
  the shell, every needle read back through the C++ plane (which lets go
  of the volume while its `.dat` is remote), downloaded again with its
  sha256.
"""

import hashlib
import io
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest
import requests

from seaweedfs_tpu.models.coder import new_coder as ref_new_coder
from seaweedfs_tpu.pb import rpc as ref_rpc
from seaweedfs_tpu.pb import volume_server_pb2 as ref_vs
from seaweedfs_tpu.s3api import sigv4_client as ref_sigv4
from seaweedfs_tpu.server import volume as ref_server
from seaweedfs_tpu.storage import backend as ref_backend
from seaweedfs_tpu.storage import needle as ref_needle
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs
from seaweedfs_tpu_torch.s3api import sigv4_client
from seaweedfs_tpu_torch.server import volume as port_server
from seaweedfs_tpu_torch.storage import backend
from seaweedfs_tpu_torch.storage import needle
from seaweedfs_tpu_torch.storage import volume
from tests.test_torch_native_dataplane import pick_port, wait_http

VID = 6
PKGS = {"ref": SimpleNamespace(volume=ref_volume, needle=ref_needle,
                               backend=ref_backend, server=ref_server,
                               rpc=ref_rpc, vs=ref_vs, sigv4=ref_sigv4),
        "port": SimpleNamespace(volume=volume, needle=needle, backend=backend,
                                server=port_server, rpc=rpc, vs=vs,
                                sigv4=sigv4_client)}


class Clock:
    """The `time` a needle module reads."""

    def __init__(self):
        self.ns = 1_700_000_000_000_000_000

    def time_ns(self) -> int:
        self.ns += 1000
        return self.ns

    def time(self) -> float:
        return 1_700_000_100.0


@pytest.fixture()
def clocks(monkeypatch):
    for p in PKGS.values():
        monkeypatch.setattr(p.needle, "time", Clock())


def _needles(seed: int, n: int = 30):
    rng = np.random.default_rng(seed)
    return [(i, int(rng.integers(1, 1 << 32)),
             rng.integers(0, 256, int(rng.integers(1, 5000)),
                          dtype=np.uint8).tobytes())
            for i in range(1, n + 1)]


def _fill(pkg, d: str, collection: str = "", seed: int = 4):
    v = pkg.volume.Volume(d, collection, VID)
    for nid, cookie, data in _needles(seed):
        v.write_needle(pkg.needle.Needle.create(nid, cookie, data))
    v.delete_needle(7)
    return v


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# -- the backend primitives -------------------------------------------------------

def test_disk_mmap_and_local_tier_primitives(tmp_path):
    p = str(tmp_path / "f.bin")
    for pkg in PKGS.values():
        d = pkg.backend.DiskFile(p, create=True)
        d.write_at(0, b"hello world")
        d.flush()
        m = pkg.backend.MmapFile(p)
        assert (d.read_at(0, 11), m.read_at(6, 5), d.size()) == \
            (b"hello world", b"world", 11)
        m.close()
        d.close()
        os.remove(p)
        b = pkg.backend.LocalTierBackend(str(tmp_path / "tier"))
        src = tmp_path / "src.bin"
        src.write_bytes(bytes(range(256)) * 4)
        assert b.upload("1.dat", str(src)) == 1024
        assert b.read_range("1.dat", 250, 10) == bytes(range(250, 256)) + \
            bytes(range(4))
        r = pkg.backend.RemoteDatFile(b, "1.dat", 1024)
        assert r.read_at(1020, 100) == bytes(range(252, 256))
        assert b.download("1.dat", str(tmp_path / "dst.bin")) == 1024
        b.delete("1.dat")
        assert not os.path.exists(tmp_path / "tier" / "1.dat")


# -- a .dat tiered by one package, read by the other ------------------------------

@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_a_tiered_dat_reads_in_the_other_package(tmp_path, clocks, writer,
                                                 reader):
    """The writer tiers its volume to a local backend; the reader opens
    the directory (the `.tier` sidecar names the backend, which the
    reader has registered under the same name), serves every needle from
    the remote `.dat`, refuses writes, and brings the `.dat` back with
    its original sha256."""
    w, r = PKGS[writer], PKGS[reader]
    root = str(tmp_path / "cloud")
    for p in (w, r):
        p.backend.register_tier_backend(
            p.backend.LocalTierBackend(root, name="xtier"))
    d = str(tmp_path / "vols")
    os.makedirs(d)
    v = _fill(w, d, "col")
    base = v.file_name()
    sha, size = _sha(base + ".dat"), v.data_size()
    assert v.tier_to_remote(w.backend.get_tier_backend("xtier")) == size
    assert v.is_tiered and v.read_only and not os.path.exists(base + ".dat")
    v.close()
    v2 = r.volume.Volume(d, "col", VID)
    try:
        assert v2.is_tiered
        for nid, cookie, data in _needles(4):
            if nid != 7:
                assert v2.read_needle(nid).data == data
        with pytest.raises(IOError):
            v2.write_needle(r.needle.Needle.create(999, 1, b"nope"))
        assert v2.tier_from_remote() == size
        assert _sha(base + ".dat") == sha and not v2.is_tiered
        assert not os.path.exists(os.path.join(root, "col_6.dat"))
    finally:
        v2.close()


def test_both_packages_leave_the_same_sidecar_and_object(tmp_path, clocks):
    out = {}
    for name, p in PKGS.items():
        root = str(tmp_path / f"cloud-{name}")
        b = p.backend.register_tier_backend(
            p.backend.LocalTierBackend(root, name="same"))
        d = str(tmp_path / name)
        os.makedirs(d)
        v = _fill(p, d)
        v.tier_to_remote(b, keep_local=True)
        base = v.file_name()
        out[name] = (_sha(base + ".dat"), _sha(base + ".idx"),
                     open(base + ".tier", "rb").read(),
                     _sha(os.path.join(root, "6.dat")))
        v.close()
    assert out["port"] == out["ref"]


# -- S3TierBackend on the wire ----------------------------------------------------

class _FakeS3:
    """A bucket over HTTP that records every request it is sent."""

    def __init__(self):
        self.objects: dict[str, bytes] = {}
        self.requests: list = []
        fake = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _record(self, body=b""):
                hdrs = sorted((k.lower(), v) for k, v in self.headers.items())
                fake.requests.append((self.command, self.path, hdrs,
                                      hashlib.sha256(body).hexdigest()))

            def _send(self, status, body=b""):
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_PUT(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                self._record(body)
                fake.objects[self.path] = body
                self._send(200)

            def do_GET(self):
                self._record()
                data = fake.objects.get(self.path)
                if data is None:
                    return self._send(404)
                rng = self.headers.get("Range")
                if rng:
                    a, b = rng.split("=")[1].split("-")
                    return self._send(206, data[int(a):int(b) + 1])
                self._send(200, data)

            def do_DELETE(self):
                self._record()
                fake.objects.pop(self.path, None)
                self._send(204)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.mark.parametrize("signed", [True, False], ids=["sigv4", "anonymous"])
def test_s3_tier_backend_sends_the_references_requests(tmp_path, clocks,
                                                       monkeypatch, signed):
    """Upload, range reads, download and delete of a tiered volume
    through each package's S3TierBackend: the same requests, signed at
    one pinned instant, and the same object left in the bucket."""
    frozen = SimpleNamespace(gmtime=lambda *a: time.gmtime(1_700_000_000),
                             strftime=time.strftime)
    got = {}
    fake = _FakeS3()  # one address: the Host header is signed
    try:
        for name, p in PKGS.items():
            monkeypatch.setattr(p.sigv4, "time", frozen)
            fake.requests, fake.objects = [], {}
            b = p.backend.S3TierBackend(
                f"http://127.0.0.1:{fake.port}/", "tier", name="s3",
                access_key="AK" if signed else "",
                secret_key="SK" if signed else "")
            d = str(tmp_path / name)
            os.makedirs(d)
            v = _fill(p, d, "col")
            v.tier_to_remote(b)
            reads = [v.read_needle(nid).data for nid, _, _ in _needles(4)
                     if nid != 7]
            objects = dict(fake.objects)
            v.tier_from_remote()
            v.close()
            got[name] = (fake.requests, reads, objects,
                         _sha(os.path.join(d, "col_6.dat")))
    finally:
        fake.close()
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1:] == got["ref"][1:]
    methods = [m for m, *_ in got["port"][0]]
    assert methods[0] == "PUT" and methods[-2:] == ["GET", "DELETE"]
    assert all(path.startswith("/tier/col_6.dat") for _, path, *_ in
               got["port"][0])
    assert any(k == "authorization" for k, _ in got["port"][0][0][2]) \
        == signed


# -- the tier RPCs of both packages' servers --------------------------------------

def _server(name: str, d: str, port: int, root: str, native: bool = False):
    p = PKGS[name]
    coder = (ref_new_coder(backend="cpu") if name == "ref"
             else RSCodecTorch(10, 4, device="cpu"))
    srv = p.server.VolumeServer(
        directories=[d], master=f"localhost:{pick_port((port,))}",
        ip="127.0.0.1", port=port, coder=coder, native=native,
        tier_backends={"local": {"default": {"root": root}}})
    srv.start()
    wait_http(port, "/status")
    p.rpc.reset_channels()
    return srv


def test_the_tier_rpcs_answer_as_the_references(tmp_path, clocks):
    """Each package's server (masterless) moves the same volume to its
    `-tierConfig` backend and back: the same stream of answers, the same
    bytes served in between, the same files after."""
    got = {}
    for name, p in PKGS.items():
        d = str(tmp_path / name)
        os.makedirs(d)
        _fill(p, d).close()
        port = pick_port()
        srv = _server(name, d, port, str(tmp_path / f"cloud-{name}"))
        try:
            stub = p.rpc.volume_stub(f"127.0.0.1:{port + 10000}")
            up = [r.SerializeToString() for r in stub.VolumeTierMoveDatToRemote(
                p.vs.VolumeTierMoveDatToRemoteRequest(
                    volume_id=VID, destination_backend_name="local"),
                timeout=60)]
            again = None
            try:
                list(stub.VolumeTierMoveDatToRemote(
                    p.vs.VolumeTierMoveDatToRemoteRequest(
                        volume_id=VID, destination_backend_name="local"),
                    timeout=60))
            except Exception as e:  # noqa: BLE001 - compared below
                again = type(e).__name__
            v = srv.store.find_volume(VID)
            reads = [v.read_needle(nid).data for nid, _, _ in _needles(4)
                     if nid != 7]
            down = [r.SerializeToString()
                    for r in stub.VolumeTierMoveDatFromRemote(
                        p.vs.VolumeTierMoveDatFromRemoteRequest(
                            volume_id=VID), timeout=60)]
            got[name] = (up, again, reads, down, _sha(os.path.join(
                d, f"{VID}.dat")))
        finally:
            srv.stop()
            p.rpc.reset_channels()
    assert got["port"] == got["ref"]


# -- end to end: the port's own S3 gateway as the tier ----------------------------

def test_a_volume_tiered_to_the_ports_own_s3_gateway(tmp_path):
    """A master, a volume server on the C++ plane whose tier backend is an
    `s3` one at the port's S3 gateway (over the port's filer), and the
    shell: `volume.tier.upload` of a sealed volume, every needle read back
    byte-exact through the public port while the plane has let go of the
    volume, `volume.tier.download`, the `.dat`'s sha256 unchanged, the
    volume back in the plane's registry and read again."""
    from seaweedfs_tpu_torch.s3api.server import S3Server
    from seaweedfs_tpu_torch.server.filer import FilerServer
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.shell.env import CommandEnv
    from seaweedfs_tpu_torch.shell.registry import run_command

    mport = pick_port()
    vport = pick_port((mport,))
    fport = pick_port((mport, vport))
    sport = pick_port((mport, vport, fport))
    ms = MasterServer(ip="127.0.0.1", port=mport, volume_size_limit_mb=64)
    ms.start(vacuum_interval=3600)
    vsrv = port_server.VolumeServer(
        directories=[str(tmp_path / "v")], master=f"127.0.0.1:{mport}",
        ip="127.0.0.1", port=vport, pulse_seconds=1, native=True,
        coder=RSCodecTorch(10, 4, device="cpu"), max_volume_counts=[40],
        tier_backends={"s3": {"default": {
            "endpoint": f"http://127.0.0.1:{sport}", "bucket": "tier"}}})
    vsrv.start()
    fs = FilerServer(ip="127.0.0.1", port=fport, master=f"127.0.0.1:{mport}",
                     store_dir=str(tmp_path / "filer"))
    gw = S3Server(port=sport, filer=f"127.0.0.1:{fport}")
    http = requests.Session()
    http.trust_env = False
    try:
        deadline = time.time() + 30
        while not ms.topo.nodes:
            assert time.time() < deadline, "volume server never registered"
            time.sleep(0.05)
        fs.start()
        gw.start()
        wait_http(sport, "/status")
        assert http.put(f"http://127.0.0.1:{sport}/tier",
                        timeout=30).status_code == 200
        assert vsrv.native_plane is not None
        rng = np.random.default_rng(9)
        fids = {}
        for i in range(24):
            a = http.get(f"http://127.0.0.1:{mport}/dir/assign"
                         "?collection=tiered", timeout=30).json()
            data = rng.integers(0, 256, int(rng.integers(1000, 40000)),
                                dtype=np.uint8).tobytes()
            r = http.post(f"http://{a['url']}/{a['fid']}", data=data,
                          timeout=30)
            assert r.status_code == 201, r.text
            fids[a["fid"]] = data
        vids = {int(f.split(",")[0]) for f in fids}
        env = CommandEnv(f"127.0.0.1:{mport}")
        out = io.StringIO()
        assert run_command(env, "lock", out) == 0
        shas = {}
        for vid in sorted(vids):
            v = vsrv.store.find_volume(vid)
            shas[vid] = _sha(v.file_name() + ".dat")
            assert vid in vsrv._native_vids
            assert run_command(env, f"volume.tier.upload -node 127.0.0.1:"
                               f"{vport} -volumeId {vid} -dest s3",
                               out) == 0, out.getvalue()
            assert v.is_tiered and vid not in vsrv._native_vids
            assert not os.path.exists(v.file_name() + ".dat")
        assert "moved" in out.getvalue()
        for fid, data in fids.items():
            r = http.get(f"http://127.0.0.1:{vport}/{fid}", timeout=30)
            assert r.status_code == 200 and r.content == data, fid
        for vid in sorted(vids):
            assert run_command(env, f"volume.tier.download -node 127.0.0.1:"
                               f"{vport} -volumeId {vid}", out) == 0, \
                out.getvalue()
            v = vsrv.store.find_volume(vid)
            assert not v.is_tiered and vid in vsrv._native_vids
            assert _sha(v.file_name() + ".dat") == shas[vid]
        for fid, data in fids.items():
            r = http.get(f"http://127.0.0.1:{vport}/{fid}", timeout=30)
            assert r.status_code == 200 and r.content == data, fid
        run_command(env, "unlock", out)
    finally:
        http.close()
        for srv in (gw, fs, vsrv, ms):
            srv.stop()
        rpc.reset_channels()
