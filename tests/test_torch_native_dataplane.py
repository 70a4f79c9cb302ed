"""The port's C++ volume data plane against the reference's, on the CPU.

g++ builds both packages' plane libraries here (the port's into
seaweedfs_tpu_torch/ops/_build/). One seeded script runs through a
`python -m seaweedfs_tpu volume -nativeDataPlane on` process and a
`python -m seaweedfs_tpu_torch volume -nativeDataPlane on` process in
turn: needle PUTs, GETs, HEADs, ranges, conditionals, a chunked PUT the
plane proxies, 307s to the Python listener (suffix ranges, EC-less
unknown volumes, a replicated volume's PUT, a TTL volume's PUT, /status),
DELETEs, then vacuum and ec.encode over gRPC. In both processes the
plane's wall clock is pinned (an LD_PRELOAD shim answers CLOCK_REALTIME
and time() with one instant for calls made from the plane library and
from nowhere else), so the planes' appendAtNs and last-modified stamps
are equal, and equal files mean equal planes. Both serve on one address,
one after the other (a write Python stamps carries a replica-epoch tag
that names the server's address). Compared with tolerance 0:

* every response's status, body, and headers except Date and the
  Python listener's random X-Trace-Id; the Location of each 307 by path
  (its port is the server's own admin port);
* the .idx bytes; the .dat bytes with every record's appendAtNs and
  last-modified bytes masked (the only bytes a clock writes), and, with
  the clock pinned, the unmasked .dat of the plane-written volume too;
* after a vacuum and ec.encode of that volume, every shard's sha256,
  with the parity rows equal to the golden-pinned table codec's product
  of the data rows (the GOLDEN_SHARD_SHA256 codec).

Then the reference's own plane tests run against the port in-process:
catch-up of the plane's idx appends, the registry rules, vacuum under
concurrent native writes, SWFS_ZEROCOPY and the sendfile counter, HEAD
and range parity with the Python listener, /status and /metrics."""

import hashlib
import http.client
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from urllib.parse import urlparse

import numpy as np
import pytest
import requests

from seaweedfs_tpu_torch.native import dataplane as port_dataplane
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs
from seaweedfs_tpu_torch.storage import types
from seaweedfs_tpu_torch.storage.file_id import (
    format_needle_id_cookie,
    parse_file_id,
)
from seaweedfs_tpu_torch.storage.needle import (
    FLAG_HAS_LAST_MODIFIED,
    FLAG_HAS_MIME,
    FLAG_HAS_NAME,
    LAST_MODIFIED_BYTES,
)
from tests import torch_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN_S = 1_700_000_000  # the plane's pinned wall clock, in seconds

_PORTS = random.Random(os.getpid() ^ 0x5eed)


def pick_port(taken=()) -> int:
    """A free HTTP port whose gRPC twin (+10000) and plane admin listener
    (+11000) are free as well, all below the kernel's ephemeral range."""
    for _ in range(400):
        port = torch_ports.draw(_PORTS, 12000, 21000)
        if any(abs(port - t) in (0, 1000, 10000, 11000) for t in taken):
            continue
        try:
            for p in (port, port + 10000, port + 11000):
                with socket.socket() as s:
                    s.bind(("", p))
        except OSError:
            continue
        return port
    raise RuntimeError("no free port triple")


def wait_http(port: int, path: str, proc=None, timeout: float = 120,
              log=None) -> None:
    """Readiness, not a sleep: poll until `path` answers 200 (following
    the plane's 307 to the Python listener)."""
    deadline = time.time() + timeout
    while True:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"process exited {proc.returncode}: "
                                 + (open(log).read()[-3000:] if log else ""))
        try:
            if requests.get(f"http://127.0.0.1:{port}{path}",
                            timeout=5).status_code == 200:
                return
        except requests.RequestException:
            pass
        assert time.time() < deadline, f"{path} on :{port} never answered"
        time.sleep(0.1)


_SHIM_C = r"""
#define _GNU_SOURCE
#include <dlfcn.h>
#include <string.h>
#include <time.h>

static int from_plane(void *ra) {
  Dl_info info;
  return dladdr(ra, &info) && info.dli_fname &&
         strstr(info.dli_fname, "swfs_dataplane") != NULL;
}

int clock_gettime(clockid_t clk, struct timespec *ts) {
  static int (*real)(clockid_t, struct timespec *);
  if (clk == CLOCK_REALTIME && from_plane(__builtin_return_address(0))) {
    ts->tv_sec = PIN_S;
    ts->tv_nsec = 0;
    return 0;
  }
  if (!real)
    real = (int (*)(clockid_t, struct timespec *))dlsym(RTLD_NEXT,
                                                        "clock_gettime");
  return real(clk, ts);
}

time_t time(time_t *t) {
  static time_t (*real)(time_t *);
  if (from_plane(__builtin_return_address(0))) {
    if (t) *t = PIN_S;
    return PIN_S;
  }
  if (!real) real = (time_t (*)(time_t *))dlsym(RTLD_NEXT, "time");
  return real(t);
}
"""


def build_clock_shim(d) -> str:
    src = os.path.join(d, "pin_clock.c")
    out = os.path.join(d, "libpin_clock.so")
    with open(src, "w") as f:
        f.write(_SHIM_C)
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", f"-DPIN_S={PIN_S}",
                    src, "-o", out, "-ldl"], check=True,
                   capture_output=True)
    return out


# -- the seeded script ---------------------------------------------------------

VID, REPL_VID, TTL_VID = 3, 4, 6


def _needles() -> list[tuple]:
    """Seeded (id, cookie, data, content type): 0 B, then 1 B - 64 KiB,
    several past the 4,096 B sendfile threshold."""
    rng = np.random.default_rng(15)
    out = [(1, int(rng.integers(1, 1 << 32)), b"", None)]
    for i in range(2, 25):
        n = int(rng.integers(1, 64 * 1024)) if i % 3 else int(
            rng.integers(1, 4096))
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        out.append((i, int(rng.integers(1, 1 << 32)), data,
                    "text/plain" if i % 4 == 0 else None))
    return out


NEEDLES = _needles()


def _fid(vid: int, nid: int, cookie: int) -> str:
    return f"{vid},{format_needle_id_cookie(nid, cookie)}"


# headers that differ between any two runs: the time of the answer, and
# the random trace id the Python listener gives each request
MASKED = ("date", "x-trace-id")


def _one(port, method, path, body=None, headers=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request(method, path, body=body, headers=headers or {},
                  encode_chunked=not isinstance(body, (bytes, type(None))))
        r = c.getresponse()
        data = r.read()
        return r.status, [(k, v) for k, v in r.getheaders()], data
    finally:
        c.close()


def request(port, method, path, body=None, headers=None, follow=True):
    """One request as a client sends it, following at most one 307 to its
    Location. -> (status, headers but the MASKED ones, body, 307 hop or
    None);
    the hop is (Location path, Location port)."""
    status, hdrs, data = _one(port, method, path, body, headers)
    hop = None
    if status == 307:
        loc = urlparse(dict(hdrs)["Location"])
        hop = (loc.path + (f"?{loc.query}" if loc.query else ""), loc.port)
        if follow:
            status, hdrs, data = _one(loc.port, method, hop[0], body,
                                      headers)
    # a Location is compared by path: its port is the server's admin port
    hdrs = [(k, urlparse(v).path if k == "Location" else v)
            for k, v in hdrs if k.lower() not in MASKED]
    return status, hdrs, data, hop


def _mask_dat(blob: bytes, version: int = 3) -> bytes:
    """Zero each record's appendAtNs and last-modified bytes."""
    out = bytearray(blob)
    off = 8  # superblock
    while off + types.NEEDLE_HEADER_SIZE <= len(blob):
        size = int.from_bytes(blob[off + 12:off + 16], "big")
        if size == 0xFFFFFFFF:
            size = 0
        body = off + types.NEEDLE_HEADER_SIZE
        if size:
            dlen = int.from_bytes(blob[body:body + 4], "big")
            p = body + 4 + dlen
            flags = blob[p]
            p += 1
            if flags & FLAG_HAS_NAME:
                p += 1 + blob[p]
            if flags & FLAG_HAS_MIME:
                p += 1 + blob[p]
            if flags & FLAG_HAS_LAST_MODIFIED:
                out[p:p + LAST_MODIFIED_BYTES] = b"\0" * LAST_MODIFIED_BYTES
        ts = body + size + types.NEEDLE_CHECKSUM_SIZE
        out[ts:ts + 8] = b"\0" * 8
        off += types.actual_size(size, version)
    return bytes(out)


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _script(pkg: str, port: int, d: str, shim: str, nobody: int) -> dict:
    """Drive one package's `volume` process through the script."""
    pb = __import__(f"{pkg}.pb", fromlist=["rpc", "volume_server_pb2",
                                           "ec_geometry_pb2"])
    mod_rpc, mod_vs, mod_eg = pb.rpc, pb.volume_server_pb2, \
        pb.ec_geometry_pb2
    log = os.path.join(d, "server.log")
    vdir = os.path.join(d, "vol")
    os.makedirs(vdir)
    env = dict(os.environ, JAX_PLATFORMS="cpu", LD_PRELOAD=shim,
               PYTHONPATH=REPO)
    with open(log, "w") as lf:
        proc = subprocess.Popen(
            [sys.executable, "-m", pkg, "volume", "-ip", "127.0.0.1",
             "-port", str(port), "-mserver", f"127.0.0.1:{nobody}",
             "-dir", vdir, "-coder", "cpu", "-nativeDataPlane", "on"],
            cwd=d, env=env, stdout=lf, stderr=subprocess.STDOUT)
    out: dict = {"log": [], "admin_ports": set()}

    def rec(tag, *a, **kw):
        status, hdrs, data, hop = request(port, *a, **kw)
        if hop is not None:
            out["admin_ports"].add(hop[1])
            hop = hop[0]
        out["log"].append((tag, status, hdrs, data, hop))
        return status, data

    try:
        wait_http(port, "/status", proc, log=log)
        mod_rpc.reset_channels()
        st = mod_rpc.volume_stub(f"127.0.0.1:{port + 10000}")
        for vid, repl, ttl in ((VID, "000", ""), (REPL_VID, "001", ""),
                               (TTL_VID, "000", "5m")):
            st.AllocateVolume(mod_vs.AllocateVolumeRequest(
                volume_id=vid, replication=repl, ttl=ttl), timeout=30)
        for nid, cookie, data, ctype in NEEDLES:
            rec("put", "PUT", "/" + _fid(VID, nid, cookie), data,
                {"Content-Type": ctype} if ctype else {})
        for nid, cookie, data, _ in NEEDLES:
            rec("get", "GET", "/" + _fid(VID, nid, cookie))
        nid, cookie, data, _ = NEEDLES[5]
        f = "/" + _fid(VID, nid, cookie)
        rec("head", "HEAD", f)
        etag = dict(request(port, "GET", f)[1])["ETag"]
        out["log"].append(("etag", etag))
        for hdrs in ({"Range": "bytes=10-19"}, {"Range": "bytes=100-"},
                     {"Range": f"bytes=0-{len(data) + 99}"},
                     {"Range": "bytes=-5"}, {"Range": "bytes=5-3"},
                     {"Range": f"bytes={len(data) + 10}-"},
                     {"Range": "bytes=0-1,5-6"},
                     {"If-None-Match": etag}, {"If-None-Match": '"x"'},
                     {"If-Modified-Since": "Sat, 29 Oct 2094 19:43:31 GMT"},
                     {"Range": "bytes=1-2", "If-Range": etag}):
            rec(f"cond {hdrs}", "GET", f, headers=hdrs)
        rec("overwrite", "PUT", f, b"v2" * 300)
        rec("same body", "PUT", f, b"v2" * 300)
        rec("reread", "GET", f)
        rec("bad cookie", "GET",
            "/" + _fid(VID, nid, (cookie + 1) & 0xFFFFFFFF))
        rec("delta fid", "PUT", "/" + _fid(VID, 200, 77) + "_1", b"delta")
        rec("delta get", "GET", "/" + _fid(VID, 201, 77))

        def chunks():
            for i in range(0, 20000, 4096):
                yield bytes((i + j) % 251 for j in range(4096))

        rec("chunked", "PUT", "/" + _fid(VID, 300, 9), chunks())
        rec("chunked get", "GET", "/" + _fid(VID, 300, 9))
        rec("replicated put", "PUT", "/" + _fid(REPL_VID, 1, 5), b"r",
            follow=False)
        rec("ttl put", "PUT", "/" + _fid(TTL_VID, 1, 5), b"ttl body")
        s_ttl, _, body_ttl, _ = request(port, "GET", "/" + _fid(TTL_VID, 1, 5))
        out["log"].append(("ttl get", s_ttl, body_ttl))
        rec("unknown vid", "GET", "/999," + format_needle_id_cookie(1, 1))
        rec("long path", "GET", "/" + "a" * 3000)
        for nid, cookie, _, _ in NEEDLES[::3]:
            rec("delete", "DELETE", "/" + _fid(VID, nid, cookie))
        for nid, cookie, _, _ in NEEDLES[::3]:
            rec("deleted get", "GET", "/" + _fid(VID, nid, cookie))
        status, _, body, hop = request(port, "GET", "/status")
        js = json.loads(body)
        out["status"] = (status, hop[0] if hop else None,
                         js["NativeDataPlane"], js["NativeRequests"],
                         js["NativeSendfile"])
        base = os.path.join(vdir, str(VID))
        out["idx"] = open(base + ".idx", "rb").read()
        out["dat"] = open(base + ".dat", "rb").read()
        out["ttl_dat"] = open(os.path.join(vdir, f"{TTL_VID}.dat"),
                              "rb").read()
        list(st.VacuumVolumeCompact(mod_vs.VacuumVolumeCompactRequest(
            volume_id=VID), timeout=60))
        st.VacuumVolumeCommit(mod_vs.VacuumVolumeCommitRequest(
            volume_id=VID), timeout=60)
        for nid, cookie, _, _ in NEEDLES:
            rec("vacuumed get", "GET", "/" + _fid(VID, nid, cookie))
        out["vacuumed_idx"] = open(base + ".idx", "rb").read()
        out["vacuumed_dat"] = open(base + ".dat", "rb").read()
        st.VolumeMarkReadonly(mod_vs.VolumeMarkReadonlyRequest(
            volume_id=VID), timeout=30)
        rec("readonly put", "PUT", "/" + _fid(VID, 400, 1), b"ro",
            follow=False)
        st.VolumeEcShardsGenerate(mod_eg.EcGenerateRequest(volume_id=VID),
                                  timeout=120)
        out["shards"] = [_sha(base + f".ec{i:02d}") for i in range(14)]
        out["ecx"] = _sha(base + ".ecx")
        out["shard_rows"] = [open(base + f".ec{i:02d}", "rb").read()
                             for i in range(14)]
        proc.send_signal(signal.SIGTERM)
        out["rc"] = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        mod_rpc.reset_channels()
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = tmp_path_factory.mktemp("plane_vs_plane")
    shim = build_clock_shim(str(d))
    nobody = pick_port()
    # one address for both, one after the other: a write that Python
    # stamps carries a replica-epoch tag naming the server's address
    port = pick_port((nobody,))
    runs = {}
    for pkg in ("seaweedfs_tpu", "seaweedfs_tpu_torch"):
        wd = d / pkg
        wd.mkdir()
        runs[pkg] = _script(pkg, port, str(wd), shim, nobody)
        runs[pkg]["port"] = port
    return runs["seaweedfs_tpu"], runs["seaweedfs_tpu_torch"]


def test_responses_equal_the_reference_planes(both):
    ref, port = both
    assert len(port["log"]) == len(ref["log"])
    for a, b in zip(ref["log"], port["log"]):
        assert b == a, a[0]
    tags = {e[0]: e for e in port["log"]}
    assert tags["put"][1] == 201
    assert tags["chunked"][1] == 201  # proxied: the body was consumed
    assert tags["chunked get"][3] == b"".join(
        bytes((i + j) % 251 for j in range(4096))
        for i in range(0, 20000, 4096))
    assert tags["ttl get"][1:] == (200, b"ttl body")


def test_every_server_ends_clean_and_reports_its_plane(both):
    for run in both:
        assert run["rc"] == 0
        assert run["status"][:3] == (200, "/status", True)
        assert run["status"][3] > 0 and run["status"][4] > 0
        assert run["admin_ports"] == {run["port"] + 11000}
    assert both[0]["status"] == both[1]["status"]


@pytest.mark.parametrize("tag,path_re", [
    ("cond {'Range': 'bytes=-5'}", None),
    ("cond {'If-Modified-Since': 'Sat, 29 Oct 2094 19:43:31 GMT'}", None),
    ("cond {'Range': 'bytes=1-2', 'If-Range'", None),
    ("replicated put", f"/{REPL_VID},"),
    ("ttl put", f"/{TTL_VID},"),
    ("unknown vid", "/999,"),
    ("readonly put", f"/{VID},"),
])
def test_the_redirects_land_where_the_references_do(both, tag, path_re):
    """Each request the plane does not take is a 307 to the same path on
    the Python listener, in both packages."""
    ref, port = both
    hits = [(a, b) for a, b in zip(ref["log"], port["log"])
            if a[0].startswith(tag)]
    assert hits, tag
    for a, b in hits:
        assert a[4] is not None and b[4] == a[4], tag
        if path_re:
            assert b[4].startswith(path_re)


def test_served_by_the_plane_without_a_redirect(both):
    """Whole GETs, HEADs, clean ranges, If-None-Match, PUTs and DELETEs of
    the plain volume never leave C++."""
    log = both[1]["log"]
    etag = next(e[1] for e in log if e[0] == "etag")
    native = {"put", "get", "head", "overwrite", "same body", "reread",
              "delete", "deleted get", "vacuumed get", "delta fid",
              "cond {'Range': 'bytes=10-19'}", "cond {'Range': 'bytes=100-'}",
              f"cond {{'If-None-Match': {etag!r}}}"}
    seen = {e[0] for e in log if e[0] in native}
    assert seen == native
    for e in log:
        if e[0] in native:
            assert e[4] is None, e[0]


@pytest.mark.parametrize("key", ["idx", "vacuumed_idx"])
def test_idx_bytes_equal(both, key):
    ref, port = both
    assert port[key] == ref[key]
    assert len(port[key]) % 16 == 0 and port[key]


@pytest.mark.parametrize("key", ["dat", "vacuumed_dat", "ttl_dat"])
def test_dat_bytes_equal_with_the_append_stamps_masked(both, key):
    ref, port = both
    assert _mask_dat(port[key]) == _mask_dat(ref[key])
    if key != "ttl_dat":  # every stamp there is the plane's pinned clock
        assert port[key] == ref[key]
    else:  # the TTL volume's PUT went through Python, which stamps
        assert _mask_dat(port[key]) != port[key]


def test_shards_after_vacuum_and_encode_equal_the_references(both):
    ref, port = both
    assert port["shards"] == ref["shards"]
    assert port["ecx"] == ref["ecx"]
    # parity = the golden-pinned table codec's product of the data rows
    from seaweedfs_tpu.ops.rs_cpu import RSCodecCPU
    from tests.test_golden_identity import GOLDEN_SHARD_SHA256, _fixture

    codec = RSCodecCPU(10, 4)
    fixture = _fixture()
    assert [hashlib.sha256(r.tobytes()).hexdigest() for r in np.concatenate(
        [fixture, np.asarray(codec.encode_parity(fixture))])] == \
        GOLDEN_SHARD_SHA256
    rows = np.stack([np.frombuffer(r, np.uint8)
                     for r in port["shard_rows"]])
    parity = np.asarray(codec.encode_parity(rows[:10]))
    assert np.array_equal(parity, rows[10:])


# -- the reference's plane tests, against the port in process ---------------

@pytest.fixture(scope="module")
def native_cluster(tmp_path_factory):
    from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer

    mport = pick_port()
    master = MasterServer(ip="localhost", port=mport,
                          volume_size_limit_mb=64)
    master.start(vacuum_interval=3600)
    vsrv = VolumeServer(
        directories=[str(tmp_path_factory.mktemp("nvol"))],
        master=f"localhost:{mport}", ip="localhost",
        port=pick_port((mport,)), native=True,
        coder=RSCodecTorch(10, 4, device="cpu"))
    vsrv.start()
    deadline = time.time() + 30
    while time.time() < deadline and not master.topo.nodes:
        time.sleep(0.05)
    assert master.topo.nodes, "volume server did not register"
    yield master, vsrv
    vsrv.stop()
    master.stop()
    rpc.reset_channels()


def _assign(master, **kw):
    from seaweedfs_tpu_torch.operation import assign

    a = assign(master.address, **kw)
    assert not a.error, a.error
    return a


def _assign_n_on_same_volume(master, n, attempts=3000):
    first = _assign(master)
    vid = parse_file_id(first.fid).volume_id
    fids = []
    for _ in range(attempts):
        if len(fids) >= n:
            break
        a = _assign(master)
        if parse_file_id(a.fid).volume_id == vid:
            fids.append(a)
    assert len(fids) >= n, f"assigns stopped routing to volume {vid}"
    return vid, fids


def test_the_library_is_built_once_per_source_into_ops_build():
    path = port_dataplane.library_path()
    assert path.parent == port_dataplane._BUILD_DIR
    assert path.parent.name == "_build" and path.parent.parent.name == "ops"
    assert path.exists()  # the fixtures above loaded it
    assert "libswfs_dataplane-" in path.name


def test_processes_building_at_once_land_one_library(tmp_path):
    """Four processes build into one empty directory at the same moment:
    each renames its own temporary file into place, so all load one
    complete library and no temporary file is left."""
    code = ("import sys; from pathlib import Path; "
            "from seaweedfs_tpu_torch.native import dataplane as d; "
            "d._BUILD_DIR = Path(sys.argv[1]); p = d.library_path(); "
            "d._build(p); import ctypes; ctypes.CDLL(str(p)); print(p)")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert len({o[0] for o in outs}) == 1
    assert [f.name for f in tmp_path.iterdir()] == [
        os.path.basename(outs[0][0].decode().strip())]


def test_a_failed_build_names_the_compiler_error(tmp_path, monkeypatch):
    bad = tmp_path / "dataplane.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(port_dataplane, "_SRC", bad)
    monkeypatch.setattr(port_dataplane, "_BUILD_DIR", tmp_path / "b")
    with pytest.raises(port_dataplane.NativeBuildError) as e:
        port_dataplane._build(port_dataplane.library_path())
    assert "g++ failed" in str(e.value) and "dataplane.cpp" in str(e.value)
    assert list((tmp_path / "b").iterdir()) == []


def test_write_read_delete_via_native_port(native_cluster):
    master, vsrv = native_cluster
    assert vsrv.native_plane is not None
    a = _assign(master)
    payload = b"native plane payload " * 40
    s = requests.Session()
    r = s.put(f"http://{a.url}/{a.fid}", data=payload,
              headers={"Content-Type": "text/plain"})
    assert r.status_code == 201, r.text
    before = vsrv.native_plane.request_count()
    g = s.get(f"http://{a.url}/{a.fid}")
    assert g.status_code == 200 and g.content == payload
    assert g.headers["Content-Type"] == "text/plain"
    assert vsrv.native_plane.request_count() > before
    assert s.get(f"http://{a.url}/{a.fid}",
                 headers={"If-None-Match": g.headers["ETag"]}
                 ).status_code == 304
    assert s.delete(f"http://{a.url}/{a.fid}").status_code == 202
    assert s.get(f"http://{a.url}/{a.fid}").status_code == 404


def test_overwrite_and_python_visibility(native_cluster):
    master, vsrv = native_cluster
    a = _assign(master)
    s = requests.Session()
    s.put(f"http://{a.url}/{a.fid}", data=b"v1")
    s.put(f"http://{a.url}/{a.fid}", data=b"v2-longer")
    assert s.get(f"http://{a.url}/{a.fid}").content == b"v2-longer"
    fid = parse_file_id(a.fid)
    n = vsrv.store.read_needle(fid.volume_id, fid.key, fid.cookie)
    assert n.data == b"v2-longer"


def test_catchup_absorbs_the_planes_idx_appends(native_cluster):
    """Both planes share one liveness predicate: a zero-byte needle the
    plane wrote stays live in the Python map after catch-up AND after a
    from-scratch replay of the same idx."""
    from seaweedfs_tpu_torch.storage.volume import NeedleMap

    master, vsrv = native_cluster
    a = _assign(master)
    fid = parse_file_id(a.fid)
    s = requests.Session()
    assert s.put(f"http://{a.url}/{a.fid}", data=b"").status_code == 201
    v = vsrv.store.find_volume(fid.volume_id)
    before = v.nm.file_counter
    assert v.nm.catchup_from_idx() >= 1
    assert v.nm.catchup_from_idx() == 0  # nothing new past the watermark
    assert v.nm.file_counter > before
    nv = v.nm.get(fid.key)
    assert nv is not None and nv.size == 0
    fresh = NeedleMap(v.nm.idx_path)
    nv2 = fresh.get(fid.key)
    assert nv2 is not None and nv2.size == 0
    fresh.close()
    assert vsrv.store.read_needle(fid.volume_id, fid.key,
                                  fid.cookie).data == b""
    assert s.delete(f"http://{a.url}/{a.fid}").status_code in (200, 202)
    assert s.get(f"http://{a.url}/{a.fid}").status_code == 404


def test_heartbeat_counters_reflect_native_writes(native_cluster):
    master, vsrv = native_cluster
    a = _assign(master)
    requests.put(f"http://{a.url}/{a.fid}", data=b"counted")
    vid = parse_file_id(a.fid).volume_id
    vsrv._sync_native_registry()
    v = vsrv.store.find_volume(vid)
    assert v.file_count() >= 1
    assert v.nm.get(parse_file_id(a.fid).key) is not None


@pytest.mark.parametrize("replication,ttl", [("001", ""), ("000", "3m")])
def test_replicated_and_ttl_volumes_stay_python(native_cluster,
                                                replication, ttl):
    """The registry rule: rp != 000 and TTL volumes are registered
    read-only in the plane, so their PUTs 307 to Python."""
    master, vsrv = native_cluster
    vsrv.store.add_volume(7777, "", replication, ttl)
    try:
        vsrv._sync_native_registry()
        assert vsrv._native_vids.get(7777) is False
        assert vsrv.store.find_volume(7777).native is vsrv.native_plane
        r = requests.put(f"http://{vsrv.address}/7777,0000000001aabbccdd",
                         data=b"x", allow_redirects=False)
        assert r.status_code == 307
        assert r.headers["Location"].endswith("/7777,0000000001aabbccdd")
    finally:
        vsrv.store.delete_volume(7777)
        vsrv._sync_native_registry()
    assert 7777 not in vsrv._native_vids


def test_read_only_flips_follow_the_registry(native_cluster):
    master, vsrv = native_cluster
    vsrv.store.add_volume(7778, "", "000", "")
    try:
        vsrv._sync_native_registry()
        assert vsrv._native_vids[7778] is True
        v = vsrv.store.find_volume(7778)
        v.read_only = True
        vsrv._sync_native_registry()
        assert vsrv._native_vids[7778] is False
        r = requests.put(f"http://{vsrv.address}/7778,0000000001aabbccdd",
                         data=b"x", allow_redirects=False)
        assert r.status_code == 307
        v.read_only = False
        vsrv._sync_native_registry()
        r = requests.put(f"http://{vsrv.address}/7778,0000000001aabbccdd",
                         data=b"x", allow_redirects=False)
        assert r.status_code == 201
    finally:
        vsrv.store.delete_volume(7778)
        vsrv._sync_native_registry()


def test_vacuum_after_native_writes(native_cluster):
    master, vsrv = native_cluster
    s = requests.Session()
    vid, fids = _assign_n_on_same_volume(master, 10)
    for a in fids:
        s.put(f"http://{a.url}/{a.fid}", data=b"x" * 500)
    for a in fids[:5]:
        assert s.delete(f"http://{a.url}/{a.fid}").status_code == 202
    v = vsrv.store.find_volume(vid)
    v.sync_native()
    assert v.deleted_count() >= 5
    size_before = v.data_size()
    v.compact()
    v.commit_compact()
    assert v.data_size() < size_before
    for a in fids[5:]:
        g = s.get(f"http://{a.url}/{a.fid}")
        assert g.status_code == 200 and g.content == b"x" * 500, a.fid
    for a in fids[:5]:
        assert s.get(f"http://{a.url}/{a.fid}").status_code == 404


def test_ec_encode_of_native_volume(native_cluster):
    """EC over a volume whose needles C++ wrote reads back (idx/dat
    coherence), with the port's coder on the CPU."""
    from seaweedfs_tpu_torch.models.coder import new_coder
    from seaweedfs_tpu_torch.storage import ec_files
    from seaweedfs_tpu_torch.storage import ec_volume as ecv
    from seaweedfs_tpu_torch.storage.ec_locate import Geometry
    from seaweedfs_tpu_torch.storage.needle import Needle

    master, vsrv = native_cluster
    s = requests.Session()
    vid, fids = _assign_n_on_same_volume(master, 12)
    payloads = {}
    for i, b in enumerate(fids):
        data = hashlib.sha256(str(i).encode()).digest() * 20
        s.put(f"http://{b.url}/{b.fid}", data=data)
        payloads[b.fid] = data
    v = vsrv.store.find_volume(vid)
    v.read_only = True
    vsrv._sync_native_registry()
    try:
        geo = Geometry(large_block=10000, small_block=100)
        coder = new_coder(10, 4, "cpu")
        base = v.file_name()
        v.sync_native()
        ec_files.generate_ec_files(base, coder, geo)
        ec_files.write_sorted_file_from_idx(base)
        vol = ecv.EcVolume(base, coder, geo)
        for fid_str, data in payloads.items():
            n = Needle.from_bytes(vol.read_needle_blob(
                parse_file_id(fid_str).key), v.version)
            assert n.data == data
        vol.close()
    finally:
        v.read_only = False
        vsrv._sync_native_registry()


def test_concurrent_storm(native_cluster):
    """Writers, overwriters, readers and deleters on one volume: the
    plane's map agrees with the idx on disk and with the Python map."""
    from concurrent.futures import ThreadPoolExecutor

    master, vsrv = native_cluster
    vid, fids = _assign_n_on_same_volume(master, 40)
    tl = threading.local()
    errors = []

    def sess():
        if not hasattr(tl, "s"):
            tl.s = requests.Session()
        return tl.s

    def worker(idx: int):
        a = fids[idx]
        try:
            for round_no in range(6):
                body = f"{a.fid}:{round_no}".encode() * 20
                assert sess().put(f"http://{a.url}/{a.fid}",
                                  data=body).status_code == 201
                g = sess().get(f"http://{a.url}/{a.fid}")
                assert g.status_code == 200 and g.content == body
            if idx % 3 == 0:
                assert sess().delete(
                    f"http://{a.url}/{a.fid}").status_code == 202
        except AssertionError as e:
            errors.append((a.fid, e))

    with ThreadPoolExecutor(8) as ex:
        list(ex.map(worker, range(len(fids))))
    assert not errors, errors[:3]
    v = vsrv.store.find_volume(vid)
    v.sync_native()
    stats_live = vsrv.native_plane.volume_stats(vid)
    vsrv.native_plane.reload_volume(vid)
    assert vsrv.native_plane.volume_stats(vid) == stats_live
    assert v.nm.file_counter == stats_live["file_count"]
    assert v.nm.deletion_counter == stats_live["del_count"]
    for i, a in enumerate(fids):
        blob = vsrv.native_plane.read_blob(vid, parse_file_id(a.fid).key)
        assert (blob is None) == (i % 3 == 0), a.fid


def test_compaction_under_concurrent_native_writes(native_cluster):
    """Writers on the plane while Python compacts the volume again and
    again: no acknowledged write is lost and none is refused."""
    master, vsrv = native_cluster
    vid, fids = _assign_n_on_same_volume(master, 6)
    stop = threading.Event()
    acked: dict[str, bytes] = {}
    indeterminate: set = set()
    errors = []

    def writer(idx):
        s = requests.Session()
        a = fids[idx]
        n = 0
        while not stop.is_set():
            n += 1
            body = f"{a.fid}#{n}".encode() * 30
            try:
                r = s.put(f"http://{a.url}/{a.fid}", data=body, timeout=30)
                if r.status_code == 201:
                    acked[a.fid] = body
                    indeterminate.discard(a.fid)
                else:
                    errors.append((a.fid, r.status_code))
            except requests.RequestException:
                indeterminate.add(a.fid)

    v = vsrv.store.find_volume(vid)
    threads = [threading.Thread(target=writer, args=(i,))
               for i in range(len(fids))]
    for t in threads:
        t.start()
    try:
        for _ in range(3):
            time.sleep(0.1)
            v.compact()
            v.commit_compact()
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors, errors[:3]
    checked = 0
    for fid, body in acked.items():
        if fid in indeterminate:
            continue
        g = requests.get(f"http://{fids[0].url}/{fid}", timeout=30)
        assert g.status_code == 200 and g.content == body, fid
        checked += 1
    assert checked > 0


@pytest.mark.parametrize("size,zerocopy,rides", [
    (4096, "", True), (4095, "", False), (64 * 1024, "0", False)])
def test_sendfile_above_4096_bytes_and_the_zerocopy_gate(tmp_path, size,
                                                         zerocopy, rides,
                                                         monkeypatch):
    """A body of 4,096 B or more rides sendfile(2) (NativeSendfile
    counts it); SWFS_ZEROCOPY=0 turns the path off."""
    from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
    from seaweedfs_tpu_torch.server.volume import VolumeServer

    monkeypatch.setenv("SWFS_ZEROCOPY", zerocopy)
    port = pick_port()
    vsrv = VolumeServer(directories=[str(tmp_path)],
                        master=f"localhost:{pick_port((port,))}",
                        ip="127.0.0.1", port=port, native=True,
                        coder=RSCodecTorch(10, 4, device="cpu"))
    vsrv.start()
    try:
        vsrv.store.add_volume(9, "", "000", "")
        vsrv._sync_native_registry()
        body = os.urandom(size)
        fid = _fid(9, 1, 0x1234)
        s = requests.Session()
        assert s.put(f"http://127.0.0.1:{port}/{fid}",
                     data=body).status_code == 201
        g = s.get(f"http://127.0.0.1:{port}/{fid}")
        assert g.status_code == 200 and g.content == body
        st = s.get(f"http://127.0.0.1:{port}/status").json()
        assert st["NativeDataPlane"] is True and st["NativeRequests"] >= 2
        assert (st["NativeSendfile"] > 0) is rides
    finally:
        vsrv.stop()
        rpc.reset_channels()


def test_range_edge_cases_answer_as_the_python_listener(native_cluster):
    master, vsrv = native_cluster
    a = _assign(master)
    body = b"R" * 1024
    s = requests.Session()
    assert s.put(f"http://{a.url}/{a.fid}", data=body).status_code == 201
    for rng in ("bytes=10-19", "bytes=1000-", "bytes=-5",
                "bytes=0-18446744073709551615",
                "bytes=99999999999999999999-", "bytes=5000-6000",
                "bytes=abc-xyz", "bytes=5-3", "weird-units=0-5"):
        native = s.get(f"http://{vsrv.address}/{a.fid}",
                       headers={"Range": rng})
        python = s.get(f"http://localhost:{vsrv.admin_port}/{a.fid}",
                       headers={"Range": rng})
        assert native.status_code == python.status_code, rng
        assert native.content == python.content, rng
        assert native.headers.get("Content-Range") == \
            python.headers.get("Content-Range"), rng


def test_head_parity(native_cluster):
    master, vsrv = native_cluster
    a = _assign(master)
    body = b"H" * 512
    s = requests.Session()
    assert s.put(f"http://{a.url}/{a.fid}", data=body).status_code == 201
    native = s.head(f"http://{vsrv.address}/{a.fid}")
    python = s.head(f"http://localhost:{vsrv.admin_port}/{a.fid}")
    got = s.get(f"http://{vsrv.address}/{a.fid}")
    assert native.status_code == python.status_code == got.status_code \
        == 200
    for h in ("Content-Length", "ETag", "Content-Type"):
        assert native.headers.get(h) == python.headers.get(h) \
            == got.headers.get(h), h
    host, _, port = vsrv.address.partition(":")
    c = http.client.HTTPConnection(host, int(port), timeout=10)
    c.request("HEAD", f"/{a.fid}")
    r1 = c.getresponse()
    r1.read()
    c.request("GET", f"/{a.fid}")
    r2 = c.getresponse()
    assert r1.status == 200 and r2.status == 200 and r2.read() == body
    c.close()


def test_status_and_metrics_expose_native_plane(native_cluster):
    master, vsrv = native_cluster
    a = _assign(master)
    requests.put(f"http://{a.url}/{a.fid}", data=b"observed")
    r = requests.get(f"http://{vsrv.address}/status", allow_redirects=False)
    assert r.status_code == 307  # the plane hands /status to Python
    st = requests.get(f"http://{vsrv.address}/status").json()
    assert st["NativeDataPlane"] is True
    assert st["NativeRequests"] >= 1
    vsrv.trigger_heartbeat()
    deadline = time.time() + 30
    while True:
        m = requests.get(f"http://{vsrv.address}/metrics").text
        line = [ln for ln in m.splitlines() if ln.startswith(
            "SeaweedFS_volumeServer_native_requests")]
        if line and float(line[0].split()[-1]) > 0:
            break
        assert time.time() < deadline, line
        time.sleep(0.2)


def test_filer_chunked_read_through_native(native_cluster, tmp_path):
    """A chunked filer file reads back whole and ranged with its chunks
    fetched from the C++ plane."""
    from seaweedfs_tpu_torch.server.filer import FilerServer

    master, vsrv = native_cluster
    fs = FilerServer(ip="localhost", port=pick_port(), master=master.address,
                     store_dir=str(tmp_path / "f"))
    fs.chunk_cache = None  # count the volume plane's hits
    fs.start()
    try:
        s = requests.Session()
        body = bytes([i % 251 for i in range(300_000)])
        r = s.put(f"http://localhost:{fs.port}/big/blob?maxMB=0.1",
                  data=body)
        assert r.status_code < 300, r.text
        before = vsrv.native_plane.request_count()
        g = s.get(f"http://localhost:{fs.port}/big/blob")
        assert g.status_code == 200 and g.content == body
        rng = s.get(f"http://localhost:{fs.port}/big/blob",
                    headers={"Range": "bytes=150000-200000"})
        assert rng.content == body[150000:200001]
        assert vsrv.native_plane.request_count() > before
    finally:
        fs.stop()


def test_native_client_benchmark(native_cluster):
    """`benchmark -nativeClient`: batched assigns and _delta fids through
    the compiled loop, the reference's result keys, 0 failed."""
    import types as _types

    from seaweedfs_tpu.command import benchmark as ref_benchmark
    from seaweedfs_tpu_torch.command.benchmark import run_benchmark

    master, vsrv = native_cluster
    opts = _types.SimpleNamespace(n=200, size=512, c=4,
                                  master=master.address, collection="",
                                  skipRead=False, assignBatch=32,
                                  nativeClient=True, filer="")
    r = run_benchmark(opts)
    assert r["write"]["failed"] == 0 and r["read"]["failed"] == 0
    assert r["write"]["requests_per_sec"] > 0
    ref_r = ref_benchmark.run_benchmark(_types.SimpleNamespace(**{
        **vars(opts), "n": 40}))
    assert {k: set(v) for k, v in r.items()} == \
        {k: set(v) for k, v in ref_r.items()}


def test_long_url_no_stack_leak(native_cluster):
    master, vsrv = native_cluster
    r = requests.get(f"http://{vsrv.address}/" + "a" * 3000,
                     allow_redirects=False, timeout=10)
    assert r.status_code == 307
    assert r.headers["Location"].endswith("a" * 3000)
    assert len(r.content) == 0
