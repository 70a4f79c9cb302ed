"""The port's C++ filer hot plane, held to the reference's, on the CPU.

Every case of the reference's hot-plane suite (tests/test_native_filer.py)
runs against a port stack: a master, a volume server with the C++ plane
and a filer whose hot plane serves /buckets/ off it. Byte parity with
the Python path, chunked transfer encoding, percent-encoded paths,
multipart and range, a Python delete that invalidates, ordered metadata
events, acknowledged PUTs that survive a SIGKILL mid-hot-log, a corrupt
hot log that stands the plane down, a high-port admin shadow,
conditionals, md5-wanting PUTs that defer to Python. Then one seeded
script runs through a reference stack and a port stack, and every answer
must be equal (tolerance 0 on status, body and the ETag, Content-Type,
Content-Length and Content-Range headers; Date, Last-Modified and the
Python listener's X-Trace-Id are not compared, the clocks of two runs
differ), down to which requests the hot plane served itself and which it
sent to Python."""

import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import requests

from seaweedfs_tpu_torch.pb import rpc
from tests.test_torch_native_dataplane import REPO, pick_port, wait_http


def _stack(pkg: str, tmp, tag: str):
    """master + a volume server with the C++ plane + a filer with the
    hot plane, all of one package, in this process."""
    mods = {m: __import__(f"{pkg}.server.{m}", fromlist=["x"])
            for m in ("master", "volume", "filer")}
    kw = {}
    if pkg == "seaweedfs_tpu_torch":
        from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch

        kw["coder"] = RSCodecTorch(10, 4, device="cpu")
    mport = pick_port()
    vport = pick_port((mport,))
    fport = pick_port((mport, vport))
    master = mods["master"].MasterServer(ip="localhost", port=mport,
                                         volume_size_limit_mb=64)
    master.start(vacuum_interval=3600)
    (tmp / f"{tag}-vol").mkdir(exist_ok=True)
    vsrv = mods["volume"].VolumeServer(
        directories=[str(tmp / f"{tag}-vol")], master=f"localhost:{mport}",
        ip="localhost", port=vport, native=True, **kw)
    vsrv.start()
    deadline = time.time() + 30
    while time.time() < deadline and not master.topo.nodes:
        time.sleep(0.05)
    assert master.topo.nodes, "volume server did not register"
    fs = mods["filer"].FilerServer(
        ip="localhost", port=fport, master=f"localhost:{mport}",
        store_dir=str(tmp / f"{tag}-filer"),
        native_volume_plane=vsrv.native_plane)
    fs.start()
    assert fs.hot_plane is not None, "hot plane did not start"
    deadline = time.time() + 30
    while time.time() < deadline and fs.hot_plane.lease_remaining() == 0:
        time.sleep(0.05)
    assert fs.hot_plane.lease_remaining() > 0, "lease pool never filled"
    return master, vsrv, fs


def _teardown(pkg, master, vsrv, fs):
    fs.stop()
    vsrv.stop()
    master.stop()
    __import__(f"{pkg}.pb.rpc", fromlist=["x"]).reset_channels()


@pytest.fixture(scope="module")
def hot_cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hot")
    stack = _stack("seaweedfs_tpu_torch", tmp, "port")
    yield stack
    _teardown("seaweedfs_tpu_torch", *stack)


def _native_url(fs, path: str) -> str:
    return f"http://localhost:{fs.port}{path}"


def _admin_url(fs, path: str) -> str:
    return f"http://localhost:{fs.admin_port}{path}"


def test_byte_parity_native_vs_python(hot_cluster):
    """Identical PUT/GET through both planes: bytes, ETag, Content-Type
    and the absorbed store entry agree."""
    _, _, fs = hot_cluster
    rng = np.random.default_rng(7)
    cases = [
        (b"x", "text/plain"),
        (b"hello hot plane" * 100, "application/octet-stream"),
        (rng.integers(0, 256, 512 * 1024, dtype=np.uint8).tobytes(),
         "image/png"),
        (b"", ""),
    ]
    for i, (payload, ctype) in enumerate(cases):
        npath = f"/buckets/parity/n{i}.bin"
        ppath = f"/buckets/parity/p{i}.bin"
        headers = {"Content-Type": ctype} if ctype else {}
        rn = requests.put(_native_url(fs, npath), data=payload,
                          headers=headers, timeout=30)
        rp = requests.put(_admin_url(fs, ppath), data=payload,
                          headers=headers, timeout=30)
        assert rn.status_code in (200, 201), rn.text
        assert rp.status_code in (200, 201), rp.text
        gn = requests.get(_native_url(fs, npath), timeout=30)
        gp = requests.get(_native_url(fs, ppath), timeout=30)
        assert gn.status_code == gp.status_code == 200
        assert gn.content == gp.content == payload
        if ctype and payload:
            assert gn.headers["Content-Type"] == ctype
            assert gp.headers["Content-Type"] == ctype
        if payload:
            fs.hot_sync()
            ga = requests.get(_admin_url(fs, npath), timeout=30)
            assert ga.status_code == 200 and ga.content == payload
            assert gn.headers.get("ETag") == ga.headers.get("ETag")
        fs.hot_sync()
        en = fs.filer.find_entry(npath)
        ep = fs.filer.find_entry(ppath)
        assert sum(c.size for c in en.chunks) == len(payload)
        assert sum(c.size for c in ep.chunks) == len(payload)
        if ctype:
            assert en.attr.mime == ep.attr.mime == ctype


def test_chunked_transfer_encoding_put(hot_cluster):
    _, _, fs = hot_cluster
    payload = os.urandom(300 * 1024)

    def gen(body, step):
        for i in range(0, len(body), step):
            yield body[i:i + step]

    r = requests.put(_native_url(fs, "/buckets/chunked/s.bin"),
                     data=gen(payload, 32 * 1024), timeout=30)
    assert r.status_code in (200, 201), r.text
    g = requests.get(_native_url(fs, "/buckets/chunked/s.bin"), timeout=30)
    assert g.status_code == 200 and g.content == payload
    # past max_body: the consumed body is proxied to Python, not 307ed
    big = os.urandom(6 * 1024 * 1024)
    r = requests.put(_native_url(fs, "/buckets/chunked/big.bin"),
                     data=gen(big, 256 * 1024), timeout=60)
    assert r.status_code in (200, 201), (r.status_code, r.text[:200])
    g = requests.get(_native_url(fs, "/buckets/chunked/big.bin"), timeout=60)
    assert g.status_code == 200 and g.content == big
    with socket.create_connection(("localhost", fs.port), timeout=10) as s:
        body = b"7;ext=1\r\nchunked\r\n3\r\n-ok\r\n0\r\n\r\n"
        s.sendall(b"PUT /buckets/chunked/raw.bin HTTP/1.1\r\n"
                  b"Host: x\r\nTransfer-Encoding: chunked\r\n"
                  b"Connection: close\r\n\r\n" + body)
        resp = b""
        while chunk := s.recv(4096):
            resp += chunk
    assert b" 201 " in resp.split(b"\r\n", 1)[0] + b" ", resp[:200]
    g = requests.get(_native_url(fs, "/buckets/chunked/raw.bin"), timeout=10)
    assert g.content == b"chunked-ok"


def test_percent_encoded_paths_are_canonical(hot_cluster):
    _, _, fs = hot_cluster
    enc = "/buckets/pct/a%20b%20c.txt"
    dec = "/buckets/pct/a b c.txt"
    assert requests.put(_native_url(fs, enc), data=b"spaces v1",
                        timeout=10).status_code in (200, 201)
    g = requests.get(_native_url(fs, enc), timeout=10)
    assert g.status_code == 200 and g.content == b"spaces v1"
    fs.hot_sync()
    e = fs.filer.find_entry(dec)
    assert sum(c.size for c in e.chunks) == len(b"spaces v1")
    assert requests.put(_admin_url(fs, enc), data=b"spaces v2 longer",
                        timeout=10).status_code in (200, 201)
    g = requests.get(_native_url(fs, enc), timeout=10)
    assert g.status_code == 200 and g.content == b"spaces v2 longer"
    r = requests.put(_native_url(fs, "/buckets/pct/bad%zz"), data=b"x",
                     timeout=10)
    assert r.status_code != 500


def test_multipart_and_range_served_natively(hot_cluster):
    _, _, fs = hot_cluster
    before = fs.hot_plane.stats()
    payload = b"multipart native payload" * 10
    r = requests.post(_native_url(fs, "/buckets/wide/mp.bin"),
                      files={"file": ("x.bin", payload)}, timeout=10)
    assert r.status_code == 201, r.text
    url = _native_url(fs, "/buckets/wide/mp.bin")
    g = requests.get(url, timeout=10)
    assert g.content == payload
    assert g.headers["Content-Type"] == "application/octet-stream"
    g = requests.get(url, headers={"Range": "bytes=5-9"}, timeout=10)
    assert g.status_code == 206 and g.content == payload[5:10]
    assert g.headers["Content-Range"] == f"bytes 5-9/{len(payload)}"
    g = requests.get(url, headers={"Range": "bytes=10-"}, timeout=10)
    assert g.status_code == 206 and g.content == payload[10:]
    g = requests.get(url, headers={"Range": f"bytes=0-{len(payload) * 2}"},
                     timeout=10)
    assert g.status_code == 206 and g.content == payload
    after = fs.hot_plane.stats()
    assert after["native_puts"] > before["native_puts"]
    assert after["native_gets"] >= before["native_gets"] + 4
    assert after["redirects"] == before["redirects"]
    g = requests.get(url, headers={"Range": "bytes=-5"}, timeout=10)
    assert g.status_code == 206 and g.content == payload[-5:]
    g = requests.get(url, headers={"Range": f"bytes={len(payload)}-"},
                     timeout=10)
    assert g.status_code == 416


def test_multipart_boundary_prefix_in_content(hot_cluster):
    _, _, fs = hot_cluster
    payload = b"head\r\n--bonus bytes that look like a boundary\r\ntail"
    body = (b"--b\r\nContent-Disposition: form-data; name=\"file\"; "
            b"filename=\"t.bin\"\r\n\r\n" + payload + b"\r\n--b--\r\n")
    with socket.create_connection(("localhost", fs.port), timeout=10) as s:
        s.sendall(b"POST /buckets/wide/prefix.bin HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: multipart/form-data; boundary=b\r\n"
                  b"Content-Length: " + str(len(body)).encode() +
                  b"\r\nConnection: close\r\n\r\n" + body)
        resp = b""
        while chunk := s.recv(4096):
            resp += chunk
    assert b" 201 " in resp.split(b"\r\n", 1)[0] + b" ", resp[:200]
    assert requests.get(_native_url(fs, "/buckets/wide/prefix.bin"),
                        timeout=10).content == payload


def test_python_delete_invalidates_hot_entry(hot_cluster):
    _, _, fs = hot_cluster
    path = "/buckets/inval/d.txt"
    assert requests.put(_native_url(fs, path), data=b"doomed",
                        timeout=10).status_code in (200, 201)
    fs.hot_sync()
    assert requests.delete(_admin_url(fs, path),
                           timeout=10).status_code in (200, 202, 204)
    assert requests.get(_native_url(fs, path), timeout=10).status_code == 404


def test_python_rename_invalidates_both_paths(hot_cluster):
    """A rename through the filer core calls the on_mutate hook for the
    old and the new path: the hot map serves neither stale."""
    _, _, fs = hot_cluster
    old, new = "/buckets/mv/a.txt", "/buckets/mv/b.txt"
    for p, body in ((old, b"old a"), (new, b"old b")):
        assert requests.put(_native_url(fs, p), data=body,
                            timeout=10).status_code in (200, 201)
        assert requests.get(_native_url(fs, p), timeout=10).content == body
    fs.hot_sync()
    fs.filer.delete_entry(new)
    fs.filer.rename(old, new)
    assert requests.get(_native_url(fs, old), timeout=10).status_code == 404
    g = requests.get(_native_url(fs, new), timeout=10)
    assert g.status_code == 200 and g.content == b"old a"


def test_metadata_events_ordered(hot_cluster):
    _, _, fs = hot_cluster
    fs.hot_sync()
    evs, cursor = fs.filer.read_events(0, timeout=0.1)
    while evs:
        evs, cursor = fs.filer.read_events(cursor, timeout=0.1)
    paths = [f"/buckets/events/e{i}.txt" for i in range(8)]
    for i, p in enumerate(paths):
        assert requests.put(_native_url(fs, p), data=f"ev{i}".encode(),
                            timeout=10).status_code in (200, 201)
    fs.hot_sync()
    seen: list[str] = []
    deadline = time.time() + 10
    while time.time() < deadline and len(seen) < len(paths):
        evs, cursor = fs.filer.read_events(cursor, timeout=0.5)
        for m in evs:
            ev = m.event_notification
            if ev.new_entry and ev.new_entry.name.startswith("e"):
                seen.append(f"{m.directory}/{ev.new_entry.name}")
    assert [p for p in seen if p in paths] == paths, seen


def test_native_plane_actually_serves(hot_cluster):
    _, _, fs = hot_cluster
    st = fs.hot_plane.stats()
    assert st["native_puts"] > 10, st
    assert st["native_gets"] > 5, st
    js = requests.get(_native_url(fs, "/status"), timeout=10).json()
    assert js["NativeHotPlane"]["native_puts"] >= st["native_puts"]


def test_hot_plane_conditional_semantics(hot_cluster):
    """If-None-Match compares weak entity-tag lists as Python does; every
    other validator (If-Range above all) defers to Python."""
    _, _, fs = hot_cluster
    payload = b"conditional hot payload" * 64
    path = "/buckets/cond/hot.bin"
    assert requests.put(_native_url(fs, path), data=payload,
                        timeout=10).status_code == 201
    g = requests.get(_native_url(fs, path), timeout=10)
    assert g.status_code == 200 and g.content == payload
    etag = g.headers["ETag"]
    before = fs.hot_plane.stats()
    for inm in (etag, f"W/{etag}", f'"x", {etag}', "*"):
        assert requests.get(_native_url(fs, path), timeout=10,
                            headers={"If-None-Match": inm}
                            ).status_code == 304, inm
    g = requests.get(_native_url(fs, path), timeout=10,
                     headers={"If-None-Match": '"nope"'})
    assert g.status_code == 200 and g.content == payload
    after = fs.hot_plane.stats()
    assert after["native_gets"] >= before["native_gets"] + 5
    assert after["redirects"] == before["redirects"]
    g = requests.get(_native_url(fs, path), timeout=10,
                     headers={"Range": "bytes=5-9", "If-Range": etag})
    assert g.status_code == 206 and g.content == payload[5:10]
    for stale in (f"W/{etag}", '"stale"'):
        g = requests.get(_native_url(fs, path), timeout=10,
                         headers={"Range": "bytes=5-9", "If-Range": stale})
        assert g.status_code == 200 and g.content == payload
    assert fs.hot_plane.stats()["redirects"] >= after["redirects"] + 3


def test_md5_wanting_put_defers_to_python(hot_cluster):
    _, _, fs = hot_cluster
    payload = b"md5 etag contract" * 32
    before = fs.hot_plane.stats()
    r = requests.put(_native_url(fs, "/buckets/md5/want.bin"), data=payload,
                     headers={"X-Swfs-Want-Md5": "1"}, timeout=10)
    assert r.status_code in (200, 201), r.text
    after = fs.hot_plane.stats()
    assert after["redirects"] > before["redirects"]
    assert after["native_puts"] == before["native_puts"]
    g = requests.get(_native_url(fs, "/buckets/md5/want.bin"), timeout=10)
    md5_etag = f'"{hashlib.md5(payload).hexdigest()}"'
    assert g.status_code == 200 and g.content == payload
    assert g.headers["ETag"] == md5_etag
    assert requests.get(_native_url(fs, "/buckets/md5/want.bin"),
                        headers={"If-None-Match": md5_etag},
                        timeout=10).status_code == 304


def test_corrupt_hotlog_stands_plane_down(tmp_path):
    """A corrupt hot-log record alarms, halts absorption and stops the
    plane acking PUTs it can no longer make durable: they go to Python
    and keep working."""
    master, vsrv, fs = _stack("seaweedfs_tpu_torch", tmp_path, "c")
    try:
        assert requests.put(_native_url(fs, "/buckets/c/ok.txt"),
                            data=b"good", timeout=10).status_code == 201
        fs.hot_sync()
        with open(fs.hot_plane.log_path, "ab") as f:
            f.write(b"\x07" + b"\x00" * 60)
        fs.hot_sync()
        assert fs._hot_log_corrupt
        before = fs.hot_plane.stats()
        r = requests.put(_native_url(fs, "/buckets/c/after.txt"),
                         data=b"via python", timeout=10)
        assert r.status_code in (200, 201)
        assert fs.hot_plane.stats()["native_puts"] == before["native_puts"]
        e = fs.filer.find_entry("/buckets/c/after.txt")
        assert sum(c.size for c in e.chunks) == len(b"via python")
        g = requests.get(_native_url(fs, "/buckets/c/after.txt"), timeout=10)
        assert g.status_code == 200 and g.content == b"via python"
    finally:
        _teardown("seaweedfs_tpu_torch", master, vsrv, fs)


def test_a_corrupt_log_found_at_start_is_set_aside(tmp_path):
    """A restart that finds a corrupt hot log absorbs what precedes the
    damage, keeps the log as filer-hot.log.corrupt and starts a fresh
    one."""
    master, vsrv, fs = _stack("seaweedfs_tpu_torch", tmp_path, "s")
    try:
        assert requests.put(_native_url(fs, "/buckets/s/ok.txt"),
                            data=b"kept", timeout=10).status_code == 201
        log_path = fs.hot_plane.log_path
        fs.hot_plane.stop()  # nothing absorbs from here on
        fs._hot_stop.set()
        for t in fs._hot_threads:
            t.join(timeout=5)
        with open(log_path, "ab") as f:
            f.write(b"\x07" + b"\x00" * 60)
        fs.hot_plane = None
        fs.stop()
        fs2 = __import__("seaweedfs_tpu_torch.server.filer",
                         fromlist=["x"]).FilerServer(
            ip="localhost", port=pick_port((fs.port,)),
            master=f"localhost:{master.port}", store_dir=fs.store_dir,
            native_volume_plane=vsrv.native_plane)
        fs2.start()
        try:
            assert os.path.exists(log_path + ".corrupt")
            assert os.path.getsize(log_path) == 0
            assert not fs2._hot_log_corrupt
            g = requests.get(_native_url(fs2, "/buckets/s/ok.txt"),
                             timeout=10)
            assert g.status_code == 200 and g.content == b"kept"
        finally:
            fs2.stop()
    finally:
        vsrv.stop()
        master.stop()
        rpc.reset_channels()


def test_high_filer_port_admin_shadow_stays_in_range(tmp_path):
    """A filer port whose +11000 would pass 65535 takes port - 11000 for
    the hot plane's admin listener, as the volume plane does."""
    from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
    from seaweedfs_tpu_torch.server.filer import FilerServer
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer

    def probe(start: int):
        for cand in range(start, 65100, 7):
            try:
                with socket.socket() as s1, socket.socket() as s2, \
                        socket.socket() as s3:
                    s1.bind(("", cand))
                    s2.bind(("", cand - 11000))
                    s3.bind(("", cand - 10000))
                return cand
            except OSError:
                continue
        return None

    mport = pick_port()
    vport = pick_port((mport,))
    master = MasterServer(ip="localhost", port=mport,
                          volume_size_limit_mb=64)
    master.start(vacuum_interval=3600)
    vsrv = VolumeServer(directories=[str(tmp_path)],
                        master=f"localhost:{mport}", ip="localhost",
                        port=vport, native=True,
                        coder=RSCodecTorch(10, 4, device="cpu"))
    vsrv.start()
    fs = None
    try:
        deadline = time.time() + 30
        while time.time() < deadline and not master.topo.nodes:
            time.sleep(0.05)
        fport = 60100
        for attempt in range(5):
            fport = probe(fport)
            if fport is None:
                break
            try:
                fs = FilerServer(ip="localhost", port=fport,
                                 master=f"localhost:{mport}",
                                 store_dir=str(tmp_path / f"f{attempt}"),
                                 native_volume_plane=vsrv.native_plane)
                fs.start()
                break
            except OSError:
                if fs is not None:
                    fs.stop()
                fs = None
                fport += 7
        assert fs is not None, "no free high port triple"
        assert fs.hot_plane is not None
        assert fs.admin_port == fport - 11000
        r = requests.put(f"http://localhost:{fport}/hi/x.bin",
                         data=b"high-port", timeout=20)
        assert r.status_code in (200, 201)
        g = requests.get(f"http://localhost:{fport}/hi/x.bin", timeout=20)
        assert g.status_code == 200 and g.content == b"high-port"
    finally:
        if fs is not None:
            fs.stop()
        vsrv.stop()
        master.stop()
        rpc.reset_channels()


def test_sigkill_mid_hotlog_preserves_acked_puts(tmp_path):
    """`python -m seaweedfs_tpu_torch server -filer` SIGKILLed during a
    PUT storm on its hot plane; restarted on the same directory, every
    acknowledged PUT reads back (the start absorbs the crashed plane's
    hot log before it truncates it)."""
    port_m = pick_port()
    port_v = pick_port((port_m,))
    port_f = pick_port((port_m, port_v))
    args = [sys.executable, "-m", "seaweedfs_tpu_torch", "server", "-dir",
            str(tmp_path), "-ip", "127.0.0.1", "-master.port", str(port_m),
            "-volume.port", str(port_v), "-filer", "-filer.port",
            str(port_f), "-coder", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO)
    log = str(tmp_path / "server.log")

    def spawn():
        with open(log, "a") as lf:
            return subprocess.Popen(args, env=env, stdout=lf,
                                    stderr=subprocess.STDOUT)

    acked: list[tuple[str, bytes]] = []
    proc = spawn()
    try:
        wait_http(port_f, "/status", proc, log=log)
        s = requests.Session()
        i = 0
        # readiness, not a sleep: storm until the hot plane itself has
        # acknowledged PUTs (its lease pool filled) and 200 are acked
        while len(acked) < 200 or s.get(
                f"http://127.0.0.1:{port_f}/status", timeout=10).json()[
                "NativeHotPlane"]["native_puts"] < 50:
            p = f"/buckets/crash/f{i}.bin"
            body = os.urandom(1024) + str(i).encode()
            r = s.put(f"http://127.0.0.1:{port_f}{p}", data=body, timeout=30)
            if r.status_code in (200, 201):
                acked.append((p, body))
            i += 1
            assert i < 20000, "the hot plane never took a PUT"
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    proc = spawn()
    try:
        wait_http(port_f, "/status", proc, log=log)
        missing = []
        s = requests.Session()
        for p, body in acked:
            g = s.get(f"http://127.0.0.1:{port_f}{p}", timeout=30)
            if g.status_code != 200 or g.content != body:
                missing.append((p, g.status_code))
        assert not missing, \
            f"{len(missing)}/{len(acked)} acked PUTs lost: {missing[:5]}"
    finally:
        proc.terminate()
        try:
            assert proc.wait(timeout=60) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        rpc.reset_channels()


# -- one script through both packages' hot planes ----------------------------

_COMPARED = ("ETag", "Content-Type", "Content-Length", "Content-Range")


def _hot_script(fs) -> list:
    """Requests through the public (hot) port; each answer with the hot
    plane's counters as they moved."""
    rng = np.random.default_rng(31)
    out = []
    s = requests.Session()

    def step(tag, method, path, **kw):
        before = fs.hot_plane.stats()
        r = s.request(method, f"http://localhost:{fs.port}{path}",
                      timeout=60, **kw)
        after = fs.hot_plane.stats()
        out.append((tag, r.status_code,
                    hashlib.sha256(r.content).hexdigest(),
                    {h: r.headers.get(h) for h in _COMPARED},
                    {k: after[k] - before[k] for k in after
                     if k != "requests"}))

    bodies = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
              for n in rng.integers(1, 96 * 1024, 12)]
    for i, b in enumerate(bodies):
        step("put", "PUT", f"/buckets/s/f{i}.bin", data=b,
             headers={"Content-Type": "image/png"} if i % 2 else {})
    for i in range(len(bodies)):
        step("get", "GET", f"/buckets/s/f{i}.bin")
    step("zero", "PUT", "/buckets/s/zero", data=b"")
    step("zero get", "GET", "/buckets/s/zero")
    step("pct", "PUT", "/buckets/s/a%20b", data=bodies[0])
    step("pct get", "GET", "/buckets/s/a b")
    step("multipart", "POST", "/buckets/s/mp",
         files={"file": ("x.bin", bodies[1])})
    for rng_h in ("bytes=5-9", "bytes=10-", "bytes=-5", "bytes=0-999999",
                  f"bytes={len(bodies[1])}-"):
        step(f"range {rng_h}", "GET", "/buckets/s/mp",
             headers={"Range": rng_h})
    etag = s.get(f"http://localhost:{fs.port}/buckets/s/f3.bin").headers[
        "ETag"]
    for h in ({"If-None-Match": etag}, {"If-None-Match": f"W/{etag}"},
              {"If-None-Match": '"nope"'},
              {"Range": "bytes=1-4", "If-Range": etag},
              {"Range": "bytes=1-4", "If-Range": '"stale"'}):
        step(f"cond {sorted(h)}", "GET", "/buckets/s/f3.bin", headers=h)
    step("md5", "PUT", "/buckets/s/md5", data=bodies[2],
         headers={"X-Swfs-Want-Md5": "1"})
    step("md5 get", "GET", "/buckets/s/md5")
    step("chunked", "PUT", "/buckets/s/chunked",
         data=(bodies[3][i:i + 4096] for i in range(0, len(bodies[3]),
                                                     4096)))
    step("chunked get", "GET", "/buckets/s/chunked")
    step("outside", "PUT", "/other/x.bin", data=b"not a bucket")
    step("outside get", "GET", "/other/x.bin")
    step("overwrite", "PUT", "/buckets/s/f0.bin", data=bodies[4])
    step("overwrite get", "GET", "/buckets/s/f0.bin")
    fs.hot_sync()
    s.delete(f"http://localhost:{fs.admin_port}/buckets/s/f1.bin")
    step("deleted get", "GET", "/buckets/s/f1.bin")
    step("listing", "GET", "/buckets/s/", headers={"Accept":
                                                   "application/json"})
    names = sorted(e["FullPath"] for e in json.loads(
        s.get(f"http://localhost:{fs.port}/buckets/s/?limit=100",
              headers={"Accept": "application/json"}).content)["Entries"])
    out.append(("names", names))
    return out


def test_one_script_answers_as_the_references_hot_plane(tmp_path):
    answers = {}
    for pkg in ("seaweedfs_tpu", "seaweedfs_tpu_torch"):
        stack = _stack(pkg, tmp_path, pkg)
        try:
            answers[pkg] = _hot_script(stack[2])
        finally:
            _teardown(pkg, *stack)
    ref, port = answers["seaweedfs_tpu"], answers["seaweedfs_tpu_torch"]
    assert len(port) == len(ref)
    for a, b in zip(ref, port):
        if a[0] == "listing":  # a JSON listing carries entry times
            assert b[:2] == a[:2] and b[4] == a[4], a[0]
            continue
        assert b == a, a[0]
    served = {e[0]: e[4] for e in port if e[0] != "names"}
    assert served["put"] == {"native_puts": 1, "native_gets": 0,
                             "redirects": 0}
    assert served["get"]["native_gets"] == 1
    assert served["md5"]["redirects"] == 1


# -- a fault the plane uncovers: HEADs that did not follow its 307 -----------


def _verify_after_encode(pkg: str, tmp) -> tuple[str, str]:
    """A file through the filer, its volume erasure-coded, then `fs.verify`
    and `volume.fsck -verbose` through the package's shell: the chunk's
    HEAD reaches the volume server's C++ plane, which hands an EC volume
    to Python with a 307. -> (fs.verify's output, volume.fsck's)."""
    import io

    shell_env = __import__(f"{pkg}.shell.env", fromlist=["x"])
    registry = __import__(f"{pkg}.shell.registry", fromlist=["x"])
    master, vsrv, fs = _stack(pkg, tmp, pkg)
    try:
        body = np.random.default_rng(3).integers(
            0, 256, 200_000, dtype=np.uint8).tobytes()
        assert requests.put(_admin_url(fs, "/docs/a.bin"), data=body,
                            timeout=60).status_code == 201
        vid = int(fs.filer.find_entry("/docs/a.bin").chunks[0].file_id
                  .split(",")[0])
        env = shell_env.CommandEnv(master.address,
                                   filer=f"localhost:{fs.port}")
        outs = []
        for line in ("lock", f"ec.encode -volumeId {vid}", "unlock",
                     "fs.verify /docs", "volume.fsck -verbose"):
            out = io.StringIO()
            rc = registry.run_command(env, line, out)
            outs.append((rc or 0, out.getvalue()))
        assert [rc for rc, _ in outs[:3]] == [0, 0, 0], outs
        assert vsrv.store.find_ec_volume(vid) is not None
        g = requests.get(_native_url(fs, "/docs/a.bin"), timeout=60)
        assert g.status_code == 200 and g.content == body
        return outs[3], outs[4]
    finally:
        _teardown(pkg, master, vsrv, fs)


def test_fs_verify_and_volume_fsck_follow_the_planes_redirect(tmp_path):
    """The reference's fs.verify and volume.fsck -verbose HEAD each chunk
    without following redirects, so behind its default C++ plane every
    chunk of an EC volume reads MISSING (HTTP 307); the port's follow the
    307 and find the chunk."""
    ref_verify, ref_fsck = _verify_after_encode("seaweedfs_tpu", tmp_path)
    verify, fsck = _verify_after_encode("seaweedfs_tpu_torch", tmp_path)
    assert ref_verify[0] == 1 and "MISSING /docs/a.bin" in ref_verify[1]
    assert "HTTP 307" in ref_fsck[1]
    assert verify == (0, verify[1]) and "MISSING" not in verify[1]
    assert "0 missing/corrupt" in verify[1]
    assert fsck[0] == 0 and "0 unreadable" in fsck[1]
    assert "HTTP" not in fsck[1]
