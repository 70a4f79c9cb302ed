"""Crash durability of the port's C++ data plane, and the CLI's default.

A `python -m seaweedfs_tpu_torch volume` process, on the C++ plane by
default, is SIGKILLed in the middle of a write storm and restarted on the
same directory: every acknowledged write reads back, counted as the
reference's tests/test_native_crash.py counts it (the acknowledged body,
or a later one whose write was in flight at the kill — never an earlier
one). Every wait is on readiness (an answer, a count of acknowledged
writes), never a fixed sleep.

The CLI: `volume` and `server` start the plane by default, /status
answers NativeDataPlane true and no process loads jax or anything of
seaweedfs_tpu; `-nativeDataPlane off` keeps the Python plane; `on` where
g++ cannot build the plane fails at start with g++'s message."""

import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import requests

from seaweedfs_tpu_torch.operation import assign
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.server.master import MasterServer
from tests.test_torch_native_dataplane import REPO, pick_port, wait_http

_WRAPPER = r"""
import atexit, runpy, sys
out = sys.argv[1]


def dump():
    with open(out, "w") as f:
        f.write("\n".join(sorted(sys.modules)))


atexit.register(dump)
sys.argv = ["seaweedfs_tpu_torch"] + sys.argv[2:]
runpy.run_module("seaweedfs_tpu_torch", run_name="__main__", alter_sys=True)
"""


def _spawn(args, tmp, name, env=None):
    """A `python -m seaweedfs_tpu_torch` process that records the modules
    it loaded when it exits."""
    log = open(tmp / f"{name}.log", "ab")
    proc = subprocess.Popen(
        [sys.executable, "-c", _WRAPPER, str(tmp / f"{name}.modules")]
        + args, cwd=REPO, env=env or dict(os.environ),
        stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc


def _modules(tmp, name) -> list[str]:
    return (tmp / f"{name}.modules").read_text().split("\n")


def _assert_no_jax(mods: list[str]) -> None:
    assert "seaweedfs_tpu_torch.native.dataplane" in mods
    assert not [m for m in mods if m in ("jax", "seaweedfs_tpu")
                or m.startswith(("jax.", "seaweedfs_tpu."))]


def _stop(proc, log) -> None:
    """SIGTERM; the process must exit 0 (its log tail says why not)."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "no exit 60 s after SIGTERM"
    assert rc == 0, f"{rc}: {log.read_text()[-3000:]}"


def _canon(fid: str, n: int) -> bytes:
    return f"{fid}:{n}:".encode() * 40


def test_sigkill_mid_storm_preserves_acked_writes(tmp_path):
    mport = pick_port()
    master = MasterServer(ip="127.0.0.1", port=mport,
                          volume_size_limit_mb=64)
    master.start(vacuum_interval=3600)
    vport = pick_port((mport,))
    vdir = tmp_path / "crashvol"
    vdir.mkdir()
    args = ["volume", "-ip", "127.0.0.1", "-port", str(vport), "-mserver",
            f"127.0.0.1:{mport}", "-dir", str(vdir), "-coder", "cpu"]
    proc = _spawn(args, tmp_path, "first")
    try:
        wait_http(vport, "/status", proc,
                  log=str(tmp_path / "first.log"))
        deadline = time.time() + 60
        while not master.topo.nodes:
            assert time.time() < deadline, "the volume never registered"
            time.sleep(0.05)
        st = requests.get(f"http://127.0.0.1:{vport}/status",
                          timeout=10).json()
        assert st["NativeDataPlane"] is True  # the default plane
        fids = []
        for _ in range(8):
            a = assign(master.address)
            assert not a.error, a.error
            fids.append(a)
        acked: dict[str, int] = {}
        lock = threading.Lock()
        stop = threading.Event()

        def writer(idx):
            s = requests.Session()
            a = fids[idx]
            n = 0
            while not stop.is_set():
                n += 1
                try:
                    r = s.put(f"http://{a.url}/{a.fid}",
                              data=_canon(a.fid, n), timeout=30)
                    if r.status_code == 201:
                        with lock:
                            acked[a.fid] = n
                except requests.RequestException:
                    return  # the server died mid-request: unacknowledged

        threads = [threading.Thread(target=writer, args=(i,))
                   for i in range(len(fids))]
        for t in threads:
            t.start()
        # readiness, not a sleep: every writer has acknowledged writes
        deadline = time.time() + 120
        while True:
            with lock:
                if len(acked) == len(fids) and min(acked.values()) >= 20:
                    break
            assert time.time() < deadline, acked
            time.sleep(0.01)
        proc.send_signal(signal.SIGKILL)  # no flush, no goodbye
        proc.wait(timeout=30)
        stop.set()
        for t in threads:
            t.join()
        with lock:
            acked = dict(acked)
        proc2 = _spawn(args, tmp_path, "second")
        try:
            wait_http(vport, "/status", proc2,
                      log=str(tmp_path / "second.log"))
            s = requests.Session()
            for fid, last_n in acked.items():
                g = s.get(f"http://127.0.0.1:{vport}/{fid}", timeout=30)
                assert g.status_code == 200, (fid, g.status_code)
                assert any(g.content == _canon(fid, n)
                           for n in range(last_n, last_n + 3)), \
                    (fid, last_n, g.content[:60])
            assert requests.get(f"http://127.0.0.1:{vport}/status",
                                timeout=10).json()["NativeDataPlane"]
        finally:
            _stop(proc2, tmp_path / "second.log")
        _assert_no_jax(_modules(tmp_path, "second"))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        master.stop()
        rpc.reset_channels()


@pytest.mark.parametrize("plane", ["default", "on", "off"])
def test_volume_serves_from_the_plane_by_default(tmp_path, plane):
    port = pick_port()
    args = ["volume", "-ip", "127.0.0.1", "-port", str(port), "-mserver",
            f"127.0.0.1:{pick_port((port,))}", "-dir", str(tmp_path),
            "-coder", "cpu"]
    if plane != "default":
        args += ["-nativeDataPlane", plane]
    proc = _spawn(args, tmp_path, "volume")
    try:
        wait_http(port, "/status", proc, log=str(tmp_path / "volume.log"))
        r = requests.get(f"http://127.0.0.1:{port}/status", timeout=10,
                         allow_redirects=False)
        on = plane != "off"
        assert r.status_code == (307 if on else 200)
        st = requests.get(f"http://127.0.0.1:{port}/status",
                          timeout=10).json()
        assert st["NativeDataPlane"] is on
        log = (tmp_path / "volume.log").read_text()
        assert ("native data plane, admin :" in log) is on
        assert ("python data plane" in log) is not on
    finally:
        _stop(proc, tmp_path / "volume.log")
    mods = _modules(tmp_path, "volume")
    if plane == "off":
        assert "seaweedfs_tpu_torch.native.dataplane" not in mods
    else:
        _assert_no_jax(mods)


def test_server_and_its_filer_serve_from_the_planes_by_default(tmp_path):
    mport = pick_port()
    vport = pick_port((mport,))
    fport = pick_port((mport, vport))
    proc = _spawn(["server", "-dir", str(tmp_path), "-ip", "127.0.0.1",
                   "-master.port", str(mport), "-volume.port", str(vport),
                   "-filer", "-filer.port", str(fport), "-coder", "cpu"],
                  tmp_path, "server")
    try:
        wait_http(fport, "/status", proc, log=str(tmp_path / "server.log"))
        st = requests.get(f"http://127.0.0.1:{vport}/status",
                          timeout=10).json()
        assert st["NativeDataPlane"] is True
        fst = requests.get(f"http://127.0.0.1:{fport}/status",
                           timeout=10).json()
        assert fst["NativeHotPlane"] is not None
        url = f"http://127.0.0.1:{fport}/buckets/b/x.bin"
        deadline = time.time() + 60
        while True:  # the first PUTs may precede the plane's fid lease
            assert requests.put(url, data=b"hot" * 99,
                                timeout=30).status_code == 201
            if requests.get(f"http://127.0.0.1:{fport}/status",
                            timeout=10).json()["NativeHotPlane"][
                    "native_puts"]:
                break
            assert time.time() < deadline, "the hot plane took no PUT"
            time.sleep(0.05)
        assert requests.get(url, timeout=30).content == b"hot" * 99
    finally:
        _stop(proc, tmp_path / "server.log")
    _assert_no_jax(_modules(tmp_path, "server"))


def test_on_fails_at_start_with_the_compiler_error(tmp_path, monkeypatch):
    """`-nativeDataPlane on` where the plane cannot build: no server, and
    the message carries g++'s own error; `auto` keeps the Python plane."""
    from seaweedfs_tpu_torch import command
    from seaweedfs_tpu_torch.native import dataplane

    bad = tmp_path / "dataplane.cpp"
    bad.write_text("#error no plane here\n")
    monkeypatch.setattr(dataplane, "_SRC", bad)
    monkeypatch.setattr(dataplane, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(dataplane, "_lib", None)
    with pytest.raises(SystemExit) as e:
        command._use_native_plane("volume", "on")
    assert "-nativeDataPlane on" in str(e.value.code)
    assert "no plane here" in str(e.value.code)
    assert command._use_native_plane("volume", "auto") is False
    assert command._use_native_plane("volume", "off") is False
    port = pick_port()
    with pytest.raises(SystemExit) as e:
        command.main(["volume", "-port", str(port), "-dir", str(tmp_path),
                      "-coder", "cpu", "-nativeDataPlane", "on"])
    assert "no plane here" in str(e.value.code)
