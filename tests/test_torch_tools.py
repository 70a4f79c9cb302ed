"""The port's offline tools and scaffold against the JAX package's, on the
CPU.

`fix` (rebuild `.idx` from `.dat`), `compact` (offline vacuum), `export`
(live needles to files) and `backup` (full, then incremental, from a live
volume server) run in both packages over the same seeded volume, with
both packages' needle clocks pinned to one fake clock, and must write
the same bytes (tolerance 0). `scaffold`, `autocomplete`,
`unautocomplete` and `update` print the reference's text. The tools also
run as processes of the port (`python -m seaweedfs_tpu_torch fix`, ...)
that import no JAX."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from seaweedfs_tpu import command as ref_command
from seaweedfs_tpu.command import tools as ref_tools
from seaweedfs_tpu.command.scaffold import TEMPLATES as REF_TEMPLATES
from seaweedfs_tpu.pb import rpc as ref_rpc
from seaweedfs_tpu.storage import needle as ref_needle
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu_torch import command
from seaweedfs_tpu_torch.command import tools
from seaweedfs_tpu_torch.command.scaffold import TEMPLATES
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.server import volume as port_server
from seaweedfs_tpu_torch.storage import needle
from seaweedfs_tpu_torch.storage import volume
from tests.test_torch_native_dataplane import REPO, pick_port, wait_http

VID = 3
PKGS = {"ref": (ref_volume, ref_needle, ref_tools),
        "port": (volume, needle, tools)}


class Clock:
    """The `time` a needle module reads: one fake clock per package."""

    def __init__(self):
        self.ns = 1_700_000_000_000_000_000

    def time_ns(self) -> int:
        self.ns += 1000
        return self.ns

    def time(self) -> float:
        return 1_700_000_100.0


@pytest.fixture()
def clocks(monkeypatch):
    for mod in (ref_needle, needle):
        monkeypatch.setattr(mod, "time", Clock())


def _needles(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(1, n + 1):
        data = rng.integers(0, 256, int(rng.integers(1, 3000)),
                            dtype=np.uint8).tobytes()
        name = f"dir{i % 3}/file{i}.bin".encode() if i % 4 else b""
        out.append((i, int(rng.integers(1, 1 << 32)), data, name))
    return out


def _fill(name: str, d: str, seed: int = 11, deletes=(4, 9, 17)) -> None:
    vol_mod, needle_mod, _ = PKGS[name]
    v = vol_mod.Volume(d, "", VID)
    for nid, cookie, data, fname in _needles(seed):
        v.write_needle(needle_mod.Needle.create(nid, cookie, data,
                                                name=fname))
    for nid in deletes:
        v.delete_needle(nid)
    v.close()


def _tree(d: str) -> dict:
    """sha256 of every file under `d`; a scrub cursor (`.scb`, written by
    a compaction) is compared without the wall-clock time it records."""
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                body = fh.read()
            if f.endswith(".scb"):
                cursor = json.loads(body)
                cursor.pop("updated")
                body = json.dumps(cursor, sort_keys=True).encode()
            out[os.path.relpath(p, d)] = hashlib.sha256(body).hexdigest()
    return out


def _volumes(tmp_path, deletes=(4, 9, 17)) -> dict:
    """One seeded volume written by each package (the same bytes)."""
    dirs = {}
    for name in PKGS:
        d = str(tmp_path / name)
        os.makedirs(d)
        _fill(name, d, deletes=deletes)
        dirs[name] = d
    assert _tree(dirs["port"]) == _tree(dirs["ref"])
    return dirs


@pytest.mark.parametrize("deletes", [(), (4, 9, 17)], ids=["live", "deleted"])
def test_fix_writes_the_references_idx(tmp_path, clocks, deletes):
    """`fix` of a copy whose `.idx` was deleted: both packages write the
    original `.idx` again, deletion markers included."""
    dirs = _volumes(tmp_path, deletes)
    with open(os.path.join(dirs["ref"], f"{VID}.idx"), "rb") as f:
        original = f.read()
    for name, d in dirs.items():
        os.remove(os.path.join(d, f"{VID}.idx"))
        PKGS[name][2].run_fix(SimpleNamespace(dir=d, volumeId=VID,
                                              collection=""))
    assert _tree(dirs["port"]) == _tree(dirs["ref"])
    with open(os.path.join(dirs["port"], f"{VID}.idx"), "rb") as f:
        fixed = f.read()
    assert fixed == original
    v = volume.Volume(dirs["port"], "", VID)
    try:
        for nid, _, data, _ in _needles(11):
            if nid not in deletes:
                assert v.read_needle(nid).data == data
    finally:
        v.close()


def test_compact_writes_the_references_files(tmp_path, clocks):
    dirs = _volumes(tmp_path)
    for name, d in dirs.items():
        PKGS[name][2].run_compact(SimpleNamespace(dir=d, volumeId=VID,
                                                  collection=""))
    assert _tree(dirs["port"]) == _tree(dirs["ref"])
    assert os.path.getsize(os.path.join(dirs["port"], f"{VID}.dat")) < \
        sum(len(x[2]) for x in _needles(11))


def test_export_writes_the_references_files(tmp_path, clocks):
    """Every live needle lands in the archive, under its name or its id,
    and the trees of both packages are equal."""
    dirs = _volumes(tmp_path)
    outs = {}
    for name, d in dirs.items():
        outs[name] = str(tmp_path / f"out-{name}")
        PKGS[name][2].run_export(SimpleNamespace(
            dir=d, volumeId=VID, collection="", output=outs[name]))
    assert _tree(outs["port"]) == _tree(outs["ref"])
    live = [x for x in _needles(11) if x[0] not in (4, 9, 17)]
    assert len(_tree(outs["port"])) == len(live)
    for nid, _, data, fname in live:
        p = os.path.join(outs["port"], fname.decode() if fname
                         else f"{nid:x}")
        with open(p, "rb") as f:
            assert f.read() == data


@pytest.fixture()
def live_server(tmp_path):
    """A masterless port volume server with the seeded volume."""
    d = tmp_path / "live"
    d.mkdir()
    _fill("port", str(d), deletes=(4,))
    port = pick_port()
    srv = port_server.VolumeServer(
        directories=[str(d)], master=f"localhost:{pick_port((port,))}",
        ip="127.0.0.1", port=port, coder=RSCodecTorch(10, 4, device="cpu"))
    srv.start()
    wait_http(port, "/status")
    rpc.reset_channels()
    ref_rpc.reset_channels()
    yield srv, f"127.0.0.1:{port}"
    srv.stop()
    rpc.reset_channels()
    ref_rpc.reset_channels()


def test_backup_full_then_incremental_writes_the_references_files(
        tmp_path, clocks, live_server, monkeypatch):
    """`backup` pulls the whole volume, then only what was appended
    since: both packages' copies are equal, and equal to the server's
    files after the full pull."""
    srv, addr = live_server
    dirs = {name: str(tmp_path / f"b-{name}") for name in PKGS}
    for name, d in dirs.items():
        assert PKGS[name][2].run_backup(SimpleNamespace(
            master="", server=addr, volumeId=VID, dir=d)) == 0
    src = {k: v for k, v in _tree(srv.store.locations[0].directory).items()
           if k.endswith((".dat", ".idx"))}
    assert _tree(dirs["port"]) == _tree(dirs["ref"])
    assert {k: v for k, v in _tree(dirs["port"]).items()
            if k.endswith((".dat", ".idx"))} == src
    v = srv.store.find_volume(VID)
    for nid, cookie, data, _ in _needles(12, 10):
        v.write_needle(needle.Needle.create(100 + nid, cookie, data))
    v.delete_needle(9)
    for name, d in dirs.items():
        # the copy stamps each record it appends: from one clock state
        monkeypatch.setattr(PKGS[name][1], "time", Clock())
        assert PKGS[name][2].run_backup(SimpleNamespace(
            master="", server=addr, volumeId=VID, dir=d)) == 0
    assert _tree(dirs["port"]) == _tree(dirs["ref"])
    b = volume.Volume(dirs["port"], "", VID)
    try:
        for nid, _, data, _ in _needles(12, 10):
            assert b.read_needle(100 + nid).data == data
        assert b.file_count() == v.file_count()
    finally:
        b.close()


@pytest.mark.parametrize("config", sorted(REF_TEMPLATES))
def test_scaffold_prints_the_references_text(config, capsys):
    outs = []
    for mod in (ref_command, command):
        assert mod.main(["scaffold", "-config", config]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0] and outs[0].strip()
    assert TEMPLATES[config] == REF_TEMPLATES[config]


@pytest.mark.parametrize("cmd", ["autocomplete", "unautocomplete", "update"])
def test_the_shell_helpers_print_the_references_text(cmd, capsys):
    assert ref_command.main([cmd]) == 0
    want = capsys.readouterr().out
    assert command.main([cmd]) == 0
    assert capsys.readouterr().out == want and want


_WRAPPER = r"""
import runpy, sys
sys.argv = ["seaweedfs_tpu_torch"] + sys.argv[1:]
try:
    runpy.run_module("seaweedfs_tpu_torch", run_name="__main__")
finally:
    assert not any(m == "jax" or m.startswith(("jax.", "seaweedfs_tpu."))
                   for m in sys.modules), "the port imported JAX"
"""


def _cli(*argv) -> str:
    r = subprocess.run([sys.executable, "-c", _WRAPPER, *argv], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout


def test_the_tools_run_as_processes_without_jax(tmp_path):
    """fix, compact and export as `python -m seaweedfs_tpu_torch`
    processes over a volume the reference wrote."""
    d = str(tmp_path / "v")
    os.makedirs(d)
    _fill("ref", d)
    with open(os.path.join(d, f"{VID}.idx"), "rb") as f:
        idx = f.read()
    os.remove(os.path.join(d, f"{VID}.idx"))
    assert "records indexed" in _cli("fix", "-dir", d, "-volumeId",
                                     str(VID))
    with open(os.path.join(d, f"{VID}.idx"), "rb") as f:
        assert len(f.read()) >= len(idx)
    out = str(tmp_path / "out")
    assert "exported 37 files" in _cli("export", "-dir", d, "-volumeId",
                                       str(VID), "-o", out)
    shutil.rmtree(out)
    assert "compacted volume" in _cli("compact", "-dir", d, "-volumeId",
                                      str(VID))
