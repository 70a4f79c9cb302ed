"""The port's Store against the JAX package's, on the CPU.

The volume server's storage lifecycle runs through both packages on the
same seeded needles: Store.write_needle into a volume, then the ec.encode
handlers' sequence (mark read-only, write_ec_files through
Store.coder_for, write_sorted_file_from_idx, save_volume_info,
mount_ec_shards, delete_volume), reads through Store.find_ec_volume with 3
shards lost, rebuild_ec_files + rebuild_ecx_file, and a restart (close,
then a new Store on the same directory). The reference Store runs the JAX
package's numpy coder; the port's runs RSCodecTorch on the CPU (K1 and K2
through their plain versions) and its own numpy coder, for rs_10_4 and
lrc_10_2_2. The .dat, .idx, .ec00-.ec13, .ecx and .vif must be
byte-identical, and the reads, the rebuilt shards and the restarted
Store's reads equal (tolerance 0). Clocks are pinned the same way in both
packages' needle modules and both Stores carry the same server address, so
needle timestamps and replica-epoch tags are equal too. One test holds the
port alone: a heartbeat taken during a vacuum commit still reports the
volume, where the reference's skips it."""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from seaweedfs_tpu.models.coder import new_coder as ref_new_coder
from seaweedfs_tpu.storage import ec_files as ref_ec_files
from seaweedfs_tpu.storage import ec_volume as ref_ec_volume
from seaweedfs_tpu.storage import needle as ref_needle
from seaweedfs_tpu.storage import store as ref_store
from seaweedfs_tpu.storage.ec_locate import Geometry as RefGeometry
from seaweedfs_tpu_torch.models.coder import new_coder
from seaweedfs_tpu_torch.ops import dispatch
from seaweedfs_tpu_torch.ops.rs_cpu import RSCodecCPU
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
from seaweedfs_tpu_torch.storage import ec_files, ec_volume, needle, recovery
from seaweedfs_tpu_torch.storage import store
from seaweedfs_tpu_torch.storage.ec_locate import Geometry
from seaweedfs_tpu_torch.storage.errors import NotFoundError
from seaweedfs_tpu_torch.utils import locks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = dict(store=ref_store, needle=ref_needle, ec_files=ref_ec_files,
           ec_volume=ref_ec_volume, Geometry=RefGeometry)
PORT = dict(store=store, needle=needle, ec_files=ec_files,
            ec_volume=ec_volume, Geometry=Geometry)
LARGE, SMALL = 10000, 100
LOST = (0, 5, 13)
VID = 7
ADDR = dict(ip="127.0.0.1", port=8080)
N_NEEDLES = 60
DELETED = 9
OVERWRITTEN = 4


class Clock:
    """A stand-in for the `time` module a needle module reads."""

    def __init__(self):
        self.ns = 1_700_000_000_000_000_000

    def time_ns(self) -> int:
        self.ns += 1000
        return self.ns

    def time(self) -> float:
        return 1_700_000_100.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _needles(mods) -> list:
    """Seeded needles of 1-4000 bytes, some with a name, mime or pairs."""
    rng = np.random.default_rng(17)
    out = []
    for i in range(1, N_NEEDLES + 1):
        data = rng.integers(0, 256, int(rng.integers(1, 4000)),
                            dtype=np.uint8).tobytes()
        kw = {}
        if i % 3 == 0:
            kw["name"] = f"file-{i}.bin".encode()
        if i % 5 == 0:
            kw["mime"] = b"application/octet-stream"
        if i % 7 == 0:
            kw["pairs"] = b'{"k":"v"}'
        out.append(mods["needle"].Needle.create(
            i, int(rng.integers(1, 1 << 32)), data,
            last_modified=1_700_000_000, **kw))
    return out


def _read(ev, mods, nid):
    """A needle through the EC volume as the server's EC read does it."""
    _, size = ev.find_needle(nid)
    n = mods["needle"].Needle.from_bytes(ev.read_needle_blob(nid),
                                         ev.version, expected_size=size)
    return (n.id, n.cookie, n.data, n.name, n.mime, n.pairs, n.append_at_ns)


def _lifecycle(mods, d: str, coder, restart_coder, code: str) -> dict:
    """The whole store lifecycle on one volume; -> the files and reads."""
    geo = mods["Geometry"](large_block=LARGE, small_block=SMALL, code=code)
    st = mods["store"].Store([d], coder=coder, **ADDR)
    v = st.add_volume(VID)
    needles = _needles(mods)
    for n in needles:
        st.write_needle(VID, n)
    st.write_needle(VID, mods["needle"].Needle.create(
        OVERWRITTEN, needles[OVERWRITTEN - 1].cookie, b"rewritten",
        last_modified=1_700_000_000))
    st.delete_needle(VID, DELETED)
    v.read_only = True
    base = v.file_name()
    mods["ec_files"].write_ec_files(base, st.coder_for(geo), geo)
    mods["ec_files"].write_sorted_file_from_idx(base)
    mods["ec_volume"].save_volume_info(base, {
        "version": v.version,
        "dataShards": geo.data_shards, "parityShards": geo.parity_shards,
        "largeBlock": geo.large_block, "smallBlock": geo.small_block,
        "geometry": geo.code_name,
    })
    files = {}
    for ext in [".dat", ".idx", ".ecx", ".vif"] + [
            f".ec{i:02d}" for i in range(geo.total_shards)]:
        with open(base + ext, "rb") as f:
            files[ext] = f.read()
    hb = st.collect_heartbeat().SerializeToString(deterministic=True)
    st.mount_ec_shards(VID, "", list(range(geo.total_shards)))
    st.delete_volume(VID)
    assert not os.path.exists(base + ".dat")
    assert not os.path.exists(base + ".idx")

    for i in LOST:
        os.remove(geo.shard_file_name(base, i))
    st.mount_ec_shards(VID, "", [])
    ev = st.find_ec_volume(VID)
    assert sorted(ev.shard_files) == sorted(
        set(range(geo.total_shards)) - set(LOST))
    live = [n.id for n in needles if n.id != DELETED]
    reads = [_read(ev, mods, nid) for nid in live]
    with pytest.raises(KeyError):
        ev.read_needle_blob(DELETED)

    rebuilt = mods["ec_files"].rebuild_ec_files(base, st.coder_for(geo),
                                                geo)
    mods["ec_volume"].rebuild_ecx_file(base)
    after = {}
    for i in range(geo.total_shards):
        with open(geo.shard_file_name(base, i), "rb") as f:
            after[i] = hashlib.sha256(f.read()).hexdigest()
    st.mount_ec_shards(VID, "", list(LOST))
    st.close()

    st = mods["store"].Store([d], coder=restart_coder, **ADDR)
    try:
        assert not st.recovery_report.unclean
        assert st.find_volume(VID) is None
        ev = st.find_ec_volume(VID)
        reread = [_read(ev, mods, nid) for nid in live]
        hb_after = st.collect_heartbeat().SerializeToString(
            deterministic=True)
    finally:
        st.close()
    return dict(files=files, reads=reads, rebuilt=rebuilt, after=after,
                reread=reread, hb=hb, hb_after=hb_after,
                listing=sorted(os.listdir(d)))


def _pin_both_clocks(mp):
    for mod in (ref_needle, needle):
        mp.setattr(mod, "time", Clock())


@pytest.fixture(scope="module", params=["rs_10_4", "lrc_10_2_2"])
def reference(request, tmp_path_factory):
    """The JAX package's Store lifecycle, once per code geometry; its
    store coder speaks that geometry (coder_for returns it)."""
    code = request.param
    d = str(tmp_path_factory.mktemp("ref"))
    with pytest.MonkeyPatch.context() as mp:
        _pin_both_clocks(mp)
        got = _lifecycle(REF, d, ref_new_coder(10, 4, "cpu", geometry=code),
                         ref_new_coder(10, 4, "cpu", geometry=code), code)
    return dict(code=code, **got)


def _port_coder(kind: str):
    if kind == "cpu":
        return new_coder(10, 4, backend="cpu")
    return RSCodecTorch(10, 4, device="cpu")


@pytest.mark.parametrize("kind", ["xor", "bits", "cpu"])
def test_store_lifecycle_matches_jax_package(reference, kind, tmp_path,
                                             monkeypatch):
    """The port's Store runs the default rs_10_4 coder of `kind`; an
    lrc_10_2_2 volume gets its coder from Store.coder_for, on the same
    backend and device."""
    if kind != "cpu":
        monkeypatch.setenv("SEAWEEDFS_TORCH_KERNEL", kind)
    _pin_both_clocks(monkeypatch)
    got = _lifecycle(PORT, str(tmp_path), _port_coder(kind),
                     _port_coder(kind), reference["code"])
    for ext, blob in reference["files"].items():
        assert got["files"][ext] == blob, f"{ext} differs"
    assert got["reads"] == reference["reads"]
    assert got["rebuilt"] == reference["rebuilt"] == list(LOST)
    assert got["after"] == reference["after"]
    assert got["after"] == {
        i: hashlib.sha256(got["files"][f".ec{i:02d}"]).hexdigest()
        for i in range(14)}
    assert got["reread"] == reference["reread"] == got["reads"]
    assert got["hb"] == reference["hb"]
    assert got["hb_after"] == reference["hb_after"]
    assert got["listing"] == reference["listing"]
    # the overwrite and the needles with names, mimes and pairs read back
    by_id = {r[0]: r for r in got["reads"]}
    assert by_id[OVERWRITTEN][2] == b"rewritten"
    assert by_id[15][3] == b"file-15.bin" and by_id[15][4]
    assert by_id[14][5].startswith(b'{"k":"v"}')


# -- the Store's surface ------------------------------------------------------


def test_coder_for_keeps_the_store_coders_backend_and_device(tmp_path,
                                                             monkeypatch):
    """Mirrors tests/test_geometry.py's coder_for test: the default
    geometry reuses the store coder, another is built once and cached, on
    the store coder's own backend and device."""
    rs = Geometry(large_block=LARGE, small_block=SMALL)
    lrc = Geometry(large_block=LARGE, small_block=SMALL, code="lrc_10_2_2")
    st = store.Store([str(tmp_path / "a")],
                     coder=RSCodecTorch(10, 4, device="cpu"))
    c = st.coder_for(lrc)
    assert st.coder_for(rs) is st.coder
    assert isinstance(c, RSCodecTorch) and c.device.type == "cpu"
    assert c.geometry_id == "lrc_10_2_2" and st.coder_for(lrc) is c
    st.close()

    host = new_coder(backend="cpu")
    st = store.Store([str(tmp_path / "b")], coder=host)
    c = st.coder_for(lrc)
    assert type(c) is RSCodecCPU and c.geometry_id == "lrc_10_2_2"
    assert c.backend_reason == host.backend_reason == "cpu_explicit"
    assert st.coder_for(lrc) is c and st.coder_for(rs) is host
    st.close()


def test_store_without_a_coder_asks_for_the_card(tmp_path, monkeypatch):
    """No coder given: the store takes new_coder(), which runs on cuda and
    raises where no card is visible; there is no silent CPU coder."""
    monkeypatch.delenv("SEAWEEDFS_TORCH_CODER", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store.Store([str(tmp_path)])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    st = store.Store([str(tmp_path)])
    assert isinstance(st.coder, RSCodecTorch) and st.coder.device.type == \
        "cuda"
    lrc = Geometry(code="lrc_10_2_2")
    assert st.coder_for(lrc).device.type == "cuda"
    st.close()


def _collections(mods, d):
    st = mods["store"].Store([d], coder=object(), **ADDR)
    for vid, col in ((1, "pics"), (2, "docs"), (3, "pics"), (4, "")):
        st.add_volume(vid, collection=col, replication="001", ttl="3d")
        st.write_needle(vid, mods["needle"].Needle.create(
            vid, 5, b"x" * (10 * vid), last_modified=1_700_000_000))
    st.delete_collection("pics")
    try:
        st.delete_volume(2, only_empty=True)
    except ValueError as e:
        refused = str(e)
    st.delete_volume(4)
    try:
        st.delete_volume(4)
    except KeyError as e:
        missing = type(e).__name__
    out = dict(
        left=sorted(os.listdir(d)),
        volumes=[vid for vid in range(1, 5) if st.has_volume(vid)],
        new=[m.SerializeToString() for m in st.new_volumes],
        deleted=[m.SerializeToString() for m in st.deleted_volumes],
        hb=st.collect_heartbeat().SerializeToString(deterministic=True),
        refused=refused, missing=missing)
    st.close()
    return out


def test_collections_deltas_and_heartbeat_match_reference(tmp_path,
                                                          monkeypatch):
    _pin_both_clocks(monkeypatch)
    os.makedirs(tmp_path / "ref")
    os.makedirs(tmp_path / "port")
    want = _collections(REF, str(tmp_path / "ref"))
    got = _collections(PORT, str(tmp_path / "port"))
    assert got == want
    assert got["volumes"] == [2] and got["missing"] == "NotFoundError"


def test_restart_after_an_unclean_stop_runs_the_ladder(tmp_path):
    """A store that never closed leaves the dirty marker down; the next
    Store repairs the torn volume before opening it."""
    d = str(tmp_path)
    st = store.Store([d], coder=new_coder(backend="cpu"), **ADDR)
    v = st.add_volume(3)
    for i in range(1, 4):
        st.write_needle(3, needle.Needle.create(i, 9, bytes([i]) * 100,
                                                last_modified=1))
    end = v.data_size()
    v.close()  # the process "dies": no Store.close()
    with open(os.path.join(d, "3.dat"), "r+b") as f:
        f.truncate(end - 5)
    assert recovery.was_unclean(d)
    st = store.Store([d], coder=new_coder(backend="cpu"), **ADDR)
    try:
        rep = st.recovery_report
        assert rep.unclean and rep.ran and rep.suspects == [3]
        assert rep.idx_entries_dropped == 1
        assert st.read_needle(3, 2).data == b"\x02" * 100
        with pytest.raises(NotFoundError):
            st.read_needle(3, 3)
        assert st.epoch_stamper.incarnation == 2
    finally:
        st.close()
    assert not recovery.was_unclean(d)


# -- the lock witness ---------------------------------------------------------


def test_lock_witness_sees_store_and_dispatch_order(tmp_path, monkeypatch):
    """Needle writes and an EC encode through a port Store with
    SWFS_LOCK_WITNESS=1 (armed for the suite by tests/conftest.py): no
    violation, and the edges volume.mu -> volume.gc_cv and dispatch.mu ->
    dispatch.lane_cv were seen."""
    assert locks.witness_enabled()
    monkeypatch.setenv("SEAWEEDFS_TORCH_KERNEL", "xor")
    st = store.Store([str(tmp_path)], coder=RSCodecTorch(10, 4,
                                                         device="cpu"))
    try:
        v = st.add_volume(1)
        assert isinstance(v._lock, locks.WitnessRLock)
        for n in _needles(PORT)[:20]:
            st.write_needle(1, n)
        v.read_only = True
        geo = Geometry(large_block=LARGE, small_block=SMALL)
        coder = st.coder_for(geo)
        ec_files.write_ec_files(v.file_name(), coder, geo)
        assert coder._ec_dispatch_sched is dispatch.scheduler_for(coder)
    finally:
        st.close()
    assert locks.violations() == []
    edges = locks.observed_edges()
    assert "volume.gc_cv" in edges.get("volume.mu", set())
    assert "dispatch.lane_cv" in edges.get("dispatch.mu", set())


# -- isolation ----------------------------------------------------------------


def test_store_runs_without_jax_or_the_jax_package(tmp_path):
    """A fresh interpreter imports the port's Store, writes needles and
    runs one CPU encode and a degraded read: no jax, no seaweedfs_tpu."""
    code = f"""
import os, sys
from seaweedfs_tpu_torch.models.coder import new_coder
from seaweedfs_tpu_torch.storage import ec_files
from seaweedfs_tpu_torch.storage.ec_locate import Geometry
from seaweedfs_tpu_torch.storage.ec_volume import save_volume_info
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
d = {str(tmp_path)!r}
st = Store([d], coder=new_coder(backend="cpu"))
v = st.add_volume(1)
for i in range(1, 30):
    st.write_needle(1, Needle.create(i, 7, bytes([i]) * (97 * i)))
v.read_only = True
geo = Geometry(large_block={LARGE}, small_block={SMALL})
ec_files.write_ec_files(v.file_name(), st.coder_for(geo), geo)
ec_files.write_sorted_file_from_idx(v.file_name())
save_volume_info(v.file_name(), {{"version": v.version,
                                  "largeBlock": {LARGE},
                                  "smallBlock": {SMALL}}})
os.remove(v.file_name() + ".ec02")
st.mount_ec_shards(1, "", [])
ev = st.find_ec_volume(1)
assert Needle.from_bytes(ev.read_needle_blob(17)).data == bytes([17]) * 1649
st.close()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "seaweedfs_tpu"))
assert not bad, bad
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


# -- the heartbeat during a vacuum commit ------------------------------------------


def test_a_heartbeat_during_a_vacuum_commit_still_reports_the_volume(
        tmp_path, monkeypatch):
    """commit_compact swaps .dat and .idx with both closed. A full-state
    heartbeat taken in that window waits for the commit and reports the
    volume at its new revision; one that skipped it would unregister the
    replica from the master's layout until the next pulse."""
    import threading

    from seaweedfs_tpu_torch.utils import failpoint

    st = store.Store([str(tmp_path)], coder=object(), **ADDR)
    try:
        v = st.add_volume(3, replication="001")
        for i in range(1, 41):
            st.write_needle(3, needle.Needle.create(i, 9, bytes([i]) * 300,
                                                    last_modified=1))
        for i in range(1, 41, 4):
            st.delete_needle(3, i, None)
        inside, release = threading.Event(), threading.Event()

        def pause_between_the_renames(name, *, ctx=""):
            if name == "volume.vacuum.commit":
                inside.set()
                release.wait(30)

        monkeypatch.setattr(failpoint, "fail", pause_between_the_renames)
        v.compact()
        commit = threading.Thread(target=v.commit_compact)
        commit.start()
        assert inside.wait(30)
        got = []
        beat = threading.Thread(
            target=lambda: got.append(st.collect_heartbeat()))
        beat.start()
        beat.join(0.5)  # inside the window: .dat and .idx are closed
        release.set()
        commit.join(30)
        beat.join(30)
        (hb,) = got
        assert [(m.id, m.compact_revision, m.file_count)
                for m in hb.volumes] == [(3, 1, 30)]
    finally:
        st.close()
