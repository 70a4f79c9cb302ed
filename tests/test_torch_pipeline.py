"""The port's EC file lifecycle against the JAX package's, on the CPU:
write_ec_files -> write_sorted_file_from_idx -> rebuild_ec_files ->
EcVolume degraded reads on a small seeded volume, with small blocks as
tests/test_ec_pipeline.py uses. The JAX side runs RSCodecJax; the port
runs RSCodecTorch on the CPU (both kernel formulations, through their
plain versions) and its numpy cpu coder. Shard sha256s, .ecx bytes and
needle bytes must be identical (tolerance 0)."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops.rs_jax import RSCodecJax
from seaweedfs_tpu.storage import ec_files as ref_ec_files
from seaweedfs_tpu.storage import ec_volume as ref_ec_volume
from seaweedfs_tpu.storage.ec_locate import Geometry as RefGeometry
from seaweedfs_tpu_torch.models.coder import new_coder
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
from seaweedfs_tpu_torch.storage import ec_files, ec_volume, idx, types
from seaweedfs_tpu_torch.storage.ec_locate import Geometry, locate_data

LARGE, SMALL = 10000, 100
LOST = (0, 5, 13)
DEGRADED = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs beside other
    workers' timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_volume(base: str, n_needles: int = 60, seed: int = 0) -> list:
    """.dat of an 8-byte superblock then padded opaque needle records, and
    its .idx (the layout of tests/test_ec_pipeline.py's synthetic volume,
    sized past one large row so both block sizes appear)."""
    rng = np.random.default_rng(seed)
    dat = bytearray(b"\x03" + bytes(7))
    entries = []
    for i in range(1, n_needles + 1):
        size = int(rng.integers(1, 4000))
        offset = len(dat)
        dat += rng.integers(0, 256, types.actual_size(size)).astype(
            np.uint8).tobytes()
        entries.append((i, offset, size))
    with open(base + ".dat", "wb") as f:
        f.write(bytes(dat))
    ids = np.array([e[0] for e in entries], np.uint64)
    offs = np.array([types.offset_to_stored(e[1]) for e in entries],
                    np.uint32)
    sizes = np.array([e[2] for e in entries], np.int32)
    with open(base + ".idx", "wb") as f:
        f.write(idx.pack_index_arrays(ids, offs, sizes))
    return entries


def _hashes(base: str, total: int) -> list[str]:
    out = []
    for i in range(total):
        with open(f"{base}.ec{i:02d}", "rb") as f:
            out.append(hashlib.sha256(f.read()).hexdigest())
    return out


def _read_all(vol, entries) -> list[bytes]:
    return [vol.read_needle_blob(nid) for nid, _, _ in entries]


@pytest.fixture(scope="module", params=["", "lrc_10_2_2"])
def reference(request, tmp_path_factory):
    """The JAX package's lifecycle on one volume, run once per code."""
    code = request.param
    d = tmp_path_factory.mktemp("ref")
    base = str(d / "1")
    entries = _make_volume(base)
    geo = RefGeometry(large_block=LARGE, small_block=SMALL, code=code)
    coder = RSCodecJax(10, 4, geometry=code or None)
    ref_ec_files.write_ec_files(base, coder, geo)
    ref_ec_files.write_sorted_file_from_idx(base)
    encoded = _hashes(base, 14)
    with open(base + ".ecx", "rb") as f:
        ecx = f.read()
    for i in LOST:
        os.remove(f"{base}.ec{i:02d}")
    rebuilt = ref_ec_files.rebuild_ec_files(base, coder, geo)
    after = _hashes(base, 14)
    os.remove(f"{base}.ec{DEGRADED:02d}")
    vol = ref_ec_volume.EcVolume(base, coder, geo=geo)
    try:
        blobs = _read_all(vol, entries)
    finally:
        vol.close()
    with open(base + ".dat", "rb") as f:
        dat = f.read()
    return dict(code=code, entries=entries, encoded=encoded, ecx=ecx,
                rebuilt=rebuilt, after=after, blobs=blobs, dat=dat)


def _port_coder(kind: str, code: str, monkeypatch):
    if kind == "cpu":
        return new_coder(10, 4, backend="cpu", geometry=code or None)
    monkeypatch.setenv("SEAWEEDFS_TORCH_KERNEL", kind)
    return RSCodecTorch(10, 4, geometry=code or None, device="cpu")


@pytest.mark.parametrize("kind", ["xor", "bits", "cpu"])
def test_lifecycle_matches_jax_package(reference, kind, tmp_path,
                                       monkeypatch):
    code = reference["code"]
    base = str(tmp_path / "1")
    entries = _make_volume(base)
    assert entries == reference["entries"]
    geo = Geometry(large_block=LARGE, small_block=SMALL, code=code)
    coder = _port_coder(kind, code, monkeypatch)

    stats = ec_files.write_ec_files(base, coder, geo)
    ec_files.write_sorted_file_from_idx(base)
    assert stats.bytes >= os.path.getsize(base + ".dat")
    assert _hashes(base, 14) == reference["encoded"]
    with open(base + ".ecx", "rb") as f:
        assert f.read() == reference["ecx"]

    for i in LOST:
        os.remove(f"{base}.ec{i:02d}")
    rstats: dict = {}
    rebuilt = ec_files.rebuild_ec_files(base, coder, geo, stats=rstats)
    assert rebuilt == reference["rebuilt"] == list(LOST)
    assert _hashes(base, 14) == reference["after"] == reference["encoded"]
    assert rstats["geometry"] == geo.code_name
    assert rstats["survivor_bytes_read"] == \
        rstats["survivor_shards"] * os.path.getsize(f"{base}.ec01")

    os.remove(f"{base}.ec{DEGRADED:02d}")
    vol = ec_volume.EcVolume(base, coder, geo=geo)
    try:
        degraded = 0
        for (nid, off, size), want in zip(entries, reference["blobs"]):
            got = vol.read_needle_blob(nid)
            length = types.actual_size(size)
            assert got == want == reference["dat"][off:off + length]
            shards = {iv.to_shard_id_and_offset(geo)[0] for iv in
                      locate_data(geo, vol.dat_size_estimate, off, length)}
            degraded += DEGRADED in shards
        assert degraded > 0  # some reads went through the reconstruct path
    finally:
        vol.close()


def test_rebuild_of_a_single_lrc_loss_reads_its_local_group(tmp_path):
    base = str(tmp_path / "1")
    _make_volume(base, n_needles=20, seed=3)
    geo = Geometry(large_block=LARGE, small_block=SMALL, code="lrc_10_2_2")
    coder = RSCodecTorch(10, 4, geometry="lrc_10_2_2", device="cpu")
    ec_files.write_ec_files(base, coder, geo)
    before = _hashes(base, 14)
    os.remove(f"{base}.ec02")
    rstats: dict = {}
    assert ec_files.rebuild_ec_files(base, coder, geo, stats=rstats) == [2]
    assert rstats["survivor_shards"] == 5
    assert _hashes(base, 14) == before


def test_rebuild_refuses_too_many_losses(tmp_path):
    base = str(tmp_path / "1")
    _make_volume(base, n_needles=10, seed=4)
    geo = Geometry(large_block=LARGE, small_block=SMALL)
    coder = new_coder(backend="cpu")
    ec_files.write_ec_files(base, coder, geo)
    for i in range(5):
        os.remove(f"{base}.ec{i:02d}")
    with pytest.raises(ValueError, match="too many shards missing"):
        ec_files.rebuild_ec_files(base, coder, geo)


def test_ecx_delete_and_volume_info(tmp_path):
    base = str(tmp_path / "1")
    entries = _make_volume(base, n_needles=12, seed=5)
    geo = Geometry(large_block=LARGE, small_block=SMALL)
    coder = new_coder(backend="cpu")
    ec_files.write_ec_files(base, coder, geo)
    ec_files.write_sorted_file_from_idx(base)
    with open(base + ".vif", "w") as f:
        json.dump({"largeBlock": LARGE, "smallBlock": SMALL, "version": 3}, f)
    assert ec_volume.load_volume_info(base)["largeBlock"] == LARGE
    vol = ec_volume.EcVolume(base, coder)  # geometry from the .vif
    try:
        nid = entries[4][0]
        assert vol.read_needle_blob(nid)
        vol.delete_needle(nid)
        with pytest.raises(ec_volume.NotFoundError):
            vol.read_needle_blob(nid)
        with pytest.raises(ec_volume.NotFoundError):
            vol.find_needle(10_000)
    finally:
        vol.close()
    with open(base + ".ecj", "rb") as f:
        assert f.read() == entries[4][0].to_bytes(8, "big")
