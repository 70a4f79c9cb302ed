"""The port's plain-volume layer against the JAX package's, on the CPU:
CRC-32C (the probe's choice, the pure-Python slice-by-8, the native g++
library, combine and the legacy transform), needle records, the Volume's
write/read/delete path with group commit, its torn-tail repair, the
recovery ladder and the digest-manifest readers it validates with. The
same seeded inputs go through both packages; bytes, fields and reports
must be equal (tolerance 0). Clocks are pinned the same way in both
packages' needle modules, so timestamps are equal too."""

import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest

from seaweedfs_tpu.scrub import digest as ref_digest
from seaweedfs_tpu.storage import crc as ref_crc
from seaweedfs_tpu.storage import needle as ref_needle
from seaweedfs_tpu.storage import recovery as ref_recovery
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu.storage.ttl import TTL as RefTTL
from seaweedfs_tpu.utils import failpoint as ref_failpoint
from seaweedfs_tpu_torch.scrub import digest
from seaweedfs_tpu_torch.storage import crc, needle, recovery, types, volume
from seaweedfs_tpu_torch.storage.errors import (CookieMismatch, DeletedError,
                                                NotFoundError)
from seaweedfs_tpu_torch.storage.ttl import TTL
from seaweedfs_tpu_torch.utils import failpoint

REF = dict(crc=ref_crc, needle=ref_needle, recovery=ref_recovery,
           volume=ref_volume, TTL=RefTTL, failpoint=ref_failpoint)
PORT = dict(crc=crc, needle=needle, recovery=recovery, volume=volume,
            TTL=TTL, failpoint=failpoint)
SIZES = [0, 1, 7, 8, 9, 63, 64, 4096, 100_003]


class Clock:
    """A stand-in for the `time` module a needle module reads: time_ns()
    steps by 1 us from a fixed start, time() is fixed."""

    def __init__(self):
        self.ns = 1_700_000_000_000_000_000

    def time_ns(self) -> int:
        self.ns += 1000
        return self.ns

    def time(self) -> float:
        return 1_700_000_100.0


@pytest.fixture
def pin_clocks(monkeypatch):
    """Both packages' needle modules on their own pinned clock."""
    for mod in (ref_needle, needle):
        monkeypatch.setattr(mod, "time", Clock())


def _buf(size: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed + size).integers(
        0, 256, size, dtype=np.uint8).tobytes()


# -- CRC-32C ------------------------------------------------------------------


@pytest.mark.parametrize("size", SIZES)
def test_crc_matches_reference(size):
    data = _buf(size)
    seed = 0x1234ABCD
    assert crc.crc32c(data) == ref_crc.crc32c(data)
    assert crc.crc32c(data, seed) == ref_crc.crc32c(data, seed)
    assert crc.crc32c_py(data) == ref_crc.crc32c_py(data) == \
        ref_crc.crc32c(data)
    assert crc.crc32c_py(data, seed) == ref_crc.crc32c(data, seed)
    c = crc.crc32c(data)
    assert crc.crc_value_legacy(c) == ref_crc.crc_value_legacy(c)
    head, tail = data[:size // 3], data[size // 3:]
    got = crc.crc32c_combine(crc.crc32c(head), crc.crc32c(tail), len(tail))
    assert got == ref_crc.crc32c_combine(ref_crc.crc32c(head),
                                         ref_crc.crc32c(tail), len(tail))
    assert got == ref_crc.crc32c(data)


@pytest.mark.parametrize("size", SIZES)
def test_native_crc_matches_reference(size):
    """The g++-built library (built on first call into ops/_build/)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native library cannot build")
    from seaweedfs_tpu_torch.ops import rs_native

    data = _buf(size, seed=5)
    assert rs_native.crc32c_native(data) == ref_crc.crc32c(data)
    assert rs_native.crc32c_native(data, 77) == ref_crc.crc32c(data, 77)
    arr = np.frombuffer(data, np.uint8)
    assert rs_native.crc32c_native(arr) == ref_crc.crc32c(data)
    assert rs_native.library_path().exists()
    assert rs_native.library_path().parent.name == "_build"


def _crc_without_google(monkeypatch):
    """A fresh copy of the port's crc module, probed as on a host without
    google_crc32c (the chip machine's case)."""
    monkeypatch.setitem(sys.modules, "google_crc32c", None)
    spec = importlib.util.spec_from_file_location(
        "seaweedfs_tpu_torch.storage._crc_probe", crc.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_crc_probe_order(monkeypatch):
    """google_crc32c first, then the native library, then pure Python."""
    try:
        import google_crc32c  # noqa: F401
        want = "google_crc32c"
    except ImportError:
        want = "native" if shutil.which("g++") else "python"
    assert crc.implementation() == want
    assert crc.crc32c(b"123456789") == 0xE3069283  # RFC 3720 vector
    probe = _crc_without_google(monkeypatch)
    assert probe.implementation() == ("native" if shutil.which("g++")
                                      else "python")
    assert probe.crc32c(b"123456789") == 0xE3069283


def test_crc_failed_build_falls_back_to_python(monkeypatch):
    """A native library that cannot build leaves crc32c on the pure-Python
    kernel, and implementation() names that kernel."""
    from seaweedfs_tpu_torch.ops import rs_native

    def no_compiler():
        raise FileNotFoundError("g++")

    monkeypatch.setattr(rs_native, "load_library", no_compiler)
    probe = _crc_without_google(monkeypatch)
    data = _buf(4099, seed=6)
    assert probe.crc32c(data, 77) == ref_crc.crc32c(data, 77)
    assert probe.implementation() == "python"


# -- needle records -----------------------------------------------------------


NEEDLE_CASES = {
    "v3_full": (types.VERSION3, dict(name=b"f.txt", mime=b"text/plain",
                                     pairs=b'{"a":"b"}', ttl="3h"), 110),
    "v3_ttl_only": (types.VERSION3, dict(ttl="5d"), 1),
    "v3_name_255": (types.VERSION3, dict(name=b"n" * 300), 4000),
    "v3_compressed_manifest": (types.VERSION3, dict(is_compressed=True,
                                                    is_chunk_manifest=True),
                               64),
    "v2_minimal": (types.VERSION2, {}, 1),
    "v2_mime_pairs": (types.VERSION2, dict(mime=b"image/png",
                                           pairs=b"x" * 1000), 9),
    "v3_empty": (types.VERSION3, {}, 0),
}


def _make(mods, case):
    version, kw, size = NEEDLE_CASES[case]
    kw = dict(kw)
    if "ttl" in kw:
        kw["ttl"] = mods["TTL"].parse(kw["ttl"])
    n = mods["needle"].Needle.create(0x1234, 0xDEADBEEF, _buf(size),
                                     last_modified=1_700_000_000, **kw)
    n.update_append_at_ns(41)
    return version, n


@pytest.mark.parametrize("case", sorted(NEEDLE_CASES))
def test_needle_bytes_match_reference(case, pin_clocks):
    version, mine = _make(PORT, case)
    _, ref = _make(REF, case)
    blob = mine.to_bytes(version)
    assert blob == ref.to_bytes(version)
    assert len(blob) == types.actual_size(mine.size, version)
    got = needle.Needle.from_bytes(blob, version, expected_size=mine.size)
    want = ref_needle.Needle.from_bytes(blob, version, expected_size=ref.size)
    for f in ("cookie", "id", "size", "data", "flags", "name", "mime",
              "pairs", "last_modified", "checksum", "append_at_ns"):
        assert getattr(got, f) == getattr(want, f), f
    assert str(got.ttl) == str(want.ttl)
    assert got.etag() == want.etag()
    if mine.size:
        with pytest.raises(needle.SizeMismatchError):
            needle.Needle.from_bytes(blob, version,
                                     expected_size=mine.size + 1)


def test_needle_crc_checks_match_reference():
    n = needle.Needle.create(1, 2, b"payload data here", last_modified=50)
    blob = bytearray(n.to_bytes(types.VERSION3))
    blob[types.NEEDLE_HEADER_SIZE + 5] ^= 0xFF
    for mod in (needle, ref_needle):
        with pytest.raises(mod.CrcError):
            mod.Needle.from_bytes(bytes(blob), types.VERSION3)
        m = mod.Needle.from_bytes(bytes(blob), types.VERSION3,
                                  check_crc=False)
        assert not m.crc_ok()
    legacy = crc.crc_value_legacy(crc.crc32c(b"data"))
    n = needle.Needle.create(1, 2, b"data", last_modified=50)
    blob = bytearray(n.to_bytes(types.VERSION3))
    pos = types.NEEDLE_HEADER_SIZE + n.size
    blob[pos:pos + 4] = legacy.to_bytes(4, "big")
    assert needle.Needle.from_bytes(bytes(blob)).data == \
        ref_needle.Needle.from_bytes(bytes(blob)).data == b"data"


def test_append_at_ns_is_monotonic(pin_clocks):
    n = needle.Needle(id=1)
    n.update_append_at_ns(10**20)
    assert n.append_at_ns == 10**20 + 1
    n.update_append_at_ns(0)
    assert n.append_at_ns == needle.time.ns


# -- the Volume ---------------------------------------------------------------


def _nd(mods, nid, data, cookie=0xABC, **kw):
    return mods["needle"].Needle.create(nid, cookie, data,
                                        last_modified=1_700_000_000, **kw)


def _files(base: str) -> dict:
    out = {}
    for ext in (".dat", ".idx"):
        if os.path.exists(base + ext):
            with open(base + ext, "rb") as f:
                out[ext] = f.read()
    return out


def _roundtrip(mods, d):
    V = mods["volume"].Volume
    v = V(d, "", 1)
    off, size, unchanged = v.write_needle(_nd(mods, 1, b"hello"))
    n = v.read_needle(1)
    out = [(off, size, unchanged), n.data, n.cookie, n.append_at_ns]
    v.close()
    return out, _files(os.path.join(d, "1"))


def _cookies(mods, d):
    v = mods["volume"].Volume(d, "", 2)
    v.write_needle(_nd(mods, 2, b"data"))
    out = []
    for cookie in (0x999, 0xABC):
        try:
            out.append(v.read_needle(2, cookie=cookie).data)
        except ValueError as e:  # CookieMismatch in both packages
            out.append(type(e).__name__)
    try:
        v.write_needle(_nd(mods, 2, b"b", cookie=2))
    except ValueError as e:
        out.append(type(e).__name__)
    v.close()
    return out, _files(os.path.join(d, "2"))


def _dedup(mods, d):
    v = mods["volume"].Volume(d, "", 3)
    v.write_needle(_nd(mods, 3, b"same"))
    before = v.data_size()
    got = v.write_needle(_nd(mods, 3, b"same"))
    out = [got, v.data_size() == before]
    v.close()
    return out, _files(os.path.join(d, "3"))


def _overwrite_delete(mods, d):
    v = mods["volume"].Volume(d, "", 4)
    v.write_needle(_nd(mods, 4, b"v1"))
    v.write_needle(_nd(mods, 4, b"version2"))
    out = [v.read_needle(4).data, v.delete_needle(4, cookie=0xABC)]
    try:
        v.read_needle(4)
    except KeyError as e:
        out.append(type(e).__name__)
    out += [v.delete_needle(4), v.file_count(), v.deleted_count(),
            v.deleted_size(), v.content_size(), v.nm.max_file_key]
    v.close()
    return out, _files(os.path.join(d, "4"))


def _reload(mods, d):
    V = mods["volume"].Volume
    v = V(d, "col", 7, ttl=mods["TTL"].parse("1d"))
    for i in range(1, 20):
        v.write_needle(_nd(mods, i, f"data-{i}".encode() * i))
    v.delete_needle(5)
    v.close()
    v2 = V(d, "col", 7)
    out = [str(v2.ttl), v2.file_count(), v2.deleted_count()]
    for i in range(1, 20):
        try:
            out.append(v2.read_needle(i).data)
        except KeyError as e:
            out.append(type(e).__name__)
    out.append([(n.id, off) for n, off in v2.scan_needles()])
    v2.close()
    return out, _files(os.path.join(d, "col_7"))


def _torn_tail(mods, d):
    V = mods["volume"].Volume
    v = V(d, "", 9)
    for i in range(1, 6):
        v.write_needle(_nd(mods, i, b"x" * 100))
    good = v.data_size()
    v.write_needle(_nd(mods, 6, b"y" * 500))
    v.close()
    with open(os.path.join(d, "9.dat"), "r+b") as f:
        f.truncate(good + 37)
    v2 = V(d, "", 9)
    out = [v2.data_size() == good, v2.read_needle(5).data]
    try:
        v2.read_needle(6)
    except KeyError as e:
        out.append(type(e).__name__)
    v2.write_needle(_nd(mods, 6, b"z" * 20))
    out.append(v2.read_needle(6).data)
    v2.close()
    return out, _files(os.path.join(d, "9"))


def _ttl_expiry(mods, d):
    v = mods["volume"].Volume(d, "", 13, ttl=mods["TTL"].parse("1m"))
    n = _nd(mods, 1, b"short-lived", ttl=mods["TTL"].parse("1m"))
    n.last_modified = 1_000_000  # long past
    v.write_needle(n)
    try:
        v.read_needle(1)
        out = ["served"]
    except KeyError as e:
        out = [type(e).__name__]
    v.close()
    return out, _files(os.path.join(d, "13"))


def _sqlite_map(mods, d):
    V = mods["volume"].Volume
    v = V(d, "", 15, needle_map_kind="sqlite")
    for i in range(1, 8):
        v.write_needle(_nd(mods, i, bytes([i]) * 33))
    v.delete_needle(3)
    v.close()
    v2 = V(d, "", 15, needle_map_kind="sqlite")
    out = [v2.file_count(), v2.read_needle(7).data]
    v2.close()
    return out, _files(os.path.join(d, "15"))


def _destroy(mods, d):
    v = mods["volume"].Volume(d, "", 21)
    v.write_needle(_nd(mods, 1, b"x"))
    v.destroy()
    return sorted(os.listdir(d)), {}


SCENARIOS = dict(roundtrip=_roundtrip, cookies=_cookies, dedup=_dedup,
                 overwrite_delete=_overwrite_delete, reload=_reload,
                 torn_tail=_torn_tail, ttl_expiry=_ttl_expiry,
                 sqlite_map=_sqlite_map, destroy=_destroy)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_volume_matches_reference(scenario, pin_clocks, tmp_path):
    """One scenario through both packages' Volume: the same answers and
    byte-identical .dat and .idx."""
    fn = SCENARIOS[scenario]
    os.makedirs(tmp_path / "ref")
    os.makedirs(tmp_path / "port")
    want = fn(REF, str(tmp_path / "ref"))
    got = fn(PORT, str(tmp_path / "port"))
    assert got == want
    assert got[1] or scenario == "destroy"


def test_volume_error_types(tmp_path):
    v = volume.Volume(str(tmp_path), "", 1)
    v.write_needle(_nd(PORT, 1, b"a"))
    with pytest.raises(CookieMismatch):
        v.read_needle(1, cookie=5)
    v.delete_needle(1)
    with pytest.raises(NotFoundError):
        v.read_needle(1)
    with pytest.raises(NotFoundError):
        v.read_needle(99)
    v.close()
    v = volume.Volume(str(tmp_path), "", 1)
    assert v.nm.get(1) is None and 1 in v.nm.tombstones
    assert isinstance(DeletedError("x"), KeyError)
    v.read_only = True
    with pytest.raises(IOError):
        v.write_needle(_nd(PORT, 2, b"b"))
    v.close()


@pytest.mark.parametrize("mods", [REF, PORT], ids=["reference", "port"])
def test_group_commit_flush_failure_freezes_the_volume(mods, tmp_path):
    """volume.commit.flush armed: the write fails and the volume refuses
    new writes until a flush succeeds, in both packages."""
    v = mods["volume"].Volume(str(tmp_path), "", 1)
    v.write_needle(_nd(mods, 1, b"ok"))
    with mods["failpoint"].active("volume.commit.flush", p=1.0):
        with pytest.raises(IOError):
            v.write_needle(_nd(mods, 2, b"lost"))
    assert v._gc_frozen
    with pytest.raises(IOError):
        v.write_needle(_nd(mods, 3, b"refused"))
    v.close()


# -- the recovery ladder ------------------------------------------------------


def _damaged_location(d: str) -> None:
    """A crashed location, made with the reference: a torn volume, a
    healthy one, an orphaned tmp, a corrupt .vif, an EC shard set that
    never saw its .ecx, and the dirty marker left down."""
    v = ref_volume.Volume(d, "", 7)
    for i in range(3):
        v.write_needle(_nd(REF, i + 1, bytes([i + 1]) * (50 + 13 * i)))
    end = v.data_size()
    v.close()
    with open(os.path.join(d, "7.dat"), "r+b") as f:
        f.truncate(end - 3)
    v = ref_volume.Volume(d, "pics", 8)
    v.write_needle(_nd(REF, 1, b"fine"))
    v.close()
    for name, body in (("x.vif.tmp", b"half"), ("8.vif", b"{not json"),
                       ("9.ec00", b"\0" * 64), ("9.ecj", b"\0" * 8),
                       (".swfs_incarnation", b"garbage")):
        with open(os.path.join(d, name), "wb") as f:
            f.write(body)
    ref_recovery.mark_dirty(d)


def _tree(d: str) -> dict:
    out = {}
    for root, _, names in os.walk(d):
        for name in names:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    out.pop(recovery.DIRTY_MARKER, None)  # holds the pid
    return out


def test_recovery_report_matches_reference(tmp_path, pin_clocks):
    src = str(tmp_path / "src")
    os.makedirs(src)
    _damaged_location(src)
    shutil.copytree(src, tmp_path / "ref")
    shutil.copytree(src, tmp_path / "port")
    want = ref_recovery.recover_store([str(tmp_path / "ref")])
    got = recovery.recover_store([str(tmp_path / "port")])
    assert got.status() == want.status()
    assert got.ran and got.dat_truncated_bytes > 0 and got.suspects
    assert got.ec_shards_quarantined == 2 and got.tmp_swept == 1
    assert _tree(str(tmp_path / "port")) == _tree(str(tmp_path / "ref"))
    assert recovery.was_unclean(str(tmp_path / "port"))  # re-armed
    v = volume.Volume(str(tmp_path / "port"), "", 7)
    assert v.read_needle(2).data == b"\x02" * 63
    with pytest.raises(NotFoundError):
        v.read_needle(3)
    v.close()


@pytest.mark.parametrize("cut", range(-8, 1))
def test_repair_dat_tail_matches_reference(cut, tmp_path):
    """Cuts at the last record's end and the 8 bytes before it."""
    d = str(tmp_path)
    v = ref_volume.Volume(d, "", 1)
    for i in range(3):
        v.write_needle(_nd(REF, i + 1, bytes([i + 1]) * (50 + 13 * i)))
    end = v.data_size()
    v.close()
    dat = os.path.join(d, "1.dat")
    with open(dat, "r+b") as f:
        f.truncate(end + cut)
    shutil.copy(dat, dat + ".ref")
    assert recovery.repair_dat_tail(dat) == \
        ref_recovery.repair_dat_tail(dat + ".ref")
    assert recovery.scan_valid_prefix(dat) == \
        ref_recovery.scan_valid_prefix(dat + ".ref")
    assert recovery.reconcile_idx(os.path.join(d, "1.idx"),
                                  os.path.getsize(dat)) == (0 if cut == 0
                                                            else 1)


def test_digest_manifests_read_as_the_reference_writes_them(tmp_path):
    """The manifest readers the ladder validates .dig files with."""
    v = ref_volume.Volume(str(tmp_path), "", 3)
    for i in range(1, 6):
        v.write_needle(_nd(REF, i, _buf(100 * i)))
    v.delete_needle(2)
    entries = ref_digest.volume_digest_entries(v)
    path = ref_digest.write_manifest(v.file_name(), entries)
    v.close()
    got = digest.read_manifest(path)
    assert [tuple(vars(e).values()) for e in got] == \
        [tuple(vars(e).values()) for e in entries]
    assert digest.rolling_digest(got) == ref_digest.rolling_digest(entries)
    assert digest.manifest_bytes(got) == ref_digest.manifest_bytes(entries)
    assert recovery._valid_dig(path)
    with open(path, "r+b") as f:
        f.truncate(16 + 10)  # inside the first entry
    assert not recovery._valid_dig(path)
    assert not ref_recovery._valid_dig(path)
