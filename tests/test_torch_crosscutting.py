"""The port's cross-cutting modules against the JAX package's, on the CPU.

Compression (`utils/compression.py`), AES-256-GCM chunk encryption with
its pure-Python fallback (`utils/cipher.py`), the on-read image
transforms (`images/`), the structured query engine and the volume
server's `Query` RPC (`query/`), and the status pages (`server/ui.py`):
the same seeded inputs go through both packages and the bytes must be
equal (tolerance 0). Randomness is pinned where a module draws it
(`os.urandom` for keys and nonces), and so is the pages' clock. Cipher
blobs sealed by one package open in the other, with and without the
`cryptography` wheel."""

import gzip
import io
import json
import random
import time
from types import SimpleNamespace

import numpy as np
import pytest

from seaweedfs_tpu import images as ref_images
from seaweedfs_tpu import query as ref_query
from seaweedfs_tpu.pb import volume_server_pb2 as ref_vs
from seaweedfs_tpu.server import ui as ref_ui
from seaweedfs_tpu.utils import cipher as ref_cipher
from seaweedfs_tpu.utils import compression as ref_compression
from seaweedfs_tpu_torch import images
from seaweedfs_tpu_torch import query
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs
from seaweedfs_tpu_torch.server import ui
from seaweedfs_tpu_torch.utils import cipher
from seaweedfs_tpu_torch.utils import compression

SEEDS = range(4)


# -- compression -----------------------------------------------------------------

def _payloads(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    text = " ".join(f"word{int(i)}" for i in rng.integers(0, 50, 4000))
    return [b"", b"a" * 4096, text.encode(),
            rng.integers(0, 256, int(rng.integers(1, 70000)),
                         dtype=np.uint8).tobytes()]


@pytest.mark.parametrize("seed", SEEDS)
def test_compression_bytes_are_the_references(seed):
    """zstd frames are equal byte for byte; gzip members are equal but
    for the MTIME field (bytes 4-8, the wall clock); each package reads
    the other's, and `maybe_decompress` sniffs alike."""
    for data in _payloads(seed):
        gz, ref_gz = compression.gzip_data(data), ref_compression.gzip_data(data)
        assert gz[:4] + gz[8:] == ref_gz[:4] + ref_gz[8:]
        assert compression.gunzip_data(ref_gz) == data
        assert ref_compression.gunzip_data(gz) == data
        zs = compression.zstd_data(data)
        assert zs == ref_compression.zstd_data(data)
        assert ref_compression.unzstd_data(zs) == data
        for blob in (gz, zs, data, b"\x1f\x8bnot gzip"):
            assert compression.maybe_decompress(blob) == \
                ref_compression.maybe_decompress(blob)


@pytest.mark.parametrize("ext,mime", [
    (".txt", ""), (".jpg", ""), ("", "video/mp4"), ("", "text/html"),
    (".js", "application/javascript"), ("", "application/json"),
    (".zip", ""), ("", ""), (".csv", "text/csv"), (".png", "image/png")])
def test_gzippable_like_the_reference(ext, mime):
    assert compression.is_gzippable(ext=ext, mime=mime) == \
        ref_compression.is_gzippable(ext=ext, mime=mime)


# -- cipher ----------------------------------------------------------------------

def _pinned_urandom(seed: int):
    rng = random.Random(seed)
    return lambda n: bytes(rng.getrandbits(8) for _ in range(n))


@pytest.mark.parametrize("wheel", [True, False],
                         ids=["cryptography", "pure-python"])
@pytest.mark.parametrize("seed", SEEDS)
def test_cipher_blobs_are_the_references(seed, wheel, monkeypatch):
    """Keys and nonces from one pinned stream: both packages seal the
    same blob, each opens the other's, and a wrong key fails in both."""
    if not wheel:
        for mod in (cipher, ref_cipher):
            monkeypatch.setattr(mod, "AESGCM", None)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, int(rng.integers(0, 3000)),
                        dtype=np.uint8).tobytes()
    blobs = {}
    for name, mod in (("ref", ref_cipher), ("port", cipher)):
        # both modules read the one os module: the stream starts anew
        monkeypatch.setattr(mod.os, "urandom", _pinned_urandom(seed))
        key = mod.gen_cipher_key()
        blobs[name] = (key, mod.encrypt(data, key))
    assert blobs["port"] == blobs["ref"]
    key, blob = blobs["ref"]
    assert cipher.decrypt(blob, key) == data
    assert ref_cipher.decrypt(blobs["port"][1], key) == data
    wrong = bytes(b ^ 1 for b in key)
    for mod in (cipher, ref_cipher):
        with pytest.raises(Exception):
            mod.decrypt(blob, wrong)


def test_cipher_fallback_against_the_wheel(monkeypatch):
    """A blob the port seals without the wheel opens with it, and the
    reverse: the fallback is the same AES-256-GCM."""
    pytest.importorskip("cryptography")
    key, data = bytes(range(32)), b"chunk bytes" * 300
    sealed_by_wheel = cipher.encrypt(data, key)
    monkeypatch.setattr(cipher, "AESGCM", None)
    assert cipher.decrypt(sealed_by_wheel, key) == data
    sealed_by_fallback = cipher.encrypt(data, key)
    monkeypatch.undo()
    assert cipher.decrypt(sealed_by_fallback, key) == data


def test_cipher_gcm_known_answer():
    """AES-256-GCM spec test case 14 (zero key, IV and plaintext) pins
    the port's pure-Python fallback, as it pins the reference's."""
    key, nonce = bytes(32), bytes(12)
    sealed = cipher._gcm(key, nonce, bytes(16), seal=True)
    assert sealed == ref_cipher._gcm(key, nonce, bytes(16), seal=True)
    assert sealed.hex() == ("cea7403d4d606b6e074ec5d3baf39d18"
                            "d0d1c8a799996bf0265b98b5d48ab919")
    assert cipher._gcm(key, nonce, sealed, seal=False) == bytes(16)
    with pytest.raises(ValueError):
        cipher._gcm(key, nonce, bytes([sealed[0] ^ 1]) + sealed[1:],
                    seal=False)


# -- images ----------------------------------------------------------------------

def _image(seed: int, fmt: str, size=(97, 61), orientation: int = 0) -> bytes:
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3),
                                       dtype=np.uint8))
    buf = io.BytesIO()
    if orientation:
        exif = Image.Exif()
        exif[0x0112] = orientation
        img.save(buf, format=fmt, exif=exif)
    else:
        img.save(buf, format=fmt)
    return buf.getvalue()


@pytest.mark.parametrize("fmt", ["PNG", "JPEG", "GIF"])
@pytest.mark.parametrize("width,height,mode", [
    (40, 0, ""), (0, 30, ""), (50, 50, "fit"), (50, 20, "fill"),
    (200, 0, ""), (0, 0, "")])
def test_resized_bytes_are_the_references(fmt, width, height, mode):
    pytest.importorskip("PIL")
    data = _image(3, fmt)
    assert images.resized(data, width, height, mode) == \
        ref_images.resized(data, width, height, mode)


def test_images_pass_through_without_pil(monkeypatch):
    """Where PIL is missing, both packages serve the stored bytes."""
    for mod in (images, ref_images):
        monkeypatch.setattr(mod, "_HAS_PIL", False)
    data = b"\x89PNG not decoded"
    assert images.resized(data, 10, 10) == ref_images.resized(data, 10, 10)
    assert images.fix_jpg_orientation(data) == data


@pytest.mark.parametrize("orientation", [0, 3, 6, 8])
def test_jpeg_orientation_fixed_like_the_reference(orientation):
    pytest.importorskip("PIL")
    data = _image(5, "JPEG", orientation=orientation)
    assert images.fix_jpg_orientation(data) == \
        ref_images.fix_jpg_orientation(data)
    assert images.fix_jpg_orientation(b"not an image") == b"not an image"
    for mime, name in (("image/png", ""), ("", "a.JPG"), ("text/plain", "")):
        assert images.is_image(mime, name) == ref_images.is_image(mime, name)


# -- query -----------------------------------------------------------------------

def _records(seed: int) -> list[dict]:
    rng = random.Random(seed)
    return [{"id": i, "name": rng.choice(["ann", "bob", "cy", "dee"]),
             "age": rng.randrange(18, 90), "score": round(rng.random(), 3),
             "tags": {"team": rng.choice(["red", "blue"]),
                      "level": rng.randrange(5)}}
            for i in range(rng.randrange(20, 60))]


def _json_lines(recs) -> bytes:
    return "".join(json.dumps(r) + "\n" for r in recs).encode()


def _csv(recs) -> bytes:
    lines = ["id,name,age,score"] + [
        f"{r['id']},{r['name']},{r['age']},{r['score']}" for r in recs]
    return ("\n".join(lines) + "\n").encode()


WHERES = ["", "age > 40", "name = bob", "age >= 30 and score < 0.5",
          "tags.team = red", "name != cy"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("where", WHERES)
def test_query_records_are_the_references(seed, where):
    recs = _records(seed)
    js, cs = _json_lines(recs), _csv(recs)
    for kw in ({}, {"select": ["name", "tags.level"]}, {"limit": 3}):
        assert query.query_json(js, where=where, **kw) == \
            ref_query.query_json(js, where=where, **kw)
    assert query.query_json(json.dumps(recs).encode(), where=where) == \
        ref_query.query_json(json.dumps(recs).encode(), where=where)
    if "tags" not in where:
        for kw in ({}, {"select": ["name"]}, {"limit": 2}):
            assert query.query_csv(cs, where=where, **kw) == \
                ref_query.query_csv(cs, where=where, **kw)


def _query_request(pb, kind: str, field: str, operand: str, value: str,
                   gzipped: bool, csv_out: bool):
    req = pb.QueryRequest(selections=["name", "age"] if csv_out else [])
    req.filter.field, req.filter.operand, req.filter.value = \
        field, operand, value
    insz = req.input_serialization
    insz.compression_type = "GZIP" if gzipped else "NONE"
    if kind == "csv":
        insz.csv_input.file_header_info = "USE"
    else:
        insz.json_input.type = "LINES"
    if csv_out:
        req.output_serialization.csv_output.field_delimiter = ","
    else:
        req.output_serialization.json_output.record_delimiter = "\n"
    return req


@pytest.mark.parametrize("kind", ["json", "csv"])
@pytest.mark.parametrize("gzipped", [False, True])
@pytest.mark.parametrize("csv_out", [False, True])
@pytest.mark.parametrize("filt", [("age", ">", "50"), ("name", "=", "ann"),
                                  ("", "", "")])
def test_execute_query_bytes_are_the_references(kind, gzipped, csv_out, filt):
    """The Query RPC's engine: the same proto request over the same
    object (gzipped or not) gives the same serialized stripe."""
    recs = _records(7)
    data = _csv(recs) if kind == "csv" else _json_lines(recs)
    if gzipped:
        data = gzip.compress(data, mtime=0)
    got = query.execute_query(data, _query_request(vs, kind, *filt,
                                                   gzipped, csv_out))
    want = ref_query.execute_query(data, _query_request(
        ref_vs, kind, *filt, gzipped, csv_out))
    assert got == want and (got or not filt[0])


# -- status pages ----------------------------------------------------------------

class _Clock:
    """The `time` a page reads, at one instant."""

    @staticmethod
    def strftime(fmt, t=None):
        return time.strftime(fmt, time.gmtime(1_700_000_000)
                             if t is None else t)

    localtime = staticmethod(time.gmtime)


def _fake_master(raft: bool):
    nodes = {}
    for i, (dc, rack) in enumerate([("dc1", "r1"), ("dc1", "r2"),
                                    ("dc2", "r1")]):
        url = f"127.0.0.1:{8080 + i}"
        nodes[url] = SimpleNamespace(
            url=url, data_center=dc, rack=rack,
            volumes={v: None for v in range(i + 2)}, max_volume_count=8,
            ec_shards={21: SimpleNamespace(bits=0b1011 << i)})
    status = {"role": "leader", "term": 3, "commit_index": 17,
              "peers": ["127.0.0.1:9334", "127.0.0.1:9335"]}
    return SimpleNamespace(
        address="127.0.0.1:9333", leader_address=lambda: "127.0.0.1:9333",
        is_leader=lambda: True,
        topo=SimpleNamespace(statistics=lambda: (10 << 30, 3 << 29, 4242),
                             volume_size_limit=256 << 20, nodes=nodes),
        raft=SimpleNamespace(status=lambda: status) if raft else None)


def _fake_volume_server():
    vols = {v: SimpleNamespace(
        collection="c" if v % 2 else "", data_size=lambda v=v: v * 12345,
        file_count=lambda v=v: v * 3, deleted_count=lambda v=v: v,
        read_only=bool(v % 3 == 0)) for v in (1, 2, 3, 7)}
    loc = SimpleNamespace(directory="/data/v<1>", disk_type="", volumes=vols,
                          ec_volumes={9: SimpleNamespace(
                              collection="ec", shard_files={0: 1, 5: 1,
                                                            13: 1})},
                          max_volume_count=8)
    return SimpleNamespace(
        address="127.0.0.1:8080", masters=["127.0.0.1:9333"],
        store=SimpleNamespace(data_center="dc1", rack="", locations=[loc]))


def _fake_entries():
    return [SimpleNamespace(
        name=n, full_path=f"/buckets/b<&>/{n}", is_directory=d,
        size=lambda s=s: s, attr=SimpleNamespace(mime=m, mtime=t))
        for n, d, s, m, t in (("sub", True, 0, "", 0),
                              ("a.txt", False, 1234, "text/plain",
                               1_700_000_100),
                              ("<script>.bin", False, 9, "", 1_700_000_200))]


@pytest.mark.parametrize("page", ["master", "master-raft", "volume", "filer"])
def test_the_status_pages_are_the_references(page, monkeypatch):
    """The same state renders to the same bytes in both packages (clock
    pinned); names a client or a heartbeat supplied are escaped."""
    for mod in (ui, ref_ui):
        monkeypatch.setattr(mod, "time", _Clock)
    if page.startswith("master"):
        st = _fake_master(page == "master-raft")
        got, want = ui.master_ui(st), ref_ui.master_ui(st)
        assert b"127.0.0.1:8082" in got
    elif page == "volume":
        st = _fake_volume_server()
        got, want = ui.volume_ui(st), ref_ui.volume_ui(st)
        assert b"<td>7</td>" in got
    else:
        st = SimpleNamespace(address="127.0.0.1:8888")
        got = ui.filer_ui(st, "/buckets/b<&>", _fake_entries())
        want = ref_ui.filer_ui(st, "/buckets/b<&>", _fake_entries())
        assert b"<script>" not in got
    assert got == want
