"""The port's streamed encode against the reference's, on the CPU.

The reference suite (tests/test_ec_stream.py) on a port cluster: a master
and three volume servers of seaweedfs_tpu_torch in one process, their
coder RSCodecTorch on the CPU (K1's plain version does the products),
one module-scoped cluster. Each case as in the reference: streamed
shards equal to a golden encode of the same .dat by the reference's
numpy coder, every needle read back; the copy path (`-stream 0`) equal
to the same golden; the destinations' `.dig` manifests equal to a CRC of
the files, with no second read; the manifest bytes; a destination flap
mid-stream that resumes with only the missing range re-sent; the
`ec.stream.slab` failpoint matched per shard and range; a destination
that refuses every slab completed by the copy fallback; the read-only
rollback of a failed encode on both paths; `/status` and `/metrics`.

Then the wire across packages, with no master: a reference source's
VolumeEcShardsGenerateStreamed streaming to a port destination, and a
port source to a reference destination, each writing shard files and
`.dig` manifests byte-identical to the same package on both ends (and a
flap of a reference destination resumed by a port source). Tolerance 0
throughout: GF arithmetic is exact."""

import hashlib
import io
import os
import random
import shutil
import socket
import threading
import time

import grpc
import numpy as np
import pytest
import requests

from seaweedfs_tpu.models.coder import new_coder as ref_new_coder
from seaweedfs_tpu.pb import ec_stream_pb2 as ref_es
from seaweedfs_tpu.pb import rpc as ref_rpc
from seaweedfs_tpu.server.volume import VolumeServer as RefVolume
from seaweedfs_tpu.storage import ec_files as ref_ec_files
from seaweedfs_tpu.storage.ec_locate import Geometry as RefGeometry
from seaweedfs_tpu.utils import failpoint as ref_failpoint
from seaweedfs_tpu_torch.operation import submit
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
from seaweedfs_tpu_torch.pb import ec_stream_pb2 as es, rpc
from seaweedfs_tpu_torch.pb import scrub_pb2
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs
from seaweedfs_tpu_torch.scrub import digest as digest_mod
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.shell.registry import run_command
from seaweedfs_tpu_torch.storage import ec_files, ec_stream
from seaweedfs_tpu_torch.storage.crc import crc32c
from seaweedfs_tpu_torch.storage.ec_locate import Geometry
from seaweedfs_tpu_torch.storage.file_id import parse_file_id
from seaweedfs_tpu_torch.utils import failpoint, numa, stats
from seaweedfs_tpu_torch.wdclient import pool
from tests import torch_ports

# small blocks so a few KB of needles cross the large/small row boundary
TEST_GEO = Geometry(large_block=10000, small_block=100)
REF_GEO = RefGeometry(large_block=10000, small_block=100)

_PORTS = random.Random(os.getpid() + 9)
_TAKEN: set[int] = set()


def _free_port() -> int:
    """A free HTTP port and its gRPC twin (+10000), below the kernel's
    ephemeral range, so no client's outgoing port takes it between the
    pick and the bind; never the same pick twice in this module."""
    for _ in range(400):
        port = torch_ports.draw(_PORTS, 12000, 22000)
        if port in _TAKEN:
            continue
        try:
            for p in (port, port + 10000):
                with socket.socket() as s:
                    s.bind(("", p))
        except OSError:
            continue
        _TAKEN.add(port)
        return port
    raise RuntimeError("no free port pair")


def _coder():
    return RSCodecTorch(10, 4, device="cpu")


@pytest.fixture(autouse=True)
def _no_leaked_failpoints():
    failpoint.clear()
    ref_failpoint.clear()
    yield
    failpoint.clear()
    ref_failpoint.clear()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """master + 3 volume servers of the port, in process."""
    mp = pytest.MonkeyPatch()
    # wire chunks aligned to TEST_GEO.large_block so shard streams span
    # multiple chunks (the resume/failpoint tests target chunk offsets)
    mp.setattr(ec_stream, "DEFAULT_WIRE_CHUNK", TEST_GEO.large_block)
    tmp = tmp_path_factory.mktemp("ecstream")
    mport = _free_port()
    master = MasterServer(ip="localhost", port=mport,
                          volume_size_limit_mb=64)
    master.start(vacuum_interval=3600)
    volumes = []
    for i in range(3):
        vsrv = VolumeServer(
            directories=[str(tmp / f"vol{i}")],
            master=f"localhost:{mport}", ip="localhost",
            port=_free_port(), pulse_seconds=1, ec_geometry=TEST_GEO,
            coder=_coder(),
            # every test grows a fresh collection (~7 volumes each);
            # leave headroom so later tests never hit "no free slot"
            max_volume_counts=[120])
        vsrv.start()
        volumes.append(vsrv)
    deadline = time.time() + 10
    while time.time() < deadline and len(master.topo.nodes) < 3:
        time.sleep(0.05)
    assert len(master.topo.nodes) == 3, "volume servers did not register"
    env = CommandEnv(master.address)
    out = io.StringIO()
    assert run_command(env, "lock", out) == 0
    yield master, volumes, env
    for v in volumes:
        v.stop()
        v._http_server.server_close()
        v._grpc_server.stop(None).wait(10)
    master.stop()
    master._http_server.server_close()
    master._grpc_server.stop(None).wait(10)
    rpc.reset_channels()
    pool.POOL.clear()
    mp.undo()


def _make_volume(master, volumes, collection, n_needles=30, seed=0,
                 min_payload=0):
    """Write needles into ONE volume -> (vid, {fid: payload}, source
    server): the first needle goes through the live assign path to grow
    the collection, the rest PUT directly into that volume so the whole
    payload stripes one .dat. Sizes span sub-block to multi-block so the
    stripe crosses small/large rows with a ragged tail."""
    rng = np.random.default_rng(seed)
    res = submit(master.address, b"seed-needle", filename="seed.bin",
                 collection=collection)
    assert "fid" in res, res
    fid = res["fid"]
    vid = parse_file_id(fid).volume_id
    src = next(v for v in volumes if v.store.has_volume(vid))
    blobs = {fid: b"seed-needle"}
    # the master's sequencer adopts the max key it observes in
    # heartbeats: descend the direct-key base per test (seeds are
    # distinct per collection) so later assigns never collide with it
    key = (0x7F - seed) << 24
    total = 0
    while len(blobs) < n_needles or total < min_payload:
        size = int(rng.integers(40, 5000))
        data = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
        f = f"{vid},{key:x}00002026"
        r = requests.put(f"http://{src.address}/{f}", data=data,
                         timeout=30)
        assert r.status_code in (200, 201), r.text
        blobs[f] = data
        total += size
        key += 1
    return vid, blobs, src


def _snapshot_dat(src, vid, tmp_path) -> str:
    """Flush + copy the volume's .dat for offline golden encoding."""
    v = src.store.find_volume(vid)
    with v._lock:
        v._sync_buffers()
    base = str(tmp_path / f"golden{vid}")
    shutil.copyfile(v.file_name() + ".dat", base + ".dat")
    return base


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _golden_hashes(base) -> list[str]:
    """The reference package's numpy coder over the same .dat."""
    ref_ec_files.generate_ec_files(base, ref_new_coder(10, 4, "cpu"),
                                   REF_GEO)
    return [_sha(REF_GEO.shard_file_name(base, i))
            for i in range(REF_GEO.total_shards)]


def _cluster_shard_hashes(volumes, vid, collection) -> dict[int, str]:
    """shard id -> sha256, gathered from whichever server holds it."""
    out = {}
    for srv in volumes:
        for loc in srv.store.locations:
            for sid in range(TEST_GEO.total_shards):
                p = TEST_GEO.shard_file_name(loc.base_name(collection, vid),
                                             sid)
                if os.path.exists(p):
                    out[sid] = _sha(p)
    return out


def _encode(env, vid, extra="") -> str:
    out = io.StringIO()
    code = run_command(env, f"ec.encode -volumeId {vid} {extra}", out)
    assert code == 0, out.getvalue()
    return out.getvalue()


def _wait_ec_registered(master, vid, timeout=10):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if vid in master.topo.ec_shard_map and vid not in {
                v for n in master.topo.nodes.values() for v in n.volumes}:
            return
        time.sleep(0.1)
    raise AssertionError(f"ec volume {vid} never registered")


def _reads_back(src, blobs) -> None:
    for fid, payload in blobs.items():
        r = requests.get(f"http://{src.address}/{fid}", timeout=30)
        assert r.status_code == 200, (fid, r.status_code)
        assert r.content == payload


# -- the streamed default: bit identity and reads -------------------------------


def test_streamed_encode_bit_identity_and_reads(cluster, tmp_path):
    """The default ec.encode (no -stream) streams: shards hash-identical
    to the reference's golden encode of the same .dat, spread across
    remote servers, and every needle reads back through the EC path."""
    master, volumes, env = cluster
    vid, blobs, src = _make_volume(master, volumes, "strm", seed=1)
    golden = _golden_hashes(_snapshot_dat(src, vid, tmp_path))

    msg = _encode(env, vid)
    assert "streamed" in msg and "overlap ratio" in msg, msg
    assert "fallback" not in msg, msg
    _wait_ec_registered(master, vid)

    got = _cluster_shard_hashes(volumes, vid, "strm")
    assert len(got) == TEST_GEO.total_shards, sorted(got)
    for sid, h in got.items():
        assert h == golden[sid], f"shard {sid} diverged from golden"
    remote_holders = {s.address for s in volumes if s is not src
                      for loc in s.store.locations
                      for sid in range(TEST_GEO.total_shards)
                      if os.path.exists(TEST_GEO.shard_file_name(
                          loc.base_name("strm", vid), sid))}
    assert remote_holders, "no shard streamed to a remote server"
    _reads_back(src, blobs)
    assert stats.EC_STREAM_BYTES.value(role="source", phase="live") > 0
    assert stats.EC_STREAM_STREAMS.value(outcome="ok") > 0


@pytest.mark.parametrize("how", ["flag", "env"])
def test_copy_path_matches_golden_and_counts_fallback(cluster, tmp_path,
                                                      how, monkeypatch):
    """`-stream 0`, or SWFS_EC_STREAM=0, runs generate-then-copy: the
    same golden bytes, and the VolumeEcShardsCopy byte counters move."""
    master, volumes, env = cluster
    collection = f"copy{how}"
    vid, blobs, src = _make_volume(master, volumes, collection,
                                   seed=2 if how == "flag" else 12)
    golden = _golden_hashes(_snapshot_dat(src, vid, tmp_path))

    before = stats.EC_COPY_FALLBACK_BYTES.value(kind="shard")
    live0 = stats.EC_STREAM_BYTES.value(role="source", phase="live")
    if how == "env":
        monkeypatch.setenv("SWFS_EC_STREAM", "0")
    msg = _encode(env, vid, "-stream 0" if how == "flag" else "")
    assert "generated 14 shards" in msg and "streamed" not in msg, msg
    _wait_ec_registered(master, vid)
    assert stats.EC_COPY_FALLBACK_BYTES.value(kind="shard") > before
    assert stats.EC_COPY_FALLBACK_SECONDS.value() > 0
    assert stats.EC_STREAM_BYTES.value(role="source",
                                       phase="live") == live0

    got = _cluster_shard_hashes(volumes, vid, collection)
    assert len(got) == TEST_GEO.total_shards
    for sid, h in got.items():
        assert h == golden[sid], f"shard {sid} diverged from golden"
    _reads_back(src, blobs)


# -- destination digests (.dig) ---------------------------------------------------


def test_destination_digest_manifest_no_second_read(cluster):
    """Every streamed destination persists a `.dig` manifest whose folded
    CRCs equal a full-file CRC re-read, and VolumeDigest answers from
    it."""
    master, volumes, env = cluster
    vid, _blobs, src = _make_volume(master, volumes, "strm2", seed=3)
    _encode(env, vid)
    _wait_ec_registered(master, vid)

    checked = 0
    for srv in volumes:
        if srv is src:
            continue
        for loc in srv.store.locations:
            base = loc.base_name("strm2", vid)
            if not os.path.exists(base + ".dig"):
                continue
            manifest = digest_mod.read_ec_manifest(base + ".dig")
            for sid, sc in manifest.items():
                with open(TEST_GEO.shard_file_name(base, sid), "rb") as f:
                    raw = f.read()
                assert len(raw) == sc.size
                assert crc32c(raw) == sc.crc, f"shard {sid} digest wrong"
                checked += 1
            stub = rpc.volume_stub(rpc.grpc_address(srv.address))
            resp = stub.VolumeDigest(
                scrub_pb2.VolumeDigestRequest(volume_id=vid), timeout=30)
            assert resp.is_ec
            got = {d.shard_id: (d.crc, d.size) for d in resp.shard_digests}
            for sid, sc in manifest.items():
                if sid in got:
                    assert got[sid] == (sc.crc, sc.size)
    assert checked > 0, "no destination manifest found"


def test_ec_manifest_format_golden(tmp_path):
    """The on-disk EC digest manifest bytes, pinned."""
    base = str(tmp_path / "7")
    digest_mod.write_ec_manifest(base, {
        1: digest_mod.ShardCrc(1, 0xDEADBEEF, 123),
        0: digest_mod.ShardCrc(0, 7, 0)})
    with open(base + ".dig", "rb") as f:
        blob = f.read()
    assert blob == (
        b"SWFSDGE\n" + (2).to_bytes(8, "big")
        + (0).to_bytes(4, "big") + (7).to_bytes(4, "big")
        + (0).to_bytes(8, "big")
        + (1).to_bytes(4, "big") + (0xDEADBEEF).to_bytes(4, "big")
        + (123).to_bytes(8, "big"))
    back = digest_mod.read_ec_manifest(base + ".dig")
    assert back[1].crc == 0xDEADBEEF and back[1].size == 123
    assert back[0].crc == 7 and back[0].size == 0


# -- chaos: destination flap mid-stream + slab-range failpoint ---------------------


def test_stream_resume_after_destination_flap(cluster, tmp_path):
    """A destination drops mid-stream (ec.stream.slab failpoint): the
    source resumes from the destination's on-disk prefix, re-sends ONLY
    the missing range, the final shards stay bit-identical, and the
    client sees no error."""
    master, volumes, env = cluster
    vid, blobs, src = _make_volume(master, volumes, "chaos", n_needles=40,
                                   seed=4, min_payload=140_000)
    base = _snapshot_dat(src, vid, tmp_path)
    dat_size = os.path.getsize(base + ".dat")
    # the stripe crosses the large-row boundary, so slabs past offset
    # large_block exist (the flap target below)
    assert dat_size > TEST_GEO.large_block * TEST_GEO.data_shards, dat_size
    golden = _golden_hashes(base)

    resumes0 = stats.EC_STREAM_RESUMES.value()
    live0 = stats.EC_STREAM_BYTES.value(role="source", phase="live")
    resend0 = stats.EC_STREAM_BYTES.value(role="source", phase="resume")
    # one destination dies on the first small-row slab it sees (offset
    # large_block, AFTER every shard's first 10000 bytes landed), once
    with failpoint.active("ec.stream.slab", p=1.0, count=1,
                          match=f"off={TEST_GEO.large_block},") as fp:
        msg = _encode(env, vid)
        assert fp.hits == 1, "destination never flapped"
    assert "1 resume(s)" in msg and "fallback" not in msg, msg
    _wait_ec_registered(master, vid)

    assert stats.EC_STREAM_RESUMES.value() == resumes0 + 1
    resent = stats.EC_STREAM_BYTES.value(role="source",
                                         phase="resume") - resend0
    live = stats.EC_STREAM_BYTES.value(role="source", phase="live") - live0
    shard_size = TEST_GEO.shard_size(dat_size)
    # the flapped destination already held every shard's large-row
    # prefix: the resume re-sent exactly the rest of each of its shards
    shares = {sum(os.path.exists(TEST_GEO.shard_file_name(
        loc.base_name("chaos", vid), sid))
        for loc in s.store.locations for sid in range(14))
        for s in volumes if s is not src}
    assert resent in {n * (shard_size - TEST_GEO.large_block)
                      for n in shares}, (resent, shard_size, shares)
    assert live > resent, (live, resent)

    got = _cluster_shard_hashes(volumes, vid, "chaos")
    assert len(got) == TEST_GEO.total_shards
    for sid, h in got.items():
        assert h == golden[sid], f"shard {sid} diverged after resume"
    _reads_back(src, blobs)


def test_stream_slab_failpoint_matches_shard_and_range(cluster):
    """The ec.stream.slab ctx is matchable per shard AND per slab offset
    (comma-terminated, so shard=1 can't substring-hit shard 10)."""
    fp = failpoint._Failpoint("ec.stream.slab", "error", 1.0, -1,
                              "shard=1, off=0,", None)
    assert fp.should_trigger("localhost:1, shard=1, off=0,")
    assert not fp.should_trigger("localhost:1, shard=10, off=0,")
    assert not fp.should_trigger("localhost:1, shard=1, off=10000,")

    # live: the first slab of ANY shard at a remote destination, once;
    # the stream resumes and converges
    master, volumes, env = cluster
    vid, blobs, src = _make_volume(master, volumes, "slab", seed=5)
    alts = "|".join(f"shard={i}, off=0," for i in range(14))
    with failpoint.active("ec.stream.slab", p=1.0, count=1,
                          match=alts) as live:
        msg = _encode(env, vid)
        assert live.hits == 1, "no targeted slab hit the failpoint"
    assert "1 resume(s)" in msg, msg
    _wait_ec_registered(master, vid)
    _reads_back(src, blobs)


def test_stream_hard_failure_falls_back_to_copy(cluster, monkeypatch):
    """A destination that refuses every stream (no count bound) is
    completed by the VolumeEcShardsCopy fallback: the archive still
    converges."""
    master, volumes, env = cluster
    vid, blobs, src = _make_volume(master, volumes, "fall", seed=6)
    monkeypatch.setattr(ec_stream, "DEFAULT_RESUME_ATTEMPTS", 2)
    failed0 = stats.EC_STREAM_STREAMS.value(outcome="failed")
    # no @match: EVERY destination refuses every slab
    with failpoint.active("ec.stream.slab", p=1.0):
        msg = _encode(env, vid)
    assert "fallback copy" in msg, msg
    assert stats.EC_STREAM_STREAMS.value(outcome="failed") > failed0
    _wait_ec_registered(master, vid)
    _reads_back(src, blobs)


# -- read-only rollback on a failed encode ---------------------------------------------


@pytest.mark.parametrize("stream,fp_name", [
    (1, "pb.VolumeEcShardsGenerateStreamed"),
    (0, "pb.VolumeEcShardsGenerate"),
])
def test_failed_encode_rolls_back_readonly(cluster, stream, fp_name):
    """A generate failure restores every replica to writable, the volume
    keeps serving, and a retry without the fault converts it."""
    master, volumes, env = cluster
    vid, blobs, src = _make_volume(master, volumes, "roll", seed=7 + stream)
    v = src.store.find_volume(vid)
    assert not v.read_only
    with failpoint.active(fp_name, p=1.0, count=1):
        out = io.StringIO()
        code = run_command(env, f"ec.encode -volumeId {vid} "
                                f"-stream {stream}", out)
        assert code != 0, "encode unexpectedly succeeded"
    assert not v.read_only, "replica left read-only after failed encode"
    fid, payload = next(iter(blobs.items()))
    r = requests.get(f"http://{src.address}/{fid}", timeout=30)
    assert r.status_code == 200 and r.content == payload
    _encode(env, vid, f"-stream {stream}")
    _wait_ec_registered(master, vid)


# -- observability ----------------------------------------------------------------------


def test_status_and_metrics_expose_ec_stream(cluster):
    master, volumes, _env = cluster
    st = requests.get(f"http://{volumes[0].address}/status",
                      timeout=10).json()
    assert "EcStream" in st
    sect = st["EcStream"]
    for key in ("streamedBytes", "inflightBytes", "resumes", "streams",
                "overlapRatio", "copyFallback"):
        assert key in sect, sect
    # the CRC-32C kernel every slab goes through, never the pure-python
    # one where a compiled one exists
    assert sect["crc32c"] in ("google_crc32c", "native"), sect
    text = requests.get(f"http://{volumes[0].address}/metrics",
                        timeout=10).text
    assert "SeaweedFS_ec_stream_bytes" in text
    assert "SeaweedFS_ec_shards_copy_bytes" in text


# -- the pipeline's hooks: shard sinks and NUMA pins --------------------------------------


def _synthetic_dat(tmp_path, nbytes: int = 123_457) -> str:
    base = str(tmp_path / "syn")
    rng = np.random.default_rng(41)
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes())
    return base


class _RecordingSink:
    """The sink hook's contract, checked on every row: a 1-D C-contiguous
    uint8 numpy row on the host, offsets in order per shard. Keeps a copy
    of every row, as EcStreamSinkSet does."""

    def __init__(self):
        self.rows: dict[int, list[tuple[int, bytes]]] = {}

    def put(self, shard_id, offset, row, nbytes):
        assert isinstance(row, np.ndarray), type(row)
        assert row.dtype == np.uint8 and row.ndim == 1, (row.dtype, row.shape)
        assert row.flags.c_contiguous
        got = self.rows.setdefault(shard_id, [])
        assert offset == sum(len(b) for _, b in got), (shard_id, offset)
        got.append((offset, bytes(memoryview(row)[:nbytes])))


@pytest.mark.parametrize("scheduler", ["on", "off"])
def test_sink_rows_are_host_rows_equal_to_the_shard_files(tmp_path,
                                                          monkeypatch,
                                                          scheduler):
    """Every row generate_ec_files hands its sink (through the dispatch
    scheduler's column-compact results, or the coder's direct call) is a
    C-contiguous uint8 numpy row, and the rows of each shard, in order,
    are that shard's file byte for byte."""
    monkeypatch.setenv("SWFS_EC_DISPATCH", "1" if scheduler == "on" else "0")
    base = _synthetic_dat(tmp_path)
    sink = _RecordingSink()
    ec_files.generate_ec_files(base, _coder(), TEST_GEO, sinks=sink)
    assert sorted(sink.rows) == list(range(TEST_GEO.total_shards))
    for sid, rows in sink.rows.items():
        with open(TEST_GEO.shard_file_name(base, sid), "rb") as f:
            assert b"".join(b for _, b in rows) == f.read(), sid


def test_a_pipeline_pins_its_reader_and_writers_to_one_node(tmp_path,
                                                            monkeypatch):
    """Under SWFS_EC_DISPATCH_PIN a thread pinned with a node hint runs on
    that node's CPUs, and one encode's (and one rebuild's) reader and
    shard writers all pin with the same hint (one next_node draw per
    pipeline); with the gate closed nothing is drawn or pinned."""
    monkeypatch.setenv("SWFS_EC_DISPATCH_PIN", "1")
    numa._reset_for_tests()
    nodes = numa.node_cpus()
    got = {}

    def pin_one():
        got["cpus"] = numa.pin_thread(len(nodes) + 1)
        got["now"] = os.sched_getaffinity(0)

    t = threading.Thread(target=pin_one)
    t.start()
    t.join()
    want = tuple(nodes[(len(nodes) + 1) % len(nodes)])
    assert got["cpus"] in (want, None)  # None: the host refused (EPERM)
    if got["cpus"] is not None:
        assert got["now"] == set(want)
        assert numa.pinning_stats()["threadsPinned"] == 1

    hints = []
    real = numa.pin_thread

    def record(node_hint=None):
        hints.append((threading.current_thread().name, node_hint))
        return real(node_hint)

    monkeypatch.setattr(numa, "pin_thread", record)
    base = _synthetic_dat(tmp_path)
    coder = _coder()
    ec_files.generate_ec_files(base, coder, TEST_GEO)
    os.remove(TEST_GEO.shard_file_name(base, 3))
    encode, hints[:] = list(hints), []
    assert ec_files.rebuild_ec_files(base, coder, TEST_GEO) == [3]
    for reader, got in (("ec-encode-reader", encode),
                        ("ec-rebuild-reader", hints)):
        pipeline = [(n, h) for n, h in got
                    if n.startswith((reader, "ec-shard-writer"))]
        names = {n for n, _ in pipeline}
        assert reader in names and len(names) >= 2, got
        assert len({h for _, h in pipeline}) == 1, pipeline
        assert pipeline[0][1] is not None

    monkeypatch.setenv("SWFS_EC_DISPATCH_PIN", "0")
    assert numa.next_node() is None and real(0) is None
    numa._reset_for_tests()


# -- the wire across packages, with no master ----------------------------------------------

WIRE_VID = 5
WIRE_SHARDS = (2, 3, 7, 11, 12)  # one destination's share, data and parity
N_WIRE_NEEDLES = 60


class _Lone:
    """One package's masterless volume server on a fresh address, and a
    stub of that package on a channel of its own."""

    def __init__(self, pkg: str, d: str):
        port = _free_port()
        if pkg == "port":
            self.srv = VolumeServer(
                directories=[d], master="localhost:1", ip="127.0.0.1",
                port=port, coder=_coder(), ec_geometry=TEST_GEO)
            self.rpc = rpc
        else:
            self.srv = RefVolume(
                directories=[d], master="localhost:1", ip="127.0.0.1",
                port=port, coder=ref_new_coder(10, 4, "cpu"),
                ec_geometry=REF_GEO)
            self.rpc = ref_rpc
        self.es = es if pkg == "port" else ref_es
        self.srv.start()
        self.dir = d
        self.address = f"127.0.0.1:{port}"
        grpc_addr = f"127.0.0.1:{port + 10000}"
        self.channel = grpc.insecure_channel(grpc_addr)
        self.stub = self.rpc.Stub(self.channel, self.rpc.VOLUME_SERVICE,
                                  grpc_addr)

    def stop(self) -> None:
        self.channel.close()
        self.srv.stop()
        self.srv._http_server.server_close()
        self.srv._grpc_server.stop(None).wait(10)


@pytest.fixture(scope="module")
def wire(tmp_path_factory):
    """A source and a destination of each package; both sources hold the
    same volume (written once through the port's server, its .dat and
    .idx copied to the reference's directory before it starts)."""
    root = tmp_path_factory.mktemp("wire")
    dirs = {n: str(root / n) for n in ("port-src", "ref-src", "port-dst",
                                       "ref-dst")}
    for d in dirs.values():
        os.mkdir(d)
    lone = {"port-src": _Lone("port", dirs["port-src"])}
    try:
        src = lone["port-src"]
        src.stub.AllocateVolume(vs.AllocateVolumeRequest(
            volume_id=WIRE_VID, replication="000"), timeout=30)
        rng = np.random.default_rng(21)
        for key in range(1, N_WIRE_NEEDLES + 1):
            data = rng.integers(0, 256, int(rng.integers(40, 5000)),
                                dtype=np.uint8).tobytes()
            r = requests.post(f"http://{src.address}/{WIRE_VID},"
                              f"{key:x}00002026", data=data, timeout=30)
            assert r.status_code == 201, r.text
        v = src.srv.store.find_volume(WIRE_VID)
        with v._lock:
            v._sync_buffers()
        for ext in (".dat", ".idx"):
            shutil.copyfile(v.file_name() + ext,
                            os.path.join(dirs["ref-src"], f"{WIRE_VID}{ext}"))
        golden_base = str(root / "golden")
        shutil.copyfile(v.file_name() + ".dat", golden_base + ".dat")
        golden = _golden_hashes(golden_base)
        for name in ("ref-src", "port-dst", "ref-dst"):
            lone[name] = _Lone(name.split("-")[0], dirs[name])
        yield lone, golden
    finally:
        for s in lone.values():
            s.stop()
        rpc.reset_channels()
        ref_rpc.reset_channels()


def _stream(lone, src: str, dst: str) -> tuple:
    """src's VolumeEcShardsGenerateStreamed of WIRE_VID with WIRE_SHARDS
    to dst -> (response, {file name: bytes} the destination wrote); the
    destination's files are then removed for the next run."""
    s, d = lone[src], lone[dst]
    req = s.es.VolumeEcShardsGenerateStreamedRequest(volume_id=WIRE_VID)
    req.targets.add(address=d.address, shard_ids=list(WIRE_SHARDS))
    resp = s.stub.VolumeEcShardsGenerateStreamed(req, timeout=120)
    got = {}
    for name in sorted(os.listdir(d.dir)):
        if not name.startswith(f"{WIRE_VID}."):
            continue  # the server's own markers
        path = os.path.join(d.dir, name)
        with open(path, "rb") as f:
            got[name] = f.read()
        os.remove(path)
    return resp, got


def _want_files(golden) -> set:
    return {f"{WIRE_VID}.ec{sid:02d}" for sid in WIRE_SHARDS} | {
        f"{WIRE_VID}.dig"}


@pytest.fixture(scope="module")
def same_package(wire):
    """The destination's files when source and destination are of one
    package: {package: files}."""
    lone, golden = wire
    out = {}
    for pkg in ("ref", "port"):
        resp, got = _stream(lone, f"{pkg}-src", f"{pkg}-dst")
        assert [t.ok for t in resp.targets] == [True], resp
        assert set(got) == _want_files(golden), sorted(got)
        for sid in WIRE_SHARDS:
            assert hashlib.sha256(
                got[f"{WIRE_VID}.ec{sid:02d}"]).hexdigest() == golden[sid]
        out[pkg] = got
    assert out["ref"] == out["port"]
    return out


@pytest.mark.parametrize("src,dst", [("ref", "port"), ("port", "ref")],
                         ids=["ref-source-to-port-destination",
                              "port-source-to-ref-destination"])
def test_streamed_shards_cross_the_wire_between_packages(wire, same_package,
                                                         src, dst):
    """One package's source streams to the other package's destination:
    the shard files and the `.dig` manifest it writes are byte-identical
    to the same package on both ends, every shard's manifest entry is
    the CRC-32C of its file, and the source streamed each byte once."""
    lone, golden = wire
    resp, got = _stream(lone, f"{src}-src", f"{dst}-dst")
    t, = resp.targets
    assert t.ok and t.resumes == 0, resp
    assert got == same_package[src] == same_package[dst]
    shard_size = len(got[f"{WIRE_VID}.ec{WIRE_SHARDS[0]:02d}"])
    assert resp.bytes_streamed == shard_size * len(WIRE_SHARDS)
    path = os.path.join(lone[f"{dst}-dst"].dir, "check.dig")
    with open(path, "wb") as f:
        f.write(got[f"{WIRE_VID}.dig"])
    manifest = digest_mod.read_ec_manifest(path)
    os.remove(path)
    assert sorted(manifest) == list(WIRE_SHARDS)
    for sid, sc in manifest.items():
        raw = got[f"{WIRE_VID}.ec{sid:02d}"]
        assert (sc.crc, sc.size) == (crc32c(raw), len(raw))


def test_a_port_source_resumes_a_flapped_ref_destination(wire, same_package,
                                                         monkeypatch):
    """The reference destination drops the port source's stream at its
    second wire chunk: the port source asks the reference's
    VolumeEcShardsStreamStatus and re-sends only the missing range; the
    files are those of an unflapped stream."""
    lone, _golden = wire
    monkeypatch.setattr(ec_stream, "DEFAULT_WIRE_CHUNK", TEST_GEO.large_block)
    with ref_failpoint.active("ec.stream.slab", p=1.0, count=1,
                              match=f"off={TEST_GEO.large_block},") as fp:
        resp, got = _stream(lone, "port-src", "ref-dst")
        assert fp.hits == 1, "the destination never flapped"
    t, = resp.targets
    assert t.ok and t.resumes == 1, resp
    assert got == same_package["ref"]
    shard_size = len(got[f"{WIRE_VID}.ec{WIRE_SHARDS[0]:02d}"])
    share = shard_size * len(WIRE_SHARDS)
    assert 0 < t.resumed_bytes <= share - TEST_GEO.large_block, (
        t.resumed_bytes, share)


# -- the inflight gauge when a stream dies ---------------------------------------


class _DiesAfterFirstSlab:
    """A stand-in for a destination's stub: the call takes the header and
    one slab off the request iterator, then fails as a dropped stream
    does."""

    def __init__(self):
        self.taken = []

    def VolumeEcShardsStream(self, requests_, timeout=None):
        self.taken.append(next(requests_))  # the header
        self.taken.append(next(requests_))  # the first slab
        raise grpc.RpcError("stream reset by peer")


def test_a_dead_stream_leaves_no_bytes_in_flight(monkeypatch, tmp_path):
    """Every slab taken off the queue leaves SeaweedFS_ec_stream_inflight_
    bytes exactly once, even when the call dies at the slab's yield; the
    slabs still queued leave it through _drain. Six 4 KiB wire chunks go
    in; the stub takes one and fails; the gauge ends where it began."""
    stub = _DiesAfterFirstSlab()
    monkeypatch.setattr(rpc, "volume_stub", lambda address: stub)
    start = stats.EC_STREAM_INFLIGHT_BYTES.value()
    dest = ec_stream.EcStreamDestination(
        "127.0.0.1:1", 7, "", [0, 1], str(tmp_path / "7"), TEST_GEO,
        shard_size=6 * 4096)
    dest._chunk = 4096
    rng = np.random.default_rng(5)
    for off in range(0, 3 * 4096, 4096):
        for sid in (0, 1):
            dest.put(sid, off, rng.integers(0, 256, 4096,
                                            dtype=np.uint8).tobytes())
    dest._thread.join(timeout=30)
    assert not dest._thread.is_alive()
    assert dest._failed is not None
    assert len(stub.taken) == 2 and stub.taken[1].HasField("slab")
    assert stats.EC_STREAM_INFLIGHT_BYTES.value() == start
