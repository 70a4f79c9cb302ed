"""The port's volume server against the JAX package's, on the CPU.

Each case runs the reference VolumeServer (numpy coder) and the port's
(RSCodecTorch on the CPU, so K1, K2 or K3's plain version does the
products, as SEAWEEDFS_TORCH_KERNEL selects) over the same seeded needles,
for rs_10_4 and lrc_10_2_2, one after the other on the same address, with
the same pinned clock in both packages' needle modules. The lifecycle is
the operator's: needles POSTed over HTTP, then over gRPC
VolumeMarkReadonly, VolumeEcShardsGenerate, VolumeEcShardsMount,
VolumeDelete, three shards unmounted, deleted and the rest remounted,
GETs (whole, Range, and 404 after VolumeEcBlobDelete), then
VolumeEcShardsRebuild, a byte flipped in .ec03 that VolumeScrub finds and
repairs, a clean stop, and VolumeEcShardsToVolume after a restart. Files
must be byte-identical and responses equal (tolerance 0: GF arithmetic is
exact). Each package's server also opens the other's directories. A
write and a delete to a volume with replication 001 reach the peer, and
vacuum (VacuumVolumeCheck, Compact, Commit, Cleanup) compacts alike, with
the same bytes in both packages. The tier RPCs, Query, the status page
and the on-read resize answer as the reference's do;
`python -m seaweedfs_tpu_torch volume -coder cpu` serves as a process
without JAX; both packages' protobuf files live in one process."""

import hashlib
import http.client
import json
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import time
from urllib.parse import urlparse

import grpc
import numpy as np
import pytest
import torch

from seaweedfs_tpu.models.coder import new_coder as ref_new_coder
from seaweedfs_tpu.pb import ec_geometry_pb2 as ref_eg
from seaweedfs_tpu.pb import rpc as ref_rpc
from seaweedfs_tpu.pb import scrub_pb2 as ref_scrub_pb2
from seaweedfs_tpu.pb import volume_server_pb2 as ref_vs
from seaweedfs_tpu.server import volume as ref_volume
from seaweedfs_tpu.storage import needle as ref_needle
from seaweedfs_tpu.storage.ec_locate import Geometry as RefGeometry
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
from seaweedfs_tpu_torch.pb import ec_geometry_pb2 as eg
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.pb import scrub_pb2
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs
from seaweedfs_tpu_torch.server import volume as port_volume
from seaweedfs_tpu_torch.storage import needle, recovery
from seaweedfs_tpu_torch.storage.ec_locate import Geometry
from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
from seaweedfs_tpu_torch.utils import locks
from tests import torch_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LARGE, SMALL = 10000, 100
VID = 5
N_NEEDLES = 48
LOST = (0, 5, 13)
BLOB_DELETED = 7
FLIP_SHARD, FLIP_AT = 3, 1000
CODES = ("rs_10_4", "lrc_10_2_2")
KINDS = ("xor", "bits", "sel")

REF = dict(volume=ref_volume, rpc=ref_rpc, vs=ref_vs, eg=ref_eg,
           scrub_pb2=ref_scrub_pb2, Geometry=RefGeometry)
PORT = dict(volume=port_volume, rpc=rpc, vs=vs, eg=eg, scrub_pb2=scrub_pb2,
            Geometry=Geometry)


class Clock:
    """A stand-in for the `time` module a needle module reads."""

    def __init__(self):
        self.ns = 1_700_000_000_000_000_000

    def time_ns(self) -> int:
        self.ns += 1000
        return self.ns

    def time(self) -> float:
        return 1_700_000_100.0


_PORTS = random.Random(os.getpid())


def _free_port_pair() -> int:
    """A free HTTP port and its gRPC twin (+10000), both below the
    kernel's ephemeral range: the servers here stop and start again on one
    address, and no client socket may take the port in between."""
    for _ in range(200):
        port = torch_ports.draw(_PORTS, 12000, 22000)
        try:
            for p in (port, port + 10000):
                with socket.socket() as s:
                    s.bind(("", p))
        except OSError:
            continue
        return port
    raise RuntimeError("no free port pair")


PORT_NO = _free_port_pair()  # every lifecycle serves on this one address
NOBODY = _free_port_pair()  # the master address: nothing listens there
while NOBODY == PORT_NO:
    NOBODY = _free_port_pair()
PEER_NO = _free_port_pair()  # the replica of the replication case
while PEER_NO in (PORT_NO, NOBODY):
    PEER_NO = _free_port_pair()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _needles() -> list[tuple]:
    """Seeded (id, cookie, data, content type) of 1 B - 64 KiB."""
    rng = np.random.default_rng(29)
    out = []
    for i in range(1, N_NEEDLES + 1):
        data = rng.integers(0, 256, int(rng.integers(1, 64 * 1024)),
                            dtype=np.uint8).tobytes()
        ctype = "text/plain" if i % 4 == 0 else None
        out.append((i, int(rng.integers(1, 1 << 32)), data, ctype))
    return out


NEEDLES = _needles()


def _fid(nid: int, cookie: int) -> str:
    return f"{VID},{format_needle_id_cookie(nid, cookie)}"


_CONNS: dict = {}


def _request(method, path, body=None, headers=None, port=PORT_NO,
             follow=True):
    """One request on a keep-alive connection per port (a fresh one for
    every request would churn the ephemeral ports other tests bind). A
    307 (the C++ plane handing a request to the Python listener) is
    followed once, as a client does, on a connection of its own."""
    conn = _CONNS.get(port)
    if conn is None:
        conn = _CONNS[port] = http.client.HTTPConnection("127.0.0.1", port,
                                                         timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        out = r.status, dict(r.getheaders()), r.read()
    except BaseException:
        _drop_conn(port)
        raise
    if out[0] != 307 or not follow:
        return out
    loc = urlparse(out[1]["Location"])
    hop = http.client.HTTPConnection("127.0.0.1", loc.port, timeout=60)
    try:
        hop.request(method, loc.path + (f"?{loc.query}" if loc.query else ""),
                    body=body, headers=headers or {})
        r = hop.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        hop.close()


def _drop_conn(port: int) -> None:
    conn = _CONNS.pop(port, None)
    if conn is not None:
        conn.close()


def _response(method, path, headers=None) -> tuple:
    status, hdrs, body = _request(method, path, headers=headers)
    return (status, body, hdrs.get("ETag"), hdrs.get("Content-Length"),
            hdrs.get("Content-Range"), hdrs.get("Content-Type"))


class _Server:
    """One package's VolumeServer on PORT_NO (or `port`), stopped so that
    the next one can bind the same address."""

    def __init__(self, mods, d: str, coder, port: int = PORT_NO):
        self.mods = mods
        self.port = port
        self.srv = mods["volume"].VolumeServer(
            directories=[d], master=f"localhost:{NOBODY}", ip="127.0.0.1",
            port=port, coder=coder, pulse_seconds=1,
            ec_geometry=mods["Geometry"](large_block=LARGE,
                                         small_block=SMALL))
        self.srv.start()
        # a channel of its own: the cached ones may sit in reconnect
        # backoff from the server that held this address before
        addr = f"127.0.0.1:{port + 10000}"
        self.channel = grpc.insecure_channel(addr)
        self.stub = mods["rpc"].Stub(self.channel,
                                     mods["rpc"].VOLUME_SERVICE, addr)

    def stop(self) -> None:
        srv = self.srv
        self.channel.close()
        _drop_conn(self.port)
        srv.stop()
        srv._http_server.server_close()
        srv._grpc_server.stop(None).wait(10)


def _files(d: str, exts) -> dict:
    out = {}
    for ext in exts:
        p = os.path.join(d, f"{VID}{ext}")
        if os.path.exists(p):
            with open(p, "rb") as f:
                out[ext] = f.read()
    return out


SHARD_EXTS = tuple(f".ec{i:02d}" for i in range(14))


def _lifecycle(mods, d: str, coder, code: str) -> dict:
    """The operator's EC lifecycle through one package's server."""
    m = mods
    out = {}
    s = _Server(m, d, coder)
    try:
        st = s.stub
        st.AllocateVolume(m["vs"].AllocateVolumeRequest(
            volume_id=VID, replication="000"), timeout=30)
        for nid, cookie, data, ctype in NEEDLES:
            status, _, body = _request(
                "POST", "/" + _fid(nid, cookie), data,
                {"Content-Type": ctype} if ctype else {})
            assert status == 201, body
        st.VolumeMarkReadonly(m["vs"].VolumeMarkReadonlyRequest(
            volume_id=VID), timeout=30)
        st.VolumeEcShardsGenerate(m["eg"].EcGenerateRequest(
            volume_id=VID, geometry=code), timeout=120)
        out["generated"] = _files(d, (".dat", ".idx", ".ecx", ".vif")
                                  + SHARD_EXTS)
        st.VolumeEcShardsMount(m["vs"].VolumeEcShardsMountRequest(
            volume_id=VID, shard_ids=list(range(14))), timeout=30)
        st.VolumeDelete(m["vs"].VolumeDeleteRequest(volume_id=VID),
                        timeout=30)
        assert not os.path.exists(os.path.join(d, f"{VID}.dat"))

        st.VolumeEcShardsUnmount(m["vs"].VolumeEcShardsUnmountRequest(
            volume_id=VID, shard_ids=list(LOST)), timeout=30)
        st.VolumeEcShardsDelete(m["vs"].VolumeEcShardsDeleteRequest(
            volume_id=VID, shard_ids=list(LOST)), timeout=30)
        st.VolumeEcShardsMount(m["vs"].VolumeEcShardsMountRequest(
            volume_id=VID, shard_ids=[i for i in range(14)
                                      if i not in LOST]), timeout=30)
        out["degraded"] = [_response("GET", "/" + _fid(nid, cookie))
                           for nid, cookie, _, _ in NEEDLES]
        nid, cookie = NEEDLES[2][:2]
        out["range"] = [
            _response("GET", "/" + _fid(nid, cookie),
                      {"Range": "bytes=100-4099"}),
            _response("GET", "/" + _fid(nid, cookie),
                      {"Range": f"bytes=-{len(NEEDLES[2][2]) // 3}"})]
        out["head"] = _response("HEAD", "/" + _fid(nid, cookie))
        st.VolumeEcBlobDelete(m["vs"].VolumeEcBlobDeleteRequest(
            volume_id=VID, file_key=BLOB_DELETED), timeout=30)
        out["blob_deleted"] = _response(
            "GET", "/" + _fid(BLOB_DELETED, NEEDLES[BLOB_DELETED - 1][1]))

        reb = st.VolumeEcShardsRebuild(m["eg"].EcRebuildRequest(
            volume_id=VID), timeout=120)
        out["rebuilt_ids"] = list(reb.rebuilt_shard_ids)
        out["rebuilt"] = _files(d, SHARD_EXTS + (".ecx",))
        st.VolumeEcShardsMount(m["vs"].VolumeEcShardsMountRequest(
            volume_id=VID, shard_ids=list(LOST)), timeout=30)

        p = os.path.join(d, f"{VID}.ec{FLIP_SHARD:02d}")
        with open(p, "r+b") as f:
            f.seek(FLIP_AT)
            b = f.read(1)
            f.seek(FLIP_AT)
            f.write(bytes([b[0] ^ 0x01]))
        scrubs = []
        for _ in range(2):
            r = st.VolumeScrub(m["scrub_pb2"].VolumeScrubRequest(
                volume_id=VID, full=True, repair=True), timeout=120)
            scrubs.append((r.volumes_scrubbed, r.needles_checked,
                           r.bytes_verified, r.repaired, r.skipped_pairs,
                           [(f.volume_id, f.kind, f.needle_id, f.shard_id,
                             f.detail, f.state) for f in r.findings]))
        out["scrub"] = scrubs
        out["repaired"] = _files(d, SHARD_EXTS)
        out["after_scrub"] = [_response("GET", "/" + _fid(nid, cookie))
                              for nid, cookie, _, _ in NEEDLES]
    finally:
        s.stop()
    out["stopped_clean"] = not os.path.exists(recovery.marker_path(d))

    snap = d + "-ec"
    shutil.copytree(d, snap)
    out["snapshot"] = snap
    s = _Server(m, d, coder)
    try:
        s.stub.VolumeEcShardsToVolume(m["vs"].VolumeEcShardsToVolumeRequest(
            volume_id=VID), timeout=120)
        out["decoded"] = _files(d, (".dat", ".idx"))
        out["decoded_gets"] = [_response("GET", "/" + _fid(nid, cookie))
                               for nid, cookie, _, _ in NEEDLES]
    finally:
        s.stop()
    return out


_RUNS: dict = {}


def _run(pkg: str, kind: str, code: str, tmp_path_factory) -> dict:
    """One lifecycle, once per (package, kernel, geometry) in this module,
    with both packages' needle clocks pinned to the same fresh Clock."""
    key = (pkg, kind, code)
    if key not in _RUNS:
        with pytest.MonkeyPatch.context() as mp:
            for mod in (ref_needle, needle):
                mp.setattr(mod, "time", Clock())
            d = str(tmp_path_factory.mktemp(f"{pkg}-{kind}-{code}") / "data")
            os.mkdir(d)
            if pkg == "ref":
                coder = ref_new_coder(10, 4, "cpu", geometry=code)
                _RUNS[key] = _lifecycle(REF, d, coder, code)
            else:
                mp.setenv("SEAWEEDFS_TORCH_KERNEL", kind)
                coder = RSCodecTorch(10, 4, geometry=code, device="cpu")
                _RUNS[key] = _lifecycle(PORT, d, coder, code)
            _RUNS[key]["dir"] = d
    return _RUNS[key]


@pytest.fixture(scope="module", params=[(k, c) for c in CODES for k in KINDS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def runs(request, tmp_path_factory):
    """(reference run, port run) of one kernel and code geometry."""
    kind, code = request.param
    return (_run("ref", "numpy", code, tmp_path_factory),
            _run("port", kind, code, tmp_path_factory))


def _sha(files: dict) -> dict:
    return {k: hashlib.sha256(v).hexdigest() for k, v in files.items()}


def test_generate_writes_the_same_files(runs):
    ref, port = runs
    assert len(ref["generated"]) == 18  # .dat .idx .ecx .vif + 14 shards
    assert _sha(port["generated"]) == _sha(ref["generated"])


def test_degraded_gets_answer_the_same(runs):
    ref, port = runs
    assert port["degraded"] == ref["degraded"]
    for (nid, _, data, ctype), got in zip(NEEDLES, port["degraded"]):
        assert got[0] == 200 and got[1] == data, nid
        assert got[3] == str(len(data))
        assert got[5] == (ctype or "application/octet-stream")
    assert port["range"] == ref["range"]
    data = NEEDLES[2][2]
    assert port["range"][0][0] == 206 and port["range"][0][1] == data[100:4100]
    assert port["range"][1][1] == data[-(len(data) // 3):]
    assert port["head"] == ref["head"] and port["head"][1] == b""
    assert port["blob_deleted"] == ref["blob_deleted"]
    assert port["blob_deleted"][0] == 404


def test_rebuild_restores_the_same_shards(runs):
    ref, port = runs
    assert port["rebuilt_ids"] == ref["rebuilt_ids"] == list(LOST)
    assert _sha(port["rebuilt"]) == _sha(ref["rebuilt"])
    gen = {k: v for k, v in port["generated"].items() if k in SHARD_EXTS}
    assert _sha({k: port["rebuilt"][k] for k in SHARD_EXTS}) == _sha(gen)


def test_scrub_finds_and_repairs_the_flipped_byte(runs):
    ref, port = runs
    assert port["scrub"] == ref["scrub"]
    first, second = port["scrub"]
    assert [(f[1], f[3], f[5]) for f in first[5]] == [
        ("ec_parity", FLIP_SHARD, "repaired")]
    assert first[3] == 1 and second[5] == []
    gen = {k: v for k, v in port["generated"].items() if k in SHARD_EXTS}
    assert _sha(port["repaired"]) == _sha(ref["repaired"]) == _sha(gen)
    assert port["after_scrub"] == port["degraded"][:BLOB_DELETED - 1] + [
        port["blob_deleted"]] + port["degraded"][BLOB_DELETED:]
    assert port["stopped_clean"] and ref["stopped_clean"]


def test_ec_shards_to_volume_decodes_the_same_dat_and_idx(runs):
    ref, port = runs
    assert set(port["decoded"]) == {".dat", ".idx"}
    assert _sha(port["decoded"]) == _sha(ref["decoded"])
    dat = port["generated"][".dat"]
    assert port["decoded"][".dat"] == dat[:len(port["decoded"][".dat"])]
    assert port["decoded_gets"] == ref["decoded_gets"]
    assert port["decoded_gets"][BLOB_DELETED - 1][0] == 404


def test_no_lock_order_violation_in_the_port_server(runs):
    assert locks.violations() == []


@pytest.mark.parametrize("code", CODES)
@pytest.mark.parametrize("direction", ["port-opens-ref", "ref-opens-port"])
def test_each_server_opens_the_others_directory(code, direction,
                                                tmp_path_factory, tmp_path):
    """The EC state (shards, .ecx, .ecj, .vif) and the decoded .dat/.idx
    that one package's server wrote serve the same bytes from the other
    package's server."""
    if direction == "port-opens-ref":
        src = _run("ref", "numpy", code, tmp_path_factory)
        mods, coder = PORT, RSCodecTorch(10, 4, geometry=code, device="cpu")
    else:
        src = _run("port", "xor", code, tmp_path_factory)
        mods, coder = REF, ref_new_coder(10, 4, "cpu", geometry=code)
    for state, path, want in (("ec", src["snapshot"], src["after_scrub"]),
                              ("decoded", src["dir"], src["decoded_gets"])):
        d = str(tmp_path / state)
        shutil.copytree(path, d)
        s = _Server(mods, d, coder)
        try:
            got = [_response("GET", "/" + _fid(nid, cookie))
                   for nid, cookie, _, _ in NEEDLES]
        finally:
            s.stop()
        assert got == want, state


# -- the tier and Query RPCs, the status page and the resize ------------------

ANSWERED_RPCS = ("VolumeTierMoveDatToRemote",
                 "VolumeTierMoveDatFromRemote", "Query")


def _lone(mods, d: str, coder):
    """A masterless server of one package on its own address, with one
    needle."""
    port = _free_port_pair()
    srv = mods["volume"].VolumeServer(
        directories=[d], master=f"localhost:{NOBODY}", ip="127.0.0.1",
        port=port, coder=coder)
    srv.start()
    mods["rpc"].reset_channels()
    stub = mods["rpc"].volume_stub(f"127.0.0.1:{port + 10000}")
    stub.AllocateVolume(mods["vs"].AllocateVolumeRequest(
        volume_id=VID, replication="000"), timeout=30)
    nid, cookie, data, _ = NEEDLES[0]
    assert _request("POST", "/" + _fid(nid, cookie), data,
                    port=port)[0] == 201
    return srv, stub, port


def _stop_lone(srv, port) -> None:
    _drop_conn(port)
    srv.stop()
    srv._http_server.server_close()


@pytest.fixture(scope="module")
def lone_server(tmp_path_factory):
    """A masterless port server on its own address, with one needle."""
    srv, stub, port = _lone(PORT, str(tmp_path_factory.mktemp("lone")),
                            RSCodecTorch(10, 4, device="cpu"))
    yield srv, stub, port
    _stop_lone(srv, port)


@pytest.fixture(scope="module")
def lone_reference(tmp_path_factory):
    """The reference's server, as `lone_server` is the port's."""
    srv, stub, port = _lone(REF, str(tmp_path_factory.mktemp("lone_ref")),
                            ref_new_coder(backend="cpu"))
    yield srv, stub, port
    _stop_lone(srv, port)


def _rpc_answer(mods, stub, name: str):
    """(status code, details or the serialized responses) of one call
    with an empty request naming VID."""
    m = {x["name"]: x for x in mods["rpc"].VOLUME_SERVICE[1]}[name]
    req = m["req"](volume_id=VID) if "volume_id" in \
        m["req"].DESCRIPTOR.fields_by_name else m["req"]()
    try:
        got = list(getattr(stub, name)(req, timeout=30))
    except grpc.RpcError as e:
        # the list of configured backends is the process's registry
        return e.code(), e.details().split(" (configured")[0]
    return grpc.StatusCode.OK, [r.SerializeToString(deterministic=True)
                                for r in got]


@pytest.mark.parametrize("name", ANSWERED_RPCS)
def test_the_tier_and_query_rpcs_answer_as_the_reference(
        lone_server, lone_reference, name):
    """The same request to both packages' servers gets the same answer:
    a tier move to a backend nobody registered is INVALID_ARGUMENT, a
    move back of a volume that is not tiered FAILED_PRECONDITION, and a
    Query that names no needle an empty stream."""
    want = _rpc_answer(REF, lone_reference[1], name)
    assert _rpc_answer(PORT, lone_server[1], name) == want
    assert want[0] != grpc.StatusCode.UNIMPLEMENTED


@pytest.mark.parametrize("name,code", [
    ("VolumeEcShardsGenerateStreamed", grpc.StatusCode.NOT_FOUND),
    ("VolumeEcShardsStream", grpc.StatusCode.ABORTED),
    ("VolumeEcShardsStreamStatus", None),
])
def test_stream_rpcs_are_served(lone_server, name, code):
    """The streamed encode's RPCs answer (tests/test_torch_ec_stream.py
    drives them end to end): a generate of a volume the server lacks is
    NOT_FOUND, a stream that ends after its header without a commit is
    ABORTED, and the resume probe reports 0 bytes of shards it holds
    none of."""
    from seaweedfs_tpu_torch.pb import ec_stream_pb2 as es

    _, stub, _ = lone_server
    if name == "VolumeEcShardsStreamStatus":
        resp = stub.VolumeEcShardsStreamStatus(
            es.VolumeEcShardsStreamStatusRequest(volume_id=VID,
                                                 shard_ids=[0, 13]),
            timeout=30)
        assert [(p.shard_id, p.size) for p in resp.shards] == [(0, 0),
                                                               (13, 0)]
        return
    with pytest.raises(grpc.RpcError) as e:
        if name == "VolumeEcShardsStream":
            stub.VolumeEcShardsStream(iter([es.VolumeEcShardsStreamRequest(
                header=es.EcStreamHeader(volume_id=VID))]), timeout=30)
        else:
            stub.VolumeEcShardsGenerateStreamed(
                es.VolumeEcShardsGenerateStreamedRequest(volume_id=VID + 1),
                timeout=30)
    assert e.value.code() == code, e.value.details()


def test_every_rpc_of_the_service_has_a_handler():
    names = [m["name"] for m in rpc.VOLUME_SERVICE[1]]
    assert names == [m["name"] for m in ref_rpc.VOLUME_SERVICE[1]]
    assert all(callable(getattr(port_volume.VolumeGrpc, n)) for n in names)


@pytest.mark.parametrize("path", ["/ui", "/", "/{fid}?width=16"])
def test_the_ui_and_resize_routes_answer_as_the_reference(
        lone_server, lone_reference, path, monkeypatch):
    """`/` and `/ui` serve the status page, equal to the reference's
    with the clock pinned and the address named alike; a resize of a
    needle that is no image serves its bytes."""
    from seaweedfs_tpu.server import ui as ref_ui
    from seaweedfs_tpu_torch.server import ui as port_ui

    clock = type("Clock", (), {
        "strftime": staticmethod(lambda fmt, *a: "2023-11-14 22:13:20")})
    for mod in (ref_ui, port_ui):
        monkeypatch.setattr(mod, "time", clock)
    nid, cookie = NEEDLES[0][:2]
    got = {}
    for name, (srv, _, port) in (("ref", lone_reference),
                                 ("port", lone_server)):
        status, hdrs, body = _request(
            "GET", path.format(fid=_fid(nid, cookie)), port=port)
        d = srv.store.locations[0].directory
        got[name] = (status, hdrs.get("Content-Type"),
                     body.replace(d.encode(), b"DIR")
                     .replace(str(port).encode(), b"PORT"))
    assert got["port"] == got["ref"]
    assert got["port"][0] == 200


def test_a_write_that_needs_peers_fails_loudly(lone_server, monkeypatch):
    """A write whose volume has a peer that is down answers 500, naming
    the failed replica leg, instead of a local-only 201; a delete acks
    its durable tombstone but counts the failed peer."""
    srv, stub, port = lone_server
    from seaweedfs_tpu_torch.utils.stats import VOLUME_REPLICA_DELETE_FAILURES

    stub.AllocateVolume(vs.AllocateVolumeRequest(volume_id=VID + 1,
                                                 replication="001"),
                        timeout=30)
    peer = "127.0.0.1:1"
    monkeypatch.setattr(srv, "lookup_volume_locations",
                        lambda vid: [srv.address, peer])
    nid, cookie, data, _ = NEEDLES[1]
    fid = f"{VID + 1},{format_needle_id_cookie(nid, cookie)}"
    status, _, body = _request("POST", "/" + fid, data, port=port)
    assert status == 500 and b"replica write to 127.0.0.1:1" in body
    assert b"ROADMAP.md" not in body
    before = VOLUME_REPLICA_DELETE_FAILURES.value(peer=peer)
    assert _request("DELETE", "/" + fid, port=port)[0] == 202
    assert VOLUME_REPLICA_DELETE_FAILURES.value(peer=peer) == before + 1


# -- replicated writes and vacuum, against the reference -----------------------

REPLICA_VID = 6
REPLICA_DELETED = (3, 8, 20)
VACUUM_VID = 7
VACUUM_DELETED = tuple(range(2, N_NEEDLES, 4))
ROT_NEEDLE = 11


def _fid_of(vid: int, nid: int, cookie: int) -> str:
    return f"{vid},{format_needle_id_cookie(nid, cookie)}"


def _replication(mods, root: str, coder) -> dict:
    """A primary and its peer (replication 001): every needle POSTed to
    the primary, some DELETEd there; -> both servers' files and GETs."""
    da, db = os.path.join(root, "a"), os.path.join(root, "b")
    os.mkdir(da)
    os.mkdir(db)
    a = _Server(mods, da, coder)
    b = _Server(mods, db, coder, port=PEER_NO)
    out = {}
    try:
        for s in (a, b):
            s.stub.AllocateVolume(mods["vs"].AllocateVolumeRequest(
                volume_id=REPLICA_VID, replication="001"), timeout=30)
        locs = [a.srv.address, b.srv.address]
        a.srv.lookup_volume_locations = lambda vid: locs
        for nid, cookie, data, ctype in NEEDLES:
            status, _, body = _request(
                "POST", "/" + _fid_of(REPLICA_VID, nid, cookie), data,
                {"Content-Type": ctype} if ctype else {})
            assert status == 201, body
        for i in REPLICA_DELETED:
            nid, cookie = NEEDLES[i][:2]
            assert _request("DELETE", "/" + _fid_of(REPLICA_VID, nid,
                                                    cookie))[0] == 202
        for s in (a, b):
            s.stub.VolumeMarkReadonly(mods["vs"].VolumeMarkReadonlyRequest(
                volume_id=REPLICA_VID), timeout=30)  # flushes the group
        out["gets"] = {p: [_request("GET", "/" + _fid_of(REPLICA_VID, nid,
                                                        cookie), port=p)[::2]
                           for nid, cookie, _, _ in NEEDLES]
                       for p in (PORT_NO, PEER_NO)}
    finally:
        for s in (a, b):
            s.stop()
    out["files"] = [{k: hashlib.sha256(v).hexdigest() for k, v in
                     _files_of(d, REPLICA_VID, (".dat", ".idx")).items()}
                    for d in (da, db)]
    return out


def _files_of(d: str, vid: int, exts) -> dict:
    out = {}
    for ext in exts:
        p = os.path.join(d, f"{vid}{ext}")
        if os.path.exists(p):
            with open(p, "rb") as f:
                out[ext] = f.read()
    return out


def _vacuum(mods, root: str, coder) -> dict:
    """Needles written and some deleted, then the vacuum RPCs in the
    master's order (check, compact, commit), a second compact undone by
    cleanup, and a compact that meets a rotten record."""
    d = os.path.join(root, "data")
    os.mkdir(d)
    s = _Server(mods, d, coder)
    v = mods["vs"]
    out = {}
    try:
        st = s.stub
        st.AllocateVolume(v.AllocateVolumeRequest(volume_id=VACUUM_VID,
                                                  replication="000"),
                          timeout=30)
        for nid, cookie, data, _ in NEEDLES:
            assert _request("POST", "/" + _fid_of(VACUUM_VID, nid, cookie),
                            data)[0] == 201
        for i in VACUUM_DELETED:
            nid, cookie = NEEDLES[i][:2]
            assert _request("DELETE", "/" + _fid_of(VACUUM_VID, nid,
                                                    cookie))[0] == 202
        out["before"] = _files_of(d, VACUUM_VID, (".dat", ".idx"))
        out["check"] = st.VacuumVolumeCheck(v.VacuumVolumeCheckRequest(
            volume_id=VACUUM_VID), timeout=30).garbage_ratio
        out["compact"] = [r.processed_bytes for r in st.VacuumVolumeCompact(
            v.VacuumVolumeCompactRequest(volume_id=VACUUM_VID), timeout=60)]
        out["copies"] = _files_of(d, VACUUM_VID, (".cpd", ".cpx"))
        r = st.VacuumVolumeCommit(v.VacuumVolumeCommitRequest(
            volume_id=VACUUM_VID), timeout=60)
        out["commit"] = (r.is_read_only, r.volume_size)
        out["after"] = _files_of(d, VACUUM_VID,
                                 (".dat", ".idx", ".cpd", ".cpx"))
        # the verified vacuum is published as a completed scrub pass: a
        # cursor and a fresh digest manifest, which VolumeDigest serves
        out["published"] = _files_of(d, VACUUM_VID, (".dig", ".scb"))
        out["digest"] = st.VolumeDigest(mods["scrub_pb2"].VolumeDigestRequest(
            volume_id=VACUUM_VID, include_entries=True),
            timeout=30).SerializeToString(deterministic=True)
        out["check_after"] = st.VacuumVolumeCheck(v.VacuumVolumeCheckRequest(
            volume_id=VACUUM_VID), timeout=30).garbage_ratio
        out["gets"] = [_response("GET", "/" + _fid_of(VACUUM_VID, nid,
                                                      cookie))
                       for nid, cookie, _, _ in NEEDLES]
        list(st.VacuumVolumeCompact(v.VacuumVolumeCompactRequest(
            volume_id=VACUUM_VID), timeout=60))
        out["pending"] = sorted(_files_of(d, VACUUM_VID, (".cpd", ".cpx")))
        st.VacuumVolumeCleanup(v.VacuumVolumeCleanupRequest(
            volume_id=VACUUM_VID), timeout=30)
        out["cleaned"] = sorted(_files_of(d, VACUUM_VID, (".cpd", ".cpx")))
        out["compacting"] = s.srv.store.find_volume(VACUUM_VID).is_compacting
        # rot in a live record: the scrub-aware compact refuses to copy it
        vol = s.srv.store.find_volume(VACUUM_VID)
        nid = NEEDLES[ROT_NEEDLE][0]
        nv = vol.nm.get(nid)
        from seaweedfs_tpu_torch.storage import types

        at = types.stored_to_actual_offset(nv.offset) + \
            types.NEEDLE_HEADER_SIZE + 8
        with open(os.path.join(d, f"{VACUUM_VID}.dat"), "r+b") as f:
            f.seek(at)
            b = f.read(1)
            f.seek(at)
            f.write(bytes([b[0] ^ 0x10]))
        suspects = []  # what the handler queues for the repair ladder
        s.srv.scrubber.report_suspect = suspects.append
        with pytest.raises(grpc.RpcError) as e:
            list(st.VacuumVolumeCompact(v.VacuumVolumeCompactRequest(
                volume_id=VACUUM_VID), timeout=60))
        out["rot"] = (e.value.code(), e.value.details())
        out["rot_suspect"] = suspects == [VACUUM_VID]
        out["rot_left"] = _files_of(d, VACUUM_VID, (".dat", ".idx"))
    finally:
        s.stop()
    return out


_CASES: dict = {}


def _case(kind: str, pkg: str, tmp_path_factory) -> dict:
    key = (kind, pkg)
    if key not in _CASES:
        with pytest.MonkeyPatch.context() as mp:
            for mod in (ref_needle, needle):
                mp.setattr(mod, "time", Clock())
            root = str(tmp_path_factory.mktemp(f"{kind}-{pkg}"))
            mods, coder = ((REF, ref_new_coder(10, 4, "cpu")) if pkg == "ref"
                           else (PORT, RSCodecTorch(10, 4, device="cpu")))
            _CASES[key] = (_replication if kind == "replication"
                           else _vacuum)(mods, root, coder)
    return _CASES[key]


def test_replicated_writes_and_deletes_reach_the_peer(tmp_path_factory):
    ref = _case("replication", "ref", tmp_path_factory)
    port = _case("replication", "port", tmp_path_factory)
    assert port == ref
    for p in (PORT_NO, PEER_NO):
        for i, ((nid, _, data, _), got) in enumerate(
                zip(NEEDLES, port["gets"][p])):
            assert got == ((404, got[1]) if i in REPLICA_DELETED
                           else (200, data)), (p, nid)


def test_vacuum_check_and_compact_match_the_reference(tmp_path_factory):
    ref = _case("vacuum", "ref", tmp_path_factory)
    port = _case("vacuum", "port", tmp_path_factory)
    assert port["check"] == ref["check"] > 0.1
    assert port["compact"] == ref["compact"]
    assert set(port["copies"]) == {".cpd", ".cpx"}
    assert _sha(port["copies"]) == _sha(ref["copies"])
    assert _sha(port["before"]) == _sha(ref["before"])


def test_vacuum_commit_swaps_in_the_same_volume(tmp_path_factory):
    ref = _case("vacuum", "ref", tmp_path_factory)
    port = _case("vacuum", "port", tmp_path_factory)
    assert port["commit"] == ref["commit"]
    assert set(port["after"]) == {".dat", ".idx"}
    assert _sha(port["after"]) == _sha(ref["after"])
    assert len(port["after"][".dat"]) < len(port["before"][".dat"])
    assert port["after"][".dat"][8:] == port["copies"][".cpd"][8:]
    assert port["check_after"] == ref["check_after"] == 0
    assert port["gets"] == ref["gets"]
    for i, ((nid, _, data, _), got) in enumerate(zip(NEEDLES, port["gets"])):
        assert got[0] == (404 if i in VACUUM_DELETED else 200), nid
        if i not in VACUUM_DELETED:
            assert got[1] == data


def test_vacuum_publishes_a_scrub_pass_and_digest(tmp_path_factory):
    """The committed vacuum's digest manifest and the VolumeDigest answer
    over the compacted volume, as the reference writes and serves them."""
    ref = _case("vacuum", "ref", tmp_path_factory)
    port = _case("vacuum", "port", tmp_path_factory)
    assert set(port["published"]) == set(ref["published"]) == {".dig",
                                                                ".scb"}
    assert port["published"][".dig"] == ref["published"][".dig"]
    assert port["digest"] == ref["digest"]


def test_vacuum_cleanup_drops_an_uncommitted_compaction(tmp_path_factory):
    ref = _case("vacuum", "ref", tmp_path_factory)
    port = _case("vacuum", "port", tmp_path_factory)
    assert port["pending"] == ref["pending"] == [".cpd", ".cpx"]
    assert port["cleaned"] == ref["cleaned"] == []
    assert port["compacting"] is ref["compacting"] is False


def test_vacuum_refuses_to_copy_a_rotten_record(tmp_path_factory):
    ref = _case("vacuum", "ref", tmp_path_factory)
    port = _case("vacuum", "port", tmp_path_factory)
    assert port["rot"] == ref["rot"]
    assert "failed CRC re-verify" in port["rot"][1]
    assert port["rot_suspect"] and ref["rot_suspect"]
    assert _sha(port["rot_left"]) == _sha(ref["rot_left"])


@pytest.mark.parametrize("how", ["tier"])
def test_tier_backends_load_at_construction(tmp_path, how):
    """`tier_backends=` registers the named backends as the reference's
    constructor does: a local one under its kind, an s3 one under
    `kind.name` with its endpoint and bucket."""
    from seaweedfs_tpu.storage import backend as ref_backend
    from seaweedfs_tpu_torch.storage import backend

    kw = {"tier_backends": {
        "local": {"default": {"root": str(tmp_path / "tier")}},
        "s3": {"b2": {"endpoint": "http://127.0.0.1:1/", "bucket": "t"}}}}
    got = {}
    for name, mods, mod, coder in (
            ("ref", REF, ref_backend, ref_new_coder(backend="cpu")),
            ("port", PORT, backend, RSCodecTorch(10, 4, device="cpu"))):
        d = tmp_path / name
        d.mkdir()
        srv = mods["volume"].VolumeServer(
            directories=[str(d)], master=f"localhost:{NOBODY}",
            port=_free_port_pair(), coder=coder, **kw)
        srv.store.close()
        local, s3 = mod.get_tier_backend("local"), mod.get_tier_backend("s3.b2")
        got[name] = (type(local).__name__, local.name, local.root,
                     type(s3).__name__, s3.name, s3.endpoint, s3.bucket)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("how", ["native", "env", "env-off"])
def test_the_native_plane_serves_at_construction(tmp_path, monkeypatch, how):
    """`native=True`, or SEAWEEDFS_TPU_NATIVE=1 process-wide, puts the C++
    plane on the public port (its /status answer: a 307 to the Python
    listener, which reports NativeDataPlane); SEAWEEDFS_TPU_NATIVE=0
    keeps the Python plane even when native=True asks for it."""
    kw = {"native": how != "env"}
    if how.startswith("env"):
        monkeypatch.setenv("SEAWEEDFS_TPU_NATIVE",
                           "0" if how == "env-off" else "1")
    port = _free_port_pair()
    srv = port_volume.VolumeServer(
        directories=[str(tmp_path)], master=f"localhost:{NOBODY}",
        port=port, coder=RSCodecTorch(10, 4, device="cpu"), **kw)
    on = how != "env-off"
    assert srv.native_enabled is on
    srv.start()
    try:
        assert (srv.native_plane is not None) is on
        status, headers, body = _request("GET", "/status", port=port,
                                         follow=False)
        assert status == (307 if on else 200)
        if on:
            assert headers["Location"].endswith(f":{srv.admin_port}/status")
            status, _, body = _request("GET", "/status", port=srv.admin_port)
        assert json.loads(body)["NativeDataPlane"] is on
    finally:
        srv.stop()
        _drop_conn(port)
        _drop_conn(srv.admin_port)
        rpc.reset_channels()


# -- the process ----------------------------------------------------------------

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


def _spawn(args, tmp_path, modules_file):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    log = open(tmp_path / "server.log", "wb")
    return subprocess.Popen(
        [sys.executable, "-c", _WRAPPER, str(modules_file)] + args,
        cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log


def test_volume_command_serves_without_jax(tmp_path):
    """`python -m seaweedfs_tpu_torch volume -coder cpu` as a process:
    /status answers, an encode and a degraded GET are served over HTTP and
    gRPC, SIGTERM stops it with exit 0 and the dirty marker lifted, and
    neither jax nor any seaweedfs_tpu module was ever imported."""
    port = _free_port_pair()
    d = tmp_path / "data"
    d.mkdir()
    modules_file = tmp_path / "modules.txt"
    proc, log = _spawn(["volume", "-dir", str(d), "-port", str(port),
                        "-mserver", f"localhost:{NOBODY}", "-coder", "cpu"],
                       tmp_path, modules_file)
    try:
        deadline = time.time() + 90
        while True:
            assert proc.poll() is None, (tmp_path / "server.log").read_text()
            try:
                if _request("GET", "/status", port=port)[0] == 200:
                    break
            except OSError:
                pass
            assert time.time() < deadline, "no /status"
            time.sleep(0.2)
        rpc.reset_channels()
        stub = rpc.volume_stub(f"127.0.0.1:{port + 10000}")
        stub.AllocateVolume(vs.AllocateVolumeRequest(volume_id=3,
                                                     replication="000"),
                            timeout=30)
        needles = NEEDLES[:12]
        for nid, cookie, data, _ in needles:
            fid = f"3,{format_needle_id_cookie(nid, cookie)}"
            assert _request("POST", "/" + fid, data, port=port)[0] == 201
        stub.VolumeMarkReadonly(vs.VolumeMarkReadonlyRequest(volume_id=3),
                                timeout=30)
        stub.VolumeEcShardsGenerate(eg.EcGenerateRequest(volume_id=3),
                                    timeout=120)
        stub.VolumeUnmount(vs.VolumeUnmountRequest(volume_id=3), timeout=30)
        stub.VolumeEcShardsDelete(vs.VolumeEcShardsDeleteRequest(
            volume_id=3, shard_ids=list(LOST)), timeout=30)
        stub.VolumeEcShardsMount(vs.VolumeEcShardsMountRequest(
            volume_id=3, shard_ids=[i for i in range(14) if i not in LOST]),
            timeout=30)
        # default geometry: a volume this small lies in shard 0's first
        # block, so every GET reconstructs
        for nid, cookie, data, _ in needles:
            fid = f"3,{format_needle_id_cookie(nid, cookie)}"
            status, _, body = _request("GET", "/" + fid, port=port)
            assert status == 200 and body == data, nid
        st = _request("GET", "/status", port=port)
        assert b'"reconstruct"' in st[2]
        _drop_conn(port)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        _drop_conn(port)
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
        rpc.reset_channels()
    assert not os.path.exists(recovery.marker_path(str(d)))
    mods = modules_file.read_text().split("\n")
    assert "seaweedfs_tpu_torch.server.volume" in mods
    assert "jax" not in mods
    assert not [m for m in mods if m == "seaweedfs_tpu"
                or m.startswith("seaweedfs_tpu.") or m.startswith("jax.")]


def test_volume_command_without_a_card_fails_at_start(tmp_path):
    """The default coder is the card: no CUDA device, no server — nothing
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the start without a CUDA device")
    proc, log = _spawn(["volume", "-dir", str(tmp_path), "-port",
                        str(_free_port_pair()), "-mserver",
                        f"localhost:{NOBODY}"], tmp_path,
                       tmp_path / "modules.txt")
    try:
        rc = proc.wait(timeout=120)
    finally:
        log.close()
    assert rc != 0
    assert "no CUDA device" in (tmp_path / "server.log").read_text()


# -- both packages' protobuf files in one process -------------------------------

PB_MODULES = ("volume_server_pb2", "scrub_pb2", "remote_pb2",
              "ec_geometry_pb2", "ec_gather_pb2", "qos_pb2", "ec_stream_pb2",
              "master_pb2")


@pytest.mark.parametrize("name", PB_MODULES)
def test_both_packages_protobuf_files_register_in_one_process(name):
    """The port's pb modules are the reference's: loaded beside them in one
    process, each message class describes the same type in the same file,
    and bytes written by one parse in the other."""
    import importlib

    ref = importlib.import_module(f"seaweedfs_tpu.pb.{name}")
    port = importlib.import_module(f"seaweedfs_tpu_torch.pb.{name}")

    def classes(mod):
        return {k: v for k, v in vars(mod).items()
                if isinstance(v, type) and hasattr(v, "DESCRIPTOR")
                and hasattr(v, "SerializeToString")}

    rc, pc = classes(ref), classes(port)
    assert rc and set(pc) == set(rc)
    for k in rc:
        assert pc[k].DESCRIPTOR.full_name == rc[k].DESCRIPTOR.full_name
        assert pc[k].DESCRIPTOR.file.name == rc[k].DESCRIPTOR.file.name
        assert (pc[k].DESCRIPTOR.file.serialized_pb
                == rc[k].DESCRIPTOR.file.serialized_pb)
    if name == "volume_server_pb2":
        msg = port.VolumeEcShardsMountRequest(volume_id=9, collection="c",
                                              shard_ids=[1, 2, 13])
        back = ref.VolumeEcShardsMountRequest.FromString(
            msg.SerializeToString())
        assert back.SerializeToString() == msg.SerializeToString()
