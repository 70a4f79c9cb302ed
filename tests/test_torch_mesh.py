"""The port's multi-device coder (seaweedfs_tpu_torch/parallel/mesh.py) and
its scheduler lanes against the JAX package's, on the CPU.

The port's ShardedCoder runs over eight CPU entries
(``[torch.device("cpu")] * 8``); the reference's over the eight XLA CPU
devices that tests/conftest.py forces. Both get the same seeded inputs and
must give the same bytes (tolerance 0: GF arithmetic is exact) at every
split: ragged B (no multiple of 8 * 8), V not a multiple of 8 (3, 11),
V = 0, survivor sets in shuffled order with surplus rows, ``want=`` sets
smaller than k (lrc_10_2_2), both per-device kernels (K1 "xor", K2
"bits", through their plain versions here). The golden RS(10,4) shard
hashes hold through generate_ec_files on the mesh with the per-chip lanes
and the V-axis split each on and off. The dispatch scheduler over the
mesh keys its lanes and picks chips as the reference's does for the same
submissions; spreads 8 pipelines over every chip; keeps its survivor-set
chips in an LRU; takes the V-split branch for a big uniform rebuild
batch; and shuts down cleanly with chip lanes queued. Mirrors
tests/test_parallel.py and tests/test_mesh_dispatch.py."""

import hashlib
import os
import threading
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.models import geometry as ref_gm
from seaweedfs_tpu.ops import dispatch as ref_dispatch
from seaweedfs_tpu.ops.rs_cpu import RSCodecCPU as RefCPU
from seaweedfs_tpu.parallel import mesh as ref_mesh
from seaweedfs_tpu.storage import ec_files as ref_ec_files
from seaweedfs_tpu.storage.ec_locate import Geometry as RefGeometry
from seaweedfs_tpu_torch import entry
from seaweedfs_tpu_torch.models import geometry as gm
from seaweedfs_tpu_torch.models.coder import new_coder
from seaweedfs_tpu_torch.ops import dispatch, gf256
from seaweedfs_tpu_torch.ops.rs_cpu import RSCodecCPU
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
from seaweedfs_tpu_torch.parallel import mesh
from seaweedfs_tpu_torch.storage import ec_files
from seaweedfs_tpu_torch.storage.ec_locate import Geometry
from seaweedfs_tpu_torch.utils import locks, stats
from tests.test_golden_identity import GOLDEN_SHARD_SHA256, _fixture

N = 8
CPU8 = [torch.device("cpu")] * N
LRC = "lrc_10_2_2"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs beside other
    workers' timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_schedulers():
    """Every scheduler a test made is closed after it, no flusher thread
    is left, and the port's lock witness records no violation."""
    before = len(locks.violations())
    yield
    dispatch.shutdown_all()
    ref_dispatch.shutdown_all()
    assert not [s for s in list(dispatch._schedulers)
                if s._thread is not None and s._thread.is_alive()], \
        "leaked ec-dispatch flusher thread"
    assert len(locks.violations()) <= before, locks.violations()[before:]


def _port(k=10, m=4, kernel="xor", geometry=None):
    return mesh.ShardedCoder(k, m, mesh=mesh.make_mesh(CPU8), kernel=kernel,
                             geometry=geometry)


def _ref(k=10, m=4, kernel="xor", geometry=None):
    assert ref_mesh.device_count() == N
    return ref_mesh.ShardedCoder(k, m, kernel=kernel,
                                 geometry=ref_gm.get(geometry)
                                 if geometry else None)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rng(seed):
    return np.random.default_rng(seed)


def _shards(data, geometry=None) -> np.ndarray:
    cpu = RefCPU(10, 4, geometry=ref_gm.get(geometry) if geometry else None)
    return np.concatenate([data, np.asarray(cpu.encode_parity(data))])


# -- the device list -----------------------------------------------------------


def test_mesh_lists_repeated_entries_and_enumerates_through_nvml():
    m = mesh.make_mesh(CPU8)
    assert m.size == N and m.axis_names == (mesh.STRIPE_AXIS,)
    assert mesh.ShardedCoder(10, 4, mesh=m).placement_devices() == CPU8
    assert mesh.local_devices() == [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    assert mesh.device_count() == torch.cuda.device_count()
    if mesh.device_count() == 0:
        # no card: the default mesh refuses, nothing falls back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.ShardedCoder(10, 4)
    with pytest.raises(ValueError, match="kernel"):
        mesh.ShardedCoder(10, 4, mesh=m, kernel="sel")


@pytest.mark.parametrize("backend", ["mesh", "single", "cuda"])
def test_device_backends_raise_without_a_card(backend, monkeypatch):
    if mesh.device_count():
        pytest.skip("a CUDA device is visible")
    monkeypatch.delenv("SEAWEEDFS_TORCH_CODER", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        new_coder(10, 4, backend=backend)


# -- the column split ----------------------------------------------------------


@pytest.mark.parametrize("b", [5000, 1, 7, 64, 3 * 64 + 5, 1 << 13])
@pytest.mark.parametrize("kernel", ["xor", "bits"])
def test_encode_parity_matches_the_reference(kernel, b):
    data = _rng(b).integers(0, 256, (10, b), dtype=np.uint8)
    got = _port(kernel=kernel).encode_parity(data)
    assert got.shape == (4, b) and got.dtype == torch.uint8
    assert np.array_equal(_np(got),
                          np.asarray(_ref(kernel=kernel).encode_parity(data)))
    assert np.array_equal(_np(got), RSCodecCPU(10, 4).encode_parity(data))


@pytest.mark.parametrize("k,m", [(6, 3), (12, 4)])
def test_other_rs_geometries(k, m):
    data = _rng(k).integers(0, 256, (k, 999), dtype=np.uint8)
    assert np.array_equal(_np(_port(k, m).encode_parity(data)),
                          np.asarray(_ref(k, m).encode_parity(data)))


@pytest.mark.parametrize("kernel", ["xor", "bits"])
def test_encode_and_reconstruct_match_the_reference(kernel):
    data = _rng(1).integers(0, 256, (10, 2048), dtype=np.uint8)
    port, ref = _port(kernel=kernel), _ref(kernel=kernel)
    shards = _np(port.encode(data))
    assert np.array_equal(shards, np.asarray(ref.encode(data)))
    for fn in ("reconstruct", "reconstruct_data"):
        survivors = {i: shards[i] for i in range(14)
                     if i not in (1, 4, 10, 12)}
        got = getattr(port, fn)(survivors)
        want = getattr(ref, fn)(survivors)
        assert sorted(got) == sorted(want)
        for i in got:
            assert np.array_equal(_np(got[i]), np.asarray(want[i]))
            assert np.array_equal(_np(got[i]), shards[i])
        # list form with None holes, as the reference accepts it
        listed = [None if i in (1, 4, 10, 12) else shards[i]
                  for i in range(14)]
        assert sorted(getattr(port, fn)(listed)) == sorted(want)
    assert port.reconstruct({i: shards[i] for i in range(14)}) == {}


@pytest.mark.parametrize("data_only", [False, True])
def test_reconstruct_stacked_over_survivor_permutations(data_only):
    port, ref = _port(), _ref()
    rng = _rng(7)
    shards = _shards(rng.integers(0, 256, (10, 4096), dtype=np.uint8))
    for trial in range(4):
        ids = list(range(14))
        rng.shuffle(ids)
        pres = tuple(ids[:10 + trial])  # surplus rows take zero columns
        stk = np.stack([shards[i] for i in pres])
        m1, r1 = port.reconstruct_stacked(pres, stk, data_only=data_only)
        m2, r2 = ref.reconstruct_stacked(pres, stk, data_only=data_only)
        assert m1 == tuple(m2)
        assert np.array_equal(_np(r1), np.asarray(r2))
        for j, i in enumerate(m1):
            assert np.array_equal(_np(r1)[j], shards[i])
    m0, r0 = port.reconstruct_stacked(tuple(range(14)), shards)
    assert m0 == () and tuple(r0.shape) == (0, 4096)


# -- the V-axis split ----------------------------------------------------------


@pytest.mark.parametrize("v", [3, 8, 11, 16])
def test_vsharded_encode_stacked_matches_the_reference(v):
    """V >= 8 splits the slabs over the entries (11: uneven parts); V = 3
    falls back to the column split. Both equal per-slab encodes, the
    reference mesh and both packages' CPU mirror of the V split."""
    stack = _rng(31).integers(0, 256, (v, 10, 257), dtype=np.uint8)
    got = _np(_port().encode_parity_stacked(stack))
    assert got.shape == (v, 4, 257)
    assert np.array_equal(got, np.asarray(_ref().encode_parity_stacked(stack)))
    per_slab = np.stack([RSCodecCPU(10, 4).encode_parity(s) for s in stack])
    assert np.array_equal(got, per_slab)
    assert np.array_equal(
        RSCodecCPU(10, 4).encode_parity_stacked_vsharded(stack, N), per_slab)
    assert np.array_equal(RefCPU(10, 4).encode_parity_stacked_vsharded(
        stack, N), per_slab)


@pytest.mark.parametrize("mesh_vshard", ["1", "0"])
def test_vsharded_encode_ragged_widths(mesh_vshard, monkeypatch):
    """Ragged slab tails ride zero columns through either split, and zero
    columns encode to zero."""
    monkeypatch.setenv("SWFS_EC_MESH_VSHARD", mesh_vshard)
    rng = _rng(32)
    widths = [512, 100, 37, 512, 9, 300, 64, 200, 411]
    stack = np.zeros((len(widths), 10, max(widths)), dtype=np.uint8)
    for i, w in enumerate(widths):
        stack[i, :, :w] = rng.integers(0, 256, (10, w), dtype=np.uint8)
    got = _np(_port().encode_parity_stacked(stack))
    assert np.array_equal(got, np.asarray(_ref().encode_parity_stacked(stack)))
    for i, w in enumerate(widths):
        assert np.array_equal(got[i][:, :w],
                              RSCodecCPU(10, 4).encode_parity(stack[i, :, :w]))
        assert not got[i][:, w:].any()


@pytest.mark.parametrize("data_only", [False, True])
def test_vsharded_reconstruct_over_survivor_permutations(data_only):
    port, ref = _port(), _ref()
    rng = _rng(33)
    shards = _shards(rng.integers(0, 256, (10, 130), dtype=np.uint8))
    for _ in range(4):
        ids = list(range(14))
        rng.shuffle(ids)
        pres = tuple(ids[:11])
        stk = np.stack([shards[i] for i in pres])
        vstack = np.stack([stk] * 9)  # V = 9 over 8 entries
        m1, r1 = port.reconstruct_stacked_vsharded(pres, vstack,
                                                   data_only=data_only)
        m2, r2 = ref.reconstruct_stacked_vsharded(pres, vstack,
                                                  data_only=data_only)
        assert m1 == tuple(m2)
        assert np.array_equal(_np(r1), np.asarray(r2))


def test_vsharded_reconstruct_shape_contract_at_v0_and_nothing_missing():
    port, ref = _port(), _ref()
    pres = tuple(range(1, 14))
    empty = np.zeros((0, 13, 100), np.uint8)
    m1, r1 = port.reconstruct_stacked_vsharded(pres, empty)
    m2, r2 = ref.reconstruct_stacked_vsharded(pres, empty)
    assert m1 == tuple(m2) == (0,)
    assert tuple(r1.shape) == tuple(r2.shape) == (0, 1, 100)
    full = np.zeros((3, 14, 100), np.uint8)
    m1, r1 = port.reconstruct_stacked_vsharded(tuple(range(14)), full)
    m2, r2 = ref.reconstruct_stacked_vsharded(tuple(range(14)), full)
    assert m1 == tuple(m2) == ()
    assert tuple(r1.shape) == tuple(r2.shape) == (3, 0, 100)


# -- the probe, the kernels, the other geometries -----------------------------


@pytest.mark.parametrize("kernel", ["xor", "bits"])
def test_parity_probe_and_checksum(kernel):
    port, ref = _port(kernel=kernel), _ref(kernel=kernel)
    shards = _shards(_rng(2).integers(0, 256, (10, 1024), dtype=np.uint8))
    assert int(port.parity_probe(shards)) == 0
    assert int(port.parity_checksum(shards)) == 0
    assert port.verify(shards)
    for row, col, flip in ((3, 100, 0xFF), (12, 1023, 0x05), (0, 0, 0x80)):
        bad = shards.copy()
        bad[row, col] ^= flip
        got = port.parity_checksum(bad)
        assert got.dtype == torch.int32 and got.dim() == 0
        assert int(got) == int(np.asarray(ref.parity_checksum(bad))) != 0
        assert int(port.parity_probe(bad)) == int(got)
        assert not port.verify(bad)


def test_the_two_kernels_agree():
    data = _rng(21).integers(0, 256, (10, 4096), dtype=np.uint8)
    out = {}
    for kernel in ("xor", "bits"):
        coder = _port(kernel=kernel)
        shards = _np(coder.encode(data))
        rebuilt = coder.reconstruct({i: shards[i] for i in range(14)
                                     if i not in (2, 7, 13)})
        out[kernel] = (shards, {i: _np(v) for i, v in rebuilt.items()})
    assert np.array_equal(out["xor"][0], out["bits"][0])
    for i in (2, 7, 13):
        assert np.array_equal(out["xor"][1][i], out["bits"][1][i])


def test_lrc_encode_reconstruct_and_minimal_reads():
    port, ref = _port(geometry=LRC), _ref(geometry=LRC)
    assert port.geometry_id == LRC
    data = _rng(29).integers(0, 256, (10, 4096), dtype=np.uint8)
    shards = _shards(data, LRC)
    assert np.array_equal(_np(port.encode(data)), shards)
    pres = tuple(i for i in range(14) if i not in (1, 6))
    stk = np.stack([shards[i] for i in pres])
    m1, r1 = port.reconstruct_stacked(pres, stk)
    m2, r2 = ref.reconstruct_stacked(pres, stk)
    assert m1 == tuple(m2) and np.array_equal(_np(r1), np.asarray(r2))
    rec = port.reconstruct({i: shards[i] for i in range(14)
                            if i not in (3, 12)})
    assert np.array_equal(_np(rec[3]), shards[3])
    assert np.array_equal(_np(rec[12]), shards[12])
    # a local group's 5 survivors repair one loss: fewer rows than k
    plan = gm.get(LRC).repair_plan((2,), tuple(i for i in range(14)
                                               if i != 2))
    assert len(plan.reads) == 5
    lstk = np.stack([shards[i] for i in plan.reads])
    m1, r1 = port.reconstruct_stacked(plan.reads, lstk, want=(2,))
    m2, r2 = ref.reconstruct_stacked(plan.reads, lstk, want=(2,))
    assert m1 == tuple(m2) == (2,)
    assert np.array_equal(_np(r1), np.asarray(r2))
    assert np.array_equal(_np(r1)[0], shards[2])
    vstack = np.stack([lstk] * 3)
    m1, r1 = port.reconstruct_stacked_vsharded(plan.reads, vstack, want=(2,))
    m2, r2 = ref.reconstruct_stacked_vsharded(plan.reads, vstack, want=(2,))
    assert m1 == tuple(m2) == (2,)
    assert np.array_equal(_np(r1), np.asarray(r2))
    # the RS want form through the V split too
    rs_shards = _shards(data)
    rpres = tuple(i for i in range(14) if i != 3)
    rv = np.stack([np.stack([rs_shards[i] for i in rpres])] * 4)
    m1, r1 = _port().reconstruct_stacked_vsharded(rpres, rv, want=(3,))
    m2, r2 = _ref().reconstruct_stacked_vsharded(rpres, rv, want=(3,))
    assert m1 == tuple(m2) == (3,)
    assert np.array_equal(_np(r1), np.asarray(r2))


def test_pm_mbr_6_3_5_on_the_mesh():
    """The product-matrix geometry is a stripe codec: both packages'
    coders refuse it, and its generator and repair products, run through
    the mesh's column split, equal the reference's structured encode and
    node repair."""
    name = "pm_mbr_6_3_5"
    pm, ref_pm = gm.get(name), ref_gm.get(name)
    assert np.array_equal(pm.generator_matrix(), ref_pm.generator_matrix())
    for make in (lambda: _port(12, 18, geometry=name),
                 lambda: _ref(12, 18, geometry=name)):
        with pytest.raises(ValueError, match="volume_capable"):
            make()
    m8 = mesh.make_mesh(CPU8)
    w = _rng(35).integers(0, 256, (pm.message_symbols, 4099), np.uint8)
    for kernel in ("xor", "bits"):
        nodes = _np(mesh._apply_sharded(pm.generator_matrix(),
                                        ("pm_gen", name), w, m8, kernel))
        nodes = nodes.reshape(pm.n_nodes, pm.sub_symbols, -1)
        assert np.array_equal(nodes, ref_pm.encode_stripe(w))
        failed = 1
        helpers = [i for i in range(pm.n_nodes) if i != failed][
            : pm.d_helpers]
        recv = np.stack([ref_pm.helper_symbol(nodes[j], failed)
                         for j in helpers])
        inv = gf256.gf_mat_inv(pm.psi[helpers])
        rebuilt = _np(mesh._apply_sharded(inv, ("pm_rep", name, failed),
                                          recv, m8, kernel))
        assert np.array_equal(rebuilt, ref_pm.repair_node(
            failed, dict(zip(helpers, recv))))
        assert np.array_equal(rebuilt, nodes[failed])


# -- per-chip entries and RSCodecTorch's device= -------------------------------


def test_per_chip_entries_match_the_reference():
    port, ref = _port(), _ref()
    assert port.prefers_vstack and ref.prefers_vstack
    rng = _rng(40)
    stack = rng.integers(0, 256, (3, 10, 300), dtype=np.uint8)
    dev = port.placement_devices()[5]
    ref_dev = ref.placement_devices()[5]
    assert np.array_equal(_np(port.encode_parity_stacked_on(stack, dev)),
                          np.asarray(ref.encode_parity_stacked_on(stack,
                                                                  ref_dev)))
    assert np.array_equal(_np(port.encode_parity_on(stack[0], dev)),
                          np.asarray(ref.encode_parity_on(stack[0], ref_dev)))
    shards = _shards(stack[1])
    pres = (13, 0, 2, 3, 4, 6, 7, 8, 9, 11, 12)
    stk = np.stack([shards[i] for i in pres])
    for kw in ({}, {"data_only": True}, {"want": (1, 5)}):
        m1, r1 = port.reconstruct_stacked_on(pres, stk, device=dev, **kw)
        m2, r2 = ref.reconstruct_stacked_on(pres, stk, device=ref_dev, **kw)
        assert m1 == tuple(m2), kw
        assert np.array_equal(_np(r1), np.asarray(r2)), kw


def test_rs_codec_torch_takes_device_and_parity_checksum():
    codec = RSCodecTorch(10, 4, device="cpu")
    data = _rng(41).integers(0, 256, (10, 777), dtype=np.uint8)
    want = RSCodecCPU(10, 4).encode_parity(data)
    assert np.array_equal(_np(codec.encode_parity(data, device="cpu")), want)
    got = codec.encode_parity_stacked(np.stack([data, data]),
                                      device=torch.device("cpu"))
    assert np.array_equal(_np(got), np.stack([want, want]))
    shards = np.concatenate([data, want])
    pres = tuple(range(3, 14))
    m1, r1 = codec.reconstruct_stacked(pres, shards[3:], device="cpu")
    assert m1 == (0, 1, 2) and np.array_equal(_np(r1), shards[:3])
    assert RSCodecTorch.parity_checksum is RSCodecTorch.parity_probe
    assert int(codec.parity_checksum(shards)) == 0


# -- the file pipeline ----------------------------------------------------------


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("lanes", ["1", "0"])
@pytest.mark.parametrize("mesh_vshard", ["1", "0"])
def test_golden_shard_hashes_through_generate_ec_files(lanes, mesh_vshard,
                                                       tmp_path, monkeypatch):
    """The frozen RS(10,4) fixture as a .dat of one small row: its 14
    shard files through the mesh coder and the scheduler (8 slabs of 512
    columns) hash to GOLDEN_SHARD_SHA256, with the per-chip lanes and the
    V-axis split each on and off; and the rebuild of three is identical."""
    monkeypatch.setenv("SWFS_EC_DISPATCH_VSHARD", lanes)
    monkeypatch.setenv("SWFS_EC_MESH_VSHARD", mesh_vshard)
    geo = Geometry(large_block=1 << 20, small_block=4096)
    base = str(tmp_path / "g")
    with open(base + ".dat", "wb") as f:
        f.write(_fixture().tobytes())
    coder = _port()
    ec_files.generate_ec_files(base, coder, geo, batch_size=512)
    got = [_sha(geo.shard_file_name(base, i)) for i in range(14)]
    assert got == GOLDEN_SHARD_SHA256
    for i in (0, 5, 13):
        os.remove(geo.shard_file_name(base, i))
    assert ec_files.rebuild_ec_files(base, coder, geo,
                                     batch_size=512) == [0, 5, 13]
    assert [_sha(geo.shard_file_name(base, i))
            for i in range(14)] == GOLDEN_SHARD_SHA256


@pytest.mark.parametrize("geometry", [None, LRC])
def test_generate_and_rebuild_match_the_reference_files(geometry, tmp_path,
                                                        monkeypatch):
    """A ragged payload across the test geometry's large and small rows:
    the port mesh's shard files equal the reference mesh's, with the
    per-chip lanes on and off, and a 3-shard rebuild restores them."""
    payload = _rng(9).integers(0, 256, 351_003, dtype=np.uint8).tobytes()
    files = {}
    for pkg in ("ref", "port0", "port1"):
        base = str(tmp_path / pkg)
        with open(base + ".dat", "wb") as f:
            f.write(payload)
        if pkg == "ref":
            geo = RefGeometry(large_block=10000, small_block=100,
                              code=geometry or "rs_10_4")
            ref_ec_files.generate_ec_files(base, _ref(geometry=geometry),
                                           geo, batch_size=2000)
        else:
            monkeypatch.setenv("SWFS_EC_DISPATCH_VSHARD", pkg[-1])
            geo = Geometry(large_block=10000, small_block=100,
                           code=geometry or "rs_10_4")
            coder = _port(geometry=geometry)
            ec_files.generate_ec_files(base, coder, geo, batch_size=2000)
            hashes = [_sha(geo.shard_file_name(base, i)) for i in range(14)]
            for i in (1, 6, 12):
                os.remove(geo.shard_file_name(base, i))
            ec_files.rebuild_ec_files(base, coder, geo, batch_size=2000)
            assert [_sha(geo.shard_file_name(base, i))
                    for i in range(14)] == hashes
        files[pkg] = [_sha(geo.shard_file_name(base, i)) for i in range(14)]
    assert files["port0"] == files["ref"]
    assert files["port1"] == files["ref"]


def test_dryrun_multichip_and_entry_on_cpu_entries():
    import __graft_entry__ as ge

    fn, (example,) = entry.entry("cpu")
    ref_fn, (ref_example,) = ge.entry()
    assert np.array_equal(example, ref_example)
    out = fn(example)
    assert out.device.type == "cpu" and tuple(out.shape) == (14, 64 * 1024)
    assert np.array_equal(_np(out), np.asarray(ref_fn(ref_example)))
    entry.dryrun_multichip(N, "cpu")
    assert entry.mesh_devices(3, "cpu") == [torch.device("cpu")] * 3
    if mesh.device_count() == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.dryrun_multichip(2)


# -- the scheduler's per-chip lanes --------------------------------------------


def _survivor_sets(n: int) -> list[tuple]:
    return [tuple(i for i in range(14) if i not in (d, d + 4, d + 8))[:11]
            for d in range(n)]


def test_lane_keys_and_chips_equal_the_references():
    """One submission sequence (encode slabs and reconstructs of several
    survivor sets, one set twice) into both packages' schedulers over
    their meshes, with a window that never fires: the same lane keys in
    the same order, the same chip per survivor set, the same per-chip
    depths; then close() drains both and every result is equal."""
    port = dispatch.EcDispatchScheduler(_port(), window=30.0)
    ref = ref_dispatch.EcDispatchScheduler(_ref(), window=30.0)
    rng = _rng(50)
    shards = _shards(rng.integers(0, 256, (10, 96), dtype=np.uint8))
    futs = []
    sets = _survivor_sets(5)
    for i in range(21):
        slab = rng.integers(0, 256, (10, 40 + i), dtype=np.uint8)
        futs.append((port.encode_parity(slab), ref.encode_parity(slab)))
        if i % 4 == 0:
            pres = sets[(i // 4) % len(sets)]
            stk = np.stack([shards[j] for j in pres])
            futs.append((port.reconstruct_stacked(pres, stk),
                         ref.reconstruct_stacked(pres, stk)))
    assert list(port._lanes) == list(ref._lanes)
    assert dict(port._rec_chips) == dict(ref._rec_chips)
    assert port.chip_depths() == ref.chip_depths()
    assert len([c for c in port.chip_depths() if c != "-"]) == N
    port.close()
    ref.close()
    for f, rf in futs:
        a, b = f.result(timeout=10), rf.result(timeout=10)
        if isinstance(a, tuple):
            assert a[0] == tuple(b[0])
            a, b = a[1], b[1]
        assert np.array_equal(_np(a), np.asarray(b))


def test_encode_lanes_spread_over_every_chip_with_reason_chip_affine():
    coder = _port()
    sched = dispatch.EcDispatchScheduler(coder, window=0.05)
    rng = _rng(34)
    b0 = stats.EC_DISPATCH_BATCHES.split_by("chip", lane="encode")
    r0 = stats.EC_DISPATCH_BATCHES.value(lane="encode", reason="chip_affine")
    slabs = [rng.integers(0, 256, (10, 64 + 8 * i), dtype=np.uint8)
             for i in range(3 * N)]
    futs = [sched.encode_parity(s) for s in slabs]
    for s, f in zip(slabs, futs):
        assert np.array_equal(np.asarray(f), RSCodecCPU(10, 4).encode_parity(s))
        assert f.chip != "-"
    b1 = stats.EC_DISPATCH_BATCHES.split_by("chip", lane="encode")
    for c in range(N):
        assert b1.get(str(c), 0) > b0.get(str(c), 0), f"chip {c} starved"
    assert stats.EC_DISPATCH_BATCHES.value(
        lane="encode", reason="chip_affine") > r0
    sched.close()


def test_the_lane_gate_restores_one_funnel(monkeypatch):
    """SWFS_EC_DISPATCH_VSHARD=0: no chip lanes; the batches say
    vshard_off and the bytes are unchanged (the non-chip lane keeps the
    [V, k, B] stack the mesh splits by slab)."""
    monkeypatch.setenv("SWFS_EC_DISPATCH_VSHARD", "0")
    sched = dispatch.EcDispatchScheduler(_port(), window=0.05)
    b0 = stats.EC_DISPATCH_BATCHES.split_by("chip", lane="encode")
    v0 = stats.EC_DISPATCH_BATCHES.value(lane="encode", reason="vshard_off")
    rng = _rng(35)
    slabs = [rng.integers(0, 256, (10, 96 - i), dtype=np.uint8)
             for i in range(12)]
    futs = [sched.encode_parity(s) for s in slabs]
    for s, f in zip(slabs, futs):
        assert np.array_equal(np.asarray(f), RSCodecCPU(10, 4).encode_parity(s))
    b1 = stats.EC_DISPATCH_BATCHES.split_by("chip", lane="encode")
    assert b1.get("-", 0) > b0.get("-", 0)
    assert all(b1.get(str(c), 0) == b0.get(str(c), 0) for c in range(N))
    assert stats.EC_DISPATCH_BATCHES.value(
        lane="encode", reason="vshard_off") > v0
    sched.close()


def test_eight_pipelines_load_every_chip():
    coder = _port()
    sched = dispatch.EcDispatchScheduler(coder, window=0.02)
    rng = _rng(36)
    payloads = [[rng.integers(0, 256, (10, 128), dtype=np.uint8)
                 for _ in range(6)] for _ in range(8)]
    want = [[RSCodecCPU(10, 4).encode_parity(s) for s in lane]
            for lane in payloads]
    b0 = stats.EC_DISPATCH_BATCHES.split_by("chip", lane="encode")
    errs = []
    barrier = threading.Barrier(8)

    def pipeline(i):
        try:
            barrier.wait()
            futs = [sched.encode_parity(s) for s in payloads[i]]
            for w, f in zip(want[i], futs):
                assert np.array_equal(np.asarray(f), w)
        except BaseException as e:  # raised below, on the main thread
            errs.append(e)

    threads = [threading.Thread(target=pipeline, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs[0]
    b1 = stats.EC_DISPATCH_BATCHES.split_by("chip", lane="encode")
    for c in range(N):
        assert b1.get(str(c), 0) > b0.get(str(c), 0), f"chip {c} starved"
    sched.close()


def test_survivor_set_chips_are_an_lru_like_the_references():
    port = dispatch.EcDispatchScheduler(_port(), window=0.02)
    ref = ref_dispatch.EcDispatchScheduler(_ref(), window=0.02)
    port._rec_max = ref._rec_max = 4
    rng = _rng(37)
    shards = _shards(rng.integers(0, 256, (10, 96), dtype=np.uint8))
    sets = _survivor_sets(6)  # 6 distinct sets > the LRU's 4
    for pres in sets + [sets[0]]:
        stk = np.stack([shards[i] for i in pres])
        m1, r1 = port.reconstruct_stacked(pres, stk).result()
        m2, r2 = ref.reconstruct_stacked(pres, stk).result()
        assert m1 == tuple(m2)
        assert np.array_equal(_np(r1), np.asarray(r2))
        assert dict(port._rec_chips) == dict(ref._rec_chips)
    assert len(port._rec_chips) <= 4
    assert len(set(port._rec_chips.values())) > 1
    port.close()
    ref.close()


def test_a_big_uniform_rebuild_batch_splits_by_slab(monkeypatch):
    """A reconstruct lane whose backlog holds >= chips slabs of one width
    flushes through reconstruct_stacked_vsharded, not its one chip."""
    coder = _port()
    calls = []
    real = coder.reconstruct_stacked_vsharded

    def spy(*a, **kw):
        calls.append(np.asarray(a[1]).shape)
        return real(*a, **kw)

    monkeypatch.setattr(coder, "reconstruct_stacked_vsharded", spy)
    sched = dispatch.EcDispatchScheduler(coder, window=30.0, max_slabs=64)
    rng = _rng(39)
    shards = _shards(rng.integers(0, 256, (10, 128), dtype=np.uint8))
    pres = tuple(i for i in range(14) if i not in (1, 6, 12))
    stk = np.stack([shards[i] for i in pres])
    want = RSCodecCPU(10, 4).reconstruct_stacked(pres, stk)
    futs = [sched.reconstruct_stacked(pres, stk, copy=True)
            for _ in range(2 * N)]
    sched.flush()  # the whole lane as ONE batch
    for f in futs:
        m, rows = f.result(timeout=30)
        assert m == tuple(want[0])
        assert np.array_equal(_np(rows), np.asarray(want[1]))
    assert calls == [(2 * N, 11, 128)]
    sched.close()


def test_demand_flush_through_a_chip_lane():
    sched = dispatch.EcDispatchScheduler(_port(), window=30.0)
    data = np.arange(640, dtype=np.uint8).reshape(10, 64)
    t0 = time.perf_counter()
    out = np.asarray(sched.encode_parity(data).result(timeout=10))
    assert time.perf_counter() - t0 < 5.0
    assert np.array_equal(out, RSCodecCPU(10, 4).encode_parity(data))
    sched.close()


def test_clean_shutdown_with_chip_lanes_queued():
    sched = dispatch.EcDispatchScheduler(_port(), window=30.0)
    rng = _rng(38)
    slabs = [rng.integers(0, 256, (10, 80), dtype=np.uint8)
             for _ in range(2 * N)]
    futs = [sched.encode_parity(s) for s in slabs]
    assert sched.pending() == len(slabs)
    depths = sched.chip_depths()
    assert sum(depths.values()) == len(slabs)
    assert sorted(depths) == sorted(str(c) for c in range(N))
    sched.close()
    for s, f in zip(slabs, futs):
        assert f.done()
        assert np.array_equal(np.asarray(f.result(timeout=1)),
                              RSCodecCPU(10, 4).encode_parity(s))
    with pytest.raises(RuntimeError):
        sched.encode_parity(np.zeros((10, 8), np.uint8))
    sched.close()  # idempotent


def test_a_flush_completion_covers_every_device_it_read():
    """On CPU entries there is no event to record; a flush's completion
    is proven at once, whatever devices it lists."""
    done = dispatch.FlushDone.after(torch.zeros(3), CPU8)
    assert done.event is None and done.others == ()
    assert done.is_ready() and dispatch._consumed(done)
    sched = dispatch.EcDispatchScheduler(_port(), window=30.0)
    assert sched._flush_devices(None) == CPU8
    assert sched._flush_devices(CPU8[2]) == [CPU8[2]]
    sched.close()


@pytest.mark.parametrize("backend", ["mesh", "native"])
def test_store_coder_for_keeps_the_mesh_and_the_native_backend(backend,
                                                               tmp_path):
    """A Store over a mesh coder (or the native host coder) builds its
    other geometries' coders on the same backend: the same device list
    and kernel, or RSCodecNative again."""
    from seaweedfs_tpu_torch.ops.rs_native import RSCodecNative
    from seaweedfs_tpu_torch.storage.store import Store

    coder = (_port(kernel="bits") if backend == "mesh"
             else new_coder(10, 4, backend="native"))
    st = Store([str(tmp_path)], coder=coder)
    try:
        lrc = st.coder_for(Geometry(code=LRC))
        assert st.coder_for(Geometry()) is coder
        assert lrc.geometry_id == LRC and type(lrc) is type(coder)
        if backend == "mesh":
            assert lrc.mesh == coder.mesh and lrc.kernel == "bits"
        else:
            assert isinstance(lrc, RSCodecNative)
            assert lrc.backend_reason == "cpu_explicit"
        data = _rng(42).integers(0, 256, (10, 999), dtype=np.uint8)
        assert np.array_equal(_np(lrc.encode_parity(data)),
                              _shards(data, LRC)[10:])
    finally:
        st.close()
