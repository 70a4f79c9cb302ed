"""The port's native host coder (ops/rs_native.py over ops/native/rs.cpp)
and its product-matrix geometry (models/geometry.py ProductMatrixMBR)
against the JAX package's, on the CPU.

g++ builds the port's library at first use, into ops/_build/, as it does
for the CRC. Its GF(2^8) matmul and XOR-schedule executor give the
reference library's bytes on seeded inputs (widths across the AVX2 step
and the executor's 16 KiB tile); ``RSCodecNative`` equals the reference's
and the numpy coder on every call of the codec surface for rs_10_4,
rs_6_3 and lrc_10_2_2; ``new_coder("native")`` and the CLI's
``-coder native`` build it. ``pm_mbr_6_3_5`` carries the reference's
generator, evaluation points, structured encode, helper symbols, node
repair and stripe decode, and every coder refuses it. Mirrors the native
and pm_mbr cases of tests/test_geometry.py and tests/test_rs_sched.py.
Every comparison of bytes is exact (tolerance 0)."""

import numpy as np
import pytest

from seaweedfs_tpu.models import geometry as ref_gm
from seaweedfs_tpu.ops import gf256 as ref_gf256
from seaweedfs_tpu.ops import rs_native as ref_native
from seaweedfs_tpu.ops import rs_sched as ref_sched
from seaweedfs_tpu.ops.rs_cpu import RSCodecCPU as RefCPU
from seaweedfs_tpu_torch import command
from seaweedfs_tpu_torch.models import geometry as gm
from seaweedfs_tpu_torch.models.coder import BACKENDS, new_coder
from seaweedfs_tpu_torch.ops import gf256, rs_native, rs_sched
from seaweedfs_tpu_torch.ops.rs_cpu import RSCodecCPU

PM = "pm_mbr_6_3_5"
GEOMETRIES = [("rs_10_4", 10, 4), ("rs_6_3", 6, 3), ("lrc_10_2_2", 10, 4)]


def _rng(seed):
    return np.random.default_rng(seed)


# -- the library ------------------------------------------------------------------


def test_the_library_builds_beside_the_kernels_with_every_entry():
    lib = rs_native.load_library()
    for name in ("swfs_gf_matmul", "swfs_xor_sched_exec", "swfs_crc32c",
                 "swfs_simd_level"):
        assert hasattr(lib, name), name
    assert rs_native.library_path().exists()
    assert rs_native.library_path().parent.name == "_build"
    assert rs_native.simd_level() == ref_native.simd_level()


@pytest.mark.parametrize("b", [1, 31, 32, 33, 4095, 16384, 40001])
def test_gf_matmul_native_equals_the_references(b):
    rng = _rng(b)
    for m, k in ((4, 10), (3, 6), (1, 1), (18, 12)):
        matrix = rng.integers(0, 256, (m, k), dtype=np.uint8)
        matrix[0, 0] = 1  # the plain-XOR branch
        if k > 1:
            matrix[-1, 1] = 0  # the skipped coefficient
        data = rng.integers(0, 256, (k, b), dtype=np.uint8)
        got = rs_native.gf_matmul_native(matrix, data)
        assert np.array_equal(got, ref_native.gf_matmul_native(matrix, data))
        assert np.array_equal(got, gf256.gf_matmul(matrix, data))
    with pytest.raises(ValueError):
        rs_native.gf_matmul_native(np.zeros((2, 3), np.uint8),
                                   np.zeros((4, 8), np.uint8))


@pytest.mark.parametrize("seed", range(4))
def test_xor_sched_exec_equals_the_references(seed):
    rng = _rng(100 + seed)
    for _ in range(4):
        m = rng.integers(0, 256, (int(rng.integers(1, 8)),
                                  int(rng.integers(1, 14))), dtype=np.uint8)
        if seed % 2:
            m = (m & 1).astype(np.uint8)  # heavy CSE: more than 4 scratch
        sched = rs_sched.compile_matrix(m)
        data = rng.integers(0, 256, (m.shape[1], int(rng.integers(1, 50000))),
                            dtype=np.uint8)
        out = np.empty((m.shape[0], data.shape[1]), np.uint8)
        rs_native.xor_sched_exec(sched.prog, data, out, sched.n_in,
                                 sched.n_out, sched.n_tmp)
        ref_out = ref_sched.compile_matrix(m).execute(data, "native")
        assert np.array_equal(out, ref_out)
        assert np.array_equal(out, gf256.gf_matmul(m, data))
    with pytest.raises(ValueError):
        rs_native.xor_sched_exec(sched.prog, data[:, ::2], out, sched.n_in,
                                 sched.n_out, sched.n_tmp)


# -- the native coder -------------------------------------------------------------


@pytest.mark.parametrize("name,k,m", GEOMETRIES)
def test_the_native_coder_equals_the_references(name, k, m):
    geom, ref_geom = gm.get(name), ref_gm.get(name)
    nat = rs_native.RSCodecNative(k, m, geometry=geom)
    ref = ref_native.RSCodecNative(k, m, geometry=ref_geom)
    cpu = RSCodecCPU(k, m, geometry=geom)
    rng = _rng(k * 100 + m)
    data = rng.integers(0, 256, (k, 3001), dtype=np.uint8)
    parity = nat.encode_parity(data)
    assert np.array_equal(parity, ref.encode_parity(data))
    assert np.array_equal(parity, cpu.encode_parity(data))
    shards = np.concatenate([data, parity])
    holes = np.concatenate([data, np.zeros((m, 3001), np.uint8)])
    assert np.array_equal(nat.encode(holes), shards)
    assert np.array_equal(ref.encode(holes), shards)
    assert nat.verify(shards)
    stack = rng.integers(0, 256, (3, k, 257), dtype=np.uint8)
    assert np.array_equal(nat.encode_parity_stacked(stack),
                          ref.encode_parity_stacked(stack))
    lost = (1, k + 1, k + m - 1)
    present = {i: shards[i] for i in range(k + m) if i not in lost}
    for fn in ("reconstruct", "reconstruct_data"):
        got, want = getattr(nat, fn)(present), getattr(ref, fn)(present)
        assert sorted(got) == sorted(want)
        for i in got:
            assert np.array_equal(np.asarray(got[i]), np.asarray(want[i]))
    pres = tuple(sorted(present))[::-1]
    stk = np.stack([shards[i] for i in pres])
    for kw in ({}, {"data_only": True}, {"want": (1,)}):
        m1, r1 = nat.reconstruct_stacked(pres, stk, **kw)
        m2, r2 = ref.reconstruct_stacked(pres, stk, **kw)
        assert tuple(m1) == tuple(m2), kw
        assert np.array_equal(np.asarray(r1), np.asarray(r2)), kw


def test_new_coder_native_and_the_cli_flag(tmp_path, monkeypatch):
    assert "native" in BACKENDS
    coder = new_coder(10, 4, backend="native", geometry="lrc_10_2_2")
    assert isinstance(coder, rs_native.RSCodecNative)
    assert coder.backend_reason == "cpu_explicit"
    assert coder.geometry_id == "lrc_10_2_2"
    built = []

    class Stop(RuntimeError):
        pass

    def fake_server(**kw):
        built.append(kw["coder"])
        raise Stop("built")

    from seaweedfs_tpu_torch.server import volume as volume_server

    monkeypatch.setattr(volume_server, "VolumeServer", fake_server)
    with pytest.raises(SystemExit, match="built"):
        command.main(["volume", "-dir", str(tmp_path), "-mserver",
                      "localhost:1", "-coder", "native"])
    assert isinstance(built[0], rs_native.RSCodecNative)
    assert built[0].backend_reason == "cpu_explicit"


# -- pm_mbr_6_3_5 -----------------------------------------------------------------


def test_pm_mbr_is_registered_with_the_references_construction():
    pm, ref = gm.get(PM), ref_gm.get(PM)
    assert isinstance(pm, gm.ProductMatrixMBR)
    assert pm is gm.pm_mbr(6, 3, 5)
    for attr in ("n_nodes", "k_nodes", "d_helpers", "message_symbols",
                 "sub_symbols", "data_shards", "parity_shards",
                 "volume_capable", "description"):
        assert getattr(pm, attr) == getattr(ref, attr), attr
    assert (pm.message_symbols, pm.volume_capable) == (12, False)
    assert np.array_equal(pm.psi, ref.psi)
    assert np.array_equal(pm.generator_matrix(), ref.generator_matrix())
    with pytest.raises(ValueError):
        gm.ProductMatrixMBR(6, 3, 6)  # d > n - 1
    w = _rng(3).integers(0, 256, (12, 9), np.uint8)
    assert np.array_equal(pm._message_matrix(w), ref._message_matrix(w))


@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_pm_mbr_refuses_every_coder(backend):
    g = gm.get(PM)
    with pytest.raises(ValueError, match="volume_capable"):
        new_coder(g.data_shards, g.parity_shards, backend=backend,
                  geometry=PM)
    with pytest.raises(ValueError, match="volume_capable"):
        gm.as_geometry(g.data_shards, g.parity_shards, g)
    with pytest.raises(TypeError):
        g.parity_matrix()
    with pytest.raises(TypeError):
        g.encode_matrix()
    with pytest.raises(TypeError):
        gm.encode_schedule(g)


@pytest.mark.parametrize("width", [1, 48, 4099])
def test_pm_mbr_encode_repair_and_decode_equal_the_references(width):
    pm, ref = gm.get(PM), ref_gm.get(PM)
    rng = _rng(width)
    w = rng.integers(0, 256, (pm.message_symbols, width), np.uint8)
    nodes = pm.encode_stripe(w)
    assert np.array_equal(nodes, ref.encode_stripe(w))
    # the structured encode is the generator matrix's product
    via = gf256.gf_matmul(pm.generator_matrix(), w).reshape(
        pm.n_nodes, pm.sub_symbols, -1)
    assert np.array_equal(nodes, via)
    assert np.array_equal(
        rs_native.gf_matmul_native(pm.generator_matrix(), w).reshape(
            nodes.shape), nodes)
    for failed in range(pm.n_nodes):
        helpers = [i for i in range(pm.n_nodes) if i != failed][
            : pm.d_helpers]
        recv = {j: pm.helper_symbol(nodes[j], failed) for j in helpers}
        for j in helpers:
            assert np.array_equal(recv[j], ref.helper_symbol(nodes[j],
                                                             failed))
        # repair moves d sub-symbols: one node's worth, not k nodes'
        assert sum(len(v) for v in recv.values()) == pm.sub_symbols * width
        rebuilt = pm.repair_node(failed, recv)
        assert np.array_equal(rebuilt, ref.repair_node(failed, recv))
        assert np.array_equal(rebuilt, nodes[failed])
    with pytest.raises(gm.UnsolvableError):
        pm.repair_node(0, {1: nodes[1][0]})
    for subset in ((0, 1, 2), (3, 4, 5), (0, 2, 5, 1)):
        got = pm.decode_stripe({i: nodes[i] for i in subset})
        assert np.array_equal(got, ref.decode_stripe(
            {i: nodes[i] for i in subset}))
        assert np.array_equal(got, w)
    with pytest.raises(gm.UnsolvableError):
        pm.decode_stripe({0: nodes[0], 1: nodes[1]})


def test_pm_mbr_generator_schedule_equals_the_references():
    g = gm.get(PM).generator_matrix()
    sched = rs_sched.compile_matrix(g)
    ref = ref_sched.compile_matrix(ref_gm.get(PM).generator_matrix())
    assert np.array_equal(sched.prog, ref.prog)
    w = _rng(5).integers(0, 256, (12, 20000), np.uint8)
    assert np.array_equal(sched.execute(w, "native"),
                          ref_gf256.gf_matmul(g, w))
    assert np.array_equal(sched.execute(w, "numpy"), gf256.gf_matmul(g, w))


def test_the_native_coder_equals_the_numpy_oracle_on_the_golden_fixture():
    import hashlib

    from tests.test_golden_identity import GOLDEN_SHARD_SHA256, _fixture

    data = _fixture()
    nat = new_coder(10, 4, backend="native")
    shards = np.concatenate([data, nat.encode_parity(data)])
    assert [hashlib.sha256(s.tobytes()).hexdigest()
            for s in shards] == GOLDEN_SHARD_SHA256
    assert np.array_equal(shards[10:], RefCPU(10, 4).encode_parity(data))
