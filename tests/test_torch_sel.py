"""Kernel K3 (the xtime-select formulation, seaweedfs_tpu_torch/ops/rs_sel.py)
against the JAX package's, its routing in RSCodecTorch, and its per-matrix
build.

The plain PyTorch version of K3 is held against seaweedfs_tpu's
``apply_matrix_sel_pallas(interpret=True)`` (the Pallas kernel in the
interpreter, as tests/test_rs_xor.py runs it), ``apply_matrix_sel`` (the
XLA form) and the port's numpy table codec. The CUDA kernel runs only on a
card: chip_smoke.py holds it against this plain version there. Exact:
tolerance 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seaweedfs_tpu.models import geometry as ref_geometry
from seaweedfs_tpu.ops import rs_xor as ref_rs_xor
from seaweedfs_tpu.ops.rs_jax import RSCodecJax
from seaweedfs_tpu_torch.ops import _build, gf256, rs_sel, rs_torch, rs_xor
from seaweedfs_tpu_torch.ops.rs_cpu import RSCodecCPU
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch

TILE = ref_rs_xor.TILE_BYTES
WIDTHS = [TILE, TILE + 333, 4095, 1]
MATRICES = ["rs_10_4", "rs_6_3", "rs_12_4", "lrc_10_2_2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs beside other
    workers' timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _encode_matrix(name: str) -> np.ndarray:
    """The encode (parity) matrix of a geometry, from the JAX package."""
    return ref_geometry.get(name).parity_matrix()


def _data(c: int, b: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(c, b),
                                                dtype=np.uint8)


@pytest.mark.parametrize("b", WIDTHS)
@pytest.mark.parametrize("name", MATRICES)
def test_sel_plain_matches_jax_pallas_xla_and_oracle(name, b):
    m = _encode_matrix(name)
    d = _data(m.shape[1], b, seed=b + 31 * len(name))
    got = rs_sel.gf_matmul_sel_torch(m, torch.from_numpy(d)).numpy()
    assert got.dtype == np.uint8 and got.shape == (m.shape[0], b)
    pallas = np.asarray(ref_rs_xor.apply_matrix_sel_pallas(
        m, jnp.asarray(d), interpret=True))
    xla = np.asarray(ref_rs_xor.apply_matrix_sel(m, jnp.asarray(d)))
    oracle = RSCodecCPU(10, 4)._matmul(m, d)
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, xla)
    assert np.array_equal(got, oracle)


def _sel_all_agree(m: np.ndarray, view: torch.Tensor) -> None:
    """K3's plain version on `view` (any row stride) equals the JAX
    package's Pallas kernel in the interpreter, its XLA form and the
    rs_cpu oracle, byte for byte."""
    d = np.ascontiguousarray(view.numpy())
    got = rs_sel.gf_matmul_sel_torch(m, view).numpy()
    assert got.dtype == np.uint8 and got.shape == (m.shape[0], d.shape[1])
    pallas = np.asarray(ref_rs_xor.apply_matrix_sel_pallas(
        m, jnp.asarray(d), interpret=True))
    xla = np.asarray(ref_rs_xor.apply_matrix_sel(m, jnp.asarray(d)))
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, xla)
    assert np.array_equal(got, RSCodecCPU(10, 4)._matmul(m, d))


@pytest.mark.parametrize("r", [1, 2, 3, 4, 5, 6, 7, 8, 14])
def test_sel_plain_at_every_r(r):
    rng = np.random.default_rng(300 + r)
    m = rng.integers(0, 256, size=(r, 10), dtype=np.uint8)
    _sel_all_agree(m, torch.from_numpy(_data(10, 1000 + r, seed=r)))


@pytest.mark.parametrize("offset", range(16))
def test_sel_plain_on_column_slices(offset):
    """A column slice at each byte offset of a buffer whose row stride
    (4133) is no multiple of 16: the layout the kernel realigns."""
    wide = torch.from_numpy(_data(10, 4133, seed=400 + offset))
    _sel_all_agree(_encode_matrix("rs_10_4"),
                   wide[:, offset:offset + 4096 + 7])


@pytest.mark.parametrize("b", range(1, 48))
def test_sel_plain_at_narrow_widths(b):
    _sel_all_agree(_encode_matrix("rs_10_4"),
                   torch.from_numpy(_data(10, b, seed=500 + b)))


@pytest.mark.parametrize("name", MATRICES)
def test_matrix_bit_rows_equal(name):
    m = _encode_matrix(name)
    assert rs_sel._matrix_bit_rows(m) == ref_rs_xor._matrix_bit_rows(m)
    assert sum(len(r) for r in rs_sel._matrix_bit_rows(m)) == \
        int(np.unpackbits(m).sum())


def test_sel_plain_takes_row_strided_views_and_checks_shapes():
    m = gf256.parity_matrix(10, 4)
    wide = _data(10, 5000, seed=3)
    view = torch.from_numpy(wide)[:, 7:7 + 4093]
    got = rs_sel.gf_matmul_sel(m, view).numpy()
    assert np.array_equal(got, RSCodecCPU(10, 4)._matmul(m, wide[:, 7:4100]))
    with pytest.raises(ValueError, match="data rows"):
        rs_sel.gf_matmul_sel(m, torch.zeros((9, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint8"):
        rs_sel.gf_matmul_sel(m.astype(np.int32),
                             torch.zeros((10, 8), dtype=torch.uint8))


@pytest.mark.parametrize("k,m,geom", [(10, 4, None), (6, 3, None),
                                      (12, 4, None), (10, 4, "lrc_10_2_2")])
def test_sel_codec_encode_matches_jax_sel(monkeypatch, k, m, geom):
    """SEAWEEDFS_TORCH_KERNEL=sel against the JAX package's sel-xla codec
    (the Pallas form needs a TPU outside interpret mode; its interpreter
    run is the test above)."""
    monkeypatch.setenv("SEAWEEDFS_TORCH_KERNEL", "sel")
    monkeypatch.setenv("SEAWEEDFS_TPU_KERNEL", "sel-xla")
    port = RSCodecTorch(k, m, geometry=geom, device="cpu")
    ref = RSCodecJax(k, m, geometry=geom)
    calls = []
    real = rs_sel.gf_matmul_sel
    monkeypatch.setattr(rs_sel, "gf_matmul_sel",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    data = _data(k, 3001, seed=k * 10 + m)
    got = port.encode_parity(data).numpy()
    assert np.array_equal(got, np.asarray(ref.encode_parity(data)))
    stack = np.stack([data[:, :1000], data[:, 1000:2000]])
    assert np.array_equal(port.encode_parity_stacked(stack).numpy(),
                          np.asarray(ref.encode_parity_stacked(stack)))
    assert len(calls) == 2
    want = ("parity", k, m) if geom is None else ("gparity", geom)
    assert all(c["key"] == want for c in calls)


def test_sel_decode_routes_to_runtime_operand(monkeypatch):
    """With sel selected, fused decode matrices run through K1's form,
    never through K3 (one library per failure pattern would be built),
    and the bytes still equal the JAX package's."""
    monkeypatch.setenv("SEAWEEDFS_TORCH_KERNEL", "sel")
    monkeypatch.setenv("SEAWEEDFS_TPU_KERNEL", "sel-xla")
    port = RSCodecTorch(10, 4, device="cpu")
    ref = RSCodecJax(10, 4)
    data = _data(10, 8192, seed=12)
    shards = port.encode(data).numpy()
    sel_keys, xor_calls = [], []
    real_sel, real_xor = rs_sel.gf_matmul_sel, rs_xor.gf_matmul_xor
    monkeypatch.setattr(
        rs_sel, "gf_matmul_sel",
        lambda m, d, key=None: sel_keys.append(key) or real_sel(m, d, key))
    monkeypatch.setattr(
        rs_xor, "gf_matmul_xor",
        lambda op, d: xor_calls.append(op.shape) or real_xor(op, d))
    lost = (1, 2, 3, 11)
    present = {i: shards[i] for i in range(14) if i not in lost}
    rebuilt = port.reconstruct(present)
    want = ref.reconstruct(present)
    for i in lost:
        assert np.array_equal(rebuilt[i].numpy(), shards[i])
        assert np.array_equal(rebuilt[i].numpy(), np.asarray(want[i]))
    pres = tuple(sorted(present))
    missing, rows = port.reconstruct_stacked(
        pres, np.stack([shards[i] for i in pres]))
    assert missing == lost
    assert np.array_equal(rows.numpy(), shards[list(lost)])
    assert sel_keys == [] and len(xor_calls) == 2
    assert all(k not in rs_torch.DECODE_KEYS for k in ("parity", "gparity"))


def test_unknown_kernel_name_raises(monkeypatch):
    for bad in ("sel-pallas", "SEL", "mxu"):
        monkeypatch.setenv("SEAWEEDFS_TORCH_KERNEL", bad)
        with pytest.raises(ValueError, match="SEAWEEDFS_TORCH_KERNEL"):
            rs_torch.kernel_choice()
    monkeypatch.setenv("SEAWEEDFS_TORCH_KERNEL", "sel")
    assert rs_torch.kernel_choice() == "sel"
    assert rs_torch.KERNELS == ("xor", "bits", "sel")


def test_specialised_source_and_library_name(monkeypatch, tmp_path):
    """The generated unit and the library name are functions of the
    matrix alone (deterministic), differ between matrices, and carry the
    matrix as constexpr values; checked without nvcc."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    rs = gf256.parity_matrix(10, 4)
    lrc = _encode_matrix("lrc_10_2_2")
    unit = _build.specialised_unit(rs_sel.TEMPLATE, rs)
    assert unit == _build.specialised_unit(rs_sel.TEMPLATE, rs.copy())
    assert unit != _build.specialised_unit(rs_sel.TEMPLATE, lrc)
    assert "constexpr int kRows = 4;" in unit
    assert "constexpr int kCols = 10;" in unit
    values = unit.split("kMatrix[40] = {", 1)[1].split("}", 1)[0]
    assert [int(v) for v in values.split(",")] == rs.reshape(-1).tolist()
    assert unit.rstrip().endswith('#include "gf_sel.cu"')
    p_rs = _build.specialised_path(rs_sel.TEMPLATE, rs)
    assert p_rs == _build.specialised_path(rs_sel.TEMPLATE, rs.copy())
    assert p_rs != _build.specialised_path(rs_sel.TEMPLATE, lrc)
    assert p_rs.name.startswith("gf_sel-4x10-") and p_rs.suffix == ".so"
    assert p_rs.parent == tmp_path / "kernels"
    # the library name depends on the flags as well
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.specialised_path(rs_sel.TEMPLATE, rs) != p_rs


def test_sel_build_needs_nvcc_and_never_falls_back(monkeypatch, tmp_path):
    """Without the CUDA toolkit a K3 build raises before writing anything;
    the CUDA wrapper refuses a CPU tensor instead of running the plain
    version, and no launch is counted."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    if _build.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed here")
    m = gf256.parity_matrix(10, 4)
    kernel = _build.SpecialisedKernel(rs_sel.TEMPLATE, "gf_sel")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.lib_for(m, ("parity", 10, 4))
    assert list((tmp_path / "kernels").iterdir()) == []
    assert kernel.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        rs_sel.gf_matmul_sel_cuda(m, torch.zeros((10, 64), dtype=torch.uint8))
    assert rs_sel.KERNEL.launches == 0


def test_sel_wrapper_refuses_what_the_kernel_does_not_take():
    """The matrix is unrolled into the kernel: a matrix past [32, 64] is
    refused (ValueError), never computed some other way."""
    for r, c in ((33, 10), (4, 65)):
        m = np.ones((r, c), dtype=np.uint8)
        with pytest.raises(ValueError, match="exceeds"):
            rs_sel.gf_matmul_sel_cuda(m, torch.zeros((c, 64),
                                                     dtype=torch.uint8))
    assert rs_sel.KERNEL.launches == 0
