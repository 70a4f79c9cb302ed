"""The plain PyTorch versions of the port's kernels against the JAX
package's formulations and Pallas kernels, and the wrappers' contract.

K1 (seaweedfs_tpu_torch/ops/rs_xor.py) against seaweedfs_tpu's
``rs_xor.gf_matmul_xor`` and ``apply_matrix_xor_pallas(interpret=True)``;
K2 (ops/rs_bits.py) against ``rs_jax.gf_matmul_bits`` and
``rs_pallas.gf_matmul_bits_pallas(interpret=True)`` — the Pallas kernels
run in the interpreter, as tests/test_rs_xor.py and tests/test_rs_pallas.py
run them. The CUDA kernels themselves run only on a card (chip_smoke.py
holds them against these plain versions there). Exact: tolerance 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seaweedfs_tpu.ops import gf256 as ref_gf256
from seaweedfs_tpu.ops import rs_jax as ref_rs_jax
from seaweedfs_tpu.ops import rs_pallas as ref_rs_pallas
from seaweedfs_tpu.ops import rs_xor as ref_rs_xor
from seaweedfs_tpu.ops.rs_cpu import RSCodecCPU as RefCPU
from seaweedfs_tpu_torch.ops import gfmat, rs_bits, rs_xor

TILE = 16384
WIDTHS = [1, 3, 4095, TILE, 2 * TILE + 4]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs beside other
    workers' timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _matrix(kind: str) -> np.ndarray:
    if kind == "encode":
        return ref_gf256.parity_matrix(10, 4)
    # fused [3, 10] decode matrix: shards 0, 5 and 13 lost
    present = tuple(i for i in range(14) if i not in (0, 5, 13))
    fm, _ = ref_rs_jax.fused_reconstruct_matrix(10, 4, present, (0, 5, 13))
    return fm


def _data(c: int, b: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(c, b),
                                                dtype=np.uint8)


def _oracle(m: np.ndarray, d: np.ndarray) -> np.ndarray:
    return RefCPU(10, 4)._matmul(m, d)


@pytest.mark.parametrize("b", WIDTHS)
@pytest.mark.parametrize("kind", ["encode", "decode"])
def test_xor_plain_matches_jax_and_pallas(kind, b):
    m = _matrix(kind)
    d = _data(m.shape[1], b, seed=b + len(kind))
    coef = gfmat.xor_coefficients(m)
    got = rs_xor.gf_matmul_xor_torch(torch.from_numpy(coef),
                                     torch.from_numpy(d)).numpy()
    padded = np.pad(d, ((0, 0), (0, (-b) % 4)))
    ref = np.asarray(ref_rs_xor.gf_matmul_xor(jnp.asarray(coef),
                                              jnp.asarray(padded)))[:, :b]
    pallas = np.asarray(ref_rs_xor.apply_matrix_xor_pallas(
        m, jnp.asarray(d), interpret=True))
    assert got.dtype == np.uint8 and got.shape == (m.shape[0], b)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, _oracle(m, d))


@pytest.mark.parametrize("b", WIDTHS)
@pytest.mark.parametrize("kind", ["encode", "decode"])
def test_bits_plain_matches_jax_and_pallas(kind, b):
    m = _matrix(kind)
    d = _data(m.shape[1], b, seed=b + 7 * len(kind))
    mbits = gfmat.gf_matrix_to_bits(m)
    got = rs_bits.gf_matmul_bits_torch(torch.from_numpy(mbits),
                                       torch.from_numpy(d)).numpy()
    ref = np.asarray(ref_rs_jax.gf_matmul_bits(jnp.asarray(mbits),
                                               jnp.asarray(d)))
    padded = np.pad(d, ((0, 0), (0, (-b) % TILE)))
    pallas = np.asarray(ref_rs_pallas.gf_matmul_bits_pallas(
        jnp.asarray(mbits), jnp.asarray(padded), m.shape[0],
        interpret=True))[:, :b]
    assert got.dtype == np.uint8 and got.shape == (m.shape[0], b)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, _oracle(m, d))


@pytest.mark.parametrize("r,c", [(1, 1), (8, 40), (3, 17), (14, 10)])
def test_plain_versions_agree_on_any_shape(r, c):
    """Both plain versions at shapes beyond RS(10,4), row-strided input
    included (a column slice of a wider buffer)."""
    rng = np.random.default_rng(r * 1000 + c)
    m = rng.integers(0, 256, size=(r, c), dtype=np.uint8)
    wide = torch.from_numpy(rng.integers(0, 256, size=(c, 1031),
                                         dtype=np.uint8))
    view = wide[:, 3:1030]
    want = _oracle(m, view.numpy())
    xor = rs_xor.gf_matmul_xor(torch.from_numpy(gfmat.xor_coefficients(m)),
                               view)
    bits = rs_bits.gf_matmul_bits(
        torch.from_numpy(gfmat.gf_matrix_to_bits(m)), view)
    assert np.array_equal(xor.numpy(), want)
    assert np.array_equal(bits.numpy(), want)


def test_zero_width_and_coefficient_layouts():
    m = _matrix("encode")
    coef = torch.from_numpy(gfmat.xor_coefficients(m))
    empty = torch.zeros((10, 0), dtype=torch.uint8)
    assert rs_xor.gf_matmul_xor(coef, empty).shape == (4, 0)
    d = torch.from_numpy(_data(10, 99, seed=5))
    flat = coef.reshape(4, 80)  # the Pallas kernel's [R, 8C] layout
    assert torch.equal(rs_xor.gf_matmul_xor(flat, d),
                       rs_xor.gf_matmul_xor(coef, d))


def test_wrappers_refuse_bad_operands():
    m = _matrix("encode")
    coef = torch.from_numpy(gfmat.xor_coefficients(m))
    mbits = torch.from_numpy(gfmat.gf_matrix_to_bits(m))
    d = torch.from_numpy(_data(10, 64, seed=9))
    with pytest.raises(ValueError):
        rs_xor.gf_matmul_xor(coef, d[:9])          # C mismatch
    with pytest.raises(ValueError):
        rs_bits.gf_matmul_bits(mbits, d[:9])
    with pytest.raises(ValueError):
        rs_xor.gf_matmul_xor(coef.to(torch.int64), d)
    with pytest.raises(ValueError):
        rs_bits.gf_matmul_bits(mbits.to(torch.int32), d)
    with pytest.raises(ValueError):
        rs_xor.gf_matmul_xor(coef, d.to(torch.int32))


def test_cuda_wrappers_never_fall_back_to_the_cpu():
    """The kernel wrappers launch or raise: a CPU tensor handed to the CUDA
    path is refused, not computed by the plain version."""
    m = _matrix("encode")
    d = torch.from_numpy(_data(10, 64, seed=11))
    with pytest.raises(ValueError, match="CUDA"):
        rs_xor.gf_matmul_xor_cuda(
            torch.from_numpy(gfmat.xor_coefficients(m)), d)
    with pytest.raises(ValueError, match="CUDA"):
        rs_bits.gf_matmul_bits_cuda(
            torch.from_numpy(gfmat.gf_matrix_to_bits(m)), d)
    assert rs_xor.KERNEL.launches == 0 and rs_bits.KERNEL.launches == 0


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without the CUDA toolkit the first launch fails loudly at the build;
    nothing is compiled at import and no library is left half-written."""
    from seaweedfs_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    if _build.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert list((tmp_path / "kernels").iterdir()) == []
    # libraries are named by their source and flags, one per source
    paths = {_build.library_path(s) for s in _build.SOURCES}
    assert len(paths) == len(_build.SOURCES)
    assert all(p.parent == tmp_path / "kernels" for p in paths)
