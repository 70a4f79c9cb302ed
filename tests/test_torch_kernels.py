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


def _xor_all_agree(m: np.ndarray, view: torch.Tensor) -> None:
    """K1's plain version on `view` (any row stride) equals the JAX
    package's gf_matmul_xor, its Pallas kernel in the interpreter and the
    rs_cpu oracle, byte for byte."""
    d = np.ascontiguousarray(view.numpy())
    b = d.shape[1]
    coef = gfmat.xor_coefficients(m)
    got = rs_xor.gf_matmul_xor_torch(torch.from_numpy(coef), view).numpy()
    padded = np.pad(d, ((0, 0), (0, (-b) % 4)))
    ref = np.asarray(ref_rs_xor.gf_matmul_xor(jnp.asarray(coef),
                                              jnp.asarray(padded)))[:, :b]
    pallas = np.asarray(ref_rs_xor.apply_matrix_xor_pallas(
        m, jnp.asarray(d), interpret=True))
    assert got.dtype == np.uint8 and got.shape == (m.shape[0], b)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, _oracle(m, d))


@pytest.mark.parametrize("r", [1, 2, 3, 4, 5, 6, 7, 8, 14])
def test_xor_plain_at_every_r(r):
    """Every R the kernel specialises on (1..8) and one past a pass of 8."""
    rng = np.random.default_rng(100 + r)
    m = rng.integers(0, 256, size=(r, 10), dtype=np.uint8)
    _xor_all_agree(m, torch.from_numpy(_data(10, 1000 + r, seed=r)))


@pytest.mark.parametrize("offset", range(16))
def test_xor_plain_on_column_slices(offset):
    """A column slice at each byte offset of a buffer whose row stride
    (4133) is no multiple of 16: the layout the kernel realigns."""
    wide = torch.from_numpy(_data(10, 4133, seed=200 + offset))
    _xor_all_agree(_matrix("decode"), wide[:, offset:offset + 4096 + 7])


@pytest.mark.parametrize("b", range(1, 48))
def test_xor_plain_at_narrow_widths(b):
    """Widths 1..47: spans shorter than, equal to and a little past one
    to three 16-byte chunks, stacked with row stride b."""
    _xor_all_agree(_matrix("encode"), torch.from_numpy(_data(10, b, seed=b)))


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


def _bits_all_agree(m: np.ndarray, view: torch.Tensor,
                    pallas: bool = False) -> None:
    """K2's plain version on `view` (any row stride) equals the JAX
    package's gf_matmul_bits and the rs_cpu oracle, byte for byte (and,
    with `pallas`, its Pallas kernel in the interpreter)."""
    d = np.ascontiguousarray(view.numpy())
    r, b = m.shape[0], d.shape[1]
    mbits = gfmat.gf_matrix_to_bits(m)
    got = rs_bits.gf_matmul_bits_torch(torch.from_numpy(mbits), view).numpy()
    ref = np.asarray(ref_rs_jax.gf_matmul_bits(jnp.asarray(mbits),
                                               jnp.asarray(d)))
    assert got.dtype == np.uint8 and got.shape == (r, b)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, _oracle(m, d))
    if pallas:
        padded = np.pad(d, ((0, 0), (0, (-b) % TILE)))
        want = np.asarray(ref_rs_pallas.gf_matmul_bits_pallas(
            jnp.asarray(mbits), jnp.asarray(padded), r,
            interpret=True))[:, :b]
        assert np.array_equal(got, want)


@pytest.mark.parametrize("r", [1, 2, 3, 4, 5, 6, 7, 8, 14])
def test_bits_plain_at_every_r(r):
    """R = 1..8 and 14: one MMA per output row, none padded; the Pallas
    kernel too at the rebuild's R = 3 and at 14."""
    rng = np.random.default_rng(300 + r)
    m = rng.integers(0, 256, size=(r, 10), dtype=np.uint8)
    _bits_all_agree(m, torch.from_numpy(_data(10, 1000 + r, seed=r)),
                    pallas=r in (3, 14))


@pytest.mark.parametrize("offset", range(16))
def test_bits_plain_on_column_slices(offset):
    """A column slice at each byte offset of a buffer whose row stride
    (4133) is no multiple of 16: the layout K2 realigns in shared memory."""
    wide = torch.from_numpy(_data(10, 4133, seed=400 + offset))
    _bits_all_agree(_matrix("decode"), wide[:, offset:offset + 4096 + 7])


@pytest.mark.parametrize("b", range(1, 48))
def test_bits_plain_at_narrow_widths(b):
    """Widths 1..47: shorter than one 16-column MMA tile up to three."""
    _bits_all_agree(_matrix("encode"),
                    torch.from_numpy(_data(10, b, seed=500 + b)))


@pytest.mark.parametrize("c", [1, 3, 17, 33, 64])
def test_bits_plain_at_every_c(c):
    """C that is no multiple of 4 (a partial column word) or past one
    256-bit k-step (33, 64: two k-steps)."""
    rng = np.random.default_rng(600 + c)
    m = rng.integers(0, 256, size=(4, c), dtype=np.uint8)
    _bits_all_agree(m, torch.from_numpy(_data(c, 777, seed=c)))


def _unpack_mma_words(words: np.ndarray, c8: int) -> np.ndarray:
    """mma_words back to the int8 [8R, 8C] bit matrix; asserts the padding
    past column 8C is zero."""
    r, s = words.shape[:2]
    w = words.astype(np.int64) & 0xFFFFFFFF
    # [r, s, g, t, h] -> [r, g, s, h, t]: word 8s + 4h + t of row 8r + g
    rows = w.reshape(r, s, 8, 4, 2).transpose(0, 2, 1, 4, 3).reshape(8 * r,
                                                                   8 * s)
    bits = (rows[:, :, None] >> np.arange(32)) & 1
    bits = bits.reshape(8 * r, 256 * s)
    assert not bits[:, c8:].any()
    return bits[:, :c8].astype(np.int8)


@pytest.mark.parametrize("r,c", [(1, 1), (3, 10), (4, 10), (7, 3), (14, 17),
                                 (2, 33), (5, 64), (3, 255)])
def test_mma_words_unpack_to_the_bit_matrix(r, c):
    """K2's packed operand holds exactly gf_matrix_to_bits, in fragment
    order, with zeros past 8C (odd C, C past one k-step) and no padded
    rows."""
    rng = np.random.default_rng(700 + r * c)
    m = rng.integers(0, 256, size=(r, c), dtype=np.uint8)
    mbits = gfmat.gf_matrix_to_bits(m)
    words = rs_bits.mma_words(torch.from_numpy(mbits))
    assert words.dtype == torch.int32
    assert tuple(words.shape) == (r, (c + 31) // 32, 32, 2)
    assert np.array_equal(_unpack_mma_words(words.numpy(), 8 * c), mbits)


def _mma_model(words: np.ndarray, d: np.ndarray) -> np.ndarray:
    """What gf_bits.cu computes from the packed words, with m16n8k256's b1
    fragments (lane = 4g + t). A warp takes 32 columns as two M tiles: rows
    g, g+8 are columns 4g, 4g+2 of the first and 4g+1, 4g+3 of the second.
    A (row-major): lane (g, t) holds word 4h + t of the k-step for rows g
    (a0, a2) and g + 8 (a1, a3). B (column-major, N = bit rows 8r..8r+7):
    lane (g, t) holds word 4h + t for bit row 8r + g (the packed [r, s,
    lane, 0..1]). D[m, n] = sum of popc(A & B) over k sits in lane
    (m % 8, n // 2), register 2 (m >= 8) + n % 2; the word of columns
    4g..4g+3 is assembled from the quad's bits by ORs."""
    r, s = words.shape[:2]
    c, b = d.shape
    rows = np.zeros((256 * s // 8, b + 32), dtype=np.uint64)
    rows[:c, :b] = d
    # word w of a column: its bytes 4w..4w+3, byte q at bits 8q
    colw = sum(rows[q::4] << np.uint64(8 * q) for q in range(4))
    w = words.astype(np.int64) & 0xFFFFFFFF
    out = np.zeros((r, b + 32), dtype=np.uint8)
    tiles = ([4 * g for g in range(8)] + [4 * g + 2 for g in range(8)],
             [4 * g + 1 for g in range(8)] + [4 * g + 3 for g in range(8)])
    for x0 in range(0, b, 32):
        for rr in range(r):
            regs = np.zeros((2, 32, 4), dtype=np.int64)
            for tile, colmap in enumerate(tiles):
                for m in range(16):
                    for n in range(8):
                        acc = 0
                        for ss in range(s):
                            for kw in range(8):
                                t, h = kw % 4, kw // 4
                                a = int(colw[8 * ss + kw, x0 + colmap[m]])
                                bw = int(w[rr, ss, 4 * n + t, h])
                                acc += bin(a & bw).count("1")
                        regs[tile, 4 * (m % 8) + n // 2,
                             2 * (m >= 8) + n % 2] = acc
            for g in range(8):
                v = 0
                for t in range(4):
                    d1 = [int(x) & 1 for x in regs[0, 4 * g + t]]
                    d2 = [int(x) & 1 for x in regs[1, 4 * g + t]]
                    v |= (d1[0] | d1[1] << 1 | d2[0] << 8 | d2[1] << 9 |
                          d1[2] << 16 | d1[3] << 17 | d2[2] << 24 |
                          d2[3] << 25) << (2 * t)
                for k in range(4):
                    out[rr, x0 + 4 * g + k] = (v >> (8 * k)) & 0xFF
    return out[:, :b]


@pytest.mark.parametrize("r,c,b", [(4, 10, 37), (3, 10, 16), (1, 33, 21),
                                   (14, 3, 9)])
def test_mma_words_fragment_model(r, c, b):
    """The packed words, read through the b1 MMA's fragment layout as
    gf_bits.cu reads them, give K2's product."""
    rng = np.random.default_rng(800 + r + c + b)
    m = rng.integers(0, 256, size=(r, c), dtype=np.uint8)
    d = _data(c, b, seed=900 + b)
    words = rs_bits.mma_words(torch.from_numpy(gfmat.gf_matrix_to_bits(m)))
    assert np.array_equal(_mma_model(words.numpy(), d), _oracle(m, d))


def test_mma_words_kept_with_the_operand():
    """Packed once per operand: a second call returns the same tensor; an
    in-place change of the operand packs it again."""
    mbits = torch.from_numpy(gfmat.gf_matrix_to_bits(_matrix("encode")))
    first = rs_bits.mma_words(mbits)
    assert rs_bits.mma_words(mbits) is first
    mbits[0, 0] ^= 1
    again = rs_bits.mma_words(mbits)
    assert again is not first
    assert np.array_equal(_unpack_mma_words(again.numpy(), 80),
                          mbits.numpy())


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


def test_library_names_cover_every_header(monkeypatch, tmp_path):
    """Editing or adding a header in csrc/ renames both kinds of library
    (a plain source's and a per-matrix template's), so a stale library is
    never loaded; checked without nvcc in a copy of csrc/."""
    from seaweedfs_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    m = _matrix("encode")

    def names():
        return (_build.library_path("gf_xor.cu"),
                _build.specialised_path("gf_sel.cu", m))

    before = names()
    assert names() == before
    header = csrc / "gf_chunks.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = names()
    assert edited[0] != before[0] and edited[1] != before[1]
    (csrc / "extra.cuh").write_text("#pragma once\n")
    added = names()
    assert added[0] != edited[0] and added[1] != edited[1]


def test_launch_counts_by_key():
    """A launch counts once in `launches` and once under its key (K1's
    wrapper keys by R); reset clears both; a refused launch counts
    nowhere."""
    from types import SimpleNamespace

    from seaweedfs_tpu_torch.ops import _build

    codes = iter([0, 0, 0, 2])
    lib = SimpleNamespace(k_launch=lambda *a: next(codes),
                          k_error_string=lambda code: b"refused")
    counter = _build._Launcher("k")
    counter._launch(lib, key=1)
    counter._launch(lib, key=1)
    counter._launch(lib)
    assert counter.launches == 3 and counter.launches_by == {1: 2}
    with pytest.raises(RuntimeError, match="refused"):
        counter._launch(lib, key=4)
    assert counter.launches == 3 and counter.launches_by == {1: 2}
    counter.reset()
    assert counter.launches == 0 and counter.launches_by == {}


def test_build_times_each_library_and_keeps_its_report(monkeypatch, tmp_path):
    """build() starts one compiler per missing library, all at once, and
    gives each its own seconds (a quick build is not charged a slow one's
    wait), keeps the compiler's report beside each library, finds built
    libraries without compiling, and raises with the report when a build
    fails. A stand-in script takes nvcc's place."""
    import stat
    import sys
    from seaweedfs_tpu_torch.ops import _build

    fake = tmp_path / "fake_nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "args = sys.argv[1:]\n"
        "src = args[-1]\n"
        "if 'broken' in src:\n"
        "    print('error: broken source'); sys.exit(2)\n"
        "time.sleep(1.5 if 'slow' in src else 0.0)\n"
        "open(args[args.index('-o') + 1], 'w').write('lib')\n"
        "print('ptxas info    : Used 12 registers')\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("quick.cu", "slow.cu", "broken.cu"):
        (csrc / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))

    built = _build.build(("slow.cu", "quick.cu"))
    assert built["quick.cu"].seconds < 1.0 <= built["slow.cu"].seconds
    for b in built.values():
        assert b.path.exists()
        assert "Used 12 registers" in _build.build_log(b.path)
    again = _build.build(("slow.cu", "quick.cu"))
    assert {b.seconds for b in again.values()} == {0.0}
    with pytest.raises(RuntimeError, match="broken source"):
        _build.build(("broken.cu",))
    assert not _build.library_path("broken.cu").exists()
