"""xtime-select formulation of the GF(2^8) matrix product (kernel K3).

For four bytes packed little-endian in a word ``y``:

    xtime(y) = ((y << 1) & 0xFEFEFEFE) ^ (sign_bytes(y) & 0x1D1D1D1D)

doubles each byte in GF(2^8) (``sign_bytes`` makes each byte 0xFF where
its top bit is set: the kernel's one ``prmt``), and ``M[r, c] * x`` is the
XOR of ``2^j * x`` over the set bits j of ``M[r, c]``. By Horner's rule
over the bits, each output row is

    out_r = S_r0 ^ xtime(S_r1 ^ xtime(... xtime(S_rt)))

where ``S_rj`` XORs the input rows whose matrix entry has bit j set and
``t`` is row r's highest set bit: a fixed selection of input rows and at
most seven doublings per output row. For a matrix known ahead of time the
selection costs nothing per element. Counterpart of
seaweedfs_tpu/ops/rs_xor.py (``gf_matmul_sel``, and the Pallas kernel of
``_sel_kernel_factory`` behind ``apply_matrix_sel_pallas``), whose bytes it
equals.

The kernel (csrc/gf_sel.cu) is a template compiled once per matrix, with
the matrix baked in (ops/_build.py), so it serves matrices that are few
and long-lived: the encode matrix of each geometry. Run-time matrices
(one per survivor set) stay on kernel K1; ops/rs_torch.py routes them.

Three functions:

  * ``gf_matmul_sel_torch`` — the plain PyTorch version: the same word
    arithmetic in int64. It serves the tests, the CPU path and the
    kernel check on the card.
  * ``gf_matmul_sel_cuda`` — the wrapper of the CUDA kernel. It builds
    the matrix's library at first use (one nvcc, a few seconds), then
    launches or raises.
  * ``gf_matmul_sel`` — picks by where the data lies: the plain version
    for a CPU tensor, the kernel for a CUDA tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, rs_xor

TEMPLATE = "gf_sel.cu"
# the matrix is unrolled into the kernel: a thread holds C input and R
# accumulator chunks of 4 words (2 for a large matrix), and compile time
# grows with R * C
MAX_ROWS = 32
MAX_COLS = 64
# loaded libraries kept per process (LRU), as the reference caps its
# specialised runners (rs_xor._SEL_MAX)
SEL_MAX = 256

KERNEL = _build.SpecialisedKernel(TEMPLATE, "gf_sel", max_libs=SEL_MAX)


def _matrix_bit_rows(matrix: np.ndarray) -> list[list[tuple[int, int]]]:
    """Per output row: the (input_row, j) pairs with bit_j(M[r, c]) set."""
    m = np.asarray(matrix, dtype=np.uint8)
    rows = []
    for r in range(m.shape[0]):
        sel = [(c, j) for c in range(m.shape[1]) for j in range(8)
               if (int(m[r, c]) >> j) & 1]
        rows.append(sel)
    return rows


def _check_operands(matrix, data: torch.Tensor) -> tuple[np.ndarray, int,
                                                         int, int]:
    m = np.asarray(matrix)
    if m.ndim != 2 or m.dtype != np.uint8:
        raise ValueError(f"matrix must be [R, C] uint8, got {m.shape} "
                         f"{m.dtype}")
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data must be [C, B] uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    r, c = m.shape
    if data.shape[0] != c:
        raise ValueError(f"a [{r}, {c}] matrix does not match "
                         f"{data.shape[0]} data rows")
    return m, r, c, data.shape[1]


def _xtime(w: torch.Tensor) -> torch.Tensor:
    """GF(256) doubling of the 4 packed bytes of each 32-bit word (held in
    int64, so no shift leaves 64 bits), with the kernel's sign-replicated
    reduction term."""
    return ((w << 1) & 0xFEFEFEFE) ^ (rs_xor.sign_bytes(w) & 0x1D1D1D1D)


def gf_matmul_sel_torch(matrix: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """out[R, B] = matrix[R, C] (x) data[C, B] in plain PyTorch on data's
    device, by the kernel's arithmetic: per output row, Horner's rule over
    its matrix bits from the highest set one, each step XORing in the
    input rows that bit selects. Any B and any row stride."""
    m, r, c, b = _check_operands(matrix, data)
    words = rs_xor.pack_words(data)
    out = torch.zeros((r, words.shape[1]), dtype=torch.int64,
                      device=data.device)
    for ri, sel in enumerate(_matrix_bit_rows(m)):
        bits = [[ci for ci, jj in sel if jj == j] for j in range(8)]
        top = max((j for j in range(8) if bits[j]), default=-1)
        h = torch.zeros_like(out[ri])
        for j in range(top, -1, -1):
            if j < top:
                h = _xtime(h)
            for ci in bits[j]:
                h = h ^ words[ci]
        out[ri] = h
    return rs_xor.unpack_words(out, b)


def _raw_key(m: np.ndarray) -> tuple:
    return ("raw", m.shape, m.tobytes())


def gf_matmul_sel_cuda(matrix: np.ndarray, data: torch.Tensor,
                       key: tuple | None = None) -> torch.Tensor:
    """The K3 kernel on a CUDA tensor. `data` [C, B] uint8 must have unit
    stride along B (any row stride: a column slice of a wider buffer is
    taken as it is); other layouts are refused, not copied. `key` is the
    matrix's compact identity for the library cache (defaults to its
    bytes). The first call for a matrix builds its library; a failed
    build or a refused launch raises. Never falls back."""
    m, r, c, b = _check_operands(matrix, data)
    if r > MAX_ROWS or c > MAX_COLS:
        raise ValueError(f"a [{r}, {c}] matrix exceeds the [{MAX_ROWS}, "
                         f"{MAX_COLS}] that K3 unrolls")
    if data.device.type != "cuda":
        raise ValueError(f"gf_matmul_sel_cuda needs data on a CUDA device, "
                         f"got {data.device}")
    if b > 1 and data.stride(1) != 1:
        raise ValueError(f"data must have unit stride along bytes, got "
                         f"strides {data.stride()}")
    out = torch.empty((r, b), dtype=torch.uint8, device=data.device)
    if b == 0 or r == 0:
        return out
    lib = KERNEL.lib_for(m, key if key is not None else _raw_key(m))
    dev = data.device.index if data.device.index is not None else \
        torch.cuda.current_device()
    stream = torch.cuda.current_stream(data.device).cuda_stream
    KERNEL.launch(lib, data.data_ptr(), data.stride(0), out.data_ptr(),
                  out.stride(0), b, dev, stream)
    return out


def gf_matmul_sel(matrix: np.ndarray, data: torch.Tensor,
                  key: tuple | None = None) -> torch.Tensor:
    """K3 on a CUDA tensor, its plain version on a CPU tensor."""
    if data.device.type == "cpu":
        return gf_matmul_sel_torch(matrix, data)
    return gf_matmul_sel_cuda(matrix, data, key=key)
