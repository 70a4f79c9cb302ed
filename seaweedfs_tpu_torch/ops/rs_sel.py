"""xtime-select formulation of the GF(2^8) matrix product (kernel K3).

For four bytes packed little-endian in a word ``y``:

    xtime(y) = ((y << 1) & 0xFEFEFEFE) ^ (((y >> 7) & 0x01010101) * 0x1D)

doubles each byte in GF(2^8), and ``M[r, c] * x`` is the XOR of ``2^j * x``
over the set bits j of ``M[r, c]``. So each input row runs a chain of seven
doublings, and each output row is a fixed selection of chain links: for
a matrix known ahead of time the selection costs nothing per element.
Counterpart of seaweedfs_tpu/ops/rs_xor.py (``gf_matmul_sel``, and the
Pallas kernel of ``_sel_kernel_factory`` behind
``apply_matrix_sel_pallas``).

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

from . import _build

TEMPLATE = "gf_sel.cu"
# the matrix is unrolled into the kernel: its accumulators are 4 * R
# registers a thread, and compile time grows with R * C
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
    """GF(256) doubling of the 4 packed bytes of each word (int64 holding
    a 32-bit value, so no product or shift leaves 64 bits)."""
    return ((w << 1) & 0xFEFEFEFE) ^ (((w >> 7) & 0x01010101) * 0x1D)


def gf_matmul_sel_torch(matrix: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """out[R, B] = matrix[R, C] (x) data[C, B] by the xtime-select scheme,
    in plain PyTorch on data's device: each input row's doubling chain,
    XORed into the output rows its matrix bits select (the kernel's
    order). Any B (the ragged tail is zero-padded to a whole word and
    sliced off)."""
    m, r, c, b = _check_operands(matrix, data)
    pad = (-b) % 4
    d = data.to(torch.int64)
    if pad:
        d = torch.nn.functional.pad(d, (0, pad))
    d = d.reshape(c, -1, 4)
    words = d[..., 0] | (d[..., 1] << 8) | (d[..., 2] << 16) | (d[..., 3] << 24)
    acc = torch.zeros((r, words.shape[1]), dtype=torch.int64,
                      device=data.device)
    # picks[c][j]: the output rows that take link j of input row c
    picks = [[[] for _ in range(8)] for _ in range(c)]
    for ri, sel in enumerate(_matrix_bit_rows(m)):
        for ci, j in sel:
            picks[ci][j].append(ri)
    for ci in range(c):
        y = words[ci]
        for j in range(8):
            for ri in picks[ci][j]:
                acc[ri] ^= y
            if j < 7:
                y = _xtime(y)
    out = torch.stack([(acc >> (8 * q)) & 0xFF for q in range(4)], dim=-1)
    return out.reshape(r, -1)[:, :b].to(torch.uint8)


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
