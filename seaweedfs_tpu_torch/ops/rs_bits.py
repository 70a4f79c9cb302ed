"""Bitsliced GF(2) formulation of the GF(2^8) matrix product (kernel K2).

Every GF(256) constant c acts on a byte x as an 8x8 bit matrix over GF(2):
bits(c*x) = M_c @ bits(x) mod 2, with M_c[i, j] = bit_i(c * 2^j). Stacking
the blocks turns the product into one GF(2) matrix product:

    out_bits[8R, B] = Mb[8R, 8C] @ data_bits[8C, B]  mod 2

Counterpart of seaweedfs_tpu/ops/rs_jax.py ``gf_matmul_bits`` and of the
Pallas ``_kernel`` behind seaweedfs_tpu/ops/rs_pallas.py
``gf_matmul_bits_pallas``.

Three functions, as in ops/rs_xor.py:

  * ``gf_matmul_bits_torch`` — the plain PyTorch version (unpack, dot,
    ``& 1``, pack) for the tests, the CPU path and the kernel check.
  * ``gf_matmul_bits_cuda`` — the wrapper of the CUDA kernel
    (csrc/gf_bits.cu), a 1-bit AND-popcount tensor-core product. It packs
    the bit matrix once per operand into the MMA's fragment order
    (``mma_words``) and launches the kernel or raises.
  * ``gf_matmul_bits`` — the plain version on a CPU tensor, the kernel on
    a CUDA tensor.
"""

from __future__ import annotations

import torch

from . import _build

KERNEL = _build.Kernel("gf_bits.cu", "gf_bits")


def _check_operands(matrix_bits: torch.Tensor,
                    data: torch.Tensor) -> tuple[int, int, int]:
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data must be [C, B] uint8, got {tuple(data.shape)} "
                         f"{data.dtype}")
    c, b = data.shape
    if matrix_bits.dtype != torch.int8 or matrix_bits.dim() != 2:
        raise ValueError(f"matrix_bits must be [8R, 8C] int8, got "
                         f"{tuple(matrix_bits.shape)} {matrix_bits.dtype}")
    r8, c8 = matrix_bits.shape
    if r8 % 8 or c8 != 8 * c:
        raise ValueError(f"matrix_bits {tuple(matrix_bits.shape)} do not "
                         f"match {c} data rows")
    return r8 // 8, c, b


def mma_words(matrix_bits: torch.Tensor) -> torch.Tensor:
    """The bit matrix [8R, 8C] packed for K2's b1 MMA, on its own device:
    int32 [R, S, 32, 2] with S = ceil(C / 32) k-steps of 256 bits, where
    [r, s, lane, h] holds bits 32w..32w+31 of row 8r + lane // 4 (bit t =
    column 32w + t, zero past 8C), w = 8s + 4h + lane % 4: lane's two B
    words of the k-step. No row is padded (one MMA makes one output row).
    Computed once per operand and kept on the tensor (recomputed if the
    tensor is changed in place)."""
    cached = getattr(matrix_bits, "_gf_mma_words", None)
    if cached is not None and cached[0] == matrix_bits._version:
        return cached[1]
    r8, c8 = matrix_bits.shape
    r, s = r8 // 8, (c8 + 255) // 256
    bits = torch.zeros((r8, 256 * s), dtype=torch.int64,
                       device=matrix_bits.device)
    bits[:, :c8] = matrix_bits.to(torch.int64) & 1
    weights = 1 << torch.arange(32, dtype=torch.int64,
                                device=matrix_bits.device)
    words = (bits.reshape(r8, 8 * s, 32) * weights).sum(dim=2)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    # [r, g, s, h, t] -> [r, s, g, t, h]: lane = 4g + t
    packed = words.reshape(r, 8, s, 2, 4).permute(0, 2, 1, 4, 3)
    packed = packed.to(torch.int32).contiguous().reshape(r, s, 32, 2)
    matrix_bits._gf_mma_words = (matrix_bits._version, packed)
    return packed


def gf_matmul_bits_torch(matrix_bits: torch.Tensor,
                         data: torch.Tensor) -> torch.Tensor:
    """out[R, B] = GFmat (x) data[C, B] with the matrix in bit form
    [8R, 8C] (gf_matrix_to_bits), in plain PyTorch on data's device. The
    dot runs in float32, which is exact here: operands are 0/1 and every
    sum is at most 8C <= 2048 < 2^24."""
    r, c, b = _check_operands(matrix_bits, data)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    # row 8d+j of `bits` is bit j of data row d
    bits = ((data[:, None, :] >> shifts[None, :, None]) & 1).reshape(8 * c, b)
    acc = matrix_bits.to(device=data.device, dtype=torch.float32) @ \
        bits.to(torch.float32)
    pbits = (acc.to(torch.int32) & 1).reshape(r, 8, b)
    weights = (1 << torch.arange(8, dtype=torch.int32,
                                 device=data.device))[None, :, None]
    return (pbits * weights).sum(dim=1).to(torch.uint8)


def gf_matmul_bits_cuda(matrix_bits: torch.Tensor,
                        data: torch.Tensor) -> torch.Tensor:
    """The K2 kernel on a CUDA tensor. `data` [C, B] uint8 must have unit
    stride along B (any row stride); other layouts are refused, not
    copied. `matrix_bits` is int8 [8R, 8C] on the same device. Raises on a refused launch; never falls back."""
    r, c, b = _check_operands(matrix_bits, data)
    if data.device.type != "cuda" or matrix_bits.device != data.device:
        raise ValueError(f"gf_matmul_bits_cuda needs data and matrix on one "
                         f"CUDA device, got {data.device} and "
                         f"{matrix_bits.device}")
    if b > 1 and data.stride(1) != 1:
        raise ValueError(f"data must have unit stride along bytes, got "
                         f"strides {data.stride()}")
    if r > 256 or c > 256:
        raise ValueError(f"a [{r}, {c}] matrix exceeds GF(256)'s 256 shards")
    out = torch.empty((r, b), dtype=torch.uint8, device=data.device)
    if b == 0 or r == 0:
        return out
    dev = data.device.index if data.device.index is not None else \
        torch.cuda.current_device()
    KERNEL.check_smem(r, c, dev)
    words = mma_words(matrix_bits)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    KERNEL.launch(words.data_ptr(), data.data_ptr(), data.stride(0),
                  out.data_ptr(), out.stride(0), r, c, b, dev, stream)
    return out


def gf_matmul_bits(matrix_bits: torch.Tensor,
                   data: torch.Tensor) -> torch.Tensor:
    """K2 on a CUDA tensor, its plain version on a CPU tensor."""
    if data.device.type == "cpu":
        return gf_matmul_bits_torch(matrix_bits, data)
    return gf_matmul_bits_cuda(matrix_bits, data)
