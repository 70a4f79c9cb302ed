"""Packed-word XOR formulation of the GF(2^8) matrix product (kernel K1).

    c * x  =  XOR_j  bit_j(x) * gfmul(c, 2^j)            (GF linearity)

For four bytes packed little-endian in a 32-bit word ``w``:

    mask_j = sign_bytes(w << (7 - j))  # 0xFF where bit j of a byte is set
    mask_j & (K * 0x01010101)          # K = gfmul(c, 2^j) in [0, 255]

``sign_bytes`` replicates each byte's top bit over the byte (the kernel's
one ``prmt``), and the shift brings bit j to the top. So one input row's
contribution to an output row is 8 masks and 8 AND-XORs on full words,
equal to the Pallas kernel's ``((w >> j) & 0x01010101) * K`` (that product
never carries). Counterpart of seaweedfs_tpu/ops/rs_xor.py
(``gf_matmul_xor``, and the Pallas ``_xor_kernel`` behind
``apply_matrix_xor_pallas``).

Three functions:

  * ``gf_matmul_xor_torch`` — the plain PyTorch version: the same word
    arithmetic in int64, holding 32-bit values.
    It serves the tests, the CPU path and the kernel check on the card.
  * ``gf_matmul_xor_cuda`` — the wrapper of the CUDA kernel
    (csrc/gf_xor.cu). It launches the kernel or raises.
  * ``gf_matmul_xor`` — picks by where the data lies: the plain version
    for a CPU tensor, the kernel for a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = _build.Kernel("gf_xor.cu", "gf_xor")
# KERNEL.launches_by counts launches per R (output rows): 1 is a degraded
# read of one interval, 3 a rebuild of three lost shards, 4 an encode


def _check_operands(coeffs: torch.Tensor, data: torch.Tensor) -> tuple[int, int, int]:
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data must be [C, B] uint8, got {tuple(data.shape)} "
                         f"{data.dtype}")
    c, b = data.shape
    if coeffs.dtype != torch.int32 or coeffs.dim() not in (2, 3):
        raise ValueError(f"coeffs must be int32 [R, C, 8] or [R, 8C], got "
                         f"{tuple(coeffs.shape)} {coeffs.dtype}")
    r = coeffs.shape[0]
    if coeffs.numel() != r * c * 8:
        raise ValueError(f"coeffs {tuple(coeffs.shape)} do not match {c} "
                         f"data rows")
    return r, c, b


def sign_bytes(w: torch.Tensor) -> torch.Tensor:
    """0xFF in each byte of the 32-bit words `w` (int64) whose top bit is
    set, 0x00 elsewhere: what ``prmt.b32 r, w, 0, 0xBA98`` computes."""
    return ((w >> 7) & 0x01010101) * 0xFF


def pack_words(data: torch.Tensor) -> torch.Tensor:
    """[C, B] uint8 -> [C, ceil(B / 4)] little-endian 32-bit words in int64
    (the ragged tail zero-padded to a whole word)."""
    c, b = data.shape
    d = data.to(torch.int64)
    pad = (-b) % 4
    if pad:
        d = torch.nn.functional.pad(d, (0, pad))
    d = d.reshape(c, -1, 4)
    return d[..., 0] | (d[..., 1] << 8) | (d[..., 2] << 16) | (d[..., 3] << 24)


def unpack_words(acc: torch.Tensor, b: int) -> torch.Tensor:
    """[R, W] words (int64) -> [R, b] uint8, inverse of pack_words."""
    out = torch.stack([(acc >> (8 * q)) & 0xFF for q in range(4)], dim=-1)
    return out.reshape(acc.shape[0], -1)[:, :b].to(torch.uint8)


def gf_matmul_xor_torch(coeffs: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """out[R, B] = GFmat (x) data[C, B] by the packed-word XOR scheme, in
    plain PyTorch on data's device, with the kernel's sign-replicated
    masks. coeffs: int32 [R, C, 8] (or [R, 8C]) from xor_coefficients;
    any B and any row stride."""
    r, c, b = _check_operands(coeffs, data)
    coef = coeffs.reshape(r, c, 8).to(device=data.device, dtype=torch.int64)
    coef = coef * 0x01010101  # replicated into all four bytes
    words = pack_words(data)
    acc = torch.zeros((r, words.shape[1]), dtype=torch.int64,
                      device=data.device)
    for ci in range(c):
        for j in range(8):
            mask = sign_bytes((words[ci] << (7 - j)) & 0xFFFFFFFF)
            acc ^= mask[None, :] & coef[:, ci, j][:, None]
    return unpack_words(acc, b)


def gf_matmul_xor_cuda(coeffs: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """The K1 kernel on a CUDA tensor. `data` [C, B] uint8 must have
    unit stride along B (any row stride — a column slice of a wider
    buffer is taken as it is); other layouts are refused, not copied.
    `coeffs` is int32 [R, C, 8] or [R, 8C], contiguous, on the same
    device. Raises on a refused launch; never falls back."""
    r, c, b = _check_operands(coeffs, data)
    if data.device.type != "cuda" or coeffs.device != data.device:
        raise ValueError(f"gf_matmul_xor_cuda needs data and coeffs on one "
                         f"CUDA device, got {data.device} and "
                         f"{coeffs.device}")
    if b > 1 and data.stride(1) != 1:
        raise ValueError(f"data must have unit stride along bytes, got "
                         f"strides {data.stride()}")
    if not coeffs.is_contiguous():
        raise ValueError("coeffs must be contiguous")
    if r > 256 or c > 256:
        raise ValueError(f"a [{r}, {c}] matrix exceeds GF(256)'s 256 shards")
    out = torch.empty((r, b), dtype=torch.uint8, device=data.device)
    if b == 0 or r == 0:
        return out
    dev = data.device.index if data.device.index is not None else \
        torch.cuda.current_device()
    KERNEL.check_smem(r, c, dev)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    KERNEL.launch(coeffs.data_ptr(), data.data_ptr(), data.stride(0),
                  out.data_ptr(), out.stride(0), r, c, b, dev, stream, key=r)
    return out


def launch_empty(device: torch.device) -> None:
    """Launch gf_xor.cu's empty kernel (one block) on `device`'s current
    stream: the floor under K1's time at small widths. Not counted."""
    fn = KERNEL.lib.gf_xor_empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = device.index if device.index is not None else \
        torch.cuda.current_device()
    KERNEL.raise_for(fn(dev, torch.cuda.current_stream(device).cuda_stream),
                     "empty launch")


def gf_matmul_xor(coeffs: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if data.device.type == "cpu":
        return gf_matmul_xor_torch(coeffs, data)
    return gf_matmul_xor_cuda(coeffs, data)
