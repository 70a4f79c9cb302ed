"""Plain Reed-Solomon over GF(2^8): the yardstick that decides `correct`.

SeaweedFS erasure-codes with klauspost/reedsolomon's default matrix: the
field GF(2^8) with the polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11d) and
generator 2; the Vandermonde matrix V[r][c] = r^c over (k + m) rows and k
columns; the systematic encode matrix E = V . inv(V[:k]). Its first k rows
are the identity, so data shards are the data, and its last m rows make
the parity. Any k shards recover the rest through the inverse of their k
rows of E. Matrix inverses over a field are unique, so every correct
implementation of this construction gives the same bytes.

Written from that description alone, in NumPy (the small matrices) and
plain PyTorch (the byte columns, on whatever device the data is on). It
imports nothing of the program under test, nor JAX.

The product out[R, B] = M[R, C] (x) data[C, B] is a table look-up per
coefficient and byte: out[r] = XOR_c MUL[M[r, c]][data[c]].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

POLY = 0x11D


@functools.lru_cache(maxsize=None)
def tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(exp[512], log[256], mul[256, 256]) of GF(2^8)/0x11d."""
    exp = np.zeros(512, np.int64)
    log = np.zeros(256, np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[:255]
    a = np.arange(256)
    mul = exp[log[a][:, None] + log[a][None, :]]
    mul[0, :] = 0
    mul[:, 0] = 0
    return exp, log, mul.astype(np.uint8)


def mul(a: int, b: int) -> int:
    return int(tables()[2][a, b])


def power(a: int, n: int) -> int:
    """a^n, with 0^0 = 1 as the Vandermonde construction wants."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    exp, log, _ = tables()
    return int(exp[(log[a] * n) % 255])


def inverse(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    exp, log, _ = tables()
    return int(exp[255 - log[a]])


def matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[r, n] x [n, c] over GF(2^8)."""
    m = tables()[2]
    a = np.asarray(a, np.uint8)
    b = np.asarray(b, np.uint8)
    out = np.zeros((a.shape[0], b.shape[1]), np.uint8)
    for i in range(a.shape[1]):
        out ^= m[a[:, i][:, None], b[i][None, :]]
    return out


def invert(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse of a square matrix over GF(2^8)."""
    n = m.shape[0]
    t = tables()[2]
    aug = np.concatenate([np.asarray(m, np.uint8), np.eye(n, dtype=np.uint8)],
                         axis=1)
    for col in range(n):
        nz = np.nonzero(aug[col:, col])[0]
        if not len(nz):
            raise ValueError("singular matrix over GF(2^8)")
        p = col + int(nz[0])
        aug[[col, p]] = aug[[p, col]]
        aug[col] = t[inverse(int(aug[col, col])), aug[col]]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= t[int(aug[r, col]), aug[col]]
    return aug[:, n:].copy()


@functools.lru_cache(maxsize=None)
def encode_matrix(k: int, m: int) -> np.ndarray:
    """klauspost's systematic [k + m, k] matrix V . inv(V[:k])."""
    v = np.array([[power(r, c) for c in range(k)] for r in range(k + m)],
                 np.uint8)
    e = matmul(v, invert(v[:k]))
    if not np.array_equal(e[:k], np.eye(k, dtype=np.uint8)):
        raise AssertionError("encode matrix is not systematic")
    return e


def parity_matrix(k: int, m: int) -> np.ndarray:
    return encode_matrix(k, m)[k:].copy()


def apply(matrix: np.ndarray, data: torch.Tensor,
          chunk: int = 64 << 20) -> torch.Tensor:
    """out[R, B] = matrix[R, C] (x) data[C, B], uint8 on data's device,
    `chunk` columns at a time so that the look-up indices stay small."""
    matrix = np.asarray(matrix, np.uint8)
    r, c = matrix.shape
    if data.dim() != 2 or data.shape[0] != c or data.dtype != torch.uint8:
        raise ValueError(f"data must be [{c}, B] uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    table = torch.from_numpy(tables()[2]).to(data.device)
    out = torch.zeros((r, data.shape[1]), dtype=torch.uint8,
                      device=data.device)
    for lo in range(0, data.shape[1], chunk):
        hi = min(lo + chunk, data.shape[1])
        for j in range(c):
            idx = data[j, lo:hi].int()
            for i in range(r):
                coef = int(matrix[i, j])
                if coef:
                    out[i, lo:hi] ^= table[coef][idx]
    return out


def encode(data: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """Parity [m, B] of data [k, B]."""
    return apply(parity_matrix(k, m), data)


def parity(data: torch.Tensor, config: dict) -> torch.Tensor:
    """Parity rows of data [k, B] under a configuration's code; this file
    knows plain RS(k, m) alone, as a configuration that names no `code`
    states it."""
    k, m = int(config["data_shards"]), int(config["parity_shards"])
    code = config.get("code", "")
    if code not in ("", f"rs_{k}_{m}"):
        raise ValueError(f"code {code!r} is not plain RS({k},{m}): its "
                         f"configuration has to name a reference of its own")
    return encode(data, k, m)
