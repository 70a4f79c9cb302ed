"""GF(2^8) arithmetic and Reed-Solomon matrix construction.

Field: GF(2^8) with the primitive polynomial x^8+x^4+x^3+x^2+1 (0x11D) and
generator element 2 — the field klauspost/reedsolomon uses, which the
SeaweedFS encoder calls.

Bit-identity argument: the encode matrix is the systematic matrix
`V · inv(V_top)` where V[r][c] = (r as field element) ** c is the (total x data)
Vandermonde matrix. Matrix inverses over a field are unique, so any correct
GF(2^8)/0x11D implementation of that construction yields byte-identical parity.

Everything here is numpy on host — these are tiny (<= 256x256) matrices
computed once per geometry. The byte-column products run in ops/rs_xor.py
and ops/rs_bits.py. A copy of seaweedfs_tpu/ops/gf256.py: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np

GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1
FIELD_SIZE = 256


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """exp/log tables for generator 2 over GF(2^8)/0x11D."""
    exp = np.zeros(512, dtype=np.uint8)  # doubled to skip mod-255 in mul
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    exp[255:510] = exp[0:255]
    return exp, log


EXP_TABLE, LOG_TABLE = _build_tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP_TABLE[LOG_TABLE[a] + LOG_TABLE[b]])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(256) division by zero")
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] - LOG_TABLE[b]) % 255])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(256) inverse of zero")
    return int(EXP_TABLE[255 - LOG_TABLE[a]])


def gf_exp(a: int, n: int) -> int:
    """a ** n in GF(256); matches klauspost galExp (a=0,n=0 -> 1)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] * n) % 255])


@functools.lru_cache(maxsize=None)
def _mul_table() -> np.ndarray:
    """Full 256x256 GF multiplication table (64KB), for vectorized host math."""
    logs = LOG_TABLE  # [256]
    a = np.arange(256)
    s = logs[a][:, None] + logs[a][None, :]
    t = EXP_TABLE[s]
    t[0, :] = 0
    t[:, 0] = 0
    return t.astype(np.uint8)


def gf_mul_vec(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise GF(256) multiply of uint8 arrays (broadcasting)."""
    return _mul_table()[a.astype(np.int32), b.astype(np.int32)]


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(256) matrix multiply: [r,k] x [k,c] -> [r,c], XOR-accumulated."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    assert a.ndim == 2 and b.ndim == 2 and a.shape[1] == b.shape[0]
    prod = _mul_table()[a.astype(np.int32)[:, :, None], b.astype(np.int32)[None, :, :]]
    return np.bitwise_xor.reduce(prod, axis=1).astype(np.uint8)


def gf_mat_inv(m: np.ndarray) -> np.ndarray:
    """Invert a square GF(256) matrix by Gauss-Jordan elimination.

    Raises ValueError if singular. The inverse is unique, so this matches any
    other correct implementation byte-for-byte.
    """
    m = np.asarray(m, dtype=np.uint8)
    n = m.shape[0]
    assert m.shape == (n, n)
    aug = np.concatenate([m.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        # find pivot
        pivot = -1
        for r in range(col, n):
            if aug[r, col] != 0:
                pivot = r
                break
        if pivot < 0:
            raise ValueError("singular matrix over GF(256)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        # scale pivot row to 1
        inv = gf_inv(int(aug[col, col]))
        aug[col] = gf_mul_vec(aug[col], np.uint8(inv))
        # eliminate all other rows
        for r in range(n):
            if r != col and aug[r, col] != 0:
                factor = aug[r, col]
                aug[r] = aug[r] ^ gf_mul_vec(np.full(2 * n, factor, np.uint8), aug[col])
    return aug[:, n:].copy()


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """V[r][c] = (r as field element) ** c — klauspost's vandermonde()."""
    v = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            v[r, c] = gf_exp(r, c)
    return v


@functools.lru_cache(maxsize=None)
def build_encode_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """Systematic encode matrix [total, data], identical to klauspost's
    default (non-Cauchy) buildMatrix: V * inv(V[:data, :data]).

    Top `data_shards` rows are the identity; the remaining rows are the
    parity generator.
    """
    total = data_shards + parity_shards
    v = vandermonde(total, data_shards)
    top_inv = gf_mat_inv(v[:data_shards, :data_shards])
    m = gf_matmul(v, top_inv)
    # systematic sanity: top rows must be the identity
    assert np.array_equal(m[:data_shards], np.eye(data_shards, dtype=np.uint8))
    return m


def parity_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """The [parity, data] generator block of the encode matrix."""
    return build_encode_matrix(data_shards, parity_shards)[data_shards:].copy()


def decode_matrix_for(
    data_shards: int, parity_shards: int, present: list[int]
) -> tuple[np.ndarray, list[int]]:
    """Build the [data, data] decode matrix from the first `data_shards`
    surviving shard rows (ascending shard id, klauspost's subset choice).

    Returns (decode_matrix, used_shard_ids): data[d] = decode[d] . stacked
    survivor bytes. The decoded data is unique regardless of subset choice.
    """
    if len(present) < data_shards:
        raise ValueError(
            f"need {data_shards} shards to reconstruct, have {len(present)}"
        )
    used = sorted(present)[:data_shards]
    enc = build_encode_matrix(data_shards, parity_shards)
    sub = enc[used, :]  # [data, data]
    return gf_mat_inv(sub), used
