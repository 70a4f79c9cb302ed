"""Host-side GF(2^8) matrix operands of the codec kernels (numpy).

Copies of the numpy helpers that the JAX package keeps inside modules that
import JAX (seaweedfs_tpu/ops/rs_jax.py, seaweedfs_tpu/ops/rs_xor.py), so
the port never imports them. Every function returns the same arrays as
its counterpart there; tests/test_torch_gf.py holds them equal.

A GF(256) matrix M [R, C] (uint8, the "byte form") reaches a kernel in one
of two derived forms:

  * "xor"  — ``xor_coefficients``: [R, C, 8] int32, the multiplier of each
             bit-j mask in the packed-word XOR kernel (ops/rs_xor.py).
  * "bits" — ``gf_matrix_to_bits``: [8R, 8C] int8, the GF(2) action matrix
             of the bitsliced kernel (ops/rs_bits.py).

Derived forms are cached by the compact identity of the matrix —
("parity", k, m), ("fdecs", k, m, present, missing), ("gdecs", name,
present, targets) — so the hot path never re-serializes matrix contents.
"""

from __future__ import annotations

import collections
import functools
import threading

import numpy as np

from . import gf256


def gf_matrix_to_bits(m: np.ndarray) -> np.ndarray:
    """Expand a GF(256) matrix [R, C] to its GF(2) action matrix [8R, 8C].

    Block (r, c) is the 8x8 bit matrix of the constant m[r, c]:
    out[8r+i, 8c+j] = bit_i(m[r,c] * 2^j).
    """
    m = np.asarray(m, dtype=np.uint8)
    r, c = m.shape
    powers = np.array([1 << j for j in range(8)], dtype=np.uint8)  # [8]
    # prod[r, c, j] = m[r,c] * 2^j in GF(256)
    prod = gf256.gf_mul_vec(m[:, :, None], powers[None, None, :])
    # bits[r, c, i, j] = bit i of prod[r, c, j]
    bits = (prod[:, :, None, :] >> np.arange(8)[None, None, :, None]) & 1
    big = bits.transpose(0, 2, 1, 3).reshape(8 * r, 8 * c)
    return big.astype(np.int8)


def xor_coefficients(matrix: np.ndarray) -> np.ndarray:
    """[R, C] GF(256) matrix -> [R, C, 8] int32 multipliers.

    out[r, c, j] = gfmul(matrix[r, c], 2^j), the scalar each bit-j mask is
    multiplied by before XOR accumulation.
    """
    m = np.asarray(matrix, dtype=np.uint8)
    powers = np.array([1 << j for j in range(8)], dtype=np.uint8)
    k = gf256.gf_mul_vec(m[:, :, None], powers[None, None, :])
    return k.astype(np.int32)


@functools.lru_cache(maxsize=1024)
def decode_matrix_cached(
    data_shards: int, parity_shards: int, present: tuple[int, ...]
) -> tuple[np.ndarray, tuple[int, ...]]:
    """Cached byte-form decode matrix for a survivor set: host Gauss-Jordan
    inversion run once per (geometry, survivor set)."""
    dec, used = gf256.decode_matrix_for(data_shards, parity_shards,
                                        list(present))
    return dec, tuple(used)


# LRU of derived operands: hot keys (the encode parity matrix) survive
# survivor-set churn.
_DERIVED_MAX = 4096
_derived_forms: "collections.OrderedDict[tuple, np.ndarray]" = (
    collections.OrderedDict()
)
_derived_lock = threading.Lock()


def derived(form: str, key: tuple, matrix: np.ndarray) -> np.ndarray:
    """The "bits" or "xor" form of byte-form `matrix`, cached under `key`."""
    if form not in ("bits", "xor"):
        raise ValueError(f"derived form must be 'bits' or 'xor', got {form!r}")
    full = (form, *key)
    with _derived_lock:
        got = _derived_forms.get(full)
        if got is not None:
            _derived_forms.move_to_end(full)
            return got
    got = gf_matrix_to_bits(matrix) if form == "bits" else \
        xor_coefficients(matrix)
    with _derived_lock:
        while len(_derived_forms) >= _DERIVED_MAX:
            _derived_forms.popitem(last=False)
        _derived_forms[full] = got
    return got


@functools.lru_cache(maxsize=1024)
def fused_reconstruct_matrix(
    data_shards: int, parity_shards: int, present: tuple[int, ...],
    missing: tuple[int, ...]
) -> tuple[np.ndarray, tuple[int, ...]]:
    """Byte-form [len(missing), k] matrix taking the k survivors straight
    to every missing shard — data AND parity — in ONE GF matmul.

    Data rows come from the decode matrix; parity rows fold the parity
    generator through it (G_p @ dec), so reconstruct needs no second
    encode pass. GF arithmetic is exact: outputs are bit-identical to the
    two-pass decode + re-encode. Cached per (geometry, survivor set,
    missing set)."""
    dec, used = decode_matrix_cached(data_shards, parity_shards, present)
    out = np.empty((len(missing), data_shards), dtype=np.uint8)
    parity_idx = [j for j, i in enumerate(missing) if i >= data_shards]
    for j, i in enumerate(missing):
        if i < data_shards:
            out[j] = dec[i]
    if parity_idx:
        gp = gf256.parity_matrix(data_shards, parity_shards)
        rows = [missing[j] - data_shards for j in parity_idx]
        out[parity_idx] = gf256.gf_matmul(gp[rows], dec)
    return out, used


@functools.lru_cache(maxsize=512)
def fused_reconstruct_stacked_matrix(
    data_shards: int, parity_shards: int, present_ids: tuple[int, ...],
    limit: int,
) -> tuple[tuple[int, ...], np.ndarray]:
    """Byte-form [missing, len(present_ids)] matrix operating on
    survivors stacked in the CALLER's row order: the fused matrix's
    columns are permuted to that order, with zero columns for surplus
    survivors — so a pre-stacked buffer needs no device gather."""
    missing = tuple(i for i in range(limit) if i not in set(present_ids))
    if not missing:
        return (), np.zeros((0, len(present_ids)), np.uint8)
    fmat, used = fused_reconstruct_matrix(
        data_shards, parity_shards, tuple(sorted(present_ids)), missing)
    col_of = {s: c for c, s in enumerate(used)}
    pm = np.zeros((len(missing), len(present_ids)), np.uint8)
    for j, s in enumerate(present_ids):
        c = col_of.get(s)
        if c is not None:
            pm[:, j] = fmat[:, c]
    return missing, pm


def parity_matrix_op(data_shards: int, parity_shards: int,
                     form: str) -> np.ndarray:
    """Cached parity-matrix operand in "bits" or "xor" form."""
    gp = gf256.parity_matrix(data_shards, parity_shards)
    return derived(form, ("parity", data_shards, parity_shards), gp)


# -- geometry-general operands ----------------------------------------------
#
# Non-RS code geometries (models/geometry.py) ride the same kernels with
# their own generator matrices; cache keys carry the geometry NAME.


def geom_parity_key(geom) -> tuple:
    return ("gparity", geom.name)


def geom_parity_op(geom, form: str) -> np.ndarray:
    """Derived-form parity operand for an arbitrary code geometry."""
    return derived(form, geom_parity_key(geom), geom.parity_matrix())


@functools.lru_cache(maxsize=2048)
def geom_stacked_matrix(geom, present_ids: tuple[int, ...],
                        targets: tuple[int, ...]) -> np.ndarray:
    """Byte-form [len(targets), len(present_ids)] repair matrix in the
    CALLER's survivor row order (CodeGeometry.repair_matrix is already
    column-ordered by its `present_ids` argument)."""
    return geom.repair_matrix(present_ids, targets)


def geom_stacked_op(geom, present_ids: tuple[int, ...],
                    targets: tuple[int, ...], form: str) -> np.ndarray:
    pm = geom_stacked_matrix(geom, present_ids, targets)
    return derived(form, ("gdecs", geom.name, present_ids, targets), pm)


def geom_targets_for(geom, present_ids: tuple[int, ...],
                     data_only: bool, want) -> tuple[int, ...]:
    """The rows a stacked reconstruct solves: `want` verbatim, else the
    complement of the survivor set under the data/total limit."""
    if want is not None:
        return tuple(want)
    limit = geom.data_shards if data_only else geom.total_shards
    return tuple(i for i in range(limit) if i not in set(present_ids))
