"""Code geometries: named GF(256) layouts behind one registry.

A copy of the parts of seaweedfs_tpu/models/geometry.py that the EC file
lifecycle needs. The codec backends (ops/rs_cpu.py, ops/rs_torch.py) are
generic GF(256) matrix engines — the CODE is entirely the generator matrix
fed to them:

  * ``rs_10_4`` (default) — classic Reed-Solomon, byte-identical to
    klauspost/reedsolomon (gf256.build_encode_matrix); any ``rs_{k}_{m}``
    name resolves on demand.
  * ``lrc_10_2_2`` — locally-repairable layout: the 10 data shards split
    into two local groups of 5, each with one XOR local parity (shards 10,
    11), plus two global parity rows g1[i] = 2^i, g2[i] = 4^i (shards 12,
    13). A single lost shard inside a local group repairs from 5 survivors.

Repair planning is one mechanism for every geometry: solve
``X @ G[survivors] = G[lost]`` with the survivor rows taken in sorted
order, greedily keeping the first linearly-independent prefix, then prune
the all-zero columns of X. For RS this reproduces klauspost's
sorted-first-k decode bit for bit; for LRC the pruning IS the local repair.

Not carried over (later slices): the compiled XOR-schedule cache and the
product-matrix regenerating code (``pm_mbr``).
"""

from __future__ import annotations

import functools
import re
import threading

import numpy as np

from ..ops import gf256

__all__ = [
    "CodeGeometry", "RepairPlan", "UnsolvableError", "register", "get",
    "names", "rs", "lrc_10_2_2", "resolve", "as_geometry",
]


class UnsolvableError(ValueError):
    """The requested shards are not recoverable from the given survivors."""


# -- GF(256) linear algebra over small matrices ------------------------------


def _eliminate(rows: np.ndarray) -> tuple[int, list[int]]:
    """Row-reduce a copy of `rows`; -> (rank, pivot column indices)."""
    m = rows.astype(np.uint8).copy()
    n_rows, n_cols = m.shape
    r = 0
    pivots: list[int] = []
    for col in range(n_cols):
        piv = None
        for i in range(r, n_rows):
            if m[i, col]:
                piv = i
                break
        if piv is None:
            continue
        m[[r, piv]] = m[[piv, r]]
        inv = gf256.gf_inv(int(m[r, col]))
        m[r] = gf256.gf_mul_vec(m[r], np.uint8(inv))
        for i in range(n_rows):
            if i != r and m[i, col]:
                m[i] = m[i] ^ gf256.gf_mul_vec(
                    np.full(n_cols, m[i, col], np.uint8), m[r])
        pivots.append(col)
        r += 1
        if r == n_rows:
            break
    return r, pivots


def gf_rank(rows: np.ndarray) -> int:
    return _eliminate(np.atleast_2d(rows))[0]


def _independent_prefix(g: np.ndarray, ids: tuple[int, ...],
                        cap: int) -> tuple[int, ...]:
    """First rows of g[ids] (in the given order) that are linearly
    independent, stopping at rank `cap`. For an MDS (RS) matrix this is
    exactly ids[:cap] — klauspost's sorted-first-k survivor choice."""
    used: list[int] = []
    basis: list[np.ndarray] = []
    rank = 0
    for i in ids:
        if rank == cap:
            break
        trial = np.stack(basis + [g[i]])
        r2 = gf_rank(trial)
        if r2 > rank:
            used.append(i)
            basis.append(g[i])
            rank = r2
    return tuple(used)


def gf_solve_rows(g_used: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """X with X @ g_used = targets over GF(256), or raise UnsolvableError.

    g_used [r, k] must have independent rows; targets [T, k]. When r == k
    this is targets @ inv(g_used) — for RS, byte-identical to the fused
    reconstruct matrix construction (matrix inverses are unique)."""
    g_used = np.atleast_2d(np.asarray(g_used, np.uint8))
    targets = np.atleast_2d(np.asarray(targets, np.uint8))
    r = g_used.shape[0]
    rank, pivots = _eliminate(g_used)
    if rank != r:
        raise UnsolvableError("survivor rows are not independent")
    a = g_used[:, pivots]  # [r, r] invertible by pivot construction
    x = gf256.gf_matmul(targets[:, pivots], gf256.gf_mat_inv(a))
    if not np.array_equal(gf256.gf_matmul(x, g_used), targets):
        raise UnsolvableError(
            "target shards are outside the survivors' span")
    return x


# -- repair plans ------------------------------------------------------------


class RepairPlan:
    """Minimal-read recovery of `want` shards from `reads` survivors.

    ``matrix [len(want), len(reads)] @ stacked-read-rows`` yields the lost
    shards' bytes. ``reads`` is the pruned survivor set — the bytes-moved
    accounting every consumer (rebuild, degraded read, scrub repair)
    reports per geometry."""

    __slots__ = ("want", "reads", "matrix")

    def __init__(self, want: tuple[int, ...], reads: tuple[int, ...],
                 matrix: np.ndarray):
        self.want = want
        self.reads = reads
        self.matrix = matrix

    def __repr__(self):  # pragma: no cover - debug aid
        return f"RepairPlan(want={self.want}, reads={self.reads})"


# -- the geometry object -----------------------------------------------------


class CodeGeometry:
    """One named code: a [total, k] GF(256) generator matrix plus the
    local-group structure repair planning exploits.

    Hash/eq is by name — the registry (and the lru caches keyed on
    geometry objects) rely on one object per name."""

    def __init__(self, name: str, data_shards: int, parity_shards: int,
                 parity_rows: np.ndarray,
                 local_groups: tuple[tuple[tuple[int, ...], int], ...] = (),
                 is_rs: bool = False, volume_capable: bool = True,
                 description: str = ""):
        parity_rows = np.asarray(parity_rows, np.uint8)
        if parity_rows.shape != (parity_shards, data_shards):
            raise ValueError(
                f"parity rows {parity_rows.shape} != "
                f"({parity_shards}, {data_shards})")
        if data_shards <= 0 or parity_shards < 0:
            raise ValueError("bad geometry")
        if data_shards + parity_shards > 256:
            raise ValueError("at most 256 total shards in GF(256)")
        self.name = name
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.local_groups = local_groups
        self.is_rs = is_rs
        self.volume_capable = volume_capable
        self.description = description
        self._gp = parity_rows
        enc = np.zeros((self.total_shards, data_shards), np.uint8)
        enc[:data_shards] = np.eye(data_shards, dtype=np.uint8)
        enc[data_shards:] = parity_rows
        self._enc = enc
        self._enc.setflags(write=False)
        self._gp.setflags(write=False)

    # identity --------------------------------------------------------------

    def __hash__(self):
        return hash(("CodeGeometry", self.name))

    def __eq__(self, other):
        return (isinstance(other, CodeGeometry) and other.name == self.name)

    def __repr__(self):
        return (f"CodeGeometry({self.name!r}, {self.data_shards}+"
                f"{self.parity_shards})")

    # matrices --------------------------------------------------------------

    def parity_matrix(self) -> np.ndarray:
        """[m, k] generator block — what every encode backend multiplies."""
        return self._gp

    def encode_matrix(self) -> np.ndarray:
        """[total, k] systematic generator (identity on top)."""
        return self._enc

    def group_of(self, shard_id: int) -> tuple[tuple[int, ...], int] | None:
        """(data_ids, local_parity_sid) of the local group covering
        shard_id (data member or the local parity itself), else None."""
        for data_ids, psid in self.local_groups:
            if shard_id == psid or shard_id in data_ids:
                return data_ids, psid
        return None

    # repair planning -------------------------------------------------------

    def decode_rows(self, present) -> tuple[int, ...]:
        """Survivor subset actually used for a full decode: the first
        linearly-independent prefix of sorted(present), rank k required.
        For RS this is sorted(present)[:k], klauspost's choice."""
        present = tuple(sorted(set(present)))
        used = _independent_prefix(self._enc, present, self.data_shards)
        if len(used) < self.data_shards:
            raise UnsolvableError(
                f"{self.name}: survivors {present} span rank "
                f"{len(used)} < {self.data_shards}")
        return used

    def repair_matrix(self, present_ids: tuple[int, ...],
                      want: tuple[int, ...]) -> np.ndarray:
        """[len(want), len(present_ids)] solving the want rows from the
        survivors STACKED IN CALLER ORDER (zero columns on survivors the
        solution does not touch). Raises UnsolvableError when the wanted
        shards are outside the survivors' span."""
        return _repair_matrix_cached(self, tuple(present_ids), tuple(want))

    def repair_plan(self, want, present) -> RepairPlan:
        """Minimal-read plan: solve from the sorted independent prefix,
        then prune survivors with all-zero coefficients. A single loss
        inside an LRC local group prunes down to the group (5 reads);
        RS always keeps k."""
        want = tuple(want)
        present = tuple(sorted(set(present) - set(want)))
        x = self.repair_matrix(present, want)
        keep = [j for j in range(len(present)) if x[:, j].any()]
        if not keep:  # want is all-zeros (degenerate) — read one anchor
            keep = [0] if present else []
        reads = tuple(present[j] for j in keep)
        return RepairPlan(want, reads, x[:, keep].copy())

    def single_loss_reads(self, lost: int) -> tuple[int, ...]:
        """Plan for one lost shard with every other shard healthy — the
        repair-bandwidth headline number per shard."""
        present = tuple(i for i in range(self.total_shards) if i != lost)
        return self.repair_plan((lost,), present).reads


@functools.lru_cache(maxsize=8192)
def _repair_matrix_cached(geom: CodeGeometry, present: tuple[int, ...],
                          want: tuple[int, ...]) -> np.ndarray:
    g = geom.encode_matrix()
    for i in (*present, *want):
        if not 0 <= i < geom.total_shards:
            raise ValueError(f"shard id {i} out of range for {geom.name}")
    order = tuple(sorted(set(present)))
    # independent prefix in sorted order, capped at k (for RS: first k).
    # At rank k the prefix spans the whole space, and below k it already
    # holds every independent survivor row — either way the solve below
    # is decisive (unsolvable means genuinely unrecoverable).
    used = _independent_prefix(g, order, geom.data_shards)
    x_used = gf_solve_rows(g[list(used)], g[list(want)])
    col_of = {s: c for c, s in enumerate(used)}
    out = np.zeros((len(want), len(present)), np.uint8)
    for j, s in enumerate(present):
        c = col_of.get(s)
        if c is not None:
            out[:, j] = x_used[:, c]
    out.setflags(write=False)
    return out


# -- constructions -----------------------------------------------------------

_RS_NAME = re.compile(r"^rs_(\d+)_(\d+)$")


@functools.lru_cache(maxsize=256)
def rs(data_shards: int = 10, parity_shards: int = 4) -> CodeGeometry:
    """Classic Reed-Solomon — THE bit-identical default. The parity block
    is gf256.parity_matrix, i.e. klauspost's V * inv(V_top) construction;
    nothing about the byte path changes when a coder is built through
    this object instead of the legacy (k, m) pair."""
    return CodeGeometry(
        f"rs_{data_shards}_{parity_shards}", data_shards, parity_shards,
        gf256.parity_matrix(data_shards, parity_shards), is_rs=True,
        description=f"Reed-Solomon({data_shards},{parity_shards}) — "
                    f"single-shard repair reads {data_shards} survivors")


@functools.lru_cache(maxsize=1)
def lrc_10_2_2() -> CodeGeometry:
    """LRC(10, 2, 2): groups {0..4}+shard10 and {5..9}+shard11 (XOR local
    parities), global parities g1[i] = 2^i, g2[i] = 4^i (shards 12, 13).

    The global rows are geometric progressions of the field generator —
    with the XOR locals this tests out maximally-usable: ALL <=3-shard
    loss patterns decode (distance 4, same as RS(10,4) for <=3) and
    861/1001 4-loss patterns do (RS decodes all 1001 — the repair
    bandwidth is bought with that tail). tests/test_geometry.py pins
    both counts by brute force."""
    k = 10
    gp = np.zeros((4, k), np.uint8)
    gp[0, 0:5] = 1
    gp[1, 5:10] = 1
    gp[2] = [gf256.gf_exp(2, i) for i in range(k)]
    gp[3] = [gf256.gf_exp(4, i) for i in range(k)]
    return CodeGeometry(
        "lrc_10_2_2", k, 4, gp,
        local_groups=(((0, 1, 2, 3, 4), 10), ((5, 6, 7, 8, 9), 11)),
        description="locally-repairable (2 groups of 5 + 1 local parity "
                    "each, 2 global parities) — single-shard repair in a "
                    "group reads 5 survivors")


# -- registry ----------------------------------------------------------------

_registry: dict[str, CodeGeometry] = {}
_registry_lock = threading.Lock()


def register(geom: CodeGeometry) -> CodeGeometry:
    with _registry_lock:
        old = _registry.get(geom.name)
        if old is not None and old is not geom:
            raise ValueError(f"geometry {geom.name!r} already registered")
        _registry[geom.name] = geom
    return geom


def names() -> list[str]:
    with _registry_lock:
        return sorted(_registry)


def get(name: str) -> CodeGeometry:
    """Resolve a registered geometry name. ``rs_{k}_{m}`` names resolve
    on demand (custom -dataShards/-parityShards encodes predate the
    registry). Unknown names raise with the registered list — the error
    every validation surface (shell, gRPC, mount) relays."""
    with _registry_lock:
        got = _registry.get(name)
    if got is not None:
        return got
    m = _RS_NAME.match(name)
    if m:
        return rs(int(m.group(1)), int(m.group(2)))
    raise ValueError(
        f"unknown code geometry {name!r}; registered: {names()} "
        f"(rs_<k>_<m> resolves on demand)")


def resolve(data_shards: int, parity_shards: int,
            name: str | None = None) -> CodeGeometry:
    """Geometry for a (k, m[, name]) triple, validating consistency."""
    if not name:
        return rs(data_shards, parity_shards)
    geom = get(name)
    if (geom.data_shards, geom.parity_shards) != (data_shards,
                                                  parity_shards):
        raise ValueError(
            f"geometry {name!r} is {geom.data_shards}+"
            f"{geom.parity_shards}, not {data_shards}+{parity_shards}")
    return geom


def as_geometry(data_shards: int, parity_shards: int,
                geometry=None) -> CodeGeometry:
    """Coder-constructor helper: accept a CodeGeometry, a name, or None
    (-> plain RS) and validate the shard counts. Non-volume-capable
    (stripe-level, non-systematic) geometries are REJECTED here: an
    ErasureCoder multiplies the systematic parity block, which such
    codes do not have — accepting one would silently encode zero
    parity (no redundancy at all)."""
    if geometry is None:
        return rs(data_shards, parity_shards)
    if isinstance(geometry, str):
        geometry = get(geometry)
    if not geometry.volume_capable:
        raise ValueError(
            f"geometry {geometry.name!r} is a stripe-level codec "
            f"(volume_capable=False); it cannot back an ErasureCoder — "
            f"use its own encode_stripe/repair_node/decode_stripe "
            f"surface")
    if (geometry.data_shards, geometry.parity_shards) != (data_shards,
                                                          parity_shards):
        raise ValueError(
            f"geometry {geometry.name!r} is {geometry.data_shards}+"
            f"{geometry.parity_shards}, not {data_shards}+{parity_shards}")
    return geometry


# built-ins
register(rs(10, 4))
register(lrc_10_2_2())
