"""Compiled XOR-schedule codec plane: matrices as programs.

Counterpart of seaweedfs_tpu/ops/rs_sched.py. A host coder (ops/rs_cpu.py,
ops/rs_native.py) multiplies a dense GF(256) matrix even when the matrix
is mostly XOR: LRC local parities are pure-XOR rows, repair matrices are
small and structured, and the numpy dense path pays a 256-entry table
gather per coefficient per byte. This module lowers a matrix to an XOR
program (arXiv:2108.02692) that the dispatch scheduler's host lanes run
instead when it is predicted cheaper (ops/dispatch.py ``_host_encode``
and the reconstruct lane, through ``maybe_encode``/``maybe_reconstruct``).

The compilation scheme is the bit-plane Horner form:

    parity_r = sum_j alpha^j * plane_{r,j}
    plane_{r,j} = XOR of inputs c where bit j of M[r, c] is set

evaluated Horner-style per output row: acc = plane_7; for j = 6..0:
acc = xtime(acc) ^ plane_j. Every plane is a pure word-wide XOR stream,
and xtime (multiply by alpha = 2 in GF(256)/0x11D) runs once per output
row and bit, not per input. Rows whose coefficients are all in {0, 1}
(LRC local parities, identity rows of a repair plan) have a single bit
plane and need no xtime at all.

CSE: all plane sets of a compile unit (every row x every bit) share one
greedy pairwise eliminator: the most frequent co-occurring input pair is
factored into a scratch register until no pair repeats.

The schedule IR is a flat [N, 3] int32 program of (op, dst, src)
triples interpreted by two executors over the SAME registers: a numpy
word-wide interpreter here and a tiled C++ executor in ops/native/rs.cpp
(``swfs_xor_sched_exec``, bound in ops/rs_native.py). Registers
0..n_out-1 ARE the output rows; n_out.. are CSE scratch. A source operand
< n_in names an input row, >= n_in names register (src - n_in).

Selection is cost-based per lane (``prefer``): the numpy dense path's
table gather costs about 24 XOR passes, so schedules win there; the
native vpshufb axpy about 1.3, so dense RS rows stay dense on the native
coder and only (near-)pure-XOR matrices switch. ``rs_cpu`` remains the
bit-identity oracle either way.

Gate: SWFS_EC_SCHED=0 restores the dense path everywhere. The compiled
schedules are cached in models/geometry.py (LRU of SCHED_CACHE entries,
compile-once under a witness-ranked lock).
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np

from ..utils.stats import (
    EC_SCHED_BATCHES,
    EC_SCHED_BYTES,
    EC_SCHED_SKIPPED,
)

__all__ = [
    "XorSchedule", "compile_matrix", "enabled", "backend_kind",
    "maybe_encode", "maybe_reconstruct",
    "OP_SET", "OP_XOR", "OP_XTIME", "OP_ZERO",
]

OP_SET = 0    # reg[dst] = source
OP_XOR = 1    # reg[dst] ^= source
OP_XTIME = 2  # reg[dst] = alpha * reg[dst]  (in place; src unused)
OP_ZERO = 3   # reg[dst] = 0                 (degenerate all-zero rows)

# Cost model, in units of one vectorized word-wide XOR pass over the
# slab (the reference's constants). Numpy: an xtime is 4 whole-array
# passes (shift/mul/shift/xor) and a dense table gather (table[c][row]
# fancy indexing) is byte-at-a-time, about 24x an XOR pass at volume-slab
# sizes. Native: the vpshufb axpy is about 1.3 passes and the AVX2 xtime
# 1.1, so dense RS stays dense there and only (near-)pure-XOR matrices
# flip.
_COST = {
    "numpy": {"set": 1.0, "xor": 1.0, "xtime": 4.5, "zero": 0.5,
              "dense_one": 1.0, "dense_mul": 24.0, "dense_init": 0.5},
    "native": {"set": 0.6, "xor": 1.0, "xtime": 1.1, "zero": 0.3,
               "dense_one": 1.0, "dense_mul": 1.3, "dense_init": 0.5},
}


def enabled() -> bool:
    """SWFS_EC_SCHED gates the compiled-schedule plane (default on)."""
    return os.environ.get("SWFS_EC_SCHED", "1").lower() not in (
        "0", "false", "off")


class XorSchedule:
    """One compiled matrix: a flat (op, dst, src) program plus the cost
    model both executors share. Immutable after compile — cached entries
    are handed to concurrent lanes without copying."""

    __slots__ = ("n_in", "n_out", "n_tmp", "prog", "ops", "op_counts",
                 "_sched_cost", "_dense_cost")

    def __init__(self, n_in: int, n_out: int, n_tmp: int,
                 ops: list[tuple[int, int, int]], matrix: np.ndarray):
        self.n_in = n_in
        self.n_out = n_out
        self.n_tmp = n_tmp
        self.ops = ops
        self.prog = np.asarray(ops, np.int32).reshape(len(ops), 3)
        counts = Counter(op for op, _, _ in ops)
        self.op_counts = {
            "set": counts.get(OP_SET, 0), "xor": counts.get(OP_XOR, 0),
            "xtime": counts.get(OP_XTIME, 0),
            "zero": counts.get(OP_ZERO, 0)}
        nnz_one = int(np.count_nonzero(matrix == 1))
        nnz_mul = int(np.count_nonzero(matrix > 1))
        self._sched_cost = {}
        self._dense_cost = {}
        for kind, c in _COST.items():
            self._sched_cost[kind] = (
                self.op_counts["set"] * c["set"]
                + self.op_counts["xor"] * c["xor"]
                + self.op_counts["xtime"] * c["xtime"]
                + self.op_counts["zero"] * c["zero"])
            self._dense_cost[kind] = (
                n_out * c["dense_init"] + nnz_one * c["dense_one"]
                + nnz_mul * c["dense_mul"])

    def predicted_cost(self, backend: str) -> tuple[float, float]:
        """(schedule_cost, dense_cost) in XOR-pass units for a backend."""
        return self._sched_cost[backend], self._dense_cost[backend]

    def prefer(self, backend: str) -> bool:
        """True when the compiled schedule is predicted cheaper than the
        backend's dense path for this matrix."""
        sched, dense = self.predicted_cost(backend)
        return sched < dense

    # -- execution ---------------------------------------------------------

    def execute(self, data: np.ndarray, backend: str = "numpy"
                ) -> np.ndarray:
        """Run the program over input rows [n_in, B] -> [n_out, B].

        `data` may be a view into the dispatch scheduler's column-compact
        arena packing: both executors read the rows in place (the native
        one by pointer), no staging copy."""
        data = np.ascontiguousarray(data, np.uint8)
        if data.ndim != 2 or data.shape[0] != self.n_in:
            raise ValueError(f"expected [{self.n_in}, B] input rows, got "
                             f"{data.shape}")
        if backend == "native":
            from . import rs_native

            out = np.empty((self.n_out, data.shape[1]), np.uint8)
            rs_native.xor_sched_exec(self.prog, data, out,
                                     self.n_in, self.n_out, self.n_tmp)
            return out
        return self._execute_numpy(data)

    def _execute_numpy(self, data: np.ndarray) -> np.ndarray:
        b = data.shape[1]
        n_in = self.n_in
        regs = np.empty((self.n_out + self.n_tmp, b), np.uint8)
        scratch = np.empty(b, np.uint8)
        for op, dst, src in self.ops:
            row = regs[dst]
            if op == OP_XOR:
                s = data[src] if src < n_in else regs[src - n_in]
                np.bitwise_xor(row, s, out=row)
            elif op == OP_SET:
                s = data[src] if src < n_in else regs[src - n_in]
                np.copyto(row, s)
            elif op == OP_XTIME:
                # alpha * x over 0x11D on uint8 needs no masks: >>7
                # yields the high bit as 0/1, <<1 naturally drops it
                np.right_shift(row, 7, out=scratch)
                scratch *= 29  # 0x11D & 0xFF
                np.left_shift(row, 1, out=row)
                np.bitwise_xor(row, scratch, out=row)
            else:  # OP_ZERO
                row[...] = 0
        return regs[: self.n_out]

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"XorSchedule({self.n_out}x{self.n_in}, tmp={self.n_tmp},"
                f" ops={len(self.ops)})")


def compile_matrix(matrix: np.ndarray) -> XorSchedule:
    """Lower a GF(256) matrix [n_out, n_in] to an XOR schedule.

    Bit-plane decomposition + greedy pairwise CSE over ALL plane sets of
    the unit (across rows, bits, and — for a fused repair matrix — every
    target of the plan), then a Horner emission per output row. Pure
    {0, 1} rows get a single plane and zero xtime ops."""
    m = np.atleast_2d(np.asarray(matrix, np.uint8))
    n_out, n_in = m.shape
    plane_sets: dict[tuple[int, int], set[int]] = {}
    for r in range(n_out):
        for j in range(8):
            s = {c for c in range(n_in) if (int(m[r, c]) >> j) & 1}
            if s:
                plane_sets[(r, j)] = s
    # greedy pairwise CSE: atoms < n_in are input rows, atoms >= n_in
    # are scratch registers defined as the XOR of an earlier pair
    temp_defs: list[tuple[int, int]] = []
    while True:
        pairs: Counter = Counter()
        for s in plane_sets.values():
            if len(s) < 2:
                continue
            atoms = sorted(s)
            for i, a in enumerate(atoms):
                for b2 in atoms[i + 1:]:
                    pairs[(a, b2)] += 1
        if not pairs:
            break
        (a, b2), n = pairs.most_common(1)[0]
        if n < 2:
            break
        t_atom = n_in + len(temp_defs)
        temp_defs.append((a, b2))
        for s in plane_sets.values():
            if a in s and b2 in s:
                s.discard(a)
                s.discard(b2)
                s.add(t_atom)
    n_tmp = len(temp_defs)

    def src_of(atom: int) -> int:
        # inputs keep their id; temp atom t lives in register n_out + t,
        # and register R is addressed as source n_in + R
        return atom if atom < n_in else n_in + n_out + (atom - n_in)

    ops: list[tuple[int, int, int]] = []
    for t, (a, b2) in enumerate(temp_defs):
        reg = n_out + t
        ops.append((OP_SET, reg, src_of(a)))
        ops.append((OP_XOR, reg, src_of(b2)))
    for r in range(n_out):
        js = [j for j in range(8) if (r, j) in plane_sets]
        if not js:
            ops.append((OP_ZERO, r, 0))
            continue
        first = True
        for j in range(max(js), -1, -1):
            if not first:
                ops.append((OP_XTIME, r, 0))
            for atom in sorted(plane_sets.get((r, j), ())):
                if first:
                    ops.append((OP_SET, r, src_of(atom)))
                    first = False
                else:
                    ops.append((OP_XOR, r, src_of(atom)))
    return XorSchedule(n_in, n_out, n_tmp, ops, m)


# -- lane-side selection (the dispatch scheduler's entry points) ------------


def backend_kind(coder) -> str | None:
    """'native' / 'numpy' when the coder's matmul runs on the host CPU
    (the lanes this plane serves), None for device-backed coders."""
    from .rs_cpu import RSCodecCPU
    from .rs_native import RSCodecNative

    if not isinstance(coder, RSCodecCPU):
        return None
    return "native" if isinstance(coder, RSCodecNative) else "numpy"


def maybe_encode(coder, wide: np.ndarray) -> np.ndarray | None:
    """Compiled-schedule parity encode for a host-CPU coder over a wide
    [k, W] slab (the dispatch scheduler's column-compact packing), or
    None when the lane should stay on the dense path (device backend,
    gate off, or dense predicted cheaper)."""
    kind = backend_kind(coder)
    if kind is None:
        return None
    if not enabled():
        EC_SCHED_SKIPPED.inc(role="encode", reason="gate_off")
        return None
    from ..models import geometry as geom_mod

    try:
        sched = geom_mod.encode_schedule(coder.geometry)
    except TypeError:
        # non-systematic geometry without a parity block
        EC_SCHED_SKIPPED.inc(role="encode", reason="unsupported")
        return None
    if not sched.prefer(kind):
        EC_SCHED_SKIPPED.inc(role="encode", reason="dense_cheaper")
        return None
    out = sched.execute(wide, backend=kind)
    EC_SCHED_BATCHES.inc(role="encode", backend=kind)
    EC_SCHED_BYTES.inc(out.nbytes, role="encode")
    return out


def maybe_reconstruct(coder, present_ids, stacked: np.ndarray,
                      data_only: bool = False, want=None):
    """Compiled-schedule reconstruct for a host-CPU coder: survivors
    [P, B] in caller row order -> (targets, rows[len(targets), B]), or
    None to stay dense. Target choice matches rs_cpu.reconstruct_stacked
    exactly: `want` verbatim, else the ascending complement of the
    survivors — and the fused repair matrix is the geometry's own
    (sorted-independent-prefix solve), so bytes are identical to both
    the want-path and the legacy dict decode."""
    kind = backend_kind(coder)
    if kind is None:
        return None
    if not enabled():
        EC_SCHED_SKIPPED.inc(role="reconstruct", reason="gate_off")
        return None
    from ..models import geometry as geom_mod

    present_ids = tuple(present_ids)
    geom = coder.geometry
    targets = tuple(want) if want is not None else tuple(
        i for i in range(geom.data_shards if data_only
                         else geom.total_shards)
        if i not in set(present_ids))
    if not targets:
        return (), np.zeros((0, np.asarray(stacked).shape[1]), np.uint8)
    try:
        sched = geom_mod.repair_schedule(geom, present_ids, targets)
    except geom_mod.UnsolvableError:
        # let the dense path raise the canonical error for this input
        EC_SCHED_SKIPPED.inc(role="reconstruct", reason="unsupported")
        return None
    if not sched.prefer(kind):
        EC_SCHED_SKIPPED.inc(role="reconstruct", reason="dense_cheaper")
        return None
    rows = sched.execute(stacked, backend=kind)
    EC_SCHED_BATCHES.inc(role="reconstruct", backend=kind)
    EC_SCHED_BYTES.inc(rows.nbytes, role="reconstruct")
    return targets, rows
