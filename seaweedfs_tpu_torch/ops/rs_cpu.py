"""CPU reference Reed-Solomon codec (numpy, table-based GF(256)).

The port's ``cpu`` backend and its independent oracle: the same encode
matrix as klauspost/reedsolomon (gf256.build_encode_matrix), applied with
a 256x256 multiplication table instead of either kernel formulation. A
copy of seaweedfs_tpu/ops/rs_cpu.py without the multi-chip mirror.
"""

from __future__ import annotations

import numpy as np

from . import gf256


def reconstruct_stacked_via_dict(coder, present_ids, stacked,
                                 data_only: bool = False):
    """Stacked-reconstruct contract implemented over the dict surface:
    (missing_ids, rows[len(missing), B]). The dict path uses the
    sorted-first-k survivor choice of the fused matrix, so bytes are
    identical across routes."""
    present_ids = tuple(present_ids)
    rec = (coder.reconstruct_data if data_only else coder.reconstruct)(
        {p: stacked[j] for j, p in enumerate(present_ids)})
    limit = coder.data_shards if data_only else coder.total_shards
    missing = tuple(i for i in range(limit) if i not in set(present_ids))
    if not missing:
        return (), np.zeros((0, stacked.shape[1]), np.uint8)
    return missing, np.stack(
        [np.asarray(rec[i], np.uint8) for i in missing])


class RSCodecCPU:
    def __init__(self, data_shards: int = 10, parity_shards: int = 4,
                 geometry=None):
        if data_shards <= 0 or parity_shards < 0:
            raise ValueError("bad geometry")
        if data_shards + parity_shards > 256:
            raise ValueError("at most 256 total shards in GF(256)")
        from ..models import geometry as geom_mod

        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        # the codec is a generic GF matrix engine — the CODE is the
        # generator matrix. None keeps the plain RS path byte-for-byte.
        self.geometry = geom_mod.as_geometry(data_shards, parity_shards,
                                             geometry)
        self._gp = (gf256.parity_matrix(data_shards, parity_shards)
                    if self.geometry.is_rs
                    else self.geometry.parity_matrix())

    @property
    def geometry_id(self) -> str:
        return self.geometry.name

    def _matmul(self, matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
        """GF(256) matmul by streaming accumulation (out[i] ^= T[c] @ row):
        XOR is exact and order-free, so the bytes equal every other
        formulation's."""
        matrix = np.asarray(matrix, dtype=np.uint8)
        data = np.asarray(data, dtype=np.uint8)
        table = gf256._mul_table()
        out = np.zeros((matrix.shape[0], data.shape[1]), dtype=np.uint8)
        for i in range(matrix.shape[0]):
            acc = out[i]
            for j in range(matrix.shape[1]):
                c = int(matrix[i, j])
                if c == 0:
                    continue
                if c == 1:
                    acc ^= data[j]
                else:
                    acc ^= table[c][data[j]]
        return out

    def encode_parity(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, dtype=np.uint8)
        if data.shape[0] != self.data_shards:
            raise ValueError(f"expected {self.data_shards} data rows, "
                             f"got shape {data.shape}")
        return self._matmul(self._gp, data)

    def encode_parity_stacked(self, stack: np.ndarray) -> np.ndarray:
        """stack [V, k, B] -> parity [V, m, B] in ONE matmul call: parity
        is a per-byte-column GF matmul, so the V slabs laid side by side
        ([k, V*B]) give bytes identical to V encode_parity calls."""
        stack = np.asarray(stack, dtype=np.uint8)
        if stack.ndim != 3 or stack.shape[1] != self.data_shards:
            raise ValueError(f"expected [V, {self.data_shards}, B], got "
                             f"shape {stack.shape}")
        v, k, b = stack.shape
        wide = stack.transpose(1, 0, 2).reshape(k, v * b)
        parity = self._matmul(self._gp, wide)
        return parity.reshape(self.parity_shards, v, b).transpose(1, 0, 2)

    def encode(self, shards: np.ndarray) -> np.ndarray:
        shards = np.asarray(shards, dtype=np.uint8).copy()
        shards[self.data_shards:] = self.encode_parity(
            shards[: self.data_shards])
        return shards

    def reconstruct(self, shards) -> dict[int, np.ndarray]:
        present = self._as_dict(shards)
        missing = [i for i in range(self.total_shards) if i not in present]
        if not missing:
            return {}
        if not self.geometry.is_rs:
            # geometry-general path: one solved [missing, P] matrix
            pres = tuple(sorted(present))
            x = self.geometry.repair_matrix(pres, tuple(missing))
            rows = self._matmul(
                x, np.stack([np.asarray(present[i], np.uint8)
                             for i in pres]))
            return {i: rows[j] for j, i in enumerate(missing)}
        dec, used = gf256.decode_matrix_for(
            self.data_shards, self.parity_shards, sorted(present.keys())
        )
        stacked = np.stack([np.asarray(present[i], np.uint8) for i in used])
        data = self._matmul(dec, stacked)
        out = {}
        parity = None
        for i in missing:
            if i < self.data_shards:
                out[i] = data[i]
            else:
                if parity is None:
                    parity = self.encode_parity(data)
                out[i] = parity[i - self.data_shards]
        return out

    def reconstruct_stacked(
        self, present_ids, stacked: np.ndarray, data_only: bool = False,
        want: tuple[int, ...] | None = None,
    ) -> tuple[tuple[int, ...], np.ndarray]:
        """Pre-stacked survivors [P, B] in caller row order ->
        (missing_ids, [len(missing), B]). `want` restricts the solve to
        those shard ids — the minimal-read repair form: the survivor set
        may then be SMALLER than k (an LRC local group) as long as it
        spans the wanted rows."""
        present_ids = tuple(present_ids)
        stacked = np.asarray(stacked, dtype=np.uint8)
        if stacked.shape[0] != len(present_ids):
            raise ValueError(f"{len(present_ids)} survivor ids for "
                             f"{stacked.shape[0]} stacked rows")
        if want is not None or not self.geometry.is_rs:
            targets = tuple(want) if want is not None else tuple(
                i for i in range((self.data_shards if data_only
                                  else self.total_shards))
                if i not in set(present_ids))
            if not targets:
                return (), np.zeros((0, stacked.shape[1]), np.uint8)
            x = self.geometry.repair_matrix(present_ids, targets)
            return targets, self._matmul(x, stacked)
        return reconstruct_stacked_via_dict(self, present_ids, stacked,
                                            data_only)

    def reconstruct_data(self, shards) -> dict[int, np.ndarray]:
        present = self._as_dict(shards)
        missing = [i for i in range(self.data_shards) if i not in present]
        if not missing:
            return {}
        rec = self.reconstruct(shards)
        return {i: rec[i] for i in missing}

    def verify(self, shards: np.ndarray) -> bool:
        shards = np.asarray(shards, dtype=np.uint8)
        return np.array_equal(
            self.encode_parity(shards[: self.data_shards]),
            shards[self.data_shards:],
        )

    def _as_dict(self, shards) -> dict[int, np.ndarray]:
        if isinstance(shards, dict):
            return dict(shards)
        return {i: s for i, s in enumerate(shards) if s is not None}
