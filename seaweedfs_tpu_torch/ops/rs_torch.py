"""Reed-Solomon codec on PyTorch tensors: ``RSCodecTorch``.

Counterpart of seaweedfs_tpu/ops/rs_jax.py ``RSCodecJax``: the same call
surface (encode_parity, encode_parity_stacked, encode, reconstruct,
reconstruct_data, reconstruct_stacked with want=, verify, parity_probe),
the same matrices, the same bytes. Every call is one GF(2^8) matrix
product over byte columns, ``out[R, B] = M[R, C] (x) data[C, B]``:

  * encode applies the [m, k] parity generator;
  * reconstruct applies a fused [missing, k] decode matrix (data rows from
    the inverse, parity rows folded through it), column-permuted to the
    caller's survivor order by ops/gfmat.py.

Routing (``dispatch_matmul``) picks the formulation by the environment
variable SEAWEEDFS_TORCH_KERNEL: ``xor`` (the default, kernel K1 in
ops/rs_xor.py), ``bits`` (kernel K2 in ops/rs_bits.py) or ``sel``
(kernel K3 in ops/rs_sel.py, compiled per matrix; it takes the encode
matrices, and the fused decode matrices go to ``xor``). On a CUDA
device the chosen kernel launches or the call raises; on the CPU its
plain PyTorch version runs. Results are uint8 tensors on the codec's
device; callers that need host bytes copy them (``.cpu().numpy()``).

Construction touches no CUDA state: the device is a name until the first
call moves data to it.
"""

from __future__ import annotations

import collections
import os
import threading

import numpy as np
import torch

from . import gf256, gfmat, rs_bits, rs_sel, rs_xor

KERNELS = ("xor", "bits", "sel")
# keys of the fused decode matrices: one per survivor and missing set
DECODE_KEYS = ("fdec", "fdecs", "gdecs")


def kernel_choice() -> str:
    """The formulation SEAWEEDFS_TORCH_KERNEL selects (default "xor")."""
    choice = os.environ.get("SEAWEEDFS_TORCH_KERNEL", "xor")
    if choice not in KERNELS:
        raise ValueError(f"SEAWEEDFS_TORCH_KERNEL={choice!r}: expected one "
                         f"of {KERNELS}")
    return choice


# Derived operands resident on their device, keyed by the matrix's compact
# identity: a survivor set's fused decode matrix (or the encode operand) is
# copied to the device once and reused by every later call. LRU so
# survivor-set churn cannot fill device memory with dead matrices.
_DEVICE_OPS_MAX = 256
_device_ops: "collections.OrderedDict[tuple, torch.Tensor]" = (
    collections.OrderedDict()
)
_device_ops_lock = threading.Lock()


def op_on_device(full_key: tuple, host_op: np.ndarray,
                 device: torch.device) -> torch.Tensor:
    """`host_op` (identified by `full_key`) on `device`, cached LRU."""
    key = (full_key, str(device))
    with _device_ops_lock:
        got = _device_ops.get(key)
        if got is not None:
            _device_ops.move_to_end(key)
            return got
    t = torch.from_numpy(np.ascontiguousarray(host_op)).to(device)
    with _device_ops_lock:
        while len(_device_ops) >= _DEVICE_OPS_MAX:
            _device_ops.popitem(last=False)
        _device_ops[key] = t
    return t


def dispatch_matmul(matrix: np.ndarray, data: torch.Tensor,
                    key: tuple) -> torch.Tensor:
    """out[R, B] = matrix[R, C] (x) data[C, B] through the selected
    formulation. `matrix` is the byte-form GF(256) matrix and `key` its
    compact cache identity."""
    kind = kernel_choice()
    if kind == "sel":
        if key[0] not in DECODE_KEYS:
            return rs_sel.gf_matmul_sel(matrix, data, key=key)
        # K3 is compiled per matrix; a decode matrix exists per failure
        # pattern (up to C(n, k) of them), so it takes the run-time-matrix
        # kernel K1 and K3 keeps the one encode matrix per geometry
        kind = "xor"
    op = op_on_device((kind, *key), gfmat.derived(kind, key, matrix),
                      data.device)
    if kind == "xor":
        return rs_xor.gf_matmul_xor(op, data)
    return rs_bits.gf_matmul_bits(op, data)


class RSCodecTorch:
    """klauspost-compatible RS codec whose products run on `device`.

    Operates on [total, B] / [k, B] uint8 arrays or tensors. Inputs may be
    numpy arrays or tensors on any device; they are moved to `device`
    (default "cuda"), and results stay there."""

    def __init__(self, data_shards: int = 10, parity_shards: int = 4,
                 geometry=None, device="cuda"):
        if data_shards <= 0 or parity_shards < 0:
            raise ValueError("bad geometry")
        if data_shards + parity_shards > 256:
            raise ValueError("at most 256 total shards in GF(256)")
        from ..models import geometry as geom_mod

        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.geometry = geom_mod.as_geometry(data_shards, parity_shards,
                                             geometry)
        self.device = torch.device(device)

    @property
    def geometry_id(self) -> str:
        return self.geometry.name

    # -- inputs ------------------------------------------------------------

    def _rows(self, x) -> torch.Tensor:
        """uint8 tensor on the codec's device with unit stride along bytes."""
        if not isinstance(x, torch.Tensor):
            arr = np.asarray(x, dtype=np.uint8)
            if not arr.flags.writeable:  # torch wants writable host memory
                arr = arr.copy()
            x = torch.from_numpy(arr)
        x = x.to(device=self.device, dtype=torch.uint8)
        if x.dim() >= 1 and x.shape[-1] > 1 and x.stride(-1) != 1:
            x = x.contiguous()
        return x

    def _stack(self, rows: list) -> torch.Tensor:
        """Stack survivor rows; host rows go to the device in one copy."""
        if all(isinstance(r, torch.Tensor) for r in rows):
            return torch.stack([self._rows(r) for r in rows])
        return self._rows(np.stack([np.asarray(r, np.uint8) for r in rows]))

    # -- Encode ------------------------------------------------------------

    def encode_parity(self, data) -> torch.Tensor:
        """data [k, B] uint8 -> parity [m, B] uint8 on the codec's device."""
        data = self._rows(data)
        if data.dim() != 2 or data.shape[0] != self.data_shards:
            raise ValueError(f"expected [{self.data_shards}, B] data, got "
                             f"{tuple(data.shape)}")
        if not self.geometry.is_rs:
            # non-RS geometry: same kernels, its own generator matrix
            return dispatch_matmul(self.geometry.parity_matrix(), data,
                                   key=gfmat.geom_parity_key(self.geometry))
        gp = gf256.parity_matrix(self.data_shards, self.parity_shards)
        return dispatch_matmul(
            gp, data, key=("parity", self.data_shards, self.parity_shards))

    def encode_parity_stacked(self, stack) -> torch.Tensor:
        """stack [V, k, B] -> parity [V, m, B] in ONE product: the V slabs
        are laid side by side along the column axis ([k, V*B]); columns
        are independent, so each slab's bytes equal its own
        encode_parity call."""
        stack = self._rows(stack)
        if stack.dim() != 3 or stack.shape[1] != self.data_shards:
            raise ValueError(f"expected [V, {self.data_shards}, B] stack, got "
                             f"{tuple(stack.shape)}")
        v, k, b = stack.shape
        wide = stack.transpose(0, 1).reshape(k, v * b)
        parity = self.encode_parity(wide)
        return parity.reshape(self.parity_shards, v, b).transpose(0, 1) \
            .contiguous()

    def encode(self, shards) -> torch.Tensor:
        """[k, B] data or [total, B] shards: fills parity rows, returns all."""
        shards = self._rows(shards)
        if shards.dim() != 2 or shards.shape[0] not in (self.data_shards,
                                                        self.total_shards):
            raise ValueError(f"expected [{self.data_shards} or "
                             f"{self.total_shards}, B], got "
                             f"{tuple(shards.shape)}")
        data = shards[: self.data_shards]
        return torch.cat([data, self.encode_parity(data)], dim=0)

    # -- Reconstruct -------------------------------------------------------

    def reconstruct_data(self, shards) -> dict[int, torch.Tensor]:
        """Recompute all missing DATA shards from any k survivors.
        `shards`: dict shard_id -> [B] bytes, or list with None for missing."""
        return self._reconstruct_fused(shards, self.data_shards)

    def reconstruct(self, shards) -> dict[int, torch.Tensor]:
        """Recompute ALL missing shards (data and parity) from any k
        survivors — one fused [missing, k] product."""
        return self._reconstruct_fused(shards, self.total_shards)

    def _reconstruct_fused(self, shards, limit: int) -> dict[int, torch.Tensor]:
        present = self._as_dict(shards)
        missing = tuple(i for i in range(limit) if i not in present)
        if not missing:
            return {}
        pres = tuple(sorted(present.keys()))
        if not self.geometry.is_rs:
            pm = gfmat.geom_stacked_matrix(self.geometry, pres, missing)
            key = ("gdecs", self.geometry.name, pres, missing)
            out = dispatch_matmul(pm, self._stack([present[i] for i in pres]),
                                  key=key)
            return {i: out[j] for j, i in enumerate(missing)}
        fmat, used = gfmat.fused_reconstruct_matrix(
            self.data_shards, self.parity_shards, pres, missing)
        key = ("fdec", self.data_shards, self.parity_shards, pres, missing)
        out = dispatch_matmul(fmat, self._stack([present[i] for i in used]),
                              key=key)
        return {i: out[j] for j, i in enumerate(missing)}

    def reconstruct_stacked(
        self, present_ids, stacked, data_only: bool = False,
        want: tuple[int, ...] | None = None,
    ) -> tuple[tuple[int, ...], torch.Tensor]:
        """Reconstruct from survivors already stacked [P, B] in caller
        row order -> (missing_ids, [len(missing), B]).

        The fused [missing, k] matrix is column-permuted to the caller's
        row order, with zero columns for surplus survivors, so a
        pre-stacked buffer needs no gather. `want` restricts the solve to
        those shard ids — the minimal-read form: the survivor set may be
        smaller than k (an LRC local group) as long as it spans them."""
        limit = self.data_shards if data_only else self.total_shards
        present_ids = tuple(present_ids)
        stacked = self._rows(stacked)
        if stacked.dim() != 2 or stacked.shape[0] != len(present_ids):
            raise ValueError(f"{len(present_ids)} survivor ids for stacked "
                             f"shape {tuple(stacked.shape)}")
        empty = torch.zeros((0, stacked.shape[1]), dtype=torch.uint8,
                            device=self.device)
        if want is not None or not self.geometry.is_rs:
            targets = gfmat.geom_targets_for(self.geometry, present_ids,
                                             data_only, want)
            if not targets:
                return (), empty
            pm = gfmat.geom_stacked_matrix(self.geometry, present_ids, targets)
            key = ("gdecs", self.geometry.name, present_ids, targets)
            return targets, dispatch_matmul(pm, stacked, key=key)
        missing, pm = gfmat.fused_reconstruct_stacked_matrix(
            self.data_shards, self.parity_shards, present_ids, limit)
        if not missing:
            return (), empty
        key = ("fdecs", self.data_shards, self.parity_shards, present_ids,
               missing)
        return missing, dispatch_matmul(pm, stacked, key=key)

    def verify(self, shards) -> bool:
        """True iff parity rows match the data rows."""
        shards = self._rows(shards)
        parity = self.encode_parity(shards[: self.data_shards])
        return bool(torch.equal(parity, shards[self.data_shards:]))

    def parity_probe(self, shards) -> torch.Tensor:
        """Scalar 0 iff stored parity matches recomputed parity, else the
        max differing byte (int32, on the codec's device)."""
        shards = self._rows(shards)
        if shards.dim() != 2 or shards.shape[0] != self.total_shards:
            raise ValueError(f"expected [{self.total_shards}, B], got "
                             f"{tuple(shards.shape)}")
        parity = self.encode_parity(shards[: self.data_shards])
        return (parity ^ shards[self.data_shards:]).to(torch.int32).max()

    # ----------------------------------------------------------------------

    def _as_dict(self, shards) -> dict:
        if isinstance(shards, dict):
            return dict(shards)
        return {i: s for i, s in enumerate(shards) if s is not None}

    def __hash__(self):
        return hash((self.data_shards, self.parity_shards,
                     self.geometry.name, str(self.device)))

    def __eq__(self, other):
        return (
            isinstance(other, RSCodecTorch)
            and self.data_shards == other.data_shards
            and self.parity_shards == other.parity_shards
            and self.geometry.name == other.geometry.name
            and self.device == other.device
        )
