"""Multi-device EC compute: one process, one coder, a list of devices.

Counterpart of seaweedfs_tpu/parallel/mesh.py. Parity is a per-byte-column
GF(2^8) matmul, so a stripe batch ``data[k, B]`` splits along B across
every device with no communication between them; a stacked batch
``[V, k, B]`` splits along V instead, each device taking whole slabs. The
reference runs one process over a JAX mesh (``shard_map``); the port runs
one process over an ordered list of ``torch.device``s, with no
``torch.distributed`` and no NCCL: each device's product is one launch of
K1 (``kernel="xor"``, ops/rs_xor.py) or K2 (``kernel="bits"``,
ops/rs_bits.py) on that device's current stream, and the results are
gathered on the first device. A mesh may list one device more than once
(torch has no counterpart of XLA's forced host device count): the CPU
tests run eight CPU entries, the card check two entries of one card.

Splits, as in the reference:

  * column split (``_apply_sharded``): B is cut at multiples of
    ``_col_pad``'s per-device quantum; device i multiplies its column
    slice; the slices are concatenated on the first device. Zero padding
    never reaches a device: a slice past B is empty and skipped, and a
    short last slice is multiplied as it is (the bytes of every column are
    independent of the others).
  * V-axis split (``_apply_stacked_vsharded``): device i takes
    ceil(V / n) whole slabs and lays them side by side into ONE
    ``[rows, V_i * B]`` product; gated by SWFS_EC_MESH_VSHARD (default
    on) and used when every device gets at least one slab.
  * the parity probe: each device's max of (recomputed ^ stored parity),
    then the max over devices on the first one (the reference's pmax).

The per-chip surface (``placement_devices``, ``encode_parity_on``,
``reconstruct_stacked_on``, ...) serves the dispatch scheduler's per-chip
lanes (ops/dispatch.py) through one lazily built single-device
``RSCodecTorch``, whose calls take ``device=``.

This module is also the port's ONE device-enumeration point:
``local_devices``/``device_count`` read ``torch.cuda.device_count()``,
which NVML answers without creating a CUDA context, so a server may still
fork after building its coder; tests/test_torch_lint.py rejects the call
anywhere else in the port.

The reference's submission lock (``_SUBMIT_MU``) guards XLA's
cross-module rendezvous of concurrently submitted multi-device programs;
one torch process has no such rendezvous (each product is an ordinary
launch on one device), so the port has no such lock.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..ops import gf256, gfmat, rs_bits, rs_xor
from ..ops.rs_torch import op_on_device

STRIPE_AXIS = "stripe"
KERNELS = ("xor", "bits")


def local_devices() -> list[torch.device]:
    """Every CUDA device this process can place work on, by explicit
    index: THE port's enumeration call (see the module docstring)."""
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def device_count() -> int:
    """len(local_devices()), answered without a CUDA context."""
    return len(local_devices())


class Mesh(NamedTuple):
    """An ordered device list and the name of its one axis."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None, axis: str = STRIPE_AXIS) -> Mesh:
    """1-D mesh over the given (default: every visible CUDA) devices. A
    device may repeat. An empty list raises: nothing falls back to the
    CPU unless the caller lists CPU devices."""
    if devices is None:
        devices = local_devices()
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise RuntimeError(
            "make_mesh: no CUDA device is visible; pass the devices "
            "(e.g. [torch.device('cpu')] * 8) to run the mesh elsewhere")
    return Mesh(devices, (axis,))


def _col_pad(b: int, n: int, quantum: int = 8) -> int:
    """B rounded up so every device gets an equal, aligned column slice."""
    step = n * quantum
    return (b + step - 1) // step * step


def _as_tensor(x) -> torch.Tensor:
    """uint8 tensor view of a numpy array (zero-copy where it can be) or
    the tensor itself; stays where it lies."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.uint8 else x.to(torch.uint8)
    arr = np.asarray(x, dtype=np.uint8)
    if not arr.flags.writeable:  # torch wants writable host memory
        arr = arr.copy()
    return torch.from_numpy(arr)


def _product(kernel: str, key: tuple, matrix: np.ndarray,
             data: torch.Tensor) -> torch.Tensor:
    """out[R, B] = matrix (x) data on data's device, through K1 or K2 (the
    plain version on a CPU device), the operand cached on that device."""
    op = op_on_device((kernel, *key), gfmat.derived(kernel, key, matrix),
                      data.device)
    if kernel == "xor":
        return rs_xor.gf_matmul_xor(op, data)
    return rs_bits.gf_matmul_bits(op, data)


def _on(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`x` on `device`, bytes unit-stride along the last axis."""
    x = x.to(device)
    if x.dim() >= 1 and x.shape[-1] > 1 and x.stride(-1) != 1:
        x = x.contiguous()
    return x


def _apply_sharded(matrix: np.ndarray, key: tuple, data, mesh: Mesh,
                   kernel: str) -> torch.Tensor:
    """[R, C] (x) data [C, B] with B split across the mesh -> [R, B] on
    the mesh's first device."""
    data = _as_tensor(data)
    b = data.shape[1]
    n = mesh.size
    per = _col_pad(b, n) // n
    outs = []
    for i, dev in enumerate(mesh.devices):
        lo, hi = i * per, min((i + 1) * per, b)
        if lo >= hi:
            break
        outs.append(_product(kernel, key, matrix, _on(data[:, lo:hi], dev)))
    first = mesh.devices[0]
    if not outs:
        return torch.zeros((matrix.shape[0], 0), dtype=torch.uint8,
                           device=first)
    if len(outs) == 1:
        return outs[0].to(first)
    return torch.cat([o.to(first) for o in outs], dim=1)


def _apply_stacked_vsharded(matrix: np.ndarray, key: tuple, stack,
                            mesh: Mesh, kernel: str) -> torch.Tensor:
    """stack [V, C, B] with V split across the mesh -> [V, R, B] on the
    first device. Each device holds whole slabs and runs ONE product over
    them, laid side by side ([C, V_i * B])."""
    stack = _as_tensor(stack)
    v, c, b = stack.shape
    r = matrix.shape[0]
    per = -(-v // mesh.size)
    outs = []
    for i, dev in enumerate(mesh.devices):
        lo, hi = i * per, min((i + 1) * per, v)
        if lo >= hi:
            break
        part = _on(stack[lo:hi], dev)
        wide = part.transpose(0, 1).reshape(c, (hi - lo) * b)
        out = _product(kernel, key, matrix, wide)
        outs.append(out.reshape(r, hi - lo, b).transpose(0, 1))
    first = mesh.devices[0]
    return torch.cat([o.to(first) for o in outs], dim=0).contiguous()


class ShardedCoder:
    """RS codec over a device mesh: the codec surface of RSCodecTorch,
    with the byte axis (or the slab axis of a stack) split across `mesh`.
    Results are uint8 tensors on the mesh's first device."""

    def __init__(self, data_shards: int = 10, parity_shards: int = 4,
                 mesh: Mesh | None = None, kernel: str = "xor",
                 geometry=None):
        if data_shards <= 0 or parity_shards < 0:
            raise ValueError("bad geometry")
        if data_shards + parity_shards > 256:
            raise ValueError("at most 256 total shards in GF(256)")
        if kernel not in KERNELS:
            raise ValueError(f"kernel must be 'xor' or 'bits', got {kernel!r}")
        from ..models import geometry as geom_mod

        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.geometry = geom_mod.as_geometry(data_shards, parity_shards,
                                             geometry)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis = self.mesh.axis_names[0]
        self._n = self.mesh.size
        # the per-device formulation: K1 ("xor") or K2 ("bits"); the mesh
        # takes it from here alone, never from SEAWEEDFS_TORCH_KERNEL
        self.kernel = kernel
        if self.geometry.is_rs:
            self._parity = (gf256.parity_matrix(data_shards, parity_shards),
                            ("parity", data_shards, parity_shards))
        else:
            self._parity = (self.geometry.parity_matrix(),
                            gfmat.geom_parity_key(self.geometry))

    @property
    def geometry_id(self) -> str:
        return self.geometry.name

    def _apply(self, matrix, key, data) -> torch.Tensor:
        return _apply_sharded(matrix, key, data, self.mesh, self.kernel)

    def _repair_operand(self, present_ids: tuple, data_only: bool, want):
        """(targets, byte-form matrix, key) of a stacked reconstruct in
        the caller's survivor row order; targets empty when nothing is
        missing."""
        limit = self.data_shards if data_only else self.total_shards
        if want is not None or not self.geometry.is_rs:
            targets = gfmat.geom_targets_for(self.geometry, present_ids,
                                             data_only, want)
            if not targets:
                return (), None, None
            return (targets,
                    gfmat.geom_stacked_matrix(self.geometry, present_ids,
                                              targets),
                    ("gdecs", self.geometry.name, present_ids, targets))
        missing, pm = gfmat.fused_reconstruct_stacked_matrix(
            self.data_shards, self.parity_shards, present_ids, limit)
        if not missing:
            return (), None, None
        return missing, pm, ("fdecs", self.data_shards, self.parity_shards,
                             present_ids, missing)

    # -- codec surface -----------------------------------------------------

    def encode_parity(self, data) -> torch.Tensor:
        """data [k, B] -> parity [m, B]; columns split across the mesh."""
        data = _as_tensor(data)
        if data.dim() != 2 or data.shape[0] != self.data_shards:
            raise ValueError(f"expected [{self.data_shards}, B] data, got "
                             f"{tuple(data.shape)}")
        return self._apply(*self._parity, data)

    def _vshard_wanted(self, v: int) -> bool:
        """The V-axis split pays when every device gets at least one whole
        slab; SWFS_EC_MESH_VSHARD=0 pins the column split."""
        if v < self._n or self._n <= 1:
            return False
        return os.environ.get("SWFS_EC_MESH_VSHARD", "1").lower() not in (
            "0", "false", "off")

    def encode_parity_stacked(self, stack) -> torch.Tensor:
        """stack [V, k, B] -> parity [V, m, B]. With V >= devices (and
        SWFS_EC_MESH_VSHARD on) the V axis splits, each device encoding
        whole slabs; otherwise the slabs are laid side by side ([k, V*B])
        and the columns split. Per-slab bytes equal V encode_parity calls
        either way."""
        stack = _as_tensor(stack)
        if stack.dim() != 3 or stack.shape[1] != self.data_shards:
            raise ValueError(f"expected [V, {self.data_shards}, B] stack, got "
                             f"{tuple(stack.shape)}")
        v, k, b = stack.shape
        if self._vshard_wanted(v):
            return _apply_stacked_vsharded(*self._parity, stack, self.mesh,
                                           self.kernel)
        wide = stack.transpose(0, 1).reshape(k, v * b)
        parity = self.encode_parity(wide)
        return parity.reshape(self.parity_shards, v, b).transpose(0, 1) \
            .contiguous()

    def reconstruct_stacked_vsharded(self, present_ids, stack,
                                     data_only: bool = False, want=None):
        """Uniform-width survivor stacks [V, P, B] -> (missing_ids,
        [V, len(missing), B]) with the V axis split across the mesh: every
        device reconstructs whole slabs through the same fused matrix as
        reconstruct_stacked (the `want` form included), so bytes are
        identical slab for slab."""
        present_ids = tuple(present_ids)
        stack = _as_tensor(stack)
        if stack.dim() != 3 or stack.shape[1] != len(present_ids):
            raise ValueError(f"{len(present_ids)} survivor ids for stack "
                             f"shape {tuple(stack.shape)}")
        missing, pm, key = self._repair_operand(present_ids, data_only, want)
        first = self.mesh.devices[0]
        if not missing:
            return (), torch.zeros((stack.shape[0], 0, stack.shape[2]),
                                   dtype=torch.uint8, device=first)
        if stack.shape[0] == 0:  # V=0: nothing to split, shape contract
            return missing, torch.zeros((0, len(missing), stack.shape[2]),
                                        dtype=torch.uint8, device=first)
        return missing, _apply_stacked_vsharded(pm, key, stack, self.mesh,
                                                self.kernel)

    # -- per-chip (device-affine) entry points -----------------------------
    #
    # The dispatch scheduler's per-chip lanes (ops/dispatch.py) flush each
    # chip's queued slabs as ONE single-device product pinned to that
    # chip: no split, no gather, every device's stream fills on its own.

    def placement_devices(self) -> list[torch.device]:
        """The mesh's devices, in mesh order: the chips the dispatch
        scheduler round-robins encode slabs (and pins survivor sets) to."""
        return list(self.mesh.devices)

    @property
    def prefers_vstack(self) -> bool:
        """Tells the dispatch scheduler to keep [V, k, B] stacks for this
        coder's non-chip lanes: a multi-device mesh splits WHOLE slabs
        across devices, which the column-compact packing would flatten."""
        return self._n > 1

    def _chip_codec(self):
        # lazily built single-device codec reused for every chip: its
        # operands are cached per device, so chips never share one
        impl = self.__dict__.get("_chip_impl")
        if impl is None:
            from ..ops.rs_torch import RSCodecTorch

            impl = self.__dict__["_chip_impl"] = RSCodecTorch(
                self.data_shards, self.parity_shards,
                geometry=self.geometry, device=self.mesh.devices[0])
        return impl

    def encode_parity_stacked_on(self, stack, device) -> torch.Tensor:
        """stack [V, k, B] encoded in one product pinned to `device`."""
        return self._chip_codec().encode_parity_stacked(stack, device=device)

    def encode_parity_on(self, data, device) -> torch.Tensor:
        """Wide [k, W] encode pinned to `device`: the scheduler's chip lane
        lays a flush's slabs side by side and launches them as one."""
        return self._chip_codec().encode_parity(data, device=device)

    def reconstruct_stacked_on(self, present_ids, stacked,
                               data_only: bool = False, device=None,
                               want=None):
        """Pre-stacked survivors [P, B] reconstructed on `device`, where
        the survivor set's fused matrix stays cached (ops/rs_torch.py
        op_on_device, LRU)."""
        return self._chip_codec().reconstruct_stacked(
            present_ids, stacked, data_only=data_only, device=device,
            want=want)

    def encode(self, shards) -> torch.Tensor:
        """[k, B] data or [total, B] shards -> all [total, B] shards with
        parity rows (re)computed, on the first device."""
        shards = _as_tensor(shards)
        if shards.dim() != 2 or shards.shape[0] not in (self.data_shards,
                                                        self.total_shards):
            raise ValueError(f"expected [{self.data_shards} or "
                             f"{self.total_shards}, B], got "
                             f"{tuple(shards.shape)}")
        data = shards[: self.data_shards]
        parity = self.encode_parity(data)
        return torch.cat([data.to(parity.device), parity], dim=0)

    def reconstruct(self, shards) -> dict[int, torch.Tensor]:
        return self._reconstruct(shards, data_only=False)

    def reconstruct_data(self, shards) -> dict[int, torch.Tensor]:
        return self._reconstruct(shards, data_only=True)

    def _reconstruct(self, shards, data_only: bool) -> dict[int, torch.Tensor]:
        present = (dict(shards) if isinstance(shards, dict)
                   else {i: s for i, s in enumerate(shards) if s is not None})
        limit = self.data_shards if data_only else self.total_shards
        missing = tuple(i for i in range(limit) if i not in present)
        if not missing:
            return {}
        pres = tuple(sorted(present))
        if not self.geometry.is_rs:
            matrix = gfmat.geom_stacked_matrix(self.geometry, pres, missing)
            key = ("gdecs", self.geometry.name, pres, missing)
            used = pres
        else:
            # one fused [missing, k] product: parity rows are folded
            # through the decode matrix on the host
            matrix, used = gfmat.fused_reconstruct_matrix(
                self.data_shards, self.parity_shards, pres, missing)
            key = ("fdec", self.data_shards, self.parity_shards, pres,
                   missing)
        rows = [present[i] for i in used]
        if all(isinstance(r, torch.Tensor) for r in rows):
            stacked = torch.stack([_as_tensor(r).to(rows[0].device)
                                   for r in rows])
        else:
            stacked = np.stack([np.asarray(r, np.uint8) for r in rows])
        out = self._apply(matrix, key, stacked)
        return {i: out[j] for j, i in enumerate(missing)}

    def reconstruct_stacked(self, present_ids, stacked,
                            data_only: bool = False, want=None):
        """Pre-stacked survivors [P, B] in caller row order ->
        (missing_ids, [missing, B]): the column-permuted fused product
        split over the mesh (the contract of
        RSCodecTorch.reconstruct_stacked, the `want` form included)."""
        present_ids = tuple(present_ids)
        stacked = _as_tensor(stacked)
        if stacked.dim() != 2 or stacked.shape[0] != len(present_ids):
            raise ValueError(f"{len(present_ids)} survivor ids for stacked "
                             f"shape {tuple(stacked.shape)}")
        missing, pm, key = self._repair_operand(present_ids, data_only, want)
        if not missing:
            return (), torch.zeros((0, stacked.shape[1]), dtype=torch.uint8,
                                   device=self.mesh.devices[0])
        return missing, self._apply(pm, key, stacked)

    def verify(self, shards) -> bool:
        return int(self.parity_probe(shards)) == 0

    # -- the integrity probe ------------------------------------------------

    def parity_probe(self, shards) -> torch.Tensor:
        """Scalar int32 on the first device: 0 iff stored parity matches
        recomputed parity, else the max differing byte. Each device takes
        its column slice's max, then the first device the max of those
        (the reference's pmax over the mesh)."""
        shards = _as_tensor(shards)
        if shards.dim() != 2 or shards.shape[0] != self.total_shards:
            raise ValueError(f"expected [{self.total_shards}, B], got "
                             f"{tuple(shards.shape)}")
        b = shards.shape[1]
        if b == 0:
            raise ValueError("parity_probe of zero columns")
        per = _col_pad(b, self._n) // self._n
        k = self.data_shards
        first = self.mesh.devices[0]
        maxes = []
        for i, dev in enumerate(self.mesh.devices):
            lo, hi = i * per, min((i + 1) * per, b)
            if lo >= hi:
                break
            part = _on(shards[:, lo:hi], dev)
            parity = _product(self.kernel, self._parity[1], self._parity[0],
                              part[:k])
            maxes.append((parity ^ part[k:]).to(torch.int32).max().to(first))
        return torch.stack(maxes).max()

    # the reference's other name for the probe
    parity_checksum = parity_probe
