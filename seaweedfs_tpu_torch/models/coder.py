"""ErasureCoder factory: the seam between storage I/O and compute.

Counterpart of seaweedfs_tpu/models/coder.py ``new_coder``. Every backend
produces the same bytes:

  * "cuda" (default) — the hand-written kernels of ops/csrc/ on the card:
    parallel/mesh.ShardedCoder over every visible card when more than one
    is visible (the reference's AutoMeshCoder), else
    ops/rs_torch.RSCodecTorch on the one card;
  * "single" — RSCodecTorch on one card, however many are visible;
  * "mesh" — ShardedCoder over every visible card;
  * "native" — ops/rs_native.RSCodecNative, the g++-built host coder;
  * "cpu" — ops/rs_cpu.RSCodecCPU, the numpy table codec and oracle.

The environment variable SEAWEEDFS_TORCH_CODER overrides the default
backend for the whole process. There is no silent CPU fallback: asking
for "cuda", "single" or "mesh" where no CUDA device is visible raises. A
host coder carries ``backend_reason``: why it runs on the CPU ("cpu_env"
when the process was pinned by SEAWEEDFS_TORCH_CODER, "cpu_explicit" when
the call site asked for it); the dispatch scheduler reports it as the
``reason`` of its batches (ops/dispatch.py).
"""

from __future__ import annotations

import os
from typing import Protocol, runtime_checkable

import numpy as np

BACKENDS = ("cuda", "single", "mesh", "native", "cpu")


@runtime_checkable
class ErasureCoder(Protocol):
    data_shards: int
    parity_shards: int
    total_shards: int

    def encode_parity(self, data): ...

    def encode_parity_stacked(self, stack): ...

    def encode(self, shards): ...

    def reconstruct(self, shards) -> dict[int, np.ndarray]: ...

    def reconstruct_data(self, shards) -> dict[int, np.ndarray]: ...

    def reconstruct_stacked(self, present_ids, stacked, data_only=False,
                            want=None): ...

    def verify(self, shards) -> bool: ...


def new_coder(
    data_shards: int = 10, parity_shards: int = 4,
    backend: str | None = None, geometry=None,
) -> ErasureCoder:
    """reedsolomon.New(data, parity) equivalent with a backend switch.

    `geometry`: a models.geometry.CodeGeometry (or registered name) whose
    generator matrix the backend multiplies — rs_{k}_{m} when omitted.

    The device coders create no CUDA context here: the device count comes
    from NVML where NVML answers (parallel/mesh.device_count), and a codec
    first touches a device when a call moves data to it, so a process may
    fork workers after building its coder."""
    host_reason = "cpu_env" if backend is None else "cpu_explicit"
    if backend is None:
        backend = os.environ.get("SEAWEEDFS_TORCH_CODER", "cuda")
    if backend in ("cuda", "single", "mesh"):
        from ..parallel import mesh

        n = mesh.device_count()
        if n == 0:
            raise RuntimeError(
                f"new_coder: no CUDA device is visible for backend "
                f"{backend!r}; the port runs its codec on the card — pass "
                f"backend='cpu' (or set SEAWEEDFS_TORCH_CODER=cpu) to run "
                f"on the host instead")
        if backend == "mesh" or (backend == "cuda" and n > 1):
            return mesh.ShardedCoder(data_shards, parity_shards,
                                     geometry=geometry)
        from ..ops.rs_torch import RSCodecTorch

        return RSCodecTorch(data_shards, parity_shards, geometry=geometry,
                            device="cuda")
    if backend == "native":
        from ..ops.rs_native import RSCodecNative

        coder = RSCodecNative(data_shards, parity_shards, geometry=geometry)
        coder.backend_reason = host_reason
        return coder
    if backend == "cpu":
        from ..ops.rs_cpu import RSCodecCPU

        coder = RSCodecCPU(data_shards, parity_shards, geometry=geometry)
        coder.backend_reason = host_reason
        return coder
    raise ValueError(f"unknown erasure coder backend {backend!r}; expected "
                     f"one of {BACKENDS}")
