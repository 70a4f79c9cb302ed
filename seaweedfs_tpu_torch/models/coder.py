"""ErasureCoder factory: the seam between storage I/O and compute.

Counterpart of seaweedfs_tpu/models/coder.py ``new_coder``, with two
backends that produce identical bytes:

  * "cuda" (default) — ops/rs_torch.RSCodecTorch on the CUDA device, its
    products in the hand-written kernels of ops/csrc/;
  * "cpu" — ops/rs_cpu.RSCodecCPU, the numpy table codec and oracle.

The environment variable SEAWEEDFS_TORCH_CODER overrides the default
backend for the whole process. There is no silent CPU fallback: asking
for "cuda" where no CUDA device exists raises. A host coder carries
``backend_reason``: why it runs on the CPU ("cpu_env" when the process
was pinned by SEAWEEDFS_TORCH_CODER, "cpu_explicit" when the call site
asked for it); the dispatch scheduler reports it as the ``reason`` of
its batches (ops/dispatch.py).
"""

from __future__ import annotations

import os
from typing import Protocol, runtime_checkable

import numpy as np

BACKENDS = ("cuda", "cpu")


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

    The "cuda" coder creates no CUDA context here: the device count comes
    from NVML where NVML answers (torch.cuda.device_count does not
    initialise CUDA then), and the codec first touches the device when a
    call moves data to it — so a process may fork workers after building
    its coder."""
    host_reason = "cpu_env" if backend is None else "cpu_explicit"
    if backend is None:
        backend = os.environ.get("SEAWEEDFS_TORCH_CODER", "cuda")
    if backend == "cuda":
        import torch

        if torch.cuda.device_count() == 0:
            raise RuntimeError(
                "new_coder: no CUDA device is visible; the port runs its "
                "codec on the card — pass backend='cpu' (or set "
                "SEAWEEDFS_TORCH_CODER=cpu) to run on the host instead")
        from ..ops.rs_torch import RSCodecTorch

        return RSCodecTorch(data_shards, parity_shards, geometry=geometry,
                            device="cuda")
    if backend == "cpu":
        from ..ops.rs_cpu import RSCodecCPU

        coder = RSCodecCPU(data_shards, parity_shards, geometry=geometry)
        coder.backend_reason = host_reason
        return coder
    raise ValueError(f"unknown erasure coder backend {backend!r}; expected "
                     f"one of {BACKENDS}")
