"""seaweedfs_tpu_torch — the PyTorch/CUDA port of seaweedfs_tpu's erasure
codec and EC file lifecycle (encode, rebuild, degraded read).

The package imports torch and numpy, never JAX and never seaweedfs_tpu:
it carries its own copies of the host-side modules it needs. GF(2^8)
matrix products run in hand-written CUDA kernels (ops/csrc/) on a CUDA
device and in their plain PyTorch versions on the CPU."""

__version__ = "0.1.0"
