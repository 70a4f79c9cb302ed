"""Entry points: the one-device encode step and the multi-device dry run.

Counterpart of the JAX package's __graft_entry__.py:

  * ``entry()`` -> (fn, example_args): the RS(10,4) encode step, the
    per-batch compute of ``ec.encode``, on K2 (ops/rs_bits.py, as the
    reference's step uses its bitsliced product);
  * ``dryrun_multichip(n)``: encode, a degraded reconstruct, the parity
    probe and the EC file pipeline through parallel/mesh.ShardedCoder
    over an n-entry mesh, checked against the numpy coder.

The reference runs its dry run in a subprocess, to force XLA's virtual
CPU devices before a backend starts; torch has no platform switch to
isolate, so the port runs it in the calling process. Its entries are the
visible cards, repeated when there are fewer than n, or CPU entries when
the caller asks for the CPU; with no card and no such request it raises.

    python -m seaweedfs_tpu_torch.entry [--cpu] [--devices N]
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import tempfile

import numpy as np
import torch

from .ops import gf256, gfmat, rs_bits
from .ops.rs_torch import op_on_device


def entry(device="cuda"):
    """-> (fn, example_args): the RS(10,4) encode step.

    fn(data[10, B] uint8, a numpy array or tensor) -> all 14 shards
    [14, B] uint8 on `device`, parity by K2. Building the step touches no
    device; the first call does."""
    key = ("parity", 10, 4)
    bits = gfmat.derived("bits", key, gf256.parity_matrix(10, 4))
    dev = torch.device(device)

    def encode_step(data):
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data, np.uint8))
        data = data.to(dev)
        parity = rs_bits.gf_matmul_bits(op_on_device(("bits", *key), bits,
                                                     dev), data)
        return torch.cat([data, parity], dim=0)

    example = np.random.default_rng(0).integers(
        0, 256, size=(10, 64 * 1024), dtype=np.uint8)
    return encode_step, (example,)


def mesh_devices(n_devices: int, device="cuda") -> list[torch.device]:
    """n entries: the visible cards in turn (repeated when there are fewer
    than n), or n CPU entries when `device` is "cpu"."""
    from .parallel import mesh

    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n_devices
    cards = mesh.local_devices()
    if not cards:
        raise RuntimeError("dryrun_multichip: no CUDA device is visible; "
                           "pass device='cpu' to run on CPU entries")
    return [cards[i % len(cards)] for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The EC step over an n-entry mesh on small shapes: encode with the
    columns split across the entries, a degraded reconstruct over the same
    mesh, the parity probe (the max over entries), then the production
    file pipeline (encode + rebuild) against the numpy coder's shards."""
    from .parallel.mesh import ShardedCoder, make_mesh

    coder = ShardedCoder(10, 4, mesh=make_mesh(mesh_devices(n_devices,
                                                            device)))
    rng = np.random.default_rng(7)
    b = n_devices * 128  # small slices per entry
    data = rng.integers(0, 256, size=(10, b), dtype=np.uint8)

    shards = coder.encode(data).cpu().numpy()
    if shards.shape != (14, b):
        raise AssertionError(f"encode gave {shards.shape}")
    lost = (0, 5, 11, 13)
    rebuilt = coder.reconstruct({i: shards[i] for i in range(14)
                                 if i not in lost})
    for i in lost:
        if not np.array_equal(rebuilt[i].cpu().numpy(), shards[i]):
            raise AssertionError(f"reconstructed shard {i} differs")
    if int(coder.parity_checksum(shards)) != 0:
        raise AssertionError("parity probe of clean shards is not 0")
    with tempfile.TemporaryDirectory() as d:
        ec_file_pipeline_oracle(d, coder, batch_size=4096)


def ec_file_pipeline_oracle(workdir: str, coder, batch_size: int = 4096,
                            drop=(2, 7, 12), payload_len: int = 200_000,
                            seed: int = 7, geo=None) -> None:
    """Run the encode + rebuild file pipeline with `coder` and check every
    shard file against the numpy coder's by sha256. `geo` defaults to a
    shrunken layout (8 KiB / 512 B blocks)."""
    from .ops.rs_cpu import RSCodecCPU
    from .storage import ec_files
    from .storage.ec_locate import Geometry

    if geo is None:
        geo = Geometry(large_block=8192, small_block=512)
    payload = np.random.default_rng(seed).integers(
        0, 256, size=payload_len, dtype=np.uint8).tobytes()
    base = os.path.join(workdir, "m")
    cpu_base = os.path.join(workdir, "cpu")
    for b in (base, cpu_base):
        with open(b + ".dat", "wb") as f:
            f.write(payload)
    k, m = coder.data_shards, coder.parity_shards
    ec_files.generate_ec_files(base, coder, geo, batch_size=batch_size)
    ec_files.generate_ec_files(cpu_base, RSCodecCPU(k, m), geo,
                               batch_size=batch_size)

    def digest(path: str) -> str:
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    digests = {i: digest(geo.shard_file_name(base, i)) for i in range(k + m)}
    for i in range(k + m):
        if digest(geo.shard_file_name(cpu_base, i)) != digests[i]:
            raise AssertionError(f"shard {i} differs from the numpy coder's")
    for i in drop:
        os.unlink(geo.shard_file_name(base, i))
    got = ec_files.rebuild_ec_files(base, coder, geo, batch_size=batch_size)
    if list(got) != sorted(drop):
        raise AssertionError(f"rebuilt {got}, not {sorted(drop)}")
    for i in drop:
        if digest(geo.shard_file_name(base, i)) != digests[i]:
            raise AssertionError(f"rebuilt shard {i} differs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on CPU entries instead of the cards")
    ap.add_argument("--devices", type=int, default=8,
                    help="mesh entries of the dry run (default 8)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    fn, example = entry(device)
    out = fn(*example)
    print("entry ok:", tuple(out.shape), out.dtype, out.device)
    dryrun_multichip(args.devices, device)
    print("dryrun_multichip ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
