#!/usr/bin/env python3
"""Time variants of kernel K2 (seaweedfs_tpu_torch/ops/csrc/gf_bits.cu) in
turns on one CUDA card, to see where its time goes.

    python3 k2_variants.py [--runs 40]

Each variant is the checkout's gf_bits.cu with a few text replacements,
built with the port's nvcc flags into a temporary directory (all builds in
parallel) and bound like the real library:

  base       the source as it is
  popc       the tensor-core MMA replaced by popc of the same fragments
             (wrong bytes; what the MMA itself costs)
  no-compute the fragment, MMA and packing phase skipped (wrong bytes;
             what staging the input and storing the output cost)
  T512,
  T2048      the largest tile 512 or 2048 columns instead of 1024
  256-thr    256 threads a block instead of 128

Each is timed with chip_smoke.py's method (CUDA events, a 1 GiB read
queued before each start event, turns after a 1 s warm-up) at the RS(10,4)
encode [4,10] x 1 MiB and at the stacked flush width, beside an empty
kernel; base must equal the plain version and every variant that keeps the
arithmetic must equal base. Prints one line per variant and shape, with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from seaweedfs_tpu_torch.ops import _build, gf256, gfmat, rs_bits, rs_xor

_MMA = '''  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));'''
_POPC = ("d[0] += __popc(a[0] & b0); d[1] += __popc(a[1] & b1); "
         "d[2] += __popc(a[2] & b0); d[3] += __popc(a[3] & b1);")
# (name, replacements, whether the bytes stay right)
VARIANTS = (
    ("base", (), True),
    ("popc", ((_MMA, _POPC),), False),
    ("no-compute", (("G < n_grp; G += kWarps",
                     "G < (B < 0 ? n_grp : 0); G += kWarps"),), False),
    ("T512", (("kMaxTile = 1024", "kMaxTile = 512"),), True),
    ("T2048", (("kMaxTile = 1024", "kMaxTile = 2048"),), True),
    ("256-thr", (("kThreads = 128;", "kThreads = 256;"),), True),
)


def build_variants(workdir: str) -> dict:
    """{name: (library, exact)}, one nvcc each, all at once."""
    src = (_build.CSRC / "gf_bits.cu").read_text()
    jobs = {}
    for name, edits, exact in VARIANTS:
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old[:40]!r} is not in "
                                   f"gf_bits.cu")
            text = text.replace(old, new)
        unit = os.path.join(workdir, f"{name}.cu")
        with open(unit, "w") as f:
            f.write(text)
        lib = os.path.join(workdir, f"{name}.so")
        jobs[name] = (lib, exact, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             lib, unit], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    libs = {}
    for name, (lib, exact, proc) in jobs.items():
        report, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{report}")
        handle = ctypes.CDLL(lib)
        handle.gf_bits_launch.argtypes = [vp, vp, ll, vp, ll, i, i, ll, i, vp]
        libs[name] = (handle, exact)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="k2-variants-") as workdir:
        libs = build_variants(workdir)
        flush = torch.zeros(1024 * cs.MIB, dtype=torch.uint8, device=dev)
        rng = np.random.default_rng(7)
        mat = gf256.parity_matrix(10, 4)
        r, c = mat.shape
        mbits = torch.from_numpy(gfmat.gf_matrix_to_bits(mat)).to(dev)
        words = rs_bits.mma_words(mbits)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for label, b in (("encode [4,10]", cs.MIB),
                         ("stacked flush [4,10]", cs.STACKED_WIDTH)):
            data = torch.from_numpy(
                rng.integers(0, 256, size=(c, b), dtype=np.uint8)).to(dev)
            outs = {n: torch.empty((r, b), dtype=torch.uint8, device=dev)
                    for n in libs}

            def run(name):
                lib = libs[name][0]
                return lambda: lib.gf_bits_launch(
                    words.data_ptr(), data.data_ptr(), data.stride(0),
                    outs[name].data_ptr(), outs[name].stride(0), r, c, b,
                    dev.index, stream)

            fns = [run(n) for n in libs] + [lambda: rs_xor.launch_empty(dev)]
            times = cs._time_turns(fns, flush, runs=args.runs)
            torch.cuda.synchronize()
            want = rs_bits.gf_matmul_bits_torch(mbits, data)
            for name, (_, exact) in libs.items():
                if exact and not torch.equal(outs[name], want):
                    raise AssertionError(f"variant {name} differs from plain "
                                         f"at {label}")
            for name, t in zip([*libs, "empty kernel"], times):
                print(f"[k2-variants] {label} x {b} B {name}: median "
                      f"{statistics.median(t):.6f} ms (quartiles "
                      f"{cs._quartiles(t)}) on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
