#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (seaweedfs_tpu_torch).

    python3 chip_smoke.py [--volume-mb 1024] [--bits-volume-mb 128]
                          [--sched-volume-mb 512] [--sched-volumes 8]
                          [--baseline DIR] [--only gf_xor|gf_bits|gf_sel]

Needs one CUDA card, the CUDA toolkit (nvcc) and nvidia-smi; exits non-zero
and prints no result without them. Phases, each printing its own line:

  1. device          card name, and name + power limit from nvidia-smi
  2. build           nvcc builds K1 and K2 from ops/csrc/ and K3 (the
                     gf_sel.cu template) once per encode matrix it serves
                     here, all in parallel, with each build's time and
                     registers (K1 by C/R, K2 by k-steps S)
  3. kernels         K1 (gf_xor.cu), K2 (gf_bits.cu) and K3 (gf_sel.cu)
                     against their plain PyTorch versions on the card, byte
                     for byte: K1 and K2 at the encode [4,10] and a fused
                     [3,10] decode matrix (plus a wide [8,40] matrix), K3 at
                     the encode matrices of RS(10,4), RS(6,3), RS(12,4) and
                     lrc_10_2_2, each over B in {1 MiB, 1 MiB + 4, 4095, 1},
                     K1 and K3 also at a stacked flush's width (6 MiB +
                     4093: several slabs and a ragged tail side by side,
                     row stride not a multiple of 16, as the scheduler
                     packs them), a row-strided input, the refusal of a
                     transposed one,
                     and the golden RS(10,4) shard hashes; K2 first at the
                     GF identity [10,10] and its [1,10] rows (its MMA
                     fragment layout) and at the stacked width too. Then
                     the layouts the kernels realign: column slices at
                     each row offset 0-15 of a buffer with row stride
                     8221, slices whose span ends at the buffer's last
                     byte, widths 1-47, K1 and K2 at every R in 1-8 and 14,
                     K2 at C in {1, 3, 17, 33, 64}. Then CUDA-event times of
                     each kernel and plain version at the shapes the main
                     path launches (TIMED_SHAPES), each beside its bytes
                     bound, and an empty kernel's time at the degraded-read
                     shape (its floor); with --baseline, another
                     checkout's K1, K2 and K3 timed in the same turns.
                     Every library must build without register spills
  4. pipeline        a seeded 1 GiB volume (.dat + .idx) through the port's
                     write_ec_files / write_sorted_file_from_idx with
                     new_coder() on cuda (kernel K1, the default): shard
                     sha256s against the port's numpy cpu coder, rebuild of
                     shards {0, 5, 13}, degraded reads with shard 3 gone
  5. pipeline-bits   encode + rebuild of a smaller volume with kernel K2
                     selected (SEAWEEDFS_TORCH_KERNEL=bits), against the
                     cpu coder
  6. pipeline-sched  8 seeded volumes encoding at once through one coder
                     with SEAWEEDFS_TORCH_KERNEL=sel: their slabs share the
                     dispatch scheduler's encode lane, one K3 launch per
                     flush; then all 8 rebuild shards {0, 5, 13} at once
                     and 8 readers read with shard 3 gone (K1, on the
                     reconstruct lanes). Shards against the cpu coder;
                     K3 launches must equal the encode lane's batches, and
                     some batch must have stacked more than one slab

--only KERNEL builds, checks and times that kernel alone and runs only its
pipeline phase (a short loop for one kernel); the run says what it skipped.

Each kernel's launch count is set to 0 just before each pipeline phase and
read just after; a kernel that path never launched fails the run. K1's
launches are also split by R (1: degraded read, 3: rebuild, 4: encode). The
last lines are one JSON object of kernel numbers, the nvidia-smi line, and
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import mmap
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from seaweedfs_tpu_torch.models import geometry
from seaweedfs_tpu_torch.models.coder import new_coder
from seaweedfs_tpu_torch.ops import _build, gf256, gfmat, rs_bits, rs_sel, \
    rs_xor
from seaweedfs_tpu_torch.storage import ec_files, idx, types
from seaweedfs_tpu_torch.storage.ec_locate import Geometry, locate_data
from seaweedfs_tpu_torch.storage.ec_volume import EcVolume
from seaweedfs_tpu_torch.utils import stats as ec_stats

# sha256 of each shard row of RS(10,4) over rng(0xEC) [10, 4096] — the
# port's copy of tests/test_golden_identity.py GOLDEN_SHARD_SHA256
GOLDEN_SHARD_SHA256 = [
    "9c7355adf15e9cbec105e1dfbf16624080ca5e58ad6f4e2418ab703bc0c3f509",
    "71a8ffbe270988fb15d6e46614c29559185f003f5c70e7fab8190780dbea2377",
    "99f63810daa37174f8296cf932cd35196bcae55584966f9b98e92161a663bf98",
    "9011e6aeac31b87a2aea2bae59e3e5942caa18583d50be53d50b226fe44ab83a",
    "e3beb7ebaad84c1592916124d4199996fab784900ef63958375a6a32cd11ff48",
    "484de4f3ef9736d472a53931e89423e7daf5f210b7c2a3a6aa10fe86a89edeca",
    "2c420ae77040ba1734d37b9095a02517b2b2aaa3d4de477168f66d8169c2de0d",
    "714238432f92d7985b3226f5c9df7099c390b675d5e18d2ec5bb5aa69afc4919",
    "97aac53066ca8d0f942b03aa906a6f0030aca47cdf9f20cec7e0b65fec7c268a",
    "a6c91ad42931acaf2d0c39193070e41938fe6c210b32b4fe4d09db05e26eeb38",
    "5b84659c44c7daa6c956ec16ee7f5d8155913df1ddd33265f2ab82ee42783205",
    "89482c87207f8950afded88c6147b0619e15967a354d998a38890ebbcc4c5bc3",
    "09f935bbea5adeee0dd7dc305b2d95e25c2cb269ebaaff01d66b2c689cbb7966",
    "6fbd770c854d81a89eef262f06b512e0eb93f9febdb26f7267f80710114996a9",
]

MIB = 1 << 20
# the width of a stacked flush of the scheduler's lanes: six 1 MiB slabs
# and a ragged tail, packed side by side, so the row stride is no
# multiple of 16 and most chunks take the kernels' masked loads
STACKED_WIDTH = 6 * MIB + 4093
REBUILD_LOST = (0, 5, 13)
DEGRADED_SHARD = 3
# a degraded read's width: one interval of padded needle records, an
# 8-byte multiple that is no 16-byte one
DEGRADED_WIDTH = 24_584
# (kernel, shape, matrix, B): the shapes the main path launches, timed
TIMED_SHAPES = (
    ("gf_xor", "encode [4,10]", "encode", MIB),
    ("gf_xor", "rebuild [3,10]", "decode", MIB),
    ("gf_xor", "degraded read [1,10]", "degraded", DEGRADED_WIDTH),
    ("gf_bits", "encode [4,10]", "encode", MIB),
    ("gf_bits", "rebuild [3,10]", "decode", MIB),
    ("gf_bits", "stacked flush [4,10]", "encode", STACKED_WIDTH),
    ("gf_bits", "degraded read [1,10]", "degraded", DEGRADED_WIDTH),
    ("gf_sel", "encode [4,10]", "encode", MIB),
    ("gf_sel", "stacked flush [4,10]", "encode", STACKED_WIDTH),
)
MIN_READS = 2000
MIN_HEALTHY_READS = 500

# memory rate by card (NVIDIA data sheets), for the bytes bound
_MEMORY_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                ("H200", 4.8e12), ("H100", 3.35e12))

# the pipeline phase that drives each kernel
PHASES = {"gf_xor": "pipeline", "gf_bits": "pipeline-bits",
          "gf_sel": "pipeline-sched"}
# each kernel: its module, operand form and the TPU kernel it replaces
KERNELS = {
    "gf_xor": dict(
        module=rs_xor, form="xor", source="seaweedfs_tpu_torch/ops/csrc/gf_xor.cu",
        replaces="seaweedfs_tpu/ops/rs_xor.py:115"),
    "gf_bits": dict(
        module=rs_bits, form="bits",
        source="seaweedfs_tpu_torch/ops/csrc/gf_bits.cu",
        replaces="seaweedfs_tpu/ops/rs_pallas.py:33"),
    "gf_sel": dict(
        module=rs_sel, form="sel",
        source="seaweedfs_tpu_torch/ops/csrc/gf_sel.cu",
        replaces="seaweedfs_tpu/ops/rs_xor.py:247"),
}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def memory_rate(name: str) -> float:
    for key, rate in _MEMORY_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate on file for card {name!r}")


# -- kernels ------------------------------------------------------------------


def sel_matrices() -> dict[str, np.ndarray]:
    """The encode matrices K3 is built for and checked at: RS(10,4) (the
    default), RS(6,3) and RS(12,4) (BASELINE config #5), lrc_10_2_2."""
    return {name: geometry.get(name).parity_matrix()
            for name in ("rs_10_4", "rs_6_3", "rs_12_4", "lrc_10_2_2")}


def _operand(kind: str, matrix: np.ndarray, dev):
    """The kernel's operand: K3 takes the matrix itself (it is baked into
    the kernel), K1 and K2 derived forms on the card."""
    if kind == "sel":
        return matrix
    host = gfmat.xor_coefficients(matrix) if kind == "xor" else \
        gfmat.gf_matrix_to_bits(matrix)
    return torch.from_numpy(host).to(dev)


def _run(name: str, op, data, plain: bool):
    mod = KERNELS[name]["module"]
    if name == "gf_xor":
        return (mod.gf_matmul_xor_torch if plain else mod.gf_matmul_xor_cuda)(
            op, data)
    if name == "gf_sel":
        return (mod.gf_matmul_sel_torch if plain else mod.gf_matmul_sel_cuda)(
            op, data)
    return (mod.gf_matmul_bits_torch if plain else mod.gf_matmul_bits_cuda)(
        op, data)


def _event_ms(fn, flush: torch.Tensor) -> float:
    """One CUDA-event timing of fn(). A read of `flush` (1 GiB, ~0.3 ms)
    is queued first: it evicts fn's inputs from L2 without leaving dirty
    lines behind, and it keeps the card busy while the host queues the
    events and fn, so the events bracket fn's device time rather than the
    host's launch overhead."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    flush.sum()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _time_turns(fns, flush: torch.Tensor, runs: int = 40,
                warmup_s: float = 1.0) -> list[list[float]]:
    """CUDA-event times of each of `fns`, taken in turns (forward, then
    backward, then forward, ...) after at least `warmup_s` seconds of all
    of them running, so clock ramp-up and drift fall on all alike."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warmup_s:
        for fn in fns:
            fn()
        torch.cuda.synchronize()
    times = [[] for _ in fns]
    for i in range(runs):
        order = list(zip(fns, times))
        for fn, out in (order if i % 2 == 0 else order[::-1]):
            out.append(_event_ms(fn, flush))
    return times


def _quartiles(xs: list[float]) -> str:
    q = statistics.quantiles(xs, n=4)
    return f"{q[0]:.4f}/{q[1]:.4f}/{q[2]:.4f}"


def _sm_clock() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def _matrices() -> dict[str, np.ndarray]:
    """K1's and K2's matrices: the RS(10,4) encode, the fused decode of
    the rebuild ([3, 10], shards REBUILD_LOST lost) and of a degraded read
    ([1, 10], shard DEGRADED_SHARD lost)."""
    def fused(lost):
        present = tuple(i for i in range(14) if i not in lost)
        return gfmat.fused_reconstruct_matrix(10, 4, present, lost)[0]
    return {"encode": gf256.parity_matrix(10, 4), "decode": fused(REBUILD_LOST),
            "degraded": fused((DEGRADED_SHARD,))}


def _check_equal(name: str, what: str, op, data) -> int:
    """Kernel against plain version on `data`, byte for byte; the largest
    absolute difference (0, or it raises)."""
    got = _run(name, op, data, plain=False)
    want = _run(name, op, data.contiguous(), plain=True)
    torch.cuda.synchronize()
    err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max().item()) \
        if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"{name} {what}: kernel differs from plain "
                             f"(max {err})")
    return err


def check_identity(dev) -> None:
    """K2's fragment layout first: the GF identity [10, 10] returns its
    input, and each row of it, as a [1, 10] matrix, returns one input
    row, at a width with a ragged tail."""
    data = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, size=(10, 4096 + 37), dtype=np.uint8)).to(dev)
    eye = np.eye(10, dtype=np.uint8)
    got = _run("gf_bits", _operand("bits", eye, dev), data, plain=False)
    if not torch.equal(got, data):
        raise AssertionError("gf_bits: the identity does not return its "
                             "input")
    for i in range(10):
        got = _run("gf_bits", _operand("bits", eye[i:i + 1], dev), data,
                   plain=False)
        if not torch.equal(got[0], data[i]):
            raise AssertionError(f"gf_bits: identity row {i} does not "
                                 f"return input row {i}")
    log("kernels", "gf_bits: identity [10,10] returns its input, each "
                   "[1,10] identity row its input row")


def check_kernels(dev, names=tuple(KERNELS)) -> dict:
    """Each of `names` against its plain version on the card, byte for
    byte: the shapes and matrices of PRs 1-2, then the layouts the
    redesigned kernels realign. Returns {kernel: max_abs_err}."""
    rng = np.random.default_rng(2024)
    mats = _matrices()
    if "gf_bits" in names:
        check_identity(dev)
    wide = rng.integers(0, 256, size=(8, 40), dtype=np.uint8)
    matrices = {"encode[4,10]": mats["encode"], "decode[3,10]": mats["decode"],
                "wide[8,40]": wide}
    sel = {f"{n}{list(m.shape)}": m for n, m in sel_matrices().items()}
    worst = {}
    for name, spec in KERNELS.items():
        if name not in names:
            continue
        err = 0
        checked = 0
        widths = (MIB, MIB + 4, 4095, 1, STACKED_WIDTH)
        for mname, mat in (sel if name == "gf_sel" else matrices).items():
            op = _operand(spec["form"], mat, dev)
            c = mat.shape[1]
            for b in widths:
                data = torch.from_numpy(
                    rng.integers(0, 256, size=(c, b), dtype=np.uint8)).to(dev)
                err = max(err, _check_equal(name, f"{mname} B={b}", op, data))
                checked += 1
            # a column slice of a wider buffer: rows strided, bytes unit-stride
            base = torch.from_numpy(rng.integers(
                0, 256, size=(c, 8192 + 13), dtype=np.uint8)).to(dev)
            err = max(err, _check_equal(name, f"{mname} row-strided", op,
                                        base[:, 5:5 + 8192]))
            checked += 1
        # a transposed (byte-strided) input is refused, not copied
        op = _operand(spec["form"], mats["encode"], dev)
        bad = torch.zeros((4096, 10), dtype=torch.uint8, device=dev).t()
        try:
            _run(name, op, bad, plain=False)
        except ValueError:
            pass
        else:
            raise AssertionError(f"{name} accepted a byte-strided input")
        # golden RS(10,4) shard hashes through the kernel
        g = np.random.default_rng(0xEC).integers(0, 256, size=(10, 4096),
                                                 dtype=np.uint8)
        parity = _run(name, op, torch.from_numpy(g).to(dev), plain=False)
        shards = np.concatenate([g, parity.cpu().numpy()])
        hashes = [hashlib.sha256(s.tobytes()).hexdigest() for s in shards]
        if hashes != GOLDEN_SHARD_SHA256:
            raise AssertionError(f"{name}: golden shard hashes differ")
        log("kernels", f"{name}: {checked} shapes byte-identical to plain, "
                       f"transposed input refused, golden hashes match")
        worst[name] = err

    # the layouts the kernels realign: every row offset, narrow widths, spans
    # that end at their allocation's last byte; and K1 and K2 at every R
    rs_mats = {"encode[4,10]": mats["encode"], "decode[3,10]": mats["decode"],
               "degraded[1,10]": mats["degraded"]}
    for name, mats_of in (("gf_xor", rs_mats), ("gf_bits", rs_mats),
                          ("gf_sel", sel)):
        if name not in names:
            continue
        err = worst[name]
        checked = 0
        for mname, mat in mats_of.items():
            op = _operand(KERNELS[name]["form"], mat, dev)
            c = mat.shape[1]
            # row stride 8221 (no multiple of 16): at offset o the rows start
            # at o, o + 8221, ...; the output [R, b] is misaligned too
            base = torch.from_numpy(rng.integers(
                0, 256, size=(c, 8221), dtype=np.uint8)).to(dev)
            for off in range(16):
                err = max(err, _check_equal(name, f"{mname} offset {off}", op,
                                            base[:, off:off + 8189]))
                # the last row's span ends at its allocation's last byte
                err = max(err, _check_equal(name, f"{mname} offset {off} to "
                                            f"the end", op, base[:, off:]))
                checked += 2
            for b in range(1, 48):
                data = torch.from_numpy(rng.integers(
                    0, 256, size=(c, b), dtype=np.uint8)).to(dev)
                err = max(err, _check_equal(name, f"{mname} B={b}", op, data))
                checked += 1
        if name in ("gf_xor", "gf_bits"):
            for r in (1, 2, 3, 4, 5, 6, 7, 8, 14):
                mat = rng.integers(0, 256, size=(r, 10), dtype=np.uint8)
                op = _operand(KERNELS[name]["form"], mat, dev)
                for b in (64 * 1024 + 3, DEGRADED_WIDTH):
                    data = torch.from_numpy(rng.integers(
                        0, 256, size=(10, b), dtype=np.uint8)).to(dev)
                    err = max(err, _check_equal(name, f"R={r} B={b}", op,
                                                data))
                    checked += 1
        extra = ", R = 1-8 and 14" if name != "gf_sel" else ""
        if name == "gf_bits":
            # C past a 4-byte word and past one 256-bit k-step
            for c in (1, 3, 17, 33, 64):
                mat = rng.integers(0, 256, size=(4, c), dtype=np.uint8)
                op = _operand("bits", mat, dev)
                base = torch.from_numpy(rng.integers(
                    0, 256, size=(c, 8221), dtype=np.uint8)).to(dev)
                dense = torch.from_numpy(rng.integers(
                    0, 256, size=(c, 65539), dtype=np.uint8)).to(dev)
                for what, data in (("B=65539", dense),
                                   ("offset 7 to the end", base[:, 7:]),
                                   ("offset 3 B=37", base[:, 3:40])):
                    err = max(err, _check_equal(name, f"[4,{c}] {what}", op,
                                                data))
                    checked += 1
            extra += ", C in {1, 3, 17, 33, 64}"
        log("kernels", f"{name}: {checked} more layouts byte-identical to "
                       f"plain (row offsets 0-15 at row stride 8221, spans "
                       f"ending at the allocation's end, widths 1-47{extra})")
        worst[name] = err
    return worst


def baseline_kernels(root: str, workdir: str | None,
                     names=tuple(KERNELS)) -> dict:
    """K1 (gf_xor.cu), K2 (gf_bits.cu) and K3 (gf_sel.cu for the RS(10,4)
    encode matrix) of another checkout at `root`, built with this
    checkout's nvcc flags and bound by the same C interface: {kernel:
    fn(operand, data) -> out}, to time another version beside this one in
    the same run. The other K2 is handed its own operand: an earlier K2
    (before its tensor-core form, which takes rs_bits.mma_words) takes the
    int8 bit matrix itself."""
    import ctypes

    csrc = os.path.join(root, "seaweedfs_tpu_torch", "ops", "csrc")
    out_dir = tempfile.mkdtemp(prefix="baseline-", dir=workdir)
    unit = os.path.join(out_dir, "gf_sel_rs_10_4.cu")
    with open(unit, "w") as f:
        f.write(_build.specialised_unit("gf_sel.cu", gf256.parity_matrix(10, 4)))
    jobs = {name: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
         os.path.join(out_dir, f"{name}.so"), *inputs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, inputs in (("gf_xor", [os.path.join(csrc, "gf_xor.cu")]),
                             ("gf_bits", [os.path.join(csrc, "gf_bits.cu")]),
                             ("gf_sel", ["-I", csrc, unit]))
        if name in names}
    libs = {}
    for name, proc in jobs.items():
        text, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"baseline {name} failed to build:\n{text}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in ("gf_xor", "gf_bits"):
        if name in libs:
            getattr(libs[name], f"{name}_launch").argtypes = [
                vp, vp, ll, vp, ll, i, i, ll, i, vp]
    if "gf_sel" in libs:
        libs["gf_sel"].gf_sel_launch.argtypes = [vp, ll, vp, ll, ll, i, vp]
    with open(os.path.join(csrc, "gf_bits.cu")) as f:
        packed_k2 = "m16n8k256" in f.read()

    def launch(name, *args):
        code = getattr(libs[name], f"{name}_launch")(*args)
        if code != 0:
            raise RuntimeError(f"baseline {name} launch failed: {code}")

    def xor(coef, data):
        out = torch.empty((coef.shape[0], data.shape[1]), dtype=torch.uint8,
                          device=data.device)
        launch("gf_xor", coef.data_ptr(), data.data_ptr(), data.stride(0),
               out.data_ptr(), out.stride(0), coef.shape[0], data.shape[0],
               data.shape[1], data.device.index,
               torch.cuda.current_stream(data.device).cuda_stream)
        return out

    def bits(mbits, data):
        op = rs_bits.mma_words(mbits) if packed_k2 else mbits
        out = torch.empty((mbits.shape[0] // 8, data.shape[1]),
                          dtype=torch.uint8, device=data.device)
        launch("gf_bits", op.data_ptr(), data.data_ptr(), data.stride(0),
               out.data_ptr(), out.stride(0), out.shape[0], data.shape[0],
               data.shape[1], data.device.index,
               torch.cuda.current_stream(data.device).cuda_stream)
        return out

    def sel(matrix, data):
        if not np.array_equal(matrix, gf256.parity_matrix(10, 4)):
            raise ValueError("the baseline K3 is built for RS(10,4) only")
        out = torch.empty((4, data.shape[1]), dtype=torch.uint8,
                          device=data.device)
        launch("gf_sel", data.data_ptr(), data.stride(0), out.data_ptr(),
               out.stride(0), data.shape[1], data.device.index,
               torch.cuda.current_stream(data.device).cuda_stream)
        return out

    return {name: fn for name, fn in
            (("gf_xor", xor), ("gf_bits", bits), ("gf_sel", sel))
            if name in libs}


def time_shapes(dev, card: str, baseline: dict | None = None,
                names=tuple(KERNELS)) -> dict:
    """CUDA-event times of each kernel and its plain version at the shapes
    the main path launches (TIMED_SHAPES), with each shape's bytes bound;
    at the degraded-read shape also an empty kernel's time, its floor; and,
    given `baseline` (baseline_kernels), the other version's K1 and K3 in
    the same turns, after a byte-for-byte check against the plain one."""
    rng = np.random.default_rng(7)
    mats = _matrices()
    flush = torch.zeros(1024 * MIB, dtype=torch.uint8, device=dev)
    rate = memory_rate(card)
    out = {}
    for name, label, mname, b in TIMED_SHAPES:
        if name not in names:
            continue
        mat = mats[mname]
        op = _operand(KERNELS[name]["form"], mat, dev)
        r, c = mat.shape
        data = torch.from_numpy(
            rng.integers(0, 256, size=(c, b), dtype=np.uint8)).to(dev)
        fns = {"kernel": lambda: _run(name, op, data, plain=False),
               "plain": lambda: _run(name, op, data, plain=True)}
        if mname == "degraded":
            fns["floor"] = lambda: rs_xor.launch_empty(dev)
        if baseline and name in baseline:
            other = baseline[name]
            if not torch.equal(other(op, data), fns["plain"]()):
                raise AssertionError(f"baseline {name} {label} differs from "
                                     f"plain")
            fns["baseline"] = lambda: other(op, data)
        times = dict(zip(fns, _time_turns(list(fns.values()), flush)))
        moved = (c + r) * b
        row = dict(kernel=name, shape=f"{label} x {b} B",
                   ms=statistics.median(times["kernel"]),
                   plain_ms=statistics.median(times["plain"]),
                   bound_ms=moved / rate * 1e3,
                   floor_ms=statistics.median(times["floor"])
                   if "floor" in times else None,
                   baseline_ms=statistics.median(times["baseline"])
                   if "baseline" in times else None)
        floor = "" if row["floor_ms"] is None else (
            f", empty kernel {row['floor_ms']:.6f} ms (quartiles "
            f"{_quartiles(times['floor'])})")
        if row["baseline_ms"] is not None:
            floor += (f", baseline {row['baseline_ms']:.6f} ms (quartiles "
                      f"{_quartiles(times['baseline'])})")
        log("kernels", f"{name} {row['shape']}: median {row['ms']:.6f} ms "
                       f"(quartiles {_quartiles(times['kernel'])}), "
                       f"{row['ms'] / row['bound_ms']:.2f}x the bytes bound "
                       f"{row['bound_ms']:.6f} ms = {moved} B at {rate:.3g} "
                       f"B/s; plain {row['plain_ms']:.6f} ms{floor}; SM "
                       f"clock, max: {_sm_clock()}; on {card}")
        out[(name, label)] = row
    return out


# -- pipeline -----------------------------------------------------------------


def make_volume(base: str, size_bytes: int, seed: int) -> list[tuple]:
    """Seeded .dat + .idx: an 8-byte superblock, then padded needle records
    of 1-64 KiB of random bytes. Returns [(needle_id, offset, length)]."""
    rng = np.random.default_rng(seed)
    needles = []
    offset = 8
    nid = 1
    while offset < size_bytes:
        size = int(rng.integers(1, 64 * 1024 + 1))
        length = types.actual_size(size)
        needles.append((nid, offset, size, length))
        offset += length
        nid += 1
    dat = rng.integers(0, 256, size=offset, dtype=np.uint8)
    dat[:8] = np.frombuffer(b"\x03" + bytes(7), np.uint8)
    dat.tofile(base + ".dat")
    ids = np.array([n[0] for n in needles], np.uint64)
    offs = np.array([types.offset_to_stored(n[1]) for n in needles], np.uint64)
    sizes = np.array([n[2] for n in needles], np.int32)
    with open(base + ".idx", "wb") as f:
        f.write(idx.pack_index_arrays(ids, offs, sizes))
    return [(n[0], n[1], n[3]) for n in needles]


def shard_hashes(base: str, geo: Geometry) -> list[str]:
    out = []
    for i in range(geo.total_shards):
        h = hashlib.sha256()
        with open(geo.shard_file_name(base, i), "rb") as f:
            while chunk := f.read(16 * MIB):
                h.update(chunk)
        out.append(h.hexdigest())
    return out


def cpu_oracle_hashes(base: str, geo: Geometry, workdir: str) -> list[str]:
    """Shard sha256s of the same volume through the port's numpy coder."""
    odir = tempfile.mkdtemp(prefix="oracle-", dir=workdir)
    try:
        obase = os.path.join(odir, "v")
        os.symlink(os.path.abspath(base + ".dat"), obase + ".dat")
        ec_files.write_ec_files(obase, new_coder(backend="cpu"), geo)
        return shard_hashes(obase, geo)
    finally:
        shutil.rmtree(odir)


def encode_and_rebuild(phase: str, base: str, geo: Geometry, coder,
                       workdir: str, card: str) -> tuple[list[str], dict]:
    dat_bytes = os.path.getsize(base + ".dat")
    t0 = time.perf_counter()
    stats = ec_files.write_ec_files(base, coder, geo)
    ec_files.write_sorted_file_from_idx(base)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    hashes = shard_hashes(base, geo)
    t0 = time.perf_counter()
    oracle = cpu_oracle_hashes(base, geo, workdir)
    oracle_s = time.perf_counter() - t0
    if hashes != oracle:
        bad = [i for i in range(geo.total_shards) if hashes[i] != oracle[i]]
        raise AssertionError(f"{phase}: shards {bad} differ from the cpu coder")
    log(phase, f"encode of {dat_bytes} B: {enc_s:.3f} s = "
               f"{dat_bytes / enc_s / 1e9:.3f} GB/s end to end on {card} "
               f"({stats.batches} slabs; reader: read {stats.read_s:.3f} s, "
               f"encode calls {stats.dispatch_s:.3f} s; coordinator: device "
               f"wait {stats.device_wait_s:.3f} s; writers: "
               f"{stats.write_s:.3f} thread-s); 14 shard sha256s match the "
               f"numpy cpu coder ({oracle_s:.1f} s)")
    for i in REBUILD_LOST:
        os.remove(geo.shard_file_name(base, i))
    rstats: dict = {}
    t0 = time.perf_counter()
    rebuilt = ec_files.rebuild_ec_files(base, coder, geo, stats=rstats)
    torch.cuda.synchronize()
    reb_s = time.perf_counter() - t0
    if tuple(rebuilt) != REBUILD_LOST:
        raise AssertionError(f"{phase}: rebuilt {rebuilt}, not {REBUILD_LOST}")
    after = shard_hashes(base, geo)
    if after != hashes:
        raise AssertionError(f"{phase}: rebuilt shards differ")
    read_b = rstats["survivor_bytes_read"]
    log(phase, f"rebuild of shards {list(REBUILD_LOST)}: {reb_s:.3f} s = "
               f"{read_b / reb_s / 1e9:.3f} GB/s of survivors read end to end "
               f"on {card}; sha-identical")
    return hashes, dict(encode_gbps=dat_bytes / enc_s / 1e9,
                        rebuild_gbps=read_b / reb_s / 1e9)


def degraded_reads(base: str, geo: Geometry, coder, needles,
                   seed: int) -> tuple[int, int]:
    os.remove(geo.shard_file_name(base, DEGRADED_SHARD))
    vol = EcVolume(base, coder, geo=geo)
    try:
        est = vol.dat_size_estimate
        touching = []
        others = []
        for nid, off, length in needles:
            ids = {iv.to_shard_id_and_offset(geo)[0]
                   for iv in locate_data(geo, est, off, length)}
            (touching if DEGRADED_SHARD in ids else others).append(
                (nid, off, length))
        rng = np.random.default_rng(seed)
        extra = max(MIN_HEALTHY_READS, MIN_READS - len(touching))
        pick = rng.choice(len(others), size=min(len(others), extra),
                          replace=False)
        chosen = touching + [others[i] for i in sorted(pick)]
        with open(base + ".dat", "rb") as f, \
                mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as dat:
            for nid, off, length in chosen:
                got = vol.read_needle_blob(nid)
                if got != dat[off:off + length]:
                    raise AssertionError(f"needle {nid} differs from its "
                                         f".dat extent")
        return len(touching), len(chosen)
    finally:
        vol.close()


def pipeline(phase: str, kernel: str, volume_mb: int, seed: int, degraded: bool,
             workdir: str, card: str) -> dict:
    os.environ["SEAWEEDFS_TORCH_KERNEL"] = KERNELS[kernel]["form"]
    geo = Geometry()
    vdir = tempfile.mkdtemp(prefix=f"{phase}-", dir=workdir)
    try:
        base = os.path.join(vdir, "1")
        t0 = time.perf_counter()
        needles = make_volume(base, volume_mb * MIB, seed)
        log(phase, f"volume: {len(needles)} needles, "
                   f"{os.path.getsize(base + '.dat')} B in "
                   f"{time.perf_counter() - t0:.1f} s")
        coder = new_coder()
        for spec in KERNELS.values():
            spec["module"].KERNEL.reset()
        _, rates = encode_and_rebuild(phase, base, geo, coder, workdir, card)
        if degraded:
            touching, n = degraded_reads(base, geo, coder, needles, seed)
            log(phase, f"{n} needle reads byte-exact, {touching} of them "
                       f"degraded (touching lost shard {DEGRADED_SHARD})")
        counts = {k: spec["module"].KERNEL.launches
                  for k, spec in KERNELS.items()}
        if counts[kernel] <= 0:
            raise AssertionError(f"{phase}: {kernel} was never launched")
        log(phase, f"launches: {counts}; gf_xor by R: "
                   f"{dict(sorted(rs_xor.KERNEL.launches_by.items()))}")
        return dict(launches=counts[kernel], **rates)
    finally:
        shutil.rmtree(vdir)
        os.environ.pop("SEAWEEDFS_TORCH_KERNEL", None)


def _all_at_once(fn, items) -> list:
    """fn(item) for every item, one thread each, started together; the
    results in order. The first error raises."""
    results = [None] * len(items)
    errors = []

    def run(i, item):
        try:
            results[i] = fn(item)
        except BaseException as e:  # raised below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, item))
               for i, item in enumerate(items)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _lane_counts() -> dict:
    """Slabs and batches per lane of the card's coder so far (its batches
    carry reason single_device; the numpy oracle's say cpu_explicit)."""
    return {lane: (ec_stats.EC_DISPATCH_SLABS.value(lane=lane),
                   ec_stats.EC_DISPATCH_BATCHES.value(
                       lane=lane, reason="single_device"),
                   ec_stats.EC_DISPATCH_WINDOW_WAIT.snapshot(lane=lane))
            for lane in ("encode", "reconstruct")}


def pipeline_sched(volume_mb: int, n_volumes: int, seed: int, workdir: str,
                   card: str) -> dict:
    """BASELINE config #4: `n_volumes` volumes encoding at once on one
    coder, their slabs meeting in the dispatch scheduler's encode lane
    (K3, SEAWEEDFS_TORCH_KERNEL=sel); then concurrent rebuilds and
    degraded reads on the reconstruct lanes (K1)."""
    phase = "pipeline-sched"
    os.environ["SEAWEEDFS_TORCH_KERNEL"] = "sel"
    geo = Geometry()
    vdir = tempfile.mkdtemp(prefix=f"{phase}-", dir=workdir)
    try:
        bases = [os.path.join(vdir, str(v + 1)) for v in range(n_volumes)]
        t0 = time.perf_counter()
        needles = [make_volume(b, volume_mb * MIB, seed + v)
                   for v, b in enumerate(bases)]
        dat_bytes = sum(os.path.getsize(b + ".dat") for b in bases)
        log(phase, f"{n_volumes} volumes: {sum(map(len, needles))} needles, "
                   f"{dat_bytes} B in {time.perf_counter() - t0:.1f} s")
        coder = new_coder()
        for spec in KERNELS.values():
            spec["module"].KERNEL.reset()
        lanes0 = _lane_counts()

        def encode(base):
            st = ec_files.write_ec_files(base, coder, geo)
            ec_files.write_sorted_file_from_idx(base)
            return st

        t0 = time.perf_counter()
        enc_stats = _all_at_once(encode, bases)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        lanes1 = _lane_counts()
        hashes = [shard_hashes(b, geo) for b in bases]
        t0 = time.perf_counter()
        for v, base in enumerate(bases):
            if hashes[v] != cpu_oracle_hashes(base, geo, workdir):
                raise AssertionError(f"{phase}: volume {v + 1}'s shards "
                                     f"differ from the cpu coder")
        oracle_s = time.perf_counter() - t0
        tot = {f: sum(getattr(st, f) for st in enc_stats)
               for f in ("bytes", "batches", "wall_s", "read_s",
                         "dispatch_s", "device_wait_s", "write_s")}
        log(phase, f"encode of {n_volumes} x {volume_mb} MiB at once: "
                   f"{dat_bytes} B in {enc_s:.3f} s = "
                   f"{dat_bytes / enc_s / 1e9:.3f} GB/s aggregate end to end "
                   f"on {card}; EncodeStats summed over the {n_volumes} "
                   f"pipelines: {tot['batches']} slabs, wall "
                   f"{tot['wall_s']:.3f} s, read {tot['read_s']:.3f} s, "
                   f"submit {tot['dispatch_s']:.3f} s, device wait "
                   f"{tot['device_wait_s']:.3f} s, write "
                   f"{tot['write_s']:.3f} thread-s; "
                   f"{n_volumes * geo.total_shards} shard sha256s match the "
                   f"numpy cpu coder ({oracle_s:.1f} s)")

        def rebuild(base):
            for i in REBUILD_LOST:
                os.remove(geo.shard_file_name(base, i))
            rstats: dict = {}
            got = ec_files.rebuild_ec_files(base, coder, geo, stats=rstats)
            if tuple(got) != REBUILD_LOST:
                raise AssertionError(f"{phase}: rebuilt {got}")
            return rstats["survivor_bytes_read"]

        t0 = time.perf_counter()
        read_b = sum(_all_at_once(rebuild, bases))
        torch.cuda.synchronize()
        reb_s = time.perf_counter() - t0
        if [shard_hashes(b, geo) for b in bases] != hashes:
            raise AssertionError(f"{phase}: rebuilt shards differ")
        log(phase, f"rebuild of shards {list(REBUILD_LOST)} of all "
                   f"{n_volumes} at once: {reb_s:.3f} s = "
                   f"{read_b / reb_s / 1e9:.3f} GB/s of survivors read "
                   f"aggregate end to end on {card}; sha-identical")
        lanes2 = _lane_counts()

        def degraded(v):
            return degraded_reads(bases[v], geo, coder, needles[v], seed + v)

        t0 = time.perf_counter()
        reads = _all_at_once(degraded, list(range(n_volumes)))
        read_s = time.perf_counter() - t0
        lanes3 = _lane_counts()
        log(phase, f"{sum(n for _, n in reads)} needle reads by "
                   f"{n_volumes} readers at once byte-exact in "
                   f"{read_s:.3f} s, {sum(t for t, _ in reads)} of them "
                   f"degraded (touching lost shard {DEGRADED_SHARD})")

        counts = {k: spec["module"].KERNEL.launches
                  for k, spec in KERNELS.items()}
        enc_slabs = lanes1["encode"][0] - lanes0["encode"][0]
        enc_batches = lanes1["encode"][1] - lanes0["encode"][1]
        rec_batches = lanes3["reconstruct"][1] - lanes1["reconstruct"][1]
        for lane, a, b, what in (("encode", lanes0, lanes1, "encode"),
                                 ("reconstruct", lanes1, lanes2, "rebuild"),
                                 ("reconstruct", lanes2, lanes3,
                                  "degraded reads")):
            slabs = a[lane][0], b[lane][0]
            batches = a[lane][1], b[lane][1]
            waits = a[lane][2], b[lane][2]
            n_sl = slabs[1] - slabs[0]
            n_b = batches[1] - batches[0]
            wait = waits[1]["sum"] - waits[0]["sum"]
            log(phase, f"{what}: {lane} lane {n_sl:.0f} slabs in "
                       f"{n_b:.0f} batches, batch factor "
                       f"{n_sl / max(n_b, 1):.3f}, mean queue wait "
                       f"{wait / max(n_sl, 1) * 1e3:.3f} ms")
        arena = ec_stats.ec_dispatch_stats()["arena"]
        log(phase, f"launches: {counts}; gf_xor by R: "
                   f"{dict(sorted(rs_xor.KERNEL.launches_by.items()))}; "
                   f"stack arena {arena}")
        if counts["gf_sel"] <= 0:
            raise AssertionError(f"{phase}: gf_sel was never launched")
        if counts["gf_sel"] != enc_batches:
            raise AssertionError(f"{phase}: {counts['gf_sel']} gf_sel "
                                 f"launches for {enc_batches} encode batches")
        if not enc_slabs > enc_batches:
            raise AssertionError(f"{phase}: no encode batch stacked more "
                                 f"than one slab ({enc_slabs} slabs, "
                                 f"{enc_batches} batches)")
        if counts["gf_xor"] <= 0 or counts["gf_xor"] != rec_batches:
            raise AssertionError(f"{phase}: {counts['gf_xor']} gf_xor "
                                 f"launches for {rec_batches} reconstruct "
                                 f"batches")
        return dict(launches=counts["gf_sel"],
                    encode_gbps=dat_bytes / enc_s / 1e9,
                    rebuild_gbps=read_b / reb_s / 1e9,
                    batch_factor=enc_slabs / enc_batches)
    finally:
        shutil.rmtree(vdir)
        os.environ.pop("SEAWEEDFS_TORCH_KERNEL", None)


# -- main ---------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--volume-mb", type=int, default=1024,
                    help="size of the K1 pipeline's volume (default 1024)")
    ap.add_argument("--bits-volume-mb", type=int, default=128,
                    help="size of the K2 pipeline's volume (default 128)")
    ap.add_argument("--sched-volume-mb", type=int, default=512,
                    help="size of each concurrent volume of the K3 "
                         "pipeline (default 512)")
    ap.add_argument("--sched-volumes", type=int, default=8,
                    help="volumes encoding at once in the K3 pipeline "
                         "(default 8)")
    ap.add_argument("--workdir", default=None,
                    help="where volumes are written (default: TMPDIR)")
    ap.add_argument("--baseline", default=None, metavar="DIR",
                    help="another checkout whose kernels are built and "
                         "timed beside this one's at every timed shape")
    ap.add_argument("--only", choices=tuple(KERNELS), default=None,
                    help="build, check and time this kernel alone and run "
                         "only its pipeline phase (a short loop for one "
                         "kernel; the default runs everything)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda}; "
                  f"{card}; nvidia-smi: {smi}")

    # one nvcc per library, all started together: K1, K2, and K3 once per
    # encode matrix it serves here (the scheduler phase would otherwise
    # build its matrix on the flusher thread, holding every lane)
    names = (args.only,) if args.only else tuple(KERNELS)
    if args.only:
        log("only", f"{args.only} alone: skipping the other kernels' builds, "
                    f"checks and timings and every pipeline phase but "
                    f"{PHASES[args.only]}")
    t0 = time.perf_counter()
    sel = sel_matrices() if "gf_sel" in names else {}
    # pipeline-sched runs K1 on its reconstruct lanes
    sources = tuple(src for src, users in (("gf_xor.cu", ("gf_xor", "gf_sel")),
                                           ("gf_bits.cu", ("gf_bits",)))
                    if set(users) & set(names))
    built = _build.build(sources, specialised=[
        (rs_sel.TEMPLATE, m) for m in sel.values()])
    log("build", f"nvcc built {len(built)} libraries in "
                 f"{time.perf_counter() - t0:.1f} s")
    labels = {_build.specialised_path(rs_sel.TEMPLATE, m).name:
              f"{rs_sel.TEMPLATE} for {name}{list(m.shape)}"
              for name, m in sel.items()}
    for key, b in built.items():
        text = _build.build_log(b.path)
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = [int(x) for x in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", text)]
        # K1's instances, C group/R pass: registers (the main path's C = 10)
        k1 = {f"{g}/{r}": int(n) for g, r, n in re.findall(
            r"gf_xor_kernelILi(\d+)ELi(\d+)E.*?Used (\d+) registers", text,
            flags=re.S) if g == "10"}
        # K2's instances: k-steps S / B fragments in registers (1) or not
        k2 = {f"{st}/{rg}": int(n) for st, rg, n in re.findall(
            r"gf_bits_kernelILi(\d+)ELb([01])E.*?Used (\d+) registers", text,
            flags=re.S)}
        by = (f"; registers by C/R {k1}" if k1 else "") + (
            f"; registers by S/in-registers {k2}" if k2 else "")
        log("build", f"{labels.get(key, key)}: {b.seconds:.1f} s; "
                     f"{len(regs)} kernels, registers {min(regs)}-"
                     f"{max(regs)}, spill bytes {sum(spills)}{by}")
        if sum(spills):
            spilled = [entry.split("'")[1] for entry in
                       text.split("Compiling entry function")[1:]
                       if re.search(r"[1-9]\d* bytes spill", entry)]
            raise AssertionError(f"{labels.get(key, key)} spills registers "
                                 f"in {spilled}")

    max_err = check_kernels(dev, names)
    baseline = None
    if args.baseline:
        t0 = time.perf_counter()
        baseline = baseline_kernels(args.baseline, args.workdir, names)
        log("build", f"baseline {', '.join(baseline)} from {args.baseline} "
                     f"in {time.perf_counter() - t0:.1f} s")
    timed = time_shapes(dev, card, baseline, names)

    paths = {}
    if "gf_xor" in names:
        paths["gf_xor"] = pipeline("pipeline", "gf_xor", args.volume_mb,
                                   seed=1, degraded=True,
                                   workdir=args.workdir, card=card)
    if "gf_bits" in names:
        paths["gf_bits"] = pipeline("pipeline-bits", "gf_bits",
                                    args.bits_volume_mb, seed=2,
                                    degraded=False, workdir=args.workdir,
                                    card=card)
    if "gf_sel" in names:
        paths["gf_sel"] = pipeline_sched(args.sched_volume_mb,
                                         args.sched_volumes, seed=3,
                                         workdir=args.workdir, card=card)

    rows = []
    for name, path in paths.items():
        spec = KERNELS[name]
        at = timed[(name, "encode [4,10]")]  # the [10, 1 MiB] encode
        rows.append(dict(
            name=name, route="cuda", source=spec["source"],
            replaces=spec["replaces"], launches=path["launches"],
            max_abs_err=max_err[name], ms=at["ms"], plain_ms=at["plain_ms"],
            bound_ms=at["bound_ms"], bound_by="bytes", library_ms=None))
    log("done", f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
