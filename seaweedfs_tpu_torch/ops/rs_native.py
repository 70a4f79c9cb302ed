"""Native (C++) host library: the host RS codec and the CRC-32C binding.

Counterpart of seaweedfs_tpu/ops/rs_native.py. Two sources build into one
library: ops/native/rs.cpp, the GF(2^8) matmul (nibble tables, vpshufb
under AVX2) and the XOR-schedule executor of the reference's
ops/native/rs.cpp, and ops/native/crc32c.cpp, its slice-by-8 CRC-32C
(storage/crc.py). Over them: ``gf_matmul_native``, ``xor_sched_exec``
(ops/rs_sched.py's native executor) and ``RSCodecNative``, the host coder
of ``new_coder``'s ``native`` backend, whose matrices come from
ops/gf256.py, so its bytes equal every other coder's.

The library is built with g++ at first use (never at import), as the
reference builds it: ``-march=native`` first, then without it. It lands in
ops/_build/ (gitignored, shared with the CUDA libraries), named by a hash
of the sources, the flags and the host's CPU (a ``-march=native`` library
runs only where it was built), and is moved into place with an atomic
rename, so concurrent processes building it at once are safe and an
edited source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from .rs_cpu import RSCodecCPU

_NATIVE = Path(__file__).resolve().with_name("native")
_SRCS = (_NATIVE / "rs.cpp", _NATIVE / "crc32c.cpp")
_BUILD_DIR = Path(__file__).resolve().with_name("_build")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lib_lock = threading.Lock()


def _host_cpu() -> bytes:
    """The CPU a -march=native build targets: its model and flags."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = {ln for ln in f.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))}
    except OSError:
        lines = set()
    return b"\n".join(sorted(lines)) or platform.machine().encode()


def library_path() -> Path:
    """Where the built library lives (content-addressed)."""
    digest = hashlib.sha256(b"".join(src.read_bytes() for src in _SRCS)
                            + " ".join(_FLAGS).encode() + _host_cpu())
    return _BUILD_DIR / f"librs_swfs-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", *_FLAGS, *map(str, _SRCS), "-o", tmp]
        native = cmd[:1] + ["-march=native"] + cmd[1:]
        try:
            subprocess.run(native, check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library() -> ctypes.CDLL:
    """Build (if missing) and load the native library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.swfs_gf_matmul.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p,
                                       ctypes.c_int64, u8p]
        lib.swfs_gf_matmul.restype = None
        lib.swfs_crc32c.argtypes = [u8p, ctypes.c_int64, ctypes.c_uint32]
        lib.swfs_crc32c.restype = ctypes.c_uint32
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.swfs_xor_sched_exec.argtypes = [
            i32p, ctypes.c_int64, u8p, ctypes.c_int, ctypes.c_int64,
            u8p, ctypes.c_int, ctypes.c_int]
        lib.swfs_xor_sched_exec.restype = None
        lib.swfs_simd_level.argtypes = []
        lib.swfs_simd_level.restype = ctypes.c_int
        _lib = lib
        return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def gf_matmul_native(matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
    """out[m, B] = matrix[m, k] (*) data[k, B] over GF(256), in C++.

    `data` reaches the kernel by pointer: the dispatch scheduler's
    page-aligned arena view is contiguous, so the ascontiguousarray below
    copies nothing."""
    lib = load_library()
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    m, k = matrix.shape
    kk, b = data.shape
    if k != kk:
        raise ValueError(f"matrix {matrix.shape} does not match data "
                         f"{data.shape}")
    out = np.empty((m, b), dtype=np.uint8)
    lib.swfs_gf_matmul(_ptr(matrix), m, k, _ptr(data), b, _ptr(out))
    return out


def xor_sched_exec(prog: np.ndarray, data: np.ndarray, out: np.ndarray,
                   n_in: int, n_out: int, n_tmp: int) -> None:
    """Run a compiled XOR schedule (ops/rs_sched.py) in C++: `prog` is the
    flat [N, 3] int32 (op, dst, src) program, `data` the [n_in, B] input
    rows, `out` the preallocated [n_out, B] result; rows by pointer."""
    lib = load_library()
    prog = np.ascontiguousarray(prog, np.int32)
    if data.dtype != np.uint8 or not data.flags.c_contiguous:
        raise ValueError("data must be C-contiguous uint8")
    if out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("out must be C-contiguous uint8")
    if data.shape != (n_in, out.shape[1]) or out.shape[0] != n_out:
        raise ValueError(f"data {data.shape} and out {out.shape} do not "
                         f"match {n_in} inputs and {n_out} outputs")
    lib.swfs_xor_sched_exec(
        prog.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        prog.shape[0], _ptr(data), n_in, data.shape[1],
        _ptr(out), n_out, n_tmp)


def crc32c_native(data: bytes | np.ndarray, seed: int = 0) -> int:
    lib = load_library()
    a = (np.frombuffer(data, dtype=np.uint8)
         if isinstance(data, (bytes, bytearray, memoryview))
         else np.ascontiguousarray(data, np.uint8))
    return int(lib.swfs_crc32c(_ptr(a), a.size, seed & 0xFFFFFFFF))


class RSCodecNative(RSCodecCPU):
    """RSCodecCPU with the GF matmul routed through the C++ kernel."""

    def __init__(self, data_shards: int = 10, parity_shards: int = 4,
                 geometry=None):
        load_library()  # fail fast if the toolchain is missing
        super().__init__(data_shards, parity_shards, geometry=geometry)

    def _matmul(self, matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
        return gf_matmul_native(matrix, data)


def simd_level() -> int:
    """2 = AVX2 vpshufb build, 0 = scalar."""
    return int(load_library().swfs_simd_level())
