"""Native (C++) host library: the CRC-32C binding that storage/crc.py uses.

Counterpart of seaweedfs_tpu/ops/rs_native.py. The source,
ops/native/crc32c.cpp, is the slice-by-8 CRC-32C of the reference's
ops/native/rs.cpp; its GF(2^8) matmul and XOR-schedule executor, and the
host RS codec over them (``RSCodecNative``, a ``native`` backend of
``new_coder``), are not part of the port yet.

The library is built with g++ at first use (never at import), as the
reference builds it: ``-march=native`` first, then without it. It lands in
ops/_build/ (gitignored, shared with the CUDA libraries), named by a hash
of the source, the flags and the host's CPU (a ``-march=native`` library
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

_SRC = Path(__file__).resolve().with_name("native") / "crc32c.cpp"
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
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()
                            + _host_cpu())
    return _BUILD_DIR / f"libcrc32c_swfs-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", *_FLAGS, str(_SRC), "-o", tmp]
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
        lib.swfs_crc32c.argtypes = [u8p, ctypes.c_int64, ctypes.c_uint32]
        lib.swfs_crc32c.restype = ctypes.c_uint32
        _lib = lib
        return lib


def crc32c_native(data: bytes | np.ndarray, seed: int = 0) -> int:
    lib = load_library()
    a = (np.frombuffer(data, dtype=np.uint8)
         if isinstance(data, (bytes, bytearray, memoryview))
         else np.ascontiguousarray(data, np.uint8))
    ptr = a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    return int(lib.swfs_crc32c(ptr, a.size, seed & 0xFFFFFFFF))
