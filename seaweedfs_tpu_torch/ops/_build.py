"""Build the port's CUDA kernels with nvcc at first use; bind them with ctypes.

Each source in ops/csrc/ compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib> <source>

Libraries land in ops/_build/ (listed in .gitignore), named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged
one loads as it is. ``build()`` starts one nvcc per source, all at once,
and waits for them together. Nothing here runs at import: the CPU tests
import every module on machines that have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().with_name("_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("gf_xor.cu", "gf_bits.cu")

_lock = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: on PATH, else the toolkit's default install."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: building the port's CUDA kernels needs the CUDA "
        "toolkit (put nvcc on PATH)")


def library_path(source: str) -> Path:
    """Where `source`'s library lives once built (content-addressed)."""
    src = (CSRC / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources=SOURCES) -> dict[str, Path]:
    """Compile every source whose library is missing, in parallel; return
    {source: library path}. Raises RuntimeError with nvcc's output when a
    build fails. The compiler's report (registers, shared memory, spills)
    is kept beside each library as <lib>.log."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        paths = {s: library_path(s) for s in sources}
        jobs = []
        for source, path in paths.items():
            if path.exists():
                continue
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((source, path, tmp, proc))
        failed = []
        for source, path, tmp, proc in jobs:
            log, _ = proc.communicate()
            path.with_name(path.name + ".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{source} (nvcc exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
        return paths


def build_log(source: str) -> str:
    """The compiler's report for `source`'s current library ('' if none)."""
    log = library_path(source).with_name(library_path(source).name + ".log")
    return log.read_text() if log.exists() else ""


class Kernel:
    """One CUDA library of the port: built and loaded at first use, with a
    plain integer count of the launches its wrapper made."""

    def __init__(self, source: str, prefix: str):
        self.source = source
        self.prefix = prefix
        self.launches = 0
        self._lib = None
        self._smem_limit: dict[int, int] = {}
        self._count_lock = threading.Lock()

    @property
    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            path = build((self.source,))[self.source]
            with _lock:
                if self._lib is None:
                    lib = ctypes.CDLL(str(path))
                    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
                    launch = getattr(lib, f"{self.prefix}_launch")
                    launch.argtypes = [vp, vp, ll, vp, ll, i, i, ll, i, vp]
                    launch.restype = i
                    smem = getattr(lib, f"{self.prefix}_smem_bytes")
                    smem.argtypes = [i, i]
                    smem.restype = ll
                    limit = getattr(lib, f"{self.prefix}_smem_limit")
                    limit.argtypes = [i, ctypes.POINTER(i)]
                    limit.restype = i
                    err = getattr(lib, f"{self.prefix}_error_string")
                    err.argtypes = [i]
                    err.restype = ctypes.c_char_p
                    self._lib = lib
        return self._lib

    def check_smem(self, rows: int, cols: int, device: int) -> None:
        """Raise ValueError when an [rows, cols] matrix's tile would not
        fit in one block's shared memory on `device`."""
        lib = self.lib
        need = getattr(lib, f"{self.prefix}_smem_bytes")(rows, cols)
        limit = self._smem_limit.get(device)
        if limit is None:
            got = ctypes.c_int(0)
            code = getattr(lib, f"{self.prefix}_smem_limit")(
                device, ctypes.byref(got))
            self.raise_for(code, "shared-memory query")
            limit = self._smem_limit[device] = got.value
        if need > limit:
            raise ValueError(
                f"{self.prefix}: a [{rows}, {cols}] matrix needs {need} bytes "
                f"of shared memory, more than the {limit} a block may use on "
                f"this device")

    def launch(self, *args) -> None:
        """Call <prefix>_launch; raise on a refused launch, else count it."""
        code = getattr(self.lib, f"{self.prefix}_launch")(*args)
        self.raise_for(code, "launch")
        with self._count_lock:
            self.launches += 1

    def raise_for(self, code: int, what: str) -> None:
        if code != 0:
            msg = getattr(self.lib, f"{self.prefix}_error_string")(code)
            raise RuntimeError(
                f"{self.prefix} {what} failed: CUDA error {code} "
                f"({msg.decode() if msg else 'unknown'})")

    def reset(self) -> None:
        with self._count_lock:
            self.launches = 0
