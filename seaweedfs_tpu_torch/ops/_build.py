"""Build the port's CUDA kernels with nvcc at first use; bind them with ctypes.

Each source in ops/csrc/ compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib> <source>

A template (gf_sel.cu) is compiled once per GF matrix instead: a generated
unit defines the matrix as constexpr values in namespace ``gf_matrix`` and
then includes the template, so the matrix is a compile-time constant of
the kernel (``specialised_unit``). That unit is kept beside its library.

Libraries land in ops/_build/ (listed in .gitignore), named by a hash of
what they are compiled from (the source, or the template and the
generated unit, and every header in csrc/) and the flags, so an edited
source or header rebuilds and an unchanged one loads as it is; a second process finds the library and
loads it without building. ``build()`` starts one nvcc per library, all
at once, and waits for them together. Each library is moved into place
with an atomic rename, so two processes building the same one at once
are safe. Nothing here runs at import: the CPU tests import every module
on machines that have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import NamedTuple

import numpy as np

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


def _headers() -> bytes:
    """Every header in csrc/, names and bytes: any source may include one,
    so each library's name covers them all."""
    return b"".join(p.name.encode() + b"\0" + p.read_bytes()
                    for p in sorted(CSRC.glob("*.cuh")))


def library_path(source: str) -> Path:
    """Where `source`'s library lives once built (content-addressed)."""
    src = (CSRC / source).read_bytes()
    digest = hashlib.sha256(src + _headers() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def specialised_unit(template: str, matrix: np.ndarray) -> str:
    """The translation unit that specialises `template` on the [R, C]
    uint8 `matrix`: the matrix as constexpr values, then the template."""
    m = np.asarray(matrix, dtype=np.uint8)
    if m.ndim != 2:
        raise ValueError(f"matrix must be [R, C], got shape {m.shape}")
    r, c = m.shape
    values = ", ".join(str(int(v)) for v in m.reshape(-1))
    return (f"// Generated by ops/_build.py: {template} specialised on a "
            f"[{r}, {c}] GF(2^8) matrix.\n"
            "#include <cstdint>\n"
            "#define GF_MATRIX_SPECIALISED 1\n"
            "namespace gf_matrix {\n"
            f"constexpr int kRows = {r};\n"
            f"constexpr int kCols = {c};\n"
            f"constexpr uint8_t kMatrix[{r * c}] = {{{values}}};\n"
            "}  // namespace gf_matrix\n"
            f'#include "{template}"\n')


def specialised_path(template: str, matrix: np.ndarray) -> Path:
    """Where `template` specialised on `matrix` lives once built: named by
    a hash of the template, the headers, the generated unit (the matrix
    bytes) and the flags."""
    m = np.asarray(matrix, dtype=np.uint8)
    unit = specialised_unit(template, m)
    digest = hashlib.sha256((CSRC / template).read_bytes() + _headers()
                            + unit.encode() + " ".join(NVCC_FLAGS).encode())
    r, c = m.shape
    return BUILD_DIR / (f"{Path(template).stem}-{r}x{c}-"
                        f"{digest.hexdigest()[:16]}.so")


class Built(NamedTuple):
    """A library and the seconds its nvcc took (0.0 when it was found
    already built)."""

    path: Path
    seconds: float


def build(sources=SOURCES, specialised=()) -> dict[str, Built]:
    """Compile every library that is missing, one nvcc each, all in
    parallel: each of `sources`, and each (template, matrix) pair of
    `specialised`. Returns {source name or specialised library's file
    name: Built}. Raises RuntimeError with nvcc's output when a build
    fails; nothing falls back. The compiler's report (registers, shared
    memory, spills) is kept beside each library as <lib>.log."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        targets: dict[str, tuple[Path, list[str], str | None]] = {}
        for source in sources:
            targets[source] = (library_path(source), [str(CSRC / source)],
                               None)
        for template, matrix in specialised:
            path = specialised_path(template, matrix)
            unit = path.with_suffix(".cu")
            targets[path.name] = (path, ["-I", str(CSRC), str(unit)],
                                  specialised_unit(template, matrix))
        out = {name: Built(path, 0.0)
               for name, (path, _, _) in targets.items()}
        missing = {name: t for name, t in targets.items()
                   if not t[0].exists()}
        compiler = nvcc() if missing else None  # raises before any write
        jobs = []
        for name, (path, inputs, unit_text) in missing.items():
            if unit_text is not None:
                unit = Path(inputs[-1])
                tmp_unit = unit.with_name(f"{unit.name}.{os.getpid()}.tmp")
                tmp_unit.write_text(unit_text)
                os.replace(tmp_unit, unit)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            log = path.with_name(path.name + ".log")
            with open(log, "w") as log_file:
                proc = subprocess.Popen(
                    [compiler, *NVCC_FLAGS, "-o", str(tmp), *inputs],
                    stdout=log_file, stderr=subprocess.STDOUT)
            jobs.append((name, path, tmp, log, proc, time.perf_counter()))
        failed = []
        while jobs:  # each build's own seconds, whatever order they end in
            for job in list(jobs):
                name, path, tmp, log, proc, t0 = job
                try:
                    proc.wait(timeout=0.05)
                except subprocess.TimeoutExpired:
                    continue
                jobs.remove(job)
                seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                                  f"{log.read_text()}")
                    continue
                os.replace(tmp, path)  # atomic: a loader sees all or none
                out[name] = Built(path, seconds)
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
        return out


def build_log(library: Path) -> str:
    """The compiler's report for a built library ('' if none)."""
    log = library.with_name(library.name + ".log")
    return log.read_text() if log.exists() else ""


class _Launcher:
    """A plain integer count of the launches a wrapper made (and, where the
    wrapper names one, a count per shape key beside it), and the
    launch-and-check step shared by the port's libraries: every library
    exports <prefix>_launch, returning cudaGetLastError(), and
    <prefix>_error_string."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self.launches = 0
        self.launches_by: dict = {}
        self._count_lock = threading.Lock()

    def _launch(self, lib: ctypes.CDLL, *args, key=None) -> None:
        """Call <prefix>_launch; raise on a refused launch, else count it
        (under `key` too, when one is given)."""
        code = getattr(lib, f"{self.prefix}_launch")(*args)
        self._raise_for(lib, code, "launch")
        with self._count_lock:
            self.launches += 1
            if key is not None:
                self.launches_by[key] = self.launches_by.get(key, 0) + 1

    def _raise_for(self, lib: ctypes.CDLL, code: int, what: str) -> None:
        if code != 0:
            msg = getattr(lib, f"{self.prefix}_error_string")(code)
            raise RuntimeError(
                f"{self.prefix} {what} failed: CUDA error {code} "
                f"({msg.decode() if msg else 'unknown'})")

    def reset(self) -> None:
        with self._count_lock:
            self.launches = 0
            self.launches_by = {}


class Kernel(_Launcher):
    """One CUDA library of the port: built and loaded at first use."""

    def __init__(self, source: str, prefix: str):
        super().__init__(prefix)
        self.source = source
        self._lib = None
        self._smem_limit: dict[int, int] = {}

    @property
    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            path = build((self.source,))[self.source].path
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

    def launch(self, *args, key=None) -> None:
        """Call <prefix>_launch; raise on a refused launch, else count it."""
        self._launch(self.lib, *args, key=key)

    def raise_for(self, code: int, what: str) -> None:
        self._raise_for(self.lib, code, what)


class SpecialisedKernel(_Launcher):
    """A CUDA template compiled once per matrix (the matrix is a
    compile-time constant of the kernel). Loaded libraries are kept in an
    LRU of `max_libs` entries keyed by the matrix's compact identity, so
    a process touches nvcc (or the disk cache) once per matrix. The
    library exports <prefix>_rows/_cols/_matrix, and a loaded library
    whose baked matrix is not the one asked for is refused."""

    def __init__(self, template: str, prefix: str, max_libs: int = 256):
        super().__init__(prefix)
        self.template = template
        self.max_libs = max_libs
        self._libs: "OrderedDict[tuple, ctypes.CDLL]" = OrderedDict()
        self._libs_lock = threading.Lock()

    def lib_for(self, matrix: np.ndarray, key: tuple) -> ctypes.CDLL:
        """The library specialised on `matrix` (identified by `key`),
        built at first use. Raises RuntimeError when nvcc fails."""
        with self._libs_lock:
            lib = self._libs.get(key)
            if lib is not None:
                self._libs.move_to_end(key)
                return lib
        m = np.ascontiguousarray(matrix, dtype=np.uint8)
        path = specialised_path(self.template, m)
        build((), specialised=((self.template, m),))
        lib = ctypes.CDLL(str(path))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        launch = getattr(lib, f"{self.prefix}_launch")
        launch.argtypes = [vp, ll, vp, ll, ll, i, vp]
        launch.restype = i
        for dim in ("rows", "cols"):
            fn = getattr(lib, f"{self.prefix}_{dim}")
            fn.argtypes = []
            fn.restype = i
        baked = getattr(lib, f"{self.prefix}_matrix")
        baked.argtypes = [vp]
        baked.restype = None
        err = getattr(lib, f"{self.prefix}_error_string")
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
        shape = (getattr(lib, f"{self.prefix}_rows")(),
                 getattr(lib, f"{self.prefix}_cols")())
        got = np.zeros(m.size, dtype=np.uint8)
        if shape == m.shape:
            baked(got.ctypes.data)
        if shape != m.shape or not np.array_equal(got.reshape(shape), m):
            raise RuntimeError(f"{path.name} holds a {shape} matrix other "
                               f"than the {m.shape} one asked for")
        with self._libs_lock:
            self._libs[key] = lib
            self._libs.move_to_end(key)
            while len(self._libs) > self.max_libs:
                self._libs.popitem(last=False)
        return lib

    def launch(self, lib: ctypes.CDLL, *args) -> None:
        """Call <prefix>_launch of `lib`; raise on a refused launch, else
        count it."""
        self._launch(lib, *args)
