"""ctypes loader + wrapper for the C++ volume data plane (dataplane.cpp).

Counterpart of seaweedfs_tpu/native/dataplane.py. The plane binds the
volume server's public port and serves needle GET/PUT/DELETE from C++
worker threads; everything else is 307-redirected to the Python listener.
Volumes are registered per-vid; all Python-side mutations to a registered
volume MUST funnel through append_record / delete (one writer authority —
the C++ lock) and reads through read_blob.

The library is built with g++ at first use (never at import), as
ops/rs_native.py builds the host coder: into ops/_build/ (gitignored),
named by a hash of the source and the flags, and moved into place with an
atomic rename, so processes that build it at once are safe and an edited
source rebuilds. A failed build raises NativeBuildError carrying g++'s
own message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().with_name("dataplane.cpp")
_BUILD_DIR = Path(__file__).resolve().parent.parent / "ops" / "_build"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lib_lock = threading.Lock()


class NativeBuildError(OSError):
    """g++ could not build (or the loader could not open) the plane."""


def library_path() -> Path:
    """Where the built library lives (content-addressed)."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libswfs_dataplane-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", *_FLAGS, str(_SRC), "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise NativeBuildError(f"g++ not found: {e}") from e
        except subprocess.CalledProcessError as e:
            raise NativeBuildError(
                f"g++ failed building {_SRC.name} (exit {e.returncode}): "
                f"{(e.stderr or '').strip()[-2000:]}") from e
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library() -> ctypes.CDLL:
    """Build (if missing) and load the plane's library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeBuildError(f"cannot load {path.name}: {e}") from e
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.swdp_start.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int]
        lib.swdp_start.restype = ctypes.c_int
        lib.swdp_stop.argtypes = [ctypes.c_int]
        lib.swdp_stop.restype = None
        lib.swdp_add_volume.argtypes = [ctypes.c_int, ctypes.c_uint32,
                                        ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.c_int, ctypes.c_int]
        lib.swdp_add_volume.restype = ctypes.c_int
        lib.swdp_remove_volume.argtypes = [ctypes.c_int, ctypes.c_uint32]
        lib.swdp_remove_volume.restype = ctypes.c_int
        lib.swdp_reload_volume.argtypes = [ctypes.c_int, ctypes.c_uint32]
        lib.swdp_reload_volume.restype = ctypes.c_int
        lib.swdp_set_writable.argtypes = [ctypes.c_int, ctypes.c_uint32,
                                          ctypes.c_int]
        lib.swdp_set_writable.restype = ctypes.c_int
        lib.swdp_append_record.argtypes = [
            ctypes.c_int, ctypes.c_uint32, ctypes.c_uint64, u8p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64)]
        lib.swdp_append_record.restype = ctypes.c_int64
        lib.swdp_read.argtypes = [ctypes.c_int, ctypes.c_uint32,
                                  ctypes.c_uint64, ctypes.POINTER(u8p)]
        lib.swdp_read.restype = ctypes.c_int64
        lib.swdp_free.argtypes = [u8p]
        lib.swdp_free.restype = None
        lib.swdp_volume_stats.argtypes = [ctypes.c_int, ctypes.c_uint32] + \
            [ctypes.POINTER(ctypes.c_int64)] * 4 + \
            [ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64)]
        lib.swdp_volume_stats.restype = ctypes.c_int
        lib.swdp_request_count.argtypes = [ctypes.c_int]
        lib.swdp_request_count.restype = ctypes.c_uint64
        lib.swdp_sendfile_count.argtypes = [ctypes.c_int]
        lib.swdp_sendfile_count.restype = ctypes.c_uint64
        lib.swdp_set_zerocopy_min.argtypes = [ctypes.c_int,
                                              ctypes.c_int64]
        lib.swdp_set_zerocopy_min.restype = ctypes.c_int
        lib.swdp_bench.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_char_p),
                                   ctypes.c_int, u8p, ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_int64)]
        lib.swdp_bench.restype = ctypes.c_int64
        lib.swfp_start.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_int64]
        lib.swfp_start.restype = ctypes.c_int
        lib.swfp_stop.argtypes = [ctypes.c_int]
        lib.swfp_stop.restype = None
        lib.swfp_add_lease.argtypes = [ctypes.c_int, ctypes.c_uint32,
                                       ctypes.c_uint64, ctypes.c_uint32,
                                       ctypes.c_uint32]
        lib.swfp_add_lease.restype = ctypes.c_int
        lib.swfp_lease_remaining.argtypes = [ctypes.c_int]
        lib.swfp_lease_remaining.restype = ctypes.c_uint64
        lib.swfp_invalidate.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.swfp_invalidate.restype = ctypes.c_int
        lib.swfp_invalidate_prefix.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.swfp_invalidate_prefix.restype = ctypes.c_int
        lib.swfp_stats.argtypes = [ctypes.c_int] + \
            [ctypes.POINTER(ctypes.c_uint64)] * 4
        lib.swfp_stats.restype = ctypes.c_int
        lib.swfp_disable_log.argtypes = [ctypes.c_int]
        lib.swfp_disable_log.restype = ctypes.c_int
        _lib = lib
        return _lib


def bench_loop(addr: str, fids: list[str], payload: bytes | None,
               lat_out=None) -> int:
    """Run the native keepalive PUT/GET loop over `fids` against addr
    ("host:port"). payload=None means GET. Returns the 2xx count; fills
    lat_out (ctypes int64 array) with per-request ns latencies. Releases
    the GIL for the whole loop."""
    lib = load_library()
    host, _, port = addr.partition(":")
    arr = (ctypes.c_char_p * len(fids))(*[f.encode() for f in fids])
    if payload is None:
        body, blen, is_put = None, 0, 0
    else:
        body = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
        blen, is_put = len(payload), 1
    ok = lib.swdp_bench(host.encode(), int(port), is_put, arr, len(fids),
                        body, blen, lat_out)
    if ok < 0:
        raise IOError(f"bench loop vs {addr}: errno {-ok}")
    return int(ok)


def native_available() -> bool:
    try:
        load_library()
        return True
    except OSError:  # NativeBuildError: no g++, a failed build or load
        return False


class NativeDataPlane:
    """One C++ HTTP plane instance (multiple may coexist per process)."""

    def __init__(self, bind_ip: str, port: int, redirect_port: int,
                 nthreads: int = 8):
        self.lib = load_library()
        self.port = port
        self.redirect_port = redirect_port
        self.plane_id = self.lib.swdp_start(bind_ip.encode(), port,
                                            redirect_port, nthreads)
        if self.plane_id <= 0:
            raise OSError(
                f"native data plane failed to start: {self.plane_id}")
        # zero-copy serving gate: SWFS_ZEROCOPY=0 disables the sendfile
        # path; any other integer is the minimum body size that rides it
        # (default 4096 — below that, one pread beats two preads +
        # sendfile)
        zc = os.environ.get("SWFS_ZEROCOPY", "")
        if zc.lower() in ("0", "false", "off"):
            self.lib.swdp_set_zerocopy_min(self.plane_id, -1)
        elif zc.isdigit() and int(zc) > 1:
            self.lib.swdp_set_zerocopy_min(self.plane_id, int(zc))

    def stop(self) -> None:
        if self.plane_id > 0:
            self.lib.swdp_stop(self.plane_id)
            self.plane_id = 0

    # -- volume registry ---------------------------------------------------

    def add_volume(self, vid: int, dat_path: str, idx_path: str,
                   version: int, writable: bool) -> None:
        rc = self.lib.swdp_add_volume(self.plane_id, vid, dat_path.encode(),
                                      idx_path.encode(), version,
                                      1 if writable else 0)
        if rc != 0:
            raise OSError(f"add_volume {vid}: {rc}")

    def remove_volume(self, vid: int) -> None:
        self.lib.swdp_remove_volume(self.plane_id, vid)

    def reload_volume(self, vid: int) -> bool:
        """Reopen a volume's files after an external swap (vacuum
        commit). On failure the C++ side already dropped its handles and
        map; remove the volume from the plane too (requests 307 to
        python, which is correct, instead of 404ing on a cleared map)
        and report False so the caller detaches."""
        rc = self.lib.swdp_reload_volume(self.plane_id, vid)
        if rc >= 0:
            return True
        from ..utils import glog

        self.lib.swdp_remove_volume(self.plane_id, vid)
        glog.error(f"native plane reload of volume {vid} failed "
                   f"(errno {-rc}); volume served by python")
        return False

    def set_writable(self, vid: int, writable: bool) -> None:
        self.lib.swdp_set_writable(self.plane_id, vid, 1 if writable else 0)

    # -- mutation funnel ---------------------------------------------------

    def append_record(self, vid: int, key: int, blob: bytes, idx_size: int,
                      ns_off: int) -> tuple[int, int]:
        """Append a prebuilt record; C++ stamps appendAtNs at ns_off.
        -> (byte_offset, append_at_ns)."""
        buf = (ctypes.c_uint8 * len(blob)).from_buffer_copy(blob)
        ns = ctypes.c_uint64(0)
        off = self.lib.swdp_append_record(self.plane_id, vid, key, buf,
                                          len(blob), idx_size, ns_off,
                                          ctypes.byref(ns))
        if off < 0:
            raise IOError(f"native append vid={vid}: errno {-off}")
        return int(off), int(ns.value)

    def read_blob(self, vid: int, key: int) -> bytes | None:
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = self.lib.swdp_read(self.plane_id, vid, key, ctypes.byref(out))
        if n < 0:
            raise IOError(f"native read vid={vid}: errno {-n}")
        if n == 0:
            return None
        try:
            return ctypes.string_at(out, n)
        finally:
            self.lib.swdp_free(out)

    def volume_stats(self, vid: int) -> dict | None:
        fc, fb, dc, db = (ctypes.c_int64() for _ in range(4))
        mk = ctypes.c_uint64()
        ds = ctypes.c_int64()
        rc = self.lib.swdp_volume_stats(
            self.plane_id, vid, ctypes.byref(fc), ctypes.byref(fb),
            ctypes.byref(dc), ctypes.byref(db), ctypes.byref(mk),
            ctypes.byref(ds))
        if rc != 0:
            return None
        return {"file_count": fc.value, "file_bytes": fb.value,
                "del_count": dc.value, "del_bytes": db.value,
                "max_key": mk.value, "dat_size": ds.value}

    def request_count(self) -> int:
        return int(self.lib.swdp_request_count(self.plane_id))

    def sendfile_count(self) -> int:
        """GETs served zero-copy via sendfile(2) since plane start."""
        return int(self.lib.swdp_sendfile_count(self.plane_id))

    def set_zerocopy_min(self, min_bytes: int) -> None:
        """Minimum body size for the sendfile path; -1 disables it."""
        self.lib.swdp_set_zerocopy_min(self.plane_id, min_bytes)


class NativeFilerPlane:
    """C++ filer hot plane: whole-object PUT/GET under `prefix` served
    straight off a co-located volume plane's registry; everything else
    307s to the python filer at redirect_port. Entry metadata lands in
    `log_path`, which FilerServer absorbs into the real store."""

    def __init__(self, bind_ip: str, port: int, redirect_port: int,
                 volume_plane_id: int, log_path: str,
                 prefix: str = "/buckets/", max_body: int = 4 << 20):
        self.lib = load_library()
        self.port = port
        self.redirect_port = redirect_port
        self.log_path = log_path
        self.prefix = prefix
        self.plane_id = self.lib.swfp_start(
            bind_ip.encode(), port, redirect_port, volume_plane_id,
            log_path.encode(), prefix.encode(), max_body)
        if self.plane_id <= 0:
            raise OSError(
                f"native filer plane failed to start: {self.plane_id}")

    def stop(self) -> None:
        if self.plane_id > 0:
            self.lib.swfp_stop(self.plane_id)
            self.plane_id = 0

    def add_lease(self, vid: int, base_key: int, cookie: int,
                  count: int) -> None:
        rc = self.lib.swfp_add_lease(self.plane_id, vid, base_key, cookie,
                                     count)
        if rc != 0:
            raise OSError(f"add_lease: {rc}")

    def lease_remaining(self) -> int:
        return int(self.lib.swfp_lease_remaining(self.plane_id))

    def disable_log(self) -> None:
        """Stop acking native PUTs (redirect them to python) — used when
        the absorber can no longer make hot-log metadata durable."""
        self.lib.swfp_disable_log(self.plane_id)

    def invalidate(self, path: str) -> None:
        self.lib.swfp_invalidate(self.plane_id, path.encode())

    def invalidate_prefix(self, path: str) -> None:
        self.lib.swfp_invalidate_prefix(self.plane_id, path.encode())

    def stats(self) -> dict:
        vals = [ctypes.c_uint64() for _ in range(4)]
        self.lib.swfp_stats(self.plane_id, *(ctypes.byref(v) for v in vals))
        return {"requests": vals[0].value, "native_puts": vals[1].value,
                "native_gets": vals[2].value, "redirects": vals[3].value}
