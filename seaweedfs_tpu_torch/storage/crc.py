"""CRC32-Castagnoli needle checksums.

The reference uses Go's hash/crc32 Castagnoli table
(SeaweedFS weed/storage/needle/crc.go:12) for every needle's data
checksum. google_crc32c provides the same polynomial (0x1EDC6F41,
hardware-accelerated); the native C++ kernel is the second choice, and a
pure-python slice-by-8 implementation keeps whole-volume scrub sweeps
usable even in stripped (crcmod-less, FUSE-less) containers — the old
byte-at-a-time table fallback made a background scrubber effectively
unable to keep up with even one volume.

Also here: `crc32c_combine`, the zlib-style GF(2) matrix combine that
merges CRCs of independently-checksummed chunks (crc(A||B) from crc(A),
crc(B), len(B)). The scrub plane's in-order syndrome sweep chains slab
CRCs with plain `crc32c(data, prev)` (cheaper); combine is the tool for
out-of-order or parallel verification folds (scrub/digest.py
`ec_shard_crcs(slab_crcs=...)`).
"""

from __future__ import annotations

import threading

_POLY = 0x82F63B78  # reversed 0x1EDC6F41 (Castagnoli)


def _make_tables(n: int = 8) -> list[list[int]]:
    """Slice-by-N lookup tables. t[0] is the classic byte table; t[k]
    advances a byte seen k positions earlier through k extra zero bytes."""
    t0 = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        t0.append(c)
    tables = [t0]
    for _ in range(1, n):
        prev = tables[-1]
        tables.append([t0[v & 0xFF] ^ (v >> 8) for v in prev])
    return tables


_T = _make_tables()


def crc32c_py(data: bytes, value: int = 0) -> int:
    """Pure-python slice-by-8 CRC32C (incremental: pass the previous value
    to extend, exactly like google_crc32c.extend)."""
    t0, t1, t2, t3, t4, t5, t6, t7 = _T
    crc = (value & 0xFFFFFFFF) ^ 0xFFFFFFFF
    b = bytes(data)
    n = len(b)
    i = 0
    # 8 bytes per iteration: fold the current CRC into the first word
    end8 = n - (n % 8)
    while i < end8:
        w = int.from_bytes(b[i:i + 8], "little") ^ crc
        crc = (t7[w & 0xFF]
               ^ t6[(w >> 8) & 0xFF]
               ^ t5[(w >> 16) & 0xFF]
               ^ t4[(w >> 24) & 0xFF]
               ^ t3[(w >> 32) & 0xFF]
               ^ t2[(w >> 40) & 0xFF]
               ^ t1[(w >> 48) & 0xFF]
               ^ t0[(w >> 56) & 0xFF])
        i += 8
    while i < n:
        crc = t0[(crc ^ b[i]) & 0xFF] ^ (crc >> 8)
        i += 1
    return crc ^ 0xFFFFFFFF


try:
    import google_crc32c

    def crc32c(data: bytes, value: int = 0) -> int:
        return google_crc32c.extend(value, bytes(data))

    def implementation() -> str:
        """The kernel `crc32c` runs: "google_crc32c", "native" or
        "python"."""
        return "google_crc32c"
except ImportError:
    try:  # native C++ slice-by-8 kernel (ops/native/crc32c.cpp)
        import subprocess

        from ..ops import rs_native

        # the library builds with g++ at the first call; if that build
        # fails, every call runs the pure-python kernel instead
        _impl = None
        _impl_name = "native"

        def _choose():
            global _impl, _impl_name
            try:
                rs_native.load_library()
                _impl = rs_native.crc32c_native
            except (OSError, subprocess.CalledProcessError):
                _impl, _impl_name = crc32c_py, "python"
            return _impl

        def crc32c(data: bytes, value: int = 0) -> int:
            return (_impl or _choose())(data, value)

        def implementation() -> str:
            """The kernel `crc32c` runs: "google_crc32c", "native" or
            "python" (builds the native library if it is not yet built)."""
            if _impl is None:
                _choose()
            return _impl_name
    # lint: allow-broad-except(import-time capability probe; stripped
    # environments fall back to the pure-python kernel)
    except Exception:  # pragma: no cover - fallback for stripped environments
        crc32c = crc32c_py

        def implementation() -> str:
            """The kernel `crc32c` runs: "google_crc32c", "native" or
            "python"."""
            return "python"


# -- combine (zlib crc32_combine ported to the Castagnoli polynomial) -------

def _gf2_matrix_times(mat: list[int], vec: int) -> int:
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_matrix_square(mat: list[int]) -> list[int]:
    return [_gf2_matrix_times(mat, mat[n]) for n in range(32)]


# byte-granular zero operators: _BYTE_POWS[k] advances a CRC through
# 2^k zero BYTES; extended lazily, shared by every combine call. On top,
# _SHIFT_CACHE memoizes the composed operator per len2 — the streaming
# EC plane folds thousands of same-sized slab CRCs (1MB slabs, 64KB
# small rows), so after the first fold each combine is one 32-row
# matrix-vector apply instead of ~log(len2) matrix squarings.
_BYTE_POWS: list[list[int]] = []
_SHIFT_CACHE: dict[int, list[int]] = {}
_SHIFT_CACHE_MAX = 1024  # distinct slab lengths in flight is tiny
# cache builds are guarded: concurrent folders (per-destination stream
# threads, the scrub daemon) racing a cold _BYTE_POWS append could land
# a power matrix at the wrong index and corrupt every later fold
_COMBINE_MU = threading.Lock()


def _matrix_mult(a: list[int], b: list[int]) -> list[int]:
    """Composition a∘b (apply b, then a) over GF(2) column vectors."""
    return [_gf2_matrix_times(a, col) for col in b]


def _byte_pow_locked(k: int) -> list[int]:
    """_COMBINE_MU must be held."""
    while len(_BYTE_POWS) <= k:
        if not _BYTE_POWS:
            # one zero BYTE = the one-zero-bit operator squared 3 times
            m = [_POLY] + [1 << (n - 1) for n in range(1, 32)]
            for _ in range(3):
                m = _gf2_matrix_square(m)
            _BYTE_POWS.append(m)
        else:
            _BYTE_POWS.append(_gf2_matrix_square(_BYTE_POWS[-1]))
    return _BYTE_POWS[k]


def _zero_shift_matrix(len2: int) -> list[int]:
    """Operator advancing a CRC through len2 zero bytes, memoized."""
    m = _SHIFT_CACHE.get(len2)  # atomic dict read; values are immutable
    if m is not None:
        return m
    with _COMBINE_MU:
        m = _SHIFT_CACHE.get(len2)
        if m is not None:
            return m
        out: list[int] | None = None
        k = 0
        rest = len2
        while rest:
            if rest & 1:
                p = _byte_pow_locked(k)
                out = p if out is None else _matrix_mult(p, out)
            rest >>= 1
            k += 1
        assert out is not None
        if len(_SHIFT_CACHE) >= _SHIFT_CACHE_MAX:
            _SHIFT_CACHE.clear()  # pathological length spread: start over
        _SHIFT_CACHE[len2] = out
        return out


def crc32c_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc(A || B) from crc1=crc(A), crc2=crc(B), len2=len(B).

    Lets the scrubber checksum slabs independently (even out of order)
    and fold them into a whole-file digest with no re-read — O(32^2)
    per fold once len2's zero-shift operator is cached (first fold of a
    new length pays O(32^2 log len2) to build it). Identity:
    combine(c, crc(b""), 0) == c."""
    if len2 <= 0:
        return crc1 & 0xFFFFFFFF
    m = _zero_shift_matrix(len2)
    return (_gf2_matrix_times(m, crc1 & 0xFFFFFFFF) ^ crc2) & 0xFFFFFFFF


def crc_value_legacy(crc: int) -> int:
    """The deprecated CRC.Value() transform (crc.go:25-27); read-side accepts
    either this or the raw value for backward compatibility."""
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF
