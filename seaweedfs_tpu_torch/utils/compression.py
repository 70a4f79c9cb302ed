"""Gzip/zstd payload compression (counterpart of
seaweedfs_tpu/utils/compression.py; SeaweedFS weed/util/compression.go —
IsGzippable heuristics, MaybeGzipData/MaybeDecompressData)."""

from __future__ import annotations

import gzip

try:
    import zstandard as _zstd

    _ZC = _zstd.ZstdCompressor(level=3)
    _ZD = _zstd.ZstdDecompressor()
except ImportError:  # pragma: no cover
    _zstd = None

_GZIP_MAGIC = b"\x1f\x8b"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

_UNCOMPRESSIBLE_EXT = {
    ".zip", ".gz", ".tgz", ".bz2", ".xz", ".zst", ".rar", ".7z",
    ".jpg", ".jpeg", ".png", ".gif", ".webp", ".mp3", ".mp4", ".mov",
    ".avi", ".mkv", ".ogg", ".aac", ".woff", ".woff2",
}


def is_gzippable(ext: str = "", mime: str = "") -> bool:
    """IsGzippable heuristic (compression.go)."""
    if ext.lower() in _UNCOMPRESSIBLE_EXT:
        return False
    if mime:
        if mime.startswith(("text/", "application/json", "application/xml",
                            "application/javascript")):
            return True
        if mime.startswith(("image/", "video/", "audio/")):
            return False
    return True


def gzip_data(data: bytes, level: int = 3) -> bytes:
    return gzip.compress(data, level)


def gunzip_data(data: bytes) -> bytes:
    return gzip.decompress(data)


def zstd_data(data: bytes) -> bytes:
    if _zstd is None:
        raise RuntimeError("zstandard not available")
    return _ZC.compress(data)


def unzstd_data(data: bytes) -> bytes:
    if _zstd is None:
        raise RuntimeError("zstandard not available")
    return _ZD.decompress(data)


def maybe_decompress(data: bytes) -> bytes:
    """Sniff magic and decompress if recognized (MaybeDecompressData)."""
    if data[:2] == _GZIP_MAGIC:
        try:
            return gunzip_data(data)
        except OSError:
            return data
    if data[:4] == _ZSTD_MAGIC and _zstd is not None:
        try:
            return unzstd_data(data)
        except _zstd.ZstdError:
            return data
    return data
