"""On-read image transforms: resize/crop + EXIF orientation fix.

Counterpart of seaweedfs_tpu/images/__init__.py (SeaweedFS weed/images/:
resizing.go `Resized`, hooked in
volume_server_handlers_read.go:294; orientation.go). PIL replaces Go's
image packages; absent PIL the functions pass bytes through untouched.
"""

from __future__ import annotations

import io

try:
    from PIL import Image, ImageOps

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False


IMAGE_MIMES = {"image/jpeg", "image/png", "image/gif", "image/webp"}


def is_image(mime: str, name: str = "") -> bool:
    if mime in IMAGE_MIMES:
        return True
    return name.lower().endswith((".jpg", ".jpeg", ".png", ".gif", ".webp"))


def fix_jpg_orientation(data: bytes) -> bytes:
    """Apply the EXIF orientation tag and strip it (orientation.go)."""
    if not _HAS_PIL:
        return data
    try:
        img = Image.open(io.BytesIO(data))
        if img.format != "JPEG":
            return data
        fixed = ImageOps.exif_transpose(img)
        if fixed is img:
            return data
        out = io.BytesIO()
        fixed.save(out, format="JPEG", quality=95)
        return out.getvalue()
    # lint: allow-broad-except(an image PIL cannot fix is served as
    # stored: a read never fails over EXIF)
    except Exception:  # noqa: BLE001 - never fail a read over EXIF
        return data


def resized(data: bytes, width: int = 0, height: int = 0,
            mode: str = "") -> tuple[bytes, int, int]:
    """Resize/crop on read (resizing.go Resized):
    mode "" = proportional fit, "fit" = letterboxed fit, "fill" = center crop.
    -> (bytes, w, h); passthrough when no resize applies."""
    if not _HAS_PIL or (not width and not height):
        return data, width, height
    try:
        img = Image.open(io.BytesIO(data))
        fmt = img.format or "PNG"
        ow, oh = img.size
        if width == 0:
            width = ow * height // oh
        if height == 0:
            height = oh * width // ow
        if mode == "fill":
            out_img = ImageOps.fit(img, (width, height))
        elif mode == "fit":
            out_img = ImageOps.pad(img.convert("RGB"), (width, height))
        else:
            img.thumbnail((width, height))
            out_img = img
        out = io.BytesIO()
        out_img.save(out, format=fmt)
        return out.getvalue(), out_img.width, out_img.height
    # lint: allow-broad-except(bytes PIL cannot resize are served as
    # stored, as resizing.go does)
    except Exception:  # noqa: BLE001
        return data, width, height
