"""Minimal BSON codec for the mongodb wire client (mongo_wire.py).

Covers the element types the filer store exchanges with a server:
document (0x03), array (0x04), string (0x02), binary (0x05, subtype
generic), double (0x01), bool (0x08), null (0x0A), int32 (0x10), int64
(0x12), plus decode-only ObjectId (0x07), UTC datetime (0x09),
timestamp (0x11), regex (0x0B) and decimal128 (0x13, surfaced as raw
bytes) so server replies never desync the parser. Dicts preserve
insertion order, which BSON requires for commands.
"""

from __future__ import annotations

import struct


class Regex:
    """BSON regular expression (type 0x0B) — used in query filters."""

    def __init__(self, pattern: str, options: str = ""):
        self.pattern = pattern
        self.options = options

    def __repr__(self) -> str:
        return f"Regex({self.pattern!r}, {self.options!r})"


class Int64(int):
    """Force BSON int64 (0x12) even for small values — required where
    the server type-checks 'long' (e.g. getMore cursor ids)."""


def _cstring(s: str) -> bytes:
    b = s.encode("utf-8")
    if b"\x00" in b:
        raise ValueError("BSON cstring cannot contain NUL")
    return b + b"\x00"


def _encode_value(name: str, v) -> bytes:
    key = _cstring(name)
    if isinstance(v, bool):          # before int: bool is an int subclass
        return b"\x08" + key + (b"\x01" if v else b"\x00")
    if isinstance(v, Int64):
        return b"\x12" + key + struct.pack("<q", v)
    if isinstance(v, int):
        if -(1 << 31) <= v < 1 << 31:
            return b"\x10" + key + struct.pack("<i", v)
        return b"\x12" + key + struct.pack("<q", v)
    if isinstance(v, float):
        return b"\x01" + key + struct.pack("<d", v)
    if isinstance(v, str):
        raw = v.encode("utf-8")
        return b"\x02" + key + struct.pack("<i", len(raw) + 1) + raw + b"\x00"
    if isinstance(v, (bytes, bytearray, memoryview)):
        raw = bytes(v)
        return b"\x05" + key + struct.pack("<i", len(raw)) + b"\x00" + raw
    if v is None:
        return b"\x0a" + key
    if isinstance(v, Regex):
        return b"\x0b" + key + _cstring(v.pattern) + _cstring(v.options)
    if isinstance(v, dict):
        return b"\x03" + key + encode_doc(v)
    if isinstance(v, (list, tuple)):
        return b"\x04" + key + encode_doc(
            {str(i): item for i, item in enumerate(v)})
    raise TypeError(f"cannot BSON-encode {type(v).__name__}")


def encode_doc(doc: dict) -> bytes:
    body = b"".join(_encode_value(k, v) for k, v in doc.items())
    return struct.pack("<i", len(body) + 5) + body + b"\x00"


def _read_cstring(buf: bytes, off: int) -> tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("utf-8"), end + 1


def _decode_value(t: int, buf: bytes, off: int):
    if t == 0x01:
        return struct.unpack_from("<d", buf, off)[0], off + 8
    if t == 0x02:
        (n,) = struct.unpack_from("<i", buf, off)
        s = buf[off + 4:off + 4 + n - 1].decode("utf-8", "replace")
        return s, off + 4 + n
    if t in (0x03, 0x04):
        doc, off2 = decode_doc(buf, off)
        if t == 0x04:
            return [doc[k] for k in doc], off2
        return doc, off2
    if t == 0x05:
        (n,) = struct.unpack_from("<i", buf, off)
        return bytes(buf[off + 5:off + 5 + n]), off + 5 + n
    if t == 0x07:                    # ObjectId
        return bytes(buf[off:off + 12]), off + 12
    if t == 0x08:
        return buf[off] != 0, off + 1
    if t in (0x09, 0x12):            # UTC datetime / int64
        return struct.unpack_from("<q", buf, off)[0], off + 8
    if t == 0x0a:
        return None, off
    if t == 0x0b:
        pat, off = _read_cstring(buf, off)
        opts, off = _read_cstring(buf, off)
        return Regex(pat, opts), off
    if t == 0x10:
        return struct.unpack_from("<i", buf, off)[0], off + 4
    if t == 0x11:                    # timestamp
        return struct.unpack_from("<Q", buf, off)[0], off + 8
    if t == 0x13:                    # decimal128 — raw
        return bytes(buf[off:off + 16]), off + 16
    raise ValueError(f"unsupported BSON type 0x{t:02x}")


def decode_doc(buf: bytes, off: int = 0) -> tuple[dict, int]:
    (total,) = struct.unpack_from("<i", buf, off)
    end = off + total
    off += 4
    out: dict = {}
    while off < end - 1:
        t = buf[off]
        name, off = _read_cstring(buf, off + 1)
        out[name], off = _decode_value(t, buf, off)
    return out, end
