"""File id codec: "volumeId,needleHexCookieHex" (e.g. "3,01637037d6").

Wire/format-compatible with SeaweedFS weed/storage/needle/file_id.go:
the needle-id+cookie hex is the 12-byte big-endian concatenation with the
id's leading zero BYTES (not nibbles) trimmed; the cookie always keeps its
8 hex chars.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FileId:
    volume_id: int
    key: int  # needle id
    cookie: int

    def __str__(self) -> str:
        return f"{self.volume_id},{format_needle_id_cookie(self.key, self.cookie)}"

    @property
    def needle_id_cookie(self) -> str:
        return format_needle_id_cookie(self.key, self.cookie)


def format_needle_id_cookie(key: int, cookie: int) -> str:
    b = key.to_bytes(8, "big") + cookie.to_bytes(4, "big")
    i = 0
    while i < 8 and b[i] == 0:
        i += 1
    return b[i:].hex()


def parse_needle_id_cookie(s: str) -> tuple[int, int]:
    """-> (needle_id, cookie). The last 8 hex chars are the cookie, the rest
    the id (ParseNeedleIdCookie, needle.go:153-170). A "_delta" suffix is
    added to the id (ParsePath, needle.go:117-142); extensions after '.' are
    stripped."""
    dot = s.find(".")
    if dot >= 0:
        s = s[:dot]
    delta = 0
    if "_" in s:
        s, delta_s = s.rsplit("_", 1)
        delta = int(delta_s)
    if len(s) <= 8:
        raise ValueError(f"key-cookie too short: {s!r}")
    if len(s) > 24:
        raise ValueError(f"key-cookie too long: {s!r}")
    split = len(s) - 8
    return int(s[:split], 16) + delta, int(s[split:], 16)


def parse_file_id(fid: str) -> FileId:
    comma = fid.find(",")
    if comma <= 0:
        raise ValueError(f"wrong fid format {fid!r}")
    vid = int(fid[:comma])
    key, cookie = parse_needle_id_cookie(fid[comma + 1 :])
    return FileId(vid, key, cookie)
