"""Volume/needle TTL: 2-byte (count, unit) codec.

Wire-compatible with SeaweedFS weed/storage/needle/volume_ttl.go:
units minute(1)/hour(2)/day(3)/week(4)/month(5)/year(6), readable strings
like "3m", "4h"; bare digits imply minutes.
"""

from __future__ import annotations

from dataclasses import dataclass

EMPTY, MINUTE, HOUR, DAY, WEEK, MONTH, YEAR = range(7)

_UNIT_FROM_CHAR = {"m": MINUTE, "h": HOUR, "d": DAY, "w": WEEK, "M": MONTH, "y": YEAR}
_CHAR_FROM_UNIT = {v: k for k, v in _UNIT_FROM_CHAR.items()}
_UNIT_MINUTES = {
    MINUTE: 1,
    HOUR: 60,
    DAY: 24 * 60,
    WEEK: 7 * 24 * 60,
    MONTH: 31 * 24 * 60,
    YEAR: 365 * 24 * 60,
}


@dataclass(frozen=True)
class TTL:
    count: int = 0
    unit: int = EMPTY

    @classmethod
    def parse(cls, s: str) -> "TTL":
        """ReadTTL: "3m"/"4h"/"5d"/"6w"/"7M"/"8y"; bare number = minutes."""
        if not s:
            return EMPTY_TTL
        unit_ch, count_s = s[-1], s[:-1]
        if unit_ch.isdigit():
            unit_ch, count_s = "m", s
        if unit_ch not in _UNIT_FROM_CHAR:
            raise ValueError(f"unknown ttl unit in {s!r}")
        return cls(int(count_s), _UNIT_FROM_CHAR[unit_ch])

    @classmethod
    def from_bytes(cls, b: bytes) -> "TTL":
        if b[0] == 0 and b[1] == 0:
            return EMPTY_TTL
        return cls(b[0], b[1])

    @classmethod
    def from_uint32(cls, v: int) -> "TTL":
        return cls.from_bytes(bytes([(v >> 8) & 0xFF, v & 0xFF]))

    def to_bytes(self) -> bytes:
        return bytes([self.count & 0xFF, self.unit & 0xFF])

    def to_uint32(self) -> int:
        if self.count == 0:
            return 0
        return ((self.count & 0xFF) << 8) | (self.unit & 0xFF)

    @property
    def minutes(self) -> int:
        if self.count == 0 or self.unit == EMPTY:
            return 0
        return self.count * _UNIT_MINUTES[self.unit]

    def __str__(self) -> str:
        if self.count == 0 or self.unit == EMPTY:
            return ""
        return f"{self.count}{_CHAR_FROM_UNIT[self.unit]}"


EMPTY_TTL = TTL()
