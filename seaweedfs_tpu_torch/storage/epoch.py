"""Per-needle causality: replica-epoch tags.

Anti-entropy's ordering rules (tombstone-wins, newest-`append_at_ns`-wins)
leave exactly one divergence class a machine cannot settle: two live
copies of the same needle with EQUAL append timestamps and different
bytes. Wall clocks cannot manufacture causality after the fact, so each
server stamps every needle it accepts with a **replica-epoch tag**:

    (incarnation, sequence, server)

* ``incarnation`` — a per-store counter persisted in
  ``.swfs_incarnation`` and bumped once per process start, so tags from
  a restarted server can never collide with its pre-crash ones even
  though the in-memory sequence resets.
* ``sequence``    — a per-volume write counter within this incarnation.
* ``server``      — crc32c of the server identity (fixed width, so the
  SAME logical write stamped independently by N replicas lands records
  of identical size — the digest comparison below depends on that).

Together these give every tagged write a position in a total order that
both sides of a replica pair compute identically, which is what lets
`_heal_divergence` resolve a same-timestamp live-vs-live conflict
deterministically instead of surfacing it to an operator.

Wire/disk form: a fixed 28-byte block appended to the needle's `pairs`
extension (the existing v2/v3 optional body section — no format fork,
vacuum/replication/EC all carry it untouched):

    magic(8) = b"\\x00SWFSEP1"   incarnation(8 BE)   sequence(8 BE)
    server_crc(4 BE)

Because the block is fixed-width and `pairs` is the LAST body section,
the tag always occupies the final TAG_LEN bytes before the stored CRC —
one bounded pread recovers it without parsing the record (the digest
manifest builder reads tag + CRC in a single 32-byte pread).

Deliberately NOT part of the divergence signal: replicas stamp the same
logical write with different tags, so the rolling digest and the
(crc, size) diff comparison exclude the tag entirely (crc covers data
only; the fixed width keeps sizes equal). The tag exists to ORDER
conflicts, never to create them. Pre-epoch records (no tag) keep the
old fallback rules, so mixed old/new clusters converge on normal
traffic and only the genuinely unorderable legacy case still surfaces.
"""

from __future__ import annotations

import os
import threading

from ..utils import atomic_write
from .crc import crc32c

MAGIC = b"\x00SWFSEP1"
TAG_LEN = len(MAGIC) + 8 + 8 + 4  # 28
INCARNATION_FILE = ".swfs_incarnation"


def tags_enabled() -> bool:
    """SWFS_EPOCH_TAGS escape hatch (default on)."""
    return os.environ.get("SWFS_EPOCH_TAGS", "1").lower() not in (
        "0", "false", "off")


def encode_tag(incarnation: int, sequence: int, server_crc: int) -> bytes:
    return (MAGIC
            + (incarnation & (1 << 64) - 1).to_bytes(8, "big")
            + (sequence & (1 << 64) - 1).to_bytes(8, "big")
            + (server_crc & 0xFFFFFFFF).to_bytes(4, "big"))


def decode_tag_block(block: bytes) -> tuple[int, int, int] | None:
    """(incarnation, sequence, server_crc) from an exact TAG_LEN block,
    or None when the magic doesn't match (pre-epoch record)."""
    if len(block) != TAG_LEN or block[:len(MAGIC)] != MAGIC:
        return None
    m = len(MAGIC)
    return (int.from_bytes(block[m:m + 8], "big"),
            int.from_bytes(block[m + 8:m + 16], "big"),
            int.from_bytes(block[m + 16:m + 20], "big"))


def decode_pairs(pairs: bytes) -> tuple[int, int, int] | None:
    """Tag carried at the END of a needle's pairs bytes, if any."""
    if len(pairs) < TAG_LEN:
        return None
    return decode_tag_block(pairs[-TAG_LEN:])


def strip_pairs(pairs: bytes) -> bytes:
    """pairs without a trailing epoch tag (idempotent re-stamp support)."""
    if decode_pairs(pairs) is not None:
        return pairs[:-TAG_LEN]
    return pairs


def order_key(epoch: tuple[int, int, int] | None) -> tuple:
    """Total-order key for conflict resolution: any tagged write outranks
    an untagged (pre-epoch) one, then (incarnation, sequence, server).
    Both replicas compare the SAME two stored tags, so both compute the
    same winner — the property that makes convergence human-free."""
    if epoch is None:
        return (0, 0, 0, 0)
    return (1, *epoch)


class EpochStamper:
    """Per-store tag mint. The incarnation counter persists in the first
    volume directory (`.swfs_incarnation`, bumped at construction); the
    per-volume sequence lives on each Volume (reset per incarnation —
    uniqueness comes from the incarnation bump)."""

    def __init__(self, directory: str, server_id: str = ""):
        self.path = os.path.join(directory, INCARNATION_FILE)
        self._lock = threading.Lock()
        prev = 0
        try:
            with open(self.path) as f:
                prev = int(f.read().strip() or 0)
        except (OSError, ValueError):
            pass
        self.incarnation = prev + 1
        try:
            # atomic + fsync'd: a torn incarnation file would
            # reset the counter and let post-restart tags collide with
            # pre-crash ones — the exact ambiguity the counter exists
            # to remove
            atomic_write.write_text_atomic(
                self.path, str(self.incarnation))
        except OSError:
            pass  # best effort: a read-only disk still gets in-memory tags
        # fixed-width server identity; fall back to the directory path so
        # bare Stores (tests, offline tools) still order deterministically
        ident = server_id or os.path.abspath(directory)
        self.server_crc = crc32c(ident.encode())

    def tag_for(self, volume) -> bytes:
        """Mint the next tag for a write to `volume` (caller holds the
        volume lock — the per-volume sequence increments under it)."""
        volume.epoch_seq += 1
        return encode_tag(self.incarnation, volume.epoch_seq,
                          self.server_crc)
