"""Per-volume digest manifests for cross-replica anti-entropy.

A digest manifest is the sorted list of (needle_id, stored_crc, size)
triples for every live needle of a volume, plus tombstone entries
(size = -1) for ids whose latest index record is a deletion. Two replicas
that agree on the rolling CRC of this list hold byte-identical live
content — so anti-entropy ships ~16 bytes per needle instead of the
needle bytes themselves, and only diffs entry lists when the rolling
digests disagree.

The stored CRC is the checksum the WRITER committed (the 4 bytes after
the needle body on disk) — reading it costs one 4-byte pread per needle,
i.e. manifest construction is index-speed, not data-speed. Whether those
stored CRCs still match the data bytes is the scrubber's CRC sweep's job
(scrubber.py); the two passes together separate "replicas diverged"
(digests differ) from "disk rotted" (sweep finding).

Manifest file format, rev 2 (golden-pinned by the reference's scrub tests;
rev-1 manifests still parse — read_manifest dispatches on the magic):

    magic   8B  b"SWFSDG2\\n"
    count   8B  big-endian entry count
    entries 36B each, ascending needle id:
            id(8, BE) crc(4, BE) size(4, BE two's-complement)
            epoch_incarnation(8, BE) epoch_seq(8, BE) epoch_server(4, BE)

The epoch triple is the replica-epoch causality tag
(storage/epoch.py), all-zero for pre-epoch records. It is metadata for
CONFLICT RESOLUTION only: replicas stamp the same logical write with
different tags, so both the rolling digest and the divergence diff
exclude it (they fold/compare the 16-byte rev-1 projection) — otherwise
every converged pair would look divergent forever.

rolling_crc = crc32c over the concatenated rev-1 entry projections of
the LIVE entries (magic and count excluded, so the digest of an empty
volume is crc32c(b"") == 0).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..storage import types
from ..utils import atomic_write
from ..storage.crc import crc32c, crc32c_combine
from ..storage.epoch import TAG_LEN, decode_tag_block

MAGIC_V1 = b"SWFSDG1\n"
MAGIC = b"SWFSDG2\n"
ENTRY_SIZE_V1 = 16
ENTRY_SIZE = 36
TOMBSTONE_SIZE = -1


@dataclass(frozen=True)
class DigestEntry:
    needle_id: int
    crc: int
    size: int  # negative = tombstone
    epoch: tuple[int, int, int] | None = None  # (incarnation, seq, server)

    def to_bytes(self) -> bytes:
        """Rev-1 16-byte projection — the comparison/rolling-CRC form
        (epoch excluded by design, see module docstring)."""
        return (self.needle_id.to_bytes(8, "big")
                + (self.crc & 0xFFFFFFFF).to_bytes(4, "big")
                + (self.size & 0xFFFFFFFF).to_bytes(4, "big"))

    def to_bytes_v2(self) -> bytes:
        inc, seq, srv = self.epoch or (0, 0, 0)
        return (self.to_bytes()
                + (inc & (1 << 64) - 1).to_bytes(8, "big")
                + (seq & (1 << 64) - 1).to_bytes(8, "big")
                + (srv & 0xFFFFFFFF).to_bytes(4, "big"))

    @classmethod
    def from_bytes(cls, b: bytes) -> "DigestEntry":
        size = int.from_bytes(b[12:16], "big")
        if size >= 1 << 31:
            size -= 1 << 32
        epoch = None
        if len(b) >= ENTRY_SIZE:
            inc = int.from_bytes(b[16:24], "big")
            seq = int.from_bytes(b[24:32], "big")
            srv = int.from_bytes(b[32:36], "big")
            if inc or seq or srv:
                epoch = (inc, seq, srv)
        return cls(int.from_bytes(b[0:8], "big"),
                   int.from_bytes(b[8:12], "big"), size, epoch)


def volume_digest_entries(v) -> list[DigestEntry]:
    """Build the sorted entry list for a plain volume: live needles carry
    the stored CRC read from disk plus their replica-epoch tag (one
    bounded pread recovers both — the tag is the fixed-width suffix of
    the body, immediately before the CRC); tombstoned ids carry (0, -1)."""
    if v.native is not None:
        v.sync_native()  # absorb C++-plane appends first
    entries: list[DigestEntry] = []
    for key, nv in list(v.nm):
        if nv.offset == 0 or types.size_is_deleted(nv.size):
            continue
        off = types.stored_to_actual_offset(nv.offset)
        tail_off = off + types.NEEDLE_HEADER_SIZE + nv.size
        epoch = None
        if nv.size >= TAG_LEN:
            blob = v._pread_durable(tail_off - TAG_LEN,
                                    TAG_LEN + types.NEEDLE_CHECKSUM_SIZE)
            epoch = decode_tag_block(blob[:TAG_LEN]) \
                if len(blob) >= TAG_LEN else None
            crc_bytes = blob[TAG_LEN:TAG_LEN + 4]
        else:
            crc_bytes = v._pread_durable(tail_off,
                                         types.NEEDLE_CHECKSUM_SIZE)
        crc = int.from_bytes(crc_bytes, "big") if len(crc_bytes) == 4 else 0
        entries.append(DigestEntry(key, crc, nv.size, epoch))
    for key in set(v.nm.tombstones):
        entries.append(DigestEntry(key, 0, TOMBSTONE_SIZE))
    entries.sort(key=lambda e: e.needle_id)
    return entries


def rolling_digest(entries: list[DigestEntry]) -> int:
    """Rolling CRC over the LIVE entries only. Tombstones are excluded
    deliberately: they exist to stop a diff from resurrecting deleted
    needles, but two replicas that agree on every live needle while
    differing in deletion HISTORY (one vacuumed, one missed a delete of
    a needle it never had) are converged — folding tombstones into the
    cheap comparison would flag such pairs as divergent on every sweep,
    forever, with nothing to heal."""
    crc = 0
    for e in entries:
        if e.size >= 0:
            crc = crc32c(e.to_bytes(), crc)
    return crc


def manifest_bytes(entries: list[DigestEntry]) -> bytes:
    out = bytearray(MAGIC)
    out += len(entries).to_bytes(8, "big")
    for e in entries:
        out += e.to_bytes_v2()
    return bytes(out)


def write_manifest(base_file_name: str, entries: list[DigestEntry]) -> str:
    """Persist `<base>.dig` atomically; returns the path."""
    path = base_file_name + ".dig"
    atomic_write.write_file_atomic(path, manifest_bytes(entries))
    return path


def read_manifest(path: str) -> list[DigestEntry]:
    """Parse a rev-2 manifest — or a rev-1 one (pre-epoch `.dig`
    files keep parsing after an upgrade; their entries carry no epoch)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] == MAGIC:
        stride = ENTRY_SIZE
    elif blob[:8] == MAGIC_V1:
        stride = ENTRY_SIZE_V1
    else:
        raise IOError(f"{path}: not a digest manifest")
    count = int.from_bytes(blob[8:16], "big")
    body = blob[16:]
    if len(body) != count * stride:
        raise IOError(f"{path}: truncated manifest")
    return [DigestEntry.from_bytes(body[i * stride:(i + 1) * stride])
            for i in range(count)]


def diff_entries(mine: list[DigestEntry], theirs: list[DigestEntry]):
    """-> (only_mine, only_theirs, differing) where differing is a list of
    (my_entry, their_entry) pairs sharing an id but not (crc, size)."""
    m = {e.needle_id: e for e in mine}
    t = {e.needle_id: e for e in theirs}
    only_mine = [m[k] for k in sorted(m.keys() - t.keys())]
    only_theirs = [t[k] for k in sorted(t.keys() - m.keys())]
    differing = [(m[k], t[k]) for k in sorted(m.keys() & t.keys())
                 if (m[k].crc, m[k].size) != (t[k].crc, t[k].size)]
    return only_mine, only_theirs, differing


# -- EC volumes: per-shard whole-file digests -------------------------------

def ec_shard_crcs(ev, chunk: int = 1 << 20,
                  slab_crcs: dict[int, list[tuple[int, int]]] | None = None,
                  ) -> dict[int, "ShardCrc"]:
    """CRC32C + size of every locally-present shard file.

    When the EC syndrome sweep already checksummed slabs (it has the
    bytes in hand anyway), pass them as `slab_crcs[sid] = [(crc, nbytes),
    ...]` in file order: the whole-file digest is then folded together
    with crc32c_combine instead of re-reading the shards."""
    out: dict[int, ShardCrc] = {}
    for sid, f in sorted(ev.shard_files.items()):
        size = f.size()
        if slab_crcs is not None and sid in slab_crcs:
            crc = 0
            for c, n in slab_crcs[sid]:
                crc = crc32c_combine(crc, c, n)
            out[sid] = ShardCrc(sid, crc, size)
            continue
        crc = 0
        off = 0
        while off < size:
            data = f.read_at(off, min(chunk, size - off))
            if not data:
                break
            crc = crc32c(data, crc)
            off += len(data)
        out[sid] = ShardCrc(sid, crc, size)
    return out


@dataclass(frozen=True)
class ShardCrc:
    shard_id: int
    crc: int
    size: int


# EC shard-digest manifest (<base>.dig for an EC'd volume — a plain
# volume never coexists with shards under the same base once encoded,
# and the magic disambiguates). Written by the streaming-EC destination
# at commit time from digests it chained WHILE writing (no second read)
# and refreshed by syndrome sweeps; read back by
# Scrubber.cached_ec_digest so VolumeDigest answers from it.
#
# Format (golden-pinned by the reference's EC stream tests):
#     magic   8B  b"SWFSDGE\n"
#     count   8B  big-endian entry count
#     entries 16B each, ascending shard id:
#             shard_id(4, BE) crc(4, BE) size(8, BE)

EC_MAGIC = b"SWFSDGE\n"
EC_ENTRY_SIZE = 16


def write_ec_manifest(base_file_name: str,
                      shard_crcs: dict[int, ShardCrc]) -> str:
    """Persist `<base>.dig` (EC form) atomically; returns the path."""
    path = base_file_name + ".dig"
    blob = bytearray(EC_MAGIC)
    blob += len(shard_crcs).to_bytes(8, "big")
    for sid in sorted(shard_crcs):
        sc = shard_crcs[sid]
        blob += (sid.to_bytes(4, "big")
                 + (sc.crc & 0xFFFFFFFF).to_bytes(4, "big")
                 + sc.size.to_bytes(8, "big"))
    atomic_write.write_file_atomic(path, bytes(blob))
    return path


def read_ec_manifest(path: str) -> dict[int, ShardCrc]:
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != EC_MAGIC:
        raise IOError(f"{path}: not an EC shard-digest manifest")
    count = int.from_bytes(blob[8:16], "big")
    body = blob[16:]
    if len(body) != count * EC_ENTRY_SIZE:
        raise IOError(f"{path}: truncated EC manifest")
    out: dict[int, ShardCrc] = {}
    for i in range(count):
        e = body[i * EC_ENTRY_SIZE:(i + 1) * EC_ENTRY_SIZE]
        sid = int.from_bytes(e[0:4], "big")
        out[sid] = ShardCrc(sid, int.from_bytes(e[4:8], "big"),
                            int.from_bytes(e[8:16], "big"))
    return out
