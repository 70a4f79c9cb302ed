"""Seeded SeaweedFS volumes and EC shard layouts.

A volume is a `.dat` of exactly the size asked: an 8-byte version-3
superblock, then needle records of 1-64 KiB, each padded as SeaweedFS pads
them (header 16 B, data, checksum 4 B, timestamp 8 B, then 1-8 B to the
next multiple of 8), and its `.idx` of 16-byte big-endian entries (id,
offset / 8, size). Record bytes are random: the encode reads the `.dat`
as bytes, so headers and checksums change no work.

Every seed gets the same multiset of needle sizes (drawn from a constant
seed) in an order of its own, and so the same number of needles and the
same `.dat` size: the seed changes the bytes and the order, not the work.
Bytes come from a `torch.Generator` on the device, one call per volume.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

HEADER = 16  # cookie 4, id 8, size 4
TAIL = 4 + 8  # checksum, version-3 timestamp
PAD = 8
MAX_NEEDLE = 64 * 1024
SIZES_SEED = 20260613  # the fixed multiset of needle sizes


def record_size(size: int) -> int:
    """Bytes a needle of `size` data bytes takes in the `.dat`."""
    body = HEADER + size + TAIL
    return body + PAD - body % PAD


def seed_of(seed: int, *parts: int) -> int:
    """A 64-bit seed for one stream of the run seeded by `seed`."""
    seq = np.random.SeedSequence([seed % (1 << 64), *parts])
    return int(seq.generate_state(1, np.uint64)[0])


@functools.lru_cache(maxsize=8)
def needle_sizes(dat_bytes: int) -> tuple[int, ...]:
    """The data sizes of the needles that fill a `.dat` of `dat_bytes`
    after its superblock: sizes of 1-64 KiB, and a last one that fills
    the rest exactly."""
    if dat_bytes % PAD or dat_bytes < 8 + 64:
        raise ValueError(f"volume of {dat_bytes} B: want a multiple of 8 "
                         f"that holds a few needles")
    rng = np.random.default_rng(SIZES_SEED)
    left = dat_bytes - 8
    sizes = []
    while left >= record_size(MAX_NEEDLE) + 64:
        s = int(rng.integers(1, MAX_NEEDLE + 1))
        sizes.append(s)
        left -= record_size(s)
    # a size s with body % 8 == 0 takes s + 36 bytes (8 of padding)
    sizes.append(left - HEADER - TAIL - PAD)
    assert sum(record_size(s) for s in sizes) == dat_bytes - 8
    return tuple(sizes)


def random_bytes(n: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(0, 256, (n,), dtype=torch.uint8, device=device,
                         generator=g)


def dat_image(dat_bytes: int, seed: int, device) -> np.ndarray:
    """The `.dat` bytes of the volume seeded by `seed` (host array)."""
    img = random_bytes(dat_bytes, seed, device).cpu().numpy()
    img[:8] = np.frombuffer(b"\x03" + bytes(7), np.uint8)
    return img


def index_bytes(dat_bytes: int, seed: int) -> bytes:
    """The `.idx` of the volume: the fixed sizes in this seed's order,
    needle ids a permutation of 1..N."""
    sizes = np.array(needle_sizes(dat_bytes), np.int64)
    rng = np.random.default_rng(seed_of(seed, 1))
    sizes = sizes[rng.permutation(len(sizes))]
    records = sizes + HEADER + TAIL
    records += PAD - records % PAD
    offsets = 8 + np.concatenate([[0], np.cumsum(records)[:-1]])
    ids = rng.permutation(len(sizes)).astype(np.uint64) + 1
    out = np.zeros((len(sizes), 16), np.uint8)
    out[:, 0:8] = ids.astype(">u8").view(np.uint8).reshape(-1, 8)
    out[:, 8:12] = (offsets // PAD).astype(">u4").view(np.uint8).reshape(-1, 4)
    out[:, 12:16] = sizes.astype(">u4").view(np.uint8).reshape(-1, 4)
    return out.tobytes()


def write_volume(base: str, dat_bytes: int, seed: int, device) -> None:
    """`<base>.dat` and `<base>.idx` of the volume seeded by `seed`."""
    dat_image(dat_bytes, seed, device).tofile(base + ".dat")
    with open(base + ".idx", "wb") as f:
        f.write(index_bytes(dat_bytes, seed))


# -- the shard layout of SeaweedFS's encoder (ec_encoder.go) ---------------


def rows(k: int, large: int, small: int, dat_bytes: int) -> list[int]:
    """Block size of each row the encoder walks: large rows while more
    than a large row is left (a strict >), then small rows."""
    out = []
    left = dat_bytes
    while left > large * k:
        out.append(large)
        left -= large * k
    while left > 0:
        out.append(small)
        left -= small * k
    return out


def data_shards(img: np.ndarray, k: int, large: int,
                small: int) -> np.ndarray:
    """[k, shard bytes] data shards of a `.dat` image, zero past its end:
    row r's block i of shard i is the `.dat`'s bytes at the row's start
    plus i blocks."""
    blocks = rows(k, large, small, len(img))
    out = np.zeros((k, sum(blocks)), np.uint8)
    at = 0  # .dat offset of the row
    col = 0  # shard offset of the row
    for b in blocks:
        for i in range(k):
            lo = min(at + i * b, len(img))
            hi = min(at + (i + 1) * b, len(img))
            out[i, col:col + hi - lo] = img[lo:hi]
        at += b * k
        col += b
    return out


def dat_bytes_in(k: int, large: int, small: int, dat_bytes: int,
                 shard_off: int, nbytes: int) -> int:
    """`.dat` bytes in the slab at `shard_off` of `nbytes` per shard (a
    slab never spans rows: the encoder splits within a row)."""
    at = 0
    col = 0
    for b in rows(k, large, small, dat_bytes):
        if col <= shard_off < col + b:
            inner = shard_off - col
            return sum(max(0, min(at + i * b + inner + nbytes, dat_bytes)
                           - min(at + i * b + inner, dat_bytes))
                       for i in range(k))
        at += b * k
        col += b
    raise ValueError(f"slab at shard offset {shard_off} is past the shards")

