"""Consistent-hash metadata ring: partition the filer namespace.

Counterpart of seaweedfs_tpu/cluster/metaring.py, byte for byte in its
layout: both packages assign every key to the same shard.

The fleet-scale metadata plane shards the filer keyspace on the PARENT
DIRECTORY of each entry: an entry lives on the shard that owns its
parent, so a single ListEntries is served entirely by one shard and a
directory's children can never straddle a partition boundary. Routing:

  - entry operations (create/stat/update/delete of path P) hash
    ``parent_of(P)``;
  - directory listings of D hash ``D`` itself — the same key its
    children were created under.

The ring is classic consistent hashing with virtual nodes: every shard
address projects ``replicas`` points onto a 64-bit circle via BLAKE2b
(never Python ``hash()`` — that is salted per process and the whole
point is that every process, every epoch, derives the IDENTICAL
layout). Adding or removing one shard therefore moves only the key
ranges adjacent to that shard's points — bounded churn, no full
reshuffle — which the property tests pin
alongside a golden layout so partition assignment can never silently
change between releases.

The master is the ring authority: shards join/renew via JoinMetaRing,
membership changes bump ``epoch``, and clients cache the ring with a
TTL (`MetaRingClient`, wdclient) refreshing once on a 410 wrong-shard
answer — the same invalidation ladder the vid cache rides.
"""

from __future__ import annotations

import bisect
import hashlib
import os

# Virtual nodes per shard. More points flatten per-shard load variance
# at the cost of a larger (still tiny: replicas × shards × 16 bytes)
# routing table.
DEFAULT_REPLICAS = 64


def hash64(key: str) -> int:
    """Position of a key on the ring: first 8 bytes of BLAKE2b, big
    endian — stable across processes, platforms and releases."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(),
        "big")


def normalize(p: str) -> str:
    """Mirror of filer.normalize (kept dependency-free: wdclient and the
    gateways route without importing the filer package)."""
    if not p.startswith("/"):
        p = "/" + p
    while "//" in p:
        p = p.replace("//", "/")
    return p.rstrip("/") or "/"


def parent_of(p: str) -> str:
    p = normalize(p)
    if p == "/":
        return "/"
    return p.rsplit("/", 1)[0] or "/"


class MetaRing:
    """Immutable ring snapshot: membership + epoch -> owner lookup."""

    def __init__(self, shards, epoch: int = 0,
                 replicas: int | None = None):
        self.shards: tuple[str, ...] = tuple(sorted(set(shards)))
        self.epoch = int(epoch)
        self.replicas = int(replicas if replicas else DEFAULT_REPLICAS)
        points: list[tuple[int, str]] = []
        for shard in self.shards:
            for i in range(self.replicas):
                points.append((hash64(f"{shard}#{i}"), shard))
        points.sort()  # hash ties (vanishing odds) break on address
        self._points = points
        self._keys = [h for h, _ in points]

    def __len__(self) -> int:
        return len(self.shards)

    def __eq__(self, other) -> bool:
        return (isinstance(other, MetaRing)
                and self.shards == other.shards
                and self.epoch == other.epoch
                and self.replicas == other.replicas)

    def __repr__(self) -> str:
        return (f"MetaRing(epoch={self.epoch}, shards={list(self.shards)},"
                f" replicas={self.replicas})")

    # -- routing -----------------------------------------------------------

    def shard_for_key(self, key: str) -> str:
        """Owner of a (normalized-directory) routing key; "" on an
        empty ring. Successor-point rule with wraparound."""
        if not self._points:
            return ""
        if len(self.shards) == 1:
            return self.shards[0]
        i = bisect.bisect_right(self._keys, hash64(key))
        if i == len(self._keys):
            i = 0
        return self._points[i][1]

    def shard_for_directory(self, directory: str) -> str:
        return self.shard_for_key(normalize(directory))

    def shard_for_entry(self, full_path: str) -> str:
        """Owner of an entry = owner of its parent directory."""
        return self.shard_for_key(parent_of(full_path))

    def owns_directory(self, shard: str, directory: str) -> bool:
        return len(self.shards) <= 1 or \
            self.shard_for_directory(directory) == shard

    def owns_entry(self, shard: str, full_path: str) -> bool:
        return len(self.shards) <= 1 or \
            self.shard_for_entry(full_path) == shard

    # -- snapshots ---------------------------------------------------------

    def with_shard(self, shard: str, epoch: int | None = None) -> "MetaRing":
        e = self.epoch + 1 if epoch is None else epoch
        return MetaRing(self.shards + (shard,), e, self.replicas)

    def without_shard(self, shard: str,
                      epoch: int | None = None) -> "MetaRing":
        e = self.epoch + 1 if epoch is None else epoch
        return MetaRing([s for s in self.shards if s != shard], e,
                        self.replicas)

    def describe(self) -> dict:
        """camelCase snapshot for /status pages (Recovery-report idiom)."""
        return {"epoch": self.epoch, "shards": list(self.shards),
                "replicas": self.replicas, "points": len(self._points)}

    # -- pb bridge ---------------------------------------------------------

    def fill_response(self, resp) -> None:
        """Populate a meta_ring_pb2.MetaRingResponse in place."""
        resp.epoch = self.epoch
        del resp.shards[:]
        resp.shards.extend(self.shards)
        resp.replicas = self.replicas

    @classmethod
    def from_response(cls, resp) -> "MetaRing":
        return cls(list(resp.shards), epoch=resp.epoch,
                   replicas=resp.replicas or None)


# -- wrong-shard answers ---------------------------------------------------

#: HTTP status a shard answers when the routing key belongs elsewhere —
#: "Gone" fits: the resource is not and will never be served here under
#: the current epoch. Clients refresh their ring once and retry.
WRONG_SHARD_STATUS = 410
#: response header carrying the shard's current ring epoch
EPOCH_HEADER = "X-Swfs-Ring-Epoch"
_WRONG_SHARD = "wrong metadata shard"


def wrong_shard_of(exc) -> "WrongShardError | None":
    """The WrongShardError carried by a gRPC abort (or any exception
    whose text embeds the wrong-shard details); None otherwise."""
    try:
        details = exc.details() or ""
    # lint: allow-broad-except(not an RpcError: its message carries the
    # details instead)
    except Exception:  # noqa: BLE001
        details = str(exc)
    return WrongShardError.from_details(details)


class WrongShardError(Exception):
    """A shard refused the request: key routes elsewhere. Carries the
    shard's current epoch (so a stale client knows its cache is old)
    and the owner it computed (a routing hint, not an authority)."""

    def __init__(self, epoch: int = 0, owner: str = "", message: str = ""):
        self.epoch = int(epoch)
        self.owner = owner
        super().__init__(
            message or f"{_WRONG_SHARD}: epoch={self.epoch} owner={owner}")

    @classmethod
    def from_details(cls, details: str) -> "WrongShardError | None":
        """Parse the gRPC abort details a shard emits; None when the
        error is something else entirely."""
        if _WRONG_SHARD not in (details or ""):
            return None
        epoch, owner = 0, ""
        # whitespace split only: the owner token is host:port, so a
        # colon split would truncate it to the bare hostname
        for tok in details.split():
            if tok.startswith("epoch="):
                try:
                    epoch = int(tok[6:])
                except ValueError:
                    pass
            elif tok.startswith("owner="):
                owner = tok[6:]
        return cls(epoch, owner, details)
