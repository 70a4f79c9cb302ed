"""redis3 filer store: bounded-size directory listings.

Counterpart of seaweedfs_tpu/filer/stores/redis3.py (SeaweedFS
weed/filer/redis3/, UniversalRedis3Store): entry blobs are stored
exactly like redis/redis2 (path-keyed, shared code in RedisStore), but a
directory's children live in a *size-bounded* structure instead of one
unbounded sorted set — redis3's reason to exist is directories with
millions of children, where a single ZSET key becomes a hot, unsharded
giant. The reference builds a redis-backed skiplist of name batches
(ItemList.go + util/skiplist, ~3.3k LoC); this store keeps the same
invariants with a flatter shape — a segment index:

  * ``<dir>\\x00idx``      — ZSET of segment START names (the implicit
    root segment "" is not listed; the NUL byte keeps these keys out
    of the entry-path keyspace, like redis.py's DIR_SET_SUFFIX)
  * ``<dir>\\x00seg:<b64(start)>`` — ZSET of the names in that segment

Each segment holds at most 2*batch names; inserts that overflow split
the segment at its median inside a MULTI/EXEC transaction (a crash
between the member move and the index update must not strand a batch
of durable entries in an unreachable segment), and removals drop empty
non-root segments. Lookups/listings locate the segment by
ZREVRANGEBYLEX over the index — the same O(log-ish) contact pattern as
the skiplist, with per-key cardinality bounded by the batch size.

Deviation, documented: the on-wire layout is NOT compatible with data
written by the Go redis3 store (its skiplist serde lives in redis
hashes); entry blobs ARE compatible with this repo's redis/redis2.
"""

from __future__ import annotations

import base64
from typing import Iterator

from ..filerstore import register_store
from .redis import RedisStore

DEFAULT_BATCH = 1000
IDX_SUFFIX = b"\x00idx"
SEG_SUFFIX = b"\x00seg:"


class SegmentedNameList:
    """Size-bounded sorted name list over redis ZSET segments."""

    def __init__(self, client, dir_key: bytes, batch: int = DEFAULT_BATCH):
        self.client = client
        self.idx = dir_key + IDX_SUFFIX
        self._seg_prefix = dir_key + SEG_SUFFIX
        self.batch = batch

    def _seg_key(self, start: str) -> bytes:
        return self._seg_prefix + base64.urlsafe_b64encode(start.encode())

    def _seg_start_for(self, name: str) -> str:
        """Greatest segment start <= name; '' is the implicit root."""
        got = self.client.cmd("ZREVRANGEBYLEX", self.idx,
                              b"[" + name.encode(), b"-",
                              "LIMIT", "0", "1")
        return got[0].decode() if got else ""

    def insert(self, name: str) -> None:
        start = self._seg_start_for(name)
        seg = self._seg_key(start)
        self.client.cmd("ZADD", seg, "0", name.encode())
        if int(self.client.cmd("ZCARD", seg)) > 2 * self.batch:
            self._split(seg)

    def _split(self, seg: bytes) -> None:
        members = self.client.cmd("ZRANGEBYLEX", seg, "-", "+")
        mid = members[len(members) // 2].decode()
        upper = members[len(members) // 2:]
        new_seg = self._seg_key(mid)
        # atomic: a crash between moving members and indexing the new
        # segment would otherwise strand `upper` unreachable to listings;
        # transaction() holds the client lock across MULTI..EXEC so a
        # concurrent thread's command can't be QUEUED into it
        self.client.transaction(
            ("ZADD", new_seg, *[x for m in upper for x in (b"0", m)]),
            ("ZADD", self.idx, "0", mid.encode()),
            ("ZREM", seg, *upper))

    def remove(self, name: str) -> None:
        start = self._seg_start_for(name)
        seg = self._seg_key(start)
        self.client.cmd("ZREM", seg, name.encode())
        if start and not int(self.client.cmd("ZCARD", seg)):
            self.client.cmd("ZREM", self.idx, start.encode())

    def iterate(self, lo: str = "", inclusive: bool = True,
                page_size: int = 1024) -> Iterator[str]:
        """Names >= lo (or > lo), ascending, across segments."""
        start = self._seg_start_for(lo) if lo else ""
        bound = (("[" if inclusive else "(") + lo).encode() if lo else b"-"
        while True:
            seg = self._seg_key(start)
            offset = 0
            while True:
                page = self.client.cmd("ZRANGEBYLEX", seg, bound, b"+",
                                       "LIMIT", str(offset),
                                       str(page_size))
                if not page:
                    break
                for m in page:
                    yield m.decode()
                if len(page) < page_size:
                    break
                offset += len(page)
            nxt = self.client.cmd("ZRANGEBYLEX", self.idx,
                                  b"(" + start.encode() if start else b"-",
                                  b"+", "LIMIT", "0", "1")
            if not nxt:
                return
            start = nxt[0].decode()
            bound = b"-"  # subsequent segments stream from their head

    def collect_with_keys(self) -> tuple[list[str], list[bytes]]:
        """(all names, all redis keys incl. index) in ~2 + segments
        round trips; ([], []) for a leaf with neither segment nor index
        so callers can skip the DEL entirely."""
        root = self._seg_key("")
        names = [m.decode() for m in
                 (self.client.cmd("ZRANGEBYLEX", root, "-", "+") or [])]
        starts = [s.decode() for s in
                  (self.client.cmd("ZRANGEBYLEX", self.idx, "-", "+")
                   or [])]
        if not names and not starts:
            return [], []
        keys = [root]
        for s in starts:
            seg = self._seg_key(s)
            keys.append(seg)
            names += [m.decode() for m in
                      (self.client.cmd("ZRANGEBYLEX", seg, "-", "+")
                       or [])]
        keys.append(self.idx)
        return names, keys


class Redis3Store(RedisStore):
    """RedisStore with segmented (bounded-key) directory listings
    (universal_redis_store.go in redis3/). Entry-blob handling is the
    parent's; only the child-index hooks differ."""

    name = "redis3"

    def __init__(self, *args, batch: int = DEFAULT_BATCH, **kwargs):
        super().__init__(*args, **kwargs)
        self.batch = int(batch)

    def _names(self, dir_path: str) -> SegmentedNameList:
        key = (dir_path.rstrip("/") or "/").encode()
        return SegmentedNameList(self.client, key, self.batch)

    # child-index hooks (see RedisStore)
    def _index_child(self, dir_path: str, name: str) -> None:
        self._names(dir_path).insert(name)

    def _unindex_child(self, dir_path: str, name: str) -> None:
        self._names(dir_path).remove(name)

    def _iter_child_names(self, dir_path: str, lo: str, inclusive: bool):
        return self._names(dir_path).iterate(lo, inclusive)

    def delete_folder_children(self, full_path: str) -> None:
        stack = [full_path.rstrip("/") or "/"]
        while stack:
            d = stack.pop()
            names, keys = self._names(d).collect_with_keys()
            if not keys:
                continue  # leaf: nothing indexed, nothing to DEL
            children = [(d.rstrip("/") or "") + "/" + n for n in names]
            self.client.cmd("DEL", *[c.encode() for c in children], *keys)
            stack.extend(children)  # dirs among them get swept next


register_store("redis3", Redis3Store)
