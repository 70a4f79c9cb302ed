"""Batched fid leasing: amortize master Assign RPCs over many PUTs.

Counterpart of seaweedfs_tpu/wdclient/lease.py.

The reference's `Assign` already supports count=N (assign_file_id.go:37):
the master reserves N consecutive needle ids on one volume and clients
address them as "fid", "fid_1", ... "fid_<N-1>" (ParsePath's "_delta"
suffix, needle.go:117-142). This pool turns that into a client-side
lease: one Assign RPC stocks a block of N fids per
(collection, replication, ttl, data_center) key, and the small-file
write path mints fids locally until the block drains — N PUTs cost ~1
master round-trip instead of N.

Safety rails:

- blocks expire after `max_age` seconds, so a volume that went
  read-only/moved after the lease can only absorb a bounded burst of
  failed writes before the pool re-asks the (possibly new) master;
- `invalidate()` drops every block immediately — callers invoke it when
  an upload to a leased location fails, and master failover inside
  `operation.assign` (its rotation/redirect plumbing) supplies the
  replacement lease from whoever leads now;
- a block carrying a write JWT (`auth`) is never batched: the master
  signs the BASE fid only, so "_delta" fids would fail JWT verification
  at the volume server. Those assigns degrade to count=1 transparently.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import replace

from ..operation import AssignResult, assign
from ..utils import trace
from ..utils.stats import CLIENT_FID_LEASE_COUNTER

DEFAULT_BATCH = 128
DEFAULT_MAX_AGE = 10.0  # seconds a leased block may serve fids


class _Block:
    __slots__ = ("base", "count", "next", "expires_at")

    def __init__(self, base: AssignResult, count: int, expires_at: float):
        self.base = base
        self.count = count
        self.next = 0
        self.expires_at = expires_at

    def take(self) -> AssignResult:
        delta = self.next
        self.next += 1
        if delta == 0:
            return self.base
        return replace(self.base, fid=f"{self.base.fid}_{delta}", count=1)


class FidLeasePool:
    """Thread-safe per-(collection, replication, ttl, dc) fid lease pool."""

    def __init__(self, master: str, *, batch: int = DEFAULT_BATCH,
                 max_age: float = DEFAULT_MAX_AGE):
        self.master = master
        self.batch = max(1, int(batch))
        self.max_age = max_age
        self._lock = threading.Lock()
        self._blocks: dict[tuple, deque[_Block]] = {}
        # single-flight refill: the overlapped PUT window
        # means W writer threads can drain a key together; only ONE
        # should pay (and reserve) a batched Assign while the others
        # wait for its block instead of each minting their own
        self._refills: dict[tuple, threading.Event] = {}
        # per-key invalidation generation: a refill Assign runs OUTSIDE
        # the lock, so a block obtained before an invalidate() must not
        # be stocked after it (it likely points at the very volume whose
        # failure triggered the invalidation)
        self._gens: dict[tuple, int] = {}
        # keys whose assigns came back JWT-signed: batching is useless
        # there (the token covers the base fid only), so later assigns
        # for these keys request count=1 instead of reserving and then
        # wasting batch-1 needle ids per PUT
        self._jwt_keys: set[tuple] = set()

    def _take_pooled(self, key: tuple) -> AssignResult | None:
        """One fid from the key's live blocks, or None when dry."""
        now = time.monotonic()
        with self._lock:
            blocks = self._blocks.get(key)
            while blocks:
                b = blocks[0]
                if b.next >= b.count:
                    blocks.popleft()
                    continue
                if b.expires_at <= now:
                    CLIENT_FID_LEASE_COUNTER.inc(result="expired")
                    blocks.popleft()
                    continue
                CLIENT_FID_LEASE_COUNTER.inc(result="hit")
                sp = trace.current()
                if sp is not None:
                    # a lease hit is the absence of a master RPC — worth
                    # an attribute, not a span of its own
                    sp.set_attr(fidLease="hit")
                return b.take()
        return None

    def acquire(self, *, collection: str = "", replication: str = "",
                ttl: str = "", data_center: str = "") -> AssignResult:
        """-> one leased fid (AssignResult with fid/url/auth), or an
        AssignResult carrying `.error` when every master refused."""
        key = (collection, replication, ttl, data_center)
        a = self._take_pooled(key)
        if a is not None:
            return a
        # pool dry for this key: one batched Assign restocks it. The RPC
        # runs outside the lock — a slow master must not stall every
        # writer thread. Refills are SINGLE-FLIGHT per key:
        # the overlapped PUT window drains a key with W threads at once,
        # and W concurrent Assigns would reserve (and then mostly waste)
        # W whole blocks of needle ids. Followers wait for the leader's
        # block; if the leader failed or its block was consumed, they
        # fall through to their own Assign (correctness never depends
        # on the leader).
        with self._lock:
            ev = self._refills.get(key)
            leader = ev is None
            if leader:
                ev = self._refills[key] = threading.Event()
        if not leader:
            ev.wait(timeout=15.0)
            a = self._take_pooled(key)
            if a is not None:
                return a
        try:
            with self._lock:
                count = 1 if key in self._jwt_keys else self.batch
                gen = self._gens.get(key, 0)
            with trace.span("wdclient.lease.refill", child_only=True,
                            count=count):
                a = assign(self.master, count=count, collection=collection,
                           replication=replication, ttl=ttl,
                           data_center=data_center)
            if a.error:
                return a
            CLIENT_FID_LEASE_COUNTER.inc(result="refill")
            granted = max(1, int(a.count or 1))
            if a.auth:
                # JWT is bound to the base fid; "_delta" fids would 401 —
                # remember so the NEXT assign doesn't reserve (and waste)
                # a whole block of needle ids it can never hand out
                with self._lock:
                    self._jwt_keys.add(key)
                return a
            block = _Block(a, granted, time.monotonic() + self.max_age)
            first = block.take()
            if block.next < block.count:
                with self._lock:
                    if self._gens.get(key, 0) == gen:
                        self._blocks.setdefault(key, deque()).append(block)
                    # else: invalidate() ran while our Assign was in
                    # flight — this block targets a suspect volume; hand
                    # out only the first fid (its upload failing is what
                    # retries are for) and let the next acquire re-ask
                    # the master
            return first
        finally:
            if leader:
                with self._lock:
                    self._refills.pop(key, None)
                ev.set()

    def invalidate(self, *, collection: str = "", replication: str = "",
                   ttl: str = "", data_center: str = "",
                   all_keys: bool = False) -> None:
        """Drop the named key's leased blocks — or every block with
        all_keys=True (master failover: every lease is suspect). An
        upload failure on ONE collection's leased volume must not also
        destroy the healthy batching of every other key."""
        key = (collection, replication, ttl, data_center)
        with self._lock:
            if all_keys:
                if self._blocks:
                    CLIENT_FID_LEASE_COUNTER.inc(result="invalidate")
                for k in set(self._blocks) | {key}:
                    self._gens[k] = self._gens.get(k, 0) + 1
                self._blocks.clear()
            else:
                self._gens[key] = self._gens.get(key, 0) + 1
                if self._blocks.pop(key, None):
                    CLIENT_FID_LEASE_COUNTER.inc(result="invalidate")

    def remaining(self) -> int:
        now = time.monotonic()
        with self._lock:
            return sum(b.count - b.next
                       for blocks in self._blocks.values()
                       for b in blocks
                       if b.expires_at > now)
