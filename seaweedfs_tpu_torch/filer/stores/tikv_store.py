"""TiKV filer store over the real RawKV gRPC API with PD routing.

Counterpart of seaweedfs_tpu/filer/stores/tikv_store.py (SeaweedFS
weed/filer/tikv/tikv_store.go, backed by tikv/client-go's txnkv): no
TiKV client library is used, so the store drives TiKV's public wire
surface itself through the repo pb stack — ``pdpb.PD`` for key->region
routing (GetRegion/GetStore, the same discovery loop client-go's
RegionCache runs) and ``tikvpb.Tikv`` RawKV for data. Layout matches the
reference exactly:

  * key = sha1(dir) + name (tikv_store.go:358 generateKey /
    hashToBytes), value = the entry protobuf
  * InsertEntry/UpdateEntry -> RawPut (:77-95)
  * FindEntry -> RawGet (:101)
  * DeleteEntry -> RawDelete (:135)
  * DeleteFolderChildren -> RawDeleteRange over the sha1(dir) prefix
    (:157 iterates then DeleteRange; RawDeleteRange does it
    server-side). NOTE the sha1 keyspace is FLAT — children of a
    directory live under sha1(dir) but grandchildren live under
    sha1(child-dir), so the subtree walk recurses through listings,
    exactly like the reference's filer-level recursive delete.
  * ListDirectoryEntries -> RawScan from sha1(dir)+start bounded by
    the prefix (:203), following region boundaries
  * kv_* -> RawPut/RawGet on the raw key bytes (tikv_store_kv.go:13)

Deviation, documented: the reference uses the *transactional* KV API
(txnkv); single-key filer ops don't need 2PC, and RawKV is TiKV's
first-class API for exactly this shape, so this store uses RawKV and
keeps the reference's on-disk key layout.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Iterator

import grpc

from ...pb import filer_pb2, rpc
from ...pb import tikv_kvrpc_pb2 as K
from ...pb import tikv_pd_pb2 as P
from ..entry import Entry
from ..filerstore import register_store
from .wire_common import prefix_end, split_dir_name

SHA1_SIZE = 20


class TikvError(IOError):
    pass


def _hash(dir_path: str) -> bytes:
    return hashlib.sha1(dir_path.encode()).digest()


def _prefix_end(prefix: bytes) -> bytes:
    return prefix_end(prefix, unbounded=b"")


class TikvStore:
    """FilerStore over pdpb.PD + tikvpb.Tikv RawKV (TikvStore,
    tikv_store.go:30)."""

    name = "tikv"

    def __init__(self, *, pdaddrs: str = "localhost:2379", timeout: int = 10,
                 **_kwargs):
        self._timeout = timeout
        self._pd_channel = grpc.insecure_channel(pdaddrs.split(",")[0])
        self.pd = rpc.Stub(self._pd_channel, rpc.tikv_pd_service())
        self._stores_mu = threading.Lock()
        self._store_stubs: dict[str, tuple[grpc.Channel, rpc.Stub]] = {}
        self._store_addrs: dict[int, str] = {}
        # fail fast if no PD answers (client-go dials PD eagerly too)
        members = self.pd.GetMembers(P.GetMembersRequest(),
                                     timeout=timeout)
        self._cluster_id = members.header.cluster_id

    # -- routing (client-go RegionCache, slimmed) --------------------------

    def _header(self) -> P.RequestHeader:
        return P.RequestHeader(cluster_id=self._cluster_id)

    def _region_for(self, key: bytes):
        r = self.pd.GetRegion(P.GetRegionRequest(
            header=self._header(), region_key=key), timeout=self._timeout)
        if r.header.error.message:
            raise TikvError(f"pd GetRegion: {r.header.error.message}")
        if not r.region.id or not r.region.peers:
            raise TikvError(
                f"pd GetRegion: no region serves key {key[:24].hex()}")
        return r.region, r.leader

    def _stub_for_store(self, store_id: int) -> rpc.Stub:
        # store_id -> address is stable (a store keeps its id for life),
        # so cache it: without this every data op pays a PD GetStore
        # round trip on top of GetRegion
        with self._stores_mu:
            addr = self._store_addrs.get(store_id)
        if addr is None:
            s = self.pd.GetStore(P.GetStoreRequest(
                header=self._header(), store_id=store_id),
                timeout=self._timeout)
            if s.header.error.message:
                raise TikvError(f"pd GetStore: {s.header.error.message}")
            addr = s.store.address
        with self._stores_mu:
            self._store_addrs[store_id] = addr
            cached = self._store_stubs.get(addr)
            if cached is None:
                ch = grpc.insecure_channel(addr)
                cached = (ch, rpc.Stub(ch, rpc.tikv_service()))
                self._store_stubs[addr] = cached
            return cached[1]

    def _ctx_and_stub(self, key: bytes):
        region, leader = self._region_for(key)
        peer = leader if leader.store_id else region.peers[0]
        ctx = K.Context(region_id=region.id,
                        region_epoch=region.region_epoch, peer=peer)
        return ctx, self._stub_for_store(peer.store_id), region

    @staticmethod
    def _check(resp) -> None:
        if resp.region_error.message:
            raise TikvError(f"region error: {resp.region_error.message}")
        if getattr(resp, "error", ""):
            raise TikvError(resp.error)

    # -- raw ops (region-aware) --------------------------------------------

    def _raw_put(self, key: bytes, value: bytes) -> None:
        ctx, stub, _ = self._ctx_and_stub(key)
        resp = stub.RawPut(K.RawPutRequest(context=ctx, key=key,
                                           value=value),
                           timeout=self._timeout)
        self._check(resp)

    def _raw_get(self, key: bytes) -> bytes | None:
        ctx, stub, _ = self._ctx_and_stub(key)
        resp = stub.RawGet(K.RawGetRequest(context=ctx, key=key),
                           timeout=self._timeout)
        self._check(resp)
        if resp.not_found:
            return None
        return resp.value

    def _raw_delete(self, key: bytes) -> None:
        ctx, stub, _ = self._ctx_and_stub(key)
        resp = stub.RawDelete(K.RawDeleteRequest(context=ctx, key=key),
                              timeout=self._timeout)
        self._check(resp)

    def _raw_delete_range(self, start: bytes, end: bytes) -> None:
        """DeleteRange [start, end), region by region (client-go splits
        ranges on region boundaries the same way)."""
        cur = start
        while True:
            ctx, stub, region = self._ctx_and_stub(cur)
            stop = end
            if region.end_key and (not end or region.end_key < end):
                stop = region.end_key
            resp = stub.RawDeleteRange(K.RawDeleteRangeRequest(
                context=ctx, start_key=cur, end_key=stop),
                timeout=self._timeout)
            self._check(resp)
            if stop == end or not region.end_key:
                return
            cur = region.end_key

    def _raw_scan(self, start: bytes, end: bytes, limit: int
                  ) -> Iterator[K.KvPair]:
        """Ascending scan of [start, end), following region boundaries
        and paging inside each region."""
        cur = start
        remaining = limit
        while remaining > 0:
            ctx, stub, region = self._ctx_and_stub(cur)
            stop = end
            if region.end_key and (not end or region.end_key < end):
                stop = region.end_key
            page = min(remaining, 1024)
            resp = stub.RawScan(K.RawScanRequest(
                context=ctx, start_key=cur, end_key=stop, limit=page),
                timeout=self._timeout)
            self._check(resp)
            for kv in resp.kvs:
                yield kv
                remaining -= 1
                if remaining <= 0:
                    return
            if len(resp.kvs) == page and resp.kvs:
                cur = resp.kvs[-1].key + b"\x00"
                continue
            if stop == end or not region.end_key:
                return
            cur = region.end_key

    # -- FilerStore SPI ----------------------------------------------------

    _split = staticmethod(split_dir_name)

    def _key(self, full_path: str) -> bytes:
        d, n = self._split(full_path)
        return _hash(d) + n.encode()

    def insert_entry(self, entry: Entry) -> None:
        self._raw_put(self._key(entry.full_path),
                      entry.to_pb().SerializeToString())

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        blob = self._raw_get(self._key(full_path))
        if blob is None:
            return None
        d, _ = self._split(full_path)
        return Entry.from_pb(d, filer_pb2.Entry.FromString(blob))

    def delete_entry(self, full_path: str) -> None:
        self._raw_delete(self._key(full_path))

    def delete_folder_children(self, full_path: str) -> None:
        """The sha1 keyspace is flat per-directory: recurse through
        listings so grandchildren under sha1(child) go too (the
        reference store only clears one directory per call and relies
        on the filer's recursive walk; this repo's store contract is
        whole-subtree)."""
        stack = [full_path.rstrip("/") or "/"]
        while stack:
            d = stack.pop()
            sub = [e for e in self.list_directory_entries(d,
                                                          limit=1_000_000)]
            prefix = _hash(d)
            self._raw_delete_range(prefix, _prefix_end(prefix))
            stack.extend((d.rstrip("/") or "") + "/" + e.name
                         for e in sub if e.is_directory)

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> Iterator[Entry]:
        base = dir_path.rstrip("/") or "/"
        h = _hash(base)
        start = max(start_file_name, prefix) if prefix else start_file_name
        lo = h + start.encode()
        if start_file_name and not include_start \
                and start == start_file_name:
            lo += b"\x00"
        hi = _prefix_end(h + prefix.encode()) if prefix else _prefix_end(h)
        for kv in self._raw_scan(lo, hi, limit):
            pb = filer_pb2.Entry.FromString(kv.value)
            yield Entry.from_pb(base, pb)

    # -- kv (tikv_store_kv.go: the raw key bytes ARE the tikv key) ---------

    def kv_put(self, key: bytes, value: bytes) -> None:
        self._raw_put(key, value)

    def kv_get(self, key: bytes) -> bytes | None:
        return self._raw_get(key)

    def close(self) -> None:
        self._pd_channel.close()
        with self._stores_mu:
            for ch, _ in self._store_stubs.values():
                ch.close()
            self._store_stubs.clear()


register_store("tikv", TikvStore)
