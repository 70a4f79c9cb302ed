"""HBase filer store over the Thrift2 gateway wire protocol.

Counterpart of seaweedfs_tpu/filer/stores/hbase_store.py (SeaweedFS
weed/filer/hbase/hbase_store.go, backed by tsuna/gohbase, the native
RegionServer RPC): no hbase client library is used, so this store drives
HBase's OTHER first-class wire surface — the Thrift2 gateway's
``THBaseService`` (hbase.thrift, shipped with every HBase) — through the
stdlib Thrift binary-protocol client in thrift_wire.py. Layout matches
the reference exactly:

  * one table, two column families: ``meta`` for entries, ``kv`` for
    the kv API, single qualifier ``a`` (hbase_store.go:42-44,
    hbase_store_kv.go:11 COLUMN_NAME)
  * row key = the full path bytes; entries carry the pb blob in
    meta:a (InsertEntry, hbase_store.go:73)
  * FindEntry -> get (doGet, hbase_store_kv.go:47)
  * DeleteEntry -> deleteSingle (doDelete)
  * ListDirectoryEntries -> getScannerResults from ``dir/<start>``,
    keeping only rows whose parent IS dir (the row keyspace mixes the
    whole subtree, hbase_store.go:152-200)
  * DeleteFolderChildren -> scan the ``dir/`` prefix and delete every
    row under it (hbase_store.go:113 — extended to the whole subtree
    like the other stores in this package, which the flat row keyspace
    gives us in one scan)
  * kv_* -> same ops against the ``kv`` family (hbase_store_kv.go)

Deviation, documented: table creation is admin-plane (the reference
uses gohbase's AdminClient; Thrift2 exposes no DDL), so the table must
exist — the in-repo fake auto-creates it, a real deployment runs
``create 't', 'meta', 'kv'`` once in hbase shell.
"""

from __future__ import annotations

from typing import Iterator

from ...pb import filer_pb2
from ..entry import Entry
from ..filerstore import register_store
from .thrift_wire import I32, LIST, STRING, STRUCT, ThriftClient
from .wire_common import prefix_end, split_dir_name

COLUMN = b"a"
CF_META = b"meta"
CF_KV = b"kv"
SCAN_PAGE = 1024


def _tcolumn(family: bytes) -> list:
    # TColumn {1: family, 2: qualifier}
    return [(1, STRING, family), (2, STRING, COLUMN)]


def _tcolumn_value(family: bytes, value: bytes) -> list:
    # TColumnValue {1: family, 2: qualifier, 3: value}
    return [(1, STRING, family), (2, STRING, COLUMN), (3, STRING, value)]


class HbaseStore:
    """FilerStore over THBaseService (HbaseStore, hbase_store.go:21)."""

    name = "hbase"

    def __init__(self, *, zkquorum: str = "localhost:9090",
                 table: str = "seaweedfs", timeout: int = 30, **_kwargs):
        # the reference's filer.toml key is `zkquorum`; Thrift2 needs
        # the gateway address, so that's what the value means here
        host, _, port = zkquorum.split(",")[0].partition(":")
        self.client = ThriftClient(host, int(port or 9090),
                                   timeout=timeout)
        self.table = table.encode()
        # fail fast (and detect a missing table) like initialize()'s
        # probe get (hbase_store.go:47-55)
        try:
            self._get(CF_META, b"\x00probe")
        except Exception:
            self.client.close()  # don't strand the socket on a bad table
            raise

    # -- thrift2 ops -------------------------------------------------------

    def _get(self, family: bytes, row: bytes) -> bytes | None:
        # get(1: table, 2: TGet{1: row, 2: [TColumn]}) -> TResult
        reply = self.client.call("get", [
            (1, STRING, self.table),
            (2, STRUCT, [(1, STRING, row),
                         (2, LIST, (STRUCT, [_tcolumn(family)]))]),
        ])
        result = reply.get(0) or {}
        for cv in result.get(2) or []:
            return cv.get(3)
        return None

    def _put(self, family: bytes, row: bytes, value: bytes) -> None:
        # put(1: table, 2: TPut{1: row, 2: [TColumnValue]})
        self.client.call("put", [
            (1, STRING, self.table),
            (2, STRUCT, [(1, STRING, row),
                         (2, LIST, (STRUCT,
                                    [_tcolumn_value(family, value)]))]),
        ])

    def _delete(self, family: bytes, row: bytes) -> None:
        # deleteSingle(1: table, 2: TDelete{1: row, 2: [TColumn]})
        self.client.call("deleteSingle", [
            (1, STRING, self.table),
            (2, STRUCT, [(1, STRING, row),
                         (2, LIST, (STRUCT, [_tcolumn(family)]))]),
        ])

    def _scan(self, start: bytes, stop: bytes
              ) -> Iterator[tuple[bytes, bytes]]:
        """(row, meta:a value) ascending over [start, stop), paging
        through getScannerResults like a caching scanner would."""
        cur = start
        while True:
            # getScannerResults(1: table, 2: TScan, 3: i32 numRows)
            reply = self.client.call("getScannerResults", [
                (1, STRING, self.table),
                (2, STRUCT, [(1, STRING, cur), (2, STRING, stop),
                             (3, LIST, (STRUCT, [_tcolumn(CF_META)]))]),
                (3, I32, SCAN_PAGE),
            ])
            results = reply.get(0) or []
            for res in results:
                row = res.get(1)
                for cv in res.get(2) or []:
                    yield row, cv.get(3)
            if len(results) < SCAN_PAGE:
                return
            cur = results[-1].get(1) + b"\x00"

    # -- FilerStore SPI ----------------------------------------------------

    _split = staticmethod(split_dir_name)

    def insert_entry(self, entry: Entry) -> None:
        self._put(CF_META, entry.full_path.encode(),
                  entry.to_pb().SerializeToString())

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        blob = self._get(CF_META, full_path.encode())
        if blob is None:
            return None
        d, _ = self._split(full_path)
        return Entry.from_pb(d, filer_pb2.Entry.FromString(blob))

    def delete_entry(self, full_path: str) -> None:
        self._delete(CF_META, full_path.encode())

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/") or "/"
        prefix = (base.rstrip("/") + "/").encode()
        stop = prefix[:-1] + b"0"  # '/' + 1 == '0': end of the subtree
        for row, _ in list(self._scan(prefix, stop)):
            self._delete(CF_META, row)

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> Iterator[Entry]:
        base = dir_path.rstrip("/") or "/"
        child_prefix = (base.rstrip("/") + "/").encode()
        start = max(start_file_name, prefix) if prefix else start_file_name
        lo = child_prefix + start.encode()
        if start_file_name and not include_start \
                and start == start_file_name:
            lo += b"\x00"
        if prefix:
            # every matching child row AND its descendants start with
            # dir/<prefix>, so this bound keeps the scan from paging
            # through the rest of the subtree discarding rows
            hi = prefix_end(child_prefix + prefix.encode())
        else:
            hi = child_prefix[:-1] + b"0"  # '/'+1: the whole subtree
        count = 0
        for row, blob in self._scan(lo, hi):
            fullpath = row.decode("utf-8", "replace")
            d, name = self._split(fullpath)
            if d != base:
                continue  # a grandchild's row: same prefix, deeper dir
            if prefix and not name.startswith(prefix):
                continue  # defensive; the range already bounds it
            pb = filer_pb2.Entry.FromString(blob)
            yield Entry.from_pb(base, pb)
            count += 1
            if count >= limit:
                return

    # -- kv (hbase_store_kv.go: kv family, same qualifier) -----------------

    def kv_put(self, key: bytes, value: bytes) -> None:
        self._put(CF_KV, key, value)

    def kv_get(self, key: bytes) -> bytes | None:
        return self._get(CF_KV, key)

    def close(self) -> None:
        self.client.close()


register_store("hbase", HbaseStore)
