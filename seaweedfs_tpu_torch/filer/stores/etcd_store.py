"""etcd filer store over the real etcd v3 gRPC API.

Counterpart of seaweedfs_tpu/filer/stores/etcd_store.py (SeaweedFS
weed/filer/etcd/etcd_store.go, backed by go.etcd.io/etcd/client/v3): no
etcd3 python client is used, but grpcio is — so the store drives the
actual ``etcdserverpb.KV`` service (proto in
seaweedfs_tpu/pb/proto/etcd_kv.proto) through the repo's generic stub
plumbing. Layout matches the reference exactly:

  * key = directory + b"\\x00" + name (DIR_FILE_SEPARATOR,
    etcd_store.go:19, genKey)
  * InsertEntry/UpdateEntry -> Put (:78-98)
  * FindEntry -> Range on the exact key (:104)
  * DeleteEntry -> DeleteRange on the exact key
  * DeleteFolderChildren -> DeleteRange on the ``dir\\x00`` prefix
    (which in etcd key-space is precisely the directory's children —
    descendants' keys embed deeper directories so the whole subtree
    shares the ``dir`` prefix; we range on ``dir`` + separator-or-slash
    to honor the repo-wide subtree contract)
  * ListDirectoryEntries -> Range [dir\\x00start, dir\\x01) sorted
    ascending with limit
  * kv_* -> Put/Range on the raw key bytes (etcd_store_kv.go)
"""

from __future__ import annotations

from typing import Iterator

from ...pb import filer_pb2
from ..entry import Entry
from ..filerstore import register_store
from .wire_common import prefix_end, split_dir_name

SEP = b"\x00"


def _prefix_end(prefix: bytes) -> bytes:
    """etcd clientv3.GetPrefixRangeEnd (b"\\x00" = whole keyspace)."""
    return prefix_end(prefix, unbounded=b"\x00")


class EtcdStore:
    """FilerStore over etcdserverpb.KV (EtcdStore, etcd_store.go:26)."""

    name = "etcd"

    def __init__(self, *, servers: str = "localhost:2379", timeout: int = 10,
                 **_kwargs):
        import grpc

        from ...pb import rpc

        self._channel = grpc.insecure_channel(
            servers.split(",")[0],
            options=[("grpc.max_receive_message_length", 1 << 30)])
        self._svc = rpc.etcd_kv_service()
        self.kv = rpc.Stub(self._channel, self._svc)
        self._timeout = timeout
        from ...pb import etcd_kv_pb2 as E

        self._E = E
        # fail fast if nothing is listening (the Go client dials eagerly)
        self.kv.Range(E.RangeRequest(key=b"\x00", limit=1),
                      timeout=timeout)

    _split = staticmethod(split_dir_name)

    def _key(self, full_path: str) -> bytes:
        d, n = self._split(full_path)
        return d.encode() + SEP + n.encode()

    def insert_entry(self, entry: Entry) -> None:
        blob = entry.to_pb().SerializeToString()
        self.kv.Put(self._E.PutRequest(key=self._key(entry.full_path),
                                       value=blob), timeout=self._timeout)

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        resp = self.kv.Range(self._E.RangeRequest(
            key=self._key(full_path), limit=1), timeout=self._timeout)
        if not resp.kvs:
            return None
        d, _ = self._split(full_path)
        pb = filer_pb2.Entry.FromString(resp.kvs[0].value)
        return Entry.from_pb(d, pb)

    def delete_entry(self, full_path: str) -> None:
        self.kv.DeleteRange(self._E.DeleteRangeRequest(
            key=self._key(full_path)), timeout=self._timeout)

    def delete_folder_children(self, full_path: str) -> None:
        base = (full_path.rstrip("/") or "/").encode()
        # direct children: "<base>\x00..."; descendants' keys start
        # "<base>/..." (their directory string extends base) — two
        # prefix deletes cover the subtree. Root is the special case:
        # EVERY key starts with "/", one prefix covers it all (the
        # two-prefix split would compute b"//", which matches nothing)
        prefixes = ((base,) if base == b"/"
                    else (base + SEP, base + b"/"))
        for prefix in prefixes:
            self.kv.DeleteRange(self._E.DeleteRangeRequest(
                key=prefix, range_end=_prefix_end(prefix)),
                timeout=self._timeout)

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> Iterator[Entry]:
        base = dir_path.rstrip("/") or "/"
        # the prefix narrows the RANGE itself, so the server-side limit
        # counts prefix-matching entries (a client-side filter after a
        # server-side limit silently truncates prefixed listings)
        start = max(start_file_name, prefix) if prefix else start_file_name
        lo = base.encode() + SEP + start.encode()
        if start_file_name and not include_start \
                and start == start_file_name:
            lo += b"\x00"  # skip the exact start key
        hi = _prefix_end(base.encode() + SEP
                         + prefix.encode() if prefix
                         else base.encode() + SEP)
        resp = self.kv.Range(self._E.RangeRequest(
            key=lo, range_end=hi, limit=limit,
            sort_order=self._E.RangeRequest.ASCEND,
            sort_target=self._E.RangeRequest.KEY), timeout=self._timeout)
        for kv in resp.kvs:
            name = kv.key.split(SEP, 1)[1].decode("utf-8", "replace")
            if prefix and not name.startswith(prefix):
                continue  # defensive; range already bounds the prefix
            pb = filer_pb2.Entry.FromString(kv.value)
            yield Entry.from_pb(base, pb)

    # -- kv (etcd_store_kv.go: the raw key bytes ARE the etcd key) ---------

    def kv_put(self, key: bytes, value: bytes) -> None:
        self.kv.Put(self._E.PutRequest(key=key, value=value),
                    timeout=self._timeout)

    def kv_get(self, key: bytes) -> bytes | None:
        resp = self.kv.Range(self._E.RangeRequest(key=key, limit=1),
                             timeout=self._timeout)
        return resp.kvs[0].value if resp.kvs else None

    def close(self) -> None:
        self._channel.close()


register_store("etcd", EtcdStore)
