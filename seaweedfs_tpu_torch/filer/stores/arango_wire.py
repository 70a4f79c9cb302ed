"""ArangoDB filer store over its REST + AQL cursor API.

Counterpart of seaweedfs_tpu/filer/stores/arango_wire.py (SeaweedFS
weed/filer/arangodb/arangodb_store.go, backed by arangodb/go-driver):
HTTP+JSON end to end, so the store drives it with the same pooled stdlib
client the elastic store uses. Layout matches the reference:

  * document _key = sha-hash of the full path (hashString,
    helpers.go:16; md5 here, same role), fields {directory, name,
    meta, ttl} with meta as an int array (bytesToArray — the Go
    driver's JSON-safe byte encoding; kept for data-format parity)
  * collection per bucket under /buckets/<name>, default
    ``seaweed_no_bucket`` for everything else (BUCKET_PREFIX /
    DEFAULT_COLLECTION, arangodb_store.go:25-26)
  * upserts via ``overwriteMode=replace`` (the reference's
    CreateDocument + conflict->UpdateDocument dance collapsed into
    the server-side form)
  * listings and subtree deletes via AQL over /_api/cursor with
    bindVars, batched (PUT /_api/cursor/<id> drains hasMore pages)
  * basic auth
"""

from __future__ import annotations

import hashlib
import re
from typing import Iterator

from ...pb import filer_pb2
from ..entry import Entry
from ..filerstore import register_store
from .elastic_wire import ElasticClient, ElasticError
from .wire_common import split_dir_name

BUCKET_PREFIX = "/buckets"
DEFAULT_COLLECTION = "seaweed_no_bucket"
KV_COLLECTION = "seaweed_kv"

LIST_AQL = ("FOR d IN @@collection FILTER d.directory == @dir "
            "AND d.name {op} @start AND STARTS_WITH(d.name, @prefix) "
            "SORT d.name ASC LIMIT @limit RETURN d")
SUBTREE_DELETE_AQL = (
    "FOR d IN @@collection FILTER d.directory == @dir OR "
    "STARTS_WITH(d.directory, @sub) REMOVE d IN @@collection")


def _hash_key(full_path: str) -> str:
    return hashlib.md5(full_path.encode()).hexdigest()


class ArangodbStore:
    """FilerStore over the REST/AQL client (ArangodbStore,
    arangodb_store.go:30)."""

    name = "arangodb"

    def __init__(self, *, host="localhost", port=8529, username="root",
                 password="", database="_system", **kwargs):
        self.client = ElasticClient(host=host, port=port,
                                    username=username, password=password,
                                    **kwargs)
        self.db = database
        self._collections: set[str] = set()
        self._ensure_collection(DEFAULT_COLLECTION)
        self._ensure_collection(KV_COLLECTION)

    # -- plumbing ----------------------------------------------------------

    def _api(self, path: str) -> str:
        return f"/_db/{self.db}/_api{path}"

    def _ensure_collection(self, coll: str) -> None:
        if coll in self._collections:
            return
        self.client.request("POST", self._api("/collection"),
                            {"name": coll},
                            ok_statuses=(200, 409))  # 409 = exists
        self._collections.add(coll)

    @staticmethod
    def _bucket_of(full_path: str) -> str | None:
        """Bucket name iff the path is strictly INSIDE a bucket
        (/buckets/<b>/...). The /buckets dir and the bucket dir entries
        themselves live in the default collection so that listing
        /buckets works — the reference resolves '/buckets' itself to
        the default collection but also writes bucket DIR entries into
        bucket collections, making ListAllMyBuckets unserviceable."""
        if not full_path.startswith(BUCKET_PREFIX + "/"):
            return None
        rest = full_path[len(BUCKET_PREFIX) + 1:]
        bucket, sep, tail = rest.partition("/")
        if not sep or not tail:
            return None              # the bucket dir entry itself
        if re.fullmatch(r"[A-Za-z0-9_\-.]+", bucket):
            return bucket
        return None

    def _collection_of(self, full_path: str, create: bool = True) -> str:
        bucket = self._bucket_of(full_path)
        if bucket is None:
            return DEFAULT_COLLECTION
        # ArangoDB collection names can't contain '.'; a plain
        # '.'->'_' swap makes buckets 'a.b' and 'a_b' SHARE a
        # collection (deleting one would wipe the other — S3 bucket
        # names legitimately contain dots). Escape-code instead:
        # '_'->'__' first, then '.'->'_d' — prefix-free, so the
        # mapping is injective for EVERY pair of bucket names, and
        # dot-free, underscore-free names keep their plain form.
        # Layout change from the earlier '.'->'_' scheme: buckets with
        # '_' or '.' in the name map to a NEW collection (the old
        # mapping was lossy, so data written under it was already at
        # risk of cross-bucket deletion; no read-fallback is kept).
        coll = "bucket_" + bucket.replace("_", "__").replace(".", "_d")
        if create:
            self._ensure_collection(coll)
        return coll

    def _collection_for_dir(self, base: str) -> str:
        """Collection holding the CHILDREN of directory `base`."""
        return self._collection_of(base + "/x", create=False)

    def _aql(self, query: str, bind: dict) -> Iterator[dict]:
        res = self.client.request("POST", self._api("/cursor"),
                                  {"query": query, "bindVars": bind,
                                   "batchSize": 1000},
                                  ok_statuses=(200, 201))
        yield from res.get("result") or []
        while res.get("hasMore"):
            res = self.client.request(
                "PUT", self._api(f"/cursor/{res['id']}"), {},
                ok_statuses=(200,))
            yield from res.get("result") or []

    _split = staticmethod(split_dir_name)

    # -- entries -----------------------------------------------------------

    def insert_entry(self, entry: Entry) -> None:
        d, n = self._split(entry.full_path)
        blob = entry.to_pb().SerializeToString()
        coll = self._collection_of(entry.full_path)
        self.client.request(
            "POST",
            self._api(f"/document/{coll}?overwriteMode=replace"),
            {"_key": _hash_key(entry.full_path), "directory": d,
             "name": n, "meta": list(blob)})

    update_entry = insert_entry

    def _decode(self, doc: dict, directory: str) -> Entry | None:
        meta = doc.get("meta")
        if not meta:
            return None
        pb = filer_pb2.Entry.FromString(bytes(meta))
        return Entry.from_pb(directory, pb)

    def find_entry(self, full_path: str) -> Entry | None:
        coll = self._collection_of(full_path, create=False)
        try:
            doc = self.client.request(
                "GET",
                self._api(f"/document/{coll}/{_hash_key(full_path)}"),
                ok_statuses=(200,))
        except ElasticError as e:
            if e.status == 404:
                return None
            raise
        d, _ = self._split(full_path)
        return self._decode(doc, d)

    def delete_entry(self, full_path: str) -> None:
        coll = self._collection_of(full_path, create=False)
        try:
            self.client.request(
                "DELETE",
                self._api(f"/document/{coll}/{_hash_key(full_path)}"),
                ok_statuses=(200, 202, 404))
        except ElasticError as e:
            if e.status != 404:
                raise

    def _drop_bucket_collections(self) -> None:
        res = self.client.request("GET", self._api("/collection"),
                                  ok_statuses=(200,))
        for c in res.get("result", []):
            name = c["name"] if isinstance(c, dict) else c
            if name.startswith("bucket_"):
                self.client.request("DELETE",
                                    self._api(f"/collection/{name}"),
                                    ok_statuses=(200, 404))
                self._collections.discard(name)

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/") or "/"
        coll = self._collection_for_dir(base)
        bucket = self._bucket_of(base + "/x")
        if bucket is not None and base == f"{BUCKET_PREFIX}/{bucket}":
            # whole-bucket wipe: drop the bucket collection O(1)
            self.client.request("DELETE",
                                self._api(f"/collection/{coll}"),
                                ok_statuses=(200, 404))
            self._collections.discard(coll)
            return
        if base in ("/", BUCKET_PREFIX):
            # the wipe spans every bucket collection too; and at root
            # the descendant prefix must be "/" itself (base + "/"
            # would be "//", which no directory starts with)
            self._drop_bucket_collections()
        sub = "/" if base == "/" else base + "/"
        try:
            list(self._aql(SUBTREE_DELETE_AQL,
                           {"@collection": coll, "dir": base,
                            "sub": sub}))
        except ElasticError as e:
            if e.status != 404:
                raise

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> Iterator[Entry]:
        base = dir_path.rstrip("/") or "/"
        coll = self._collection_for_dir(base)
        op = ">=" if include_start else ">"
        query = LIST_AQL.replace("{op}", op)
        try:
            docs = self._aql(query, {"@collection": coll, "dir": base,
                                     "start": start_file_name,
                                     "prefix": prefix or "",
                                     "limit": limit})
            for doc in docs:
                entry = self._decode(doc, base)
                if entry is not None:
                    yield entry
        except ElasticError as e:
            if e.status == 404:
                return
            raise

    # -- kv (arangodb_store_kv.go: hashed key doc in a kv collection) ------

    def kv_put(self, key: bytes, value: bytes) -> None:
        self.client.request(
            "POST",
            self._api(f"/document/{KV_COLLECTION}?overwriteMode=replace"),
            {"_key": key.hex(), "value": list(value)})

    def kv_get(self, key: bytes) -> bytes | None:
        try:
            doc = self.client.request(
                "GET", self._api(f"/document/{KV_COLLECTION}/{key.hex()}"),
                ok_statuses=(200,))
        except ElasticError as e:
            if e.status == 404:
                return None
            raise
        v = doc.get("value")
        return bytes(v) if v is not None else None

    def close(self) -> None:
        self.client.close()


register_store("arangodb", ArangodbStore)
