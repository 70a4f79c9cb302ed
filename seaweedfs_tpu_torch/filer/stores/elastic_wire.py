"""Elasticsearch filer store over its plain REST/JSON API.

Counterpart of seaweedfs_tpu/filer/stores/elastic_wire.py (SeaweedFS
weed/filer/elastic/v7/elastic_store.go, build-tag-gated in the reference
and backed by olivere/elastic): no client library here either —
Elasticsearch's API is HTTP+JSON, so the store drives it with the stdlib
http.client, matching the reference's layout exactly:

  * one index per top-level directory, named ``.seaweedfs_<seg>``
    (indexPrefix, elastic_store.go:22; getIndex), ``.seaweedfs_``
    bare for root-level entries
  * document id = md5 hex of the full path; ``ParentId`` = md5 hex of
    the directory (InsertEntry :107-118)
  * listings are term queries on ParentId with search_after
    pagination (listDirectoryEntries :200+). Deviation: the reference
    sorts on _id DESCENDING (Sort("_id", false), elastic_store.go:277)
    — i.e. md5-of-path order — which breaks lexicographic listing and
    start/prefix pagination; this store indexes Name and sorts on it,
    keeping the repo-wide ordering contract the filer requires
  * deleting a top-level directory drops its whole index
    (DeleteEntry :160-166)
  * kv entries live in ``.seaweedfs_kv_entries`` (indexKV :23)

Entry metadata is stored as base64 of the filer pb (the reference
marshals its Entry struct to JSON; the pb blob is this repo's
canonical serialized form, and binary fields must be base64 in JSON
either way).
"""

from __future__ import annotations

import base64
import hashlib
import http.client
import json
import threading
from typing import Iterator

from ...pb import filer_pb2
from ..entry import Entry
from ..filerstore import register_store
from .wire_common import quick_ack, split_dir_name

INDEX_PREFIX = ".seaweedfs_"
INDEX_KV = ".seaweedfs_kv_entries"


class ElasticError(Exception):
    def __init__(self, status: int, message: str):
        self.status = status
        super().__init__(f"HTTP {status}: {message}")


class ElasticClient:
    """Tiny pooled REST client (one http.client conn per thread)."""

    def __init__(self, *, host="localhost", port=9200, username="",
                 password="", timeout=30):
        self.host, self.port, self.timeout = host, int(port), timeout
        self._auth = None
        if username:
            self._auth = "Basic " + base64.b64encode(
                f"{username}:{password}".encode()).decode()
        self._local = threading.local()
        # every conn ever opened, so close() can reach the ones parked
        # in OTHER threads' locals (a thread-local-only close leaks fds)
        self._all_conns: list[http.client.HTTPConnection] = []
        self._conns_lock = threading.Lock()

    def _conn(self) -> http.client.HTTPConnection:
        c = getattr(self._local, "conn", None)
        if c is None:
            c = http.client.HTTPConnection(self.host, self.port,
                                           timeout=self.timeout)
            self._local.conn = c
            with self._conns_lock:
                self._all_conns.append(c)
        return c

    def request(self, method: str, path: str, body: dict | None = None,
                ok_statuses: tuple = (200, 201)) -> dict:
        payload = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"}
        if self._auth:
            headers["Authorization"] = self._auth
        for attempt in (0, 1):
            c = self._conn()
            try:
                c.request(method, path, body=payload, headers=headers)
                quick_ack(c.sock)  # headers and body may come apart
                resp = c.getresponse()
                raw = resp.read()
                break
            except (http.client.HTTPException, OSError):
                # stale pooled connection: rebuild once, then surface
                try:
                    c.close()
                except OSError:
                    pass
                self._local.conn = None
                with self._conns_lock:
                    try:
                        self._all_conns.remove(c)
                    except ValueError:
                        pass
                if attempt:
                    raise
        doc = json.loads(raw) if raw else {}
        if resp.status not in ok_statuses:
            raise ElasticError(resp.status,
                               str(doc.get("error", raw[:200])))
        return doc

    def close(self) -> None:
        with self._conns_lock:
            conns, self._all_conns = self._all_conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        self._local.conn = None


def _md5(s: str) -> str:
    return hashlib.md5(s.encode()).hexdigest()


def _seg_index(seg: str) -> str:
    """ES index names must be lowercase; the reference just lower()s
    (getIndex, elastic_store.go:301) so /Data and /data COLLIDE in one
    index — and an index drop for one destroys the other. Disambiguate
    case variants with a short md5 suffix instead."""
    low = seg.lower()
    if seg != low:
        return INDEX_PREFIX + low + "-" + _md5(seg)[:6]
    return INDEX_PREFIX + low


def _index_of(full_path: str, is_directory: bool = False) -> str:
    """getIndex (elastic_store.go:298-310): '/a/b' -> .seaweedfs_a;
    a top-level FILE '/a' lives in the bare '.seaweedfs_' index, while
    DIRECTORY '/a' (for listing its children) maps to .seaweedfs_a."""
    parts = full_path.split("/")
    if is_directory and len(parts) >= 2:
        return _seg_index(parts[1])
    if len(parts) > 2:
        return _seg_index(parts[1])
    return INDEX_PREFIX


class ElasticStore:
    """FilerStore over the REST client (ElasticStore,
    elastic_store.go:48)."""

    name = "elastic7"

    def __init__(self, *, host="localhost", port=9200, username="",
                 password="", max_page_size=10000, **kwargs):
        self.client = ElasticClient(host=host, port=port,
                                    username=username, password=password,
                                    **kwargs)
        self.max_page_size = max_page_size
        self._known_indices: set[str] = set()
        # kv index exists up front (initialize, elastic_store.go:79-86)
        self.client.request("PUT", "/" + INDEX_KV, {},
                            ok_statuses=(200, 400))  # 400 = already exists

    _ENTRY_MAPPINGS = {
        "mappings": {"properties": {
            # keyword, not text: real ES dynamic-maps strings as text,
            # on which sort and exact term/prefix queries are rejected
            # ("Fielddata is disabled on text fields")
            "ParentId": {"type": "keyword"},
            "Name": {"type": "keyword"},
            "FullPath": {"type": "keyword"},
            "Meta": {"type": "keyword", "index": False},
        }}}

    def _ensure_index(self, index: str) -> None:
        if index in self._known_indices:
            return
        self.client.request("PUT", "/" + index, self._ENTRY_MAPPINGS,
                            ok_statuses=(200, 400))
        self._known_indices.add(index)

    # -- entries -----------------------------------------------------------

    def _doc_path(self, full_path: str) -> str:
        return f"/{_index_of(full_path)}/_doc/{_md5(full_path)}"

    def insert_entry(self, entry: Entry) -> None:
        d, n = self._split(entry.full_path)
        blob = entry.to_pb().SerializeToString()
        self._ensure_index(_index_of(entry.full_path))
        self.client.request("PUT", self._doc_path(entry.full_path), {
            "ParentId": _md5(d),
            "FullPath": entry.full_path,
            "Name": n,
            "Meta": base64.b64encode(blob).decode()})

    update_entry = insert_entry

    _split = staticmethod(split_dir_name)

    def _decode(self, src: dict, directory: str) -> Entry | None:
        meta = src.get("Meta")
        if not meta:
            return None
        pb = filer_pb2.Entry.FromString(base64.b64decode(meta))
        return Entry.from_pb(directory, pb)

    def find_entry(self, full_path: str) -> Entry | None:
        try:
            doc = self.client.request("GET", self._doc_path(full_path),
                                      ok_statuses=(200,))
        except ElasticError as e:
            if e.status == 404:
                return None
            raise
        if not doc.get("found"):
            return None
        d, _ = self._split(full_path)
        return self._decode(doc.get("_source", {}), d)

    def delete_entry(self, full_path: str) -> None:
        # top-level DIRECTORY: drop its whole index (DeleteEntry
        # :160-166 — which passes isDirectory=false to getIndex and
        # would nuke the shared bare index, and drops it for top-level
        # FILES too; both corrected here — a file named /Data must not
        # wipe the /Data directory tree)
        if full_path.count("/") == 1 and full_path != "/":
            e = self.find_entry(full_path)
            # a MISSING entry must not drop the index: deletes are
            # idempotent everywhere else, and a stray second delete of
            # a file racing a same-named directory's creation would
            # otherwise wipe that directory's whole subtree
            if e is not None and e.is_directory:
                index = _index_of(full_path, is_directory=True)
                self.client.request("DELETE", "/" + index,
                                    ok_statuses=(200, 404))
                self._known_indices.discard(index)
        try:
            self.client.request("DELETE", self._doc_path(full_path),
                                ok_statuses=(200, 404))
        except ElasticError as e:
            if e.status != 404:
                raise

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/") or "/"
        if base.count("/") == 1 and base != "/":
            # every descendant of /a lives in .seaweedfs_a (getIndex):
            # dropping the index deletes the whole subtree O(1); the
            # /a entry itself (bare index) is the caller's to keep
            index = _index_of(base, is_directory=True)
            self.client.request("DELETE", "/" + index,
                                ok_statuses=(200, 404))
            self._known_indices.discard(index)
            return
        # deeper dirs: list + delete (DeleteFolderChildren :193-201),
        # recursing for the subtree contract
        for entry in list(self.list_directory_entries(base,
                                                      limit=1 << 30)):
            if entry.is_directory:
                self.delete_folder_children(entry.full_path)
            self.delete_entry(entry.full_path)

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> Iterator[Entry]:
        base = dir_path.rstrip("/") or "/"
        index = _index_of(base, is_directory=True)
        parent = _md5(base)
        # one refresh per listing instead of refresh=true on every
        # write (the per-write form serializes real-ES ingest behind
        # segment creation; GET-by-id is realtime and needs neither)
        try:
            self.client.request("POST", f"/{index}/_refresh", {},
                                ok_statuses=(200, 404))
        except ElasticError:
            pass
        must: list = [{"term": {"ParentId": parent}}]
        if start_file_name:
            op = "gte" if include_start else "gt"
            must.append({"range": {"Name": {op: start_file_name}}})
        if prefix:
            must.append({"prefix": {"Name": prefix}})
        search_after = None
        got = 0
        while got < limit:
            body: dict = {
                "query": {"bool": {"must": must}},
                "sort": [{"Name": "asc"}],
                "size": min(self.max_page_size, limit - got),
            }
            if search_after:
                body["search_after"] = search_after
            try:
                res = self.client.request(
                    "POST", f"/{index}/_search", body, ok_statuses=(200,))
            except ElasticError as e:
                if e.status == 404:
                    return
                raise
            hits = res.get("hits", {}).get("hits", [])
            if not hits:
                return
            for h in hits:
                search_after = h.get("sort") or [
                    h.get("_source", {}).get("Name", "")]
                entry = self._decode(h.get("_source", {}), base)
                if entry is None:
                    continue
                yield entry
                got += 1
                if got >= limit:
                    return
            if len(hits) < body["size"]:
                return

    # -- kv (elastic_store_kv.go) ------------------------------------------

    def kv_put(self, key: bytes, value: bytes) -> None:
        self.client.request(
            "PUT", f"/{INDEX_KV}/_doc/{key.hex()}",
            {"Value": base64.b64encode(value).decode()})

    def kv_get(self, key: bytes) -> bytes | None:
        try:
            doc = self.client.request("GET",
                                      f"/{INDEX_KV}/_doc/{key.hex()}",
                                      ok_statuses=(200,))
        except ElasticError as e:
            if e.status == 404:
                return None
            raise
        if not doc.get("found"):
            return None
        return base64.b64decode(doc["_source"]["Value"])

    def close(self) -> None:
        self.client.close()


register_store("elastic7", ElasticStore)
register_store("elastic", ElasticStore)
