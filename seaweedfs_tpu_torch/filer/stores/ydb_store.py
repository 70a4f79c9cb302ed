"""YDB filer store over the real Table-service gRPC API.

Counterpart of seaweedfs_tpu/filer/stores/ydb_store.py (SeaweedFS
weed/filer/ydb/ydb_store.go, backed by ydb-go-sdk/v3): no YDB client
library is used, so the store drives YDB's public wire surface itself —
``Ydb.Table.V1.TableService`` (CreateSession / ExecuteDataQuery /
ExecuteSchemeQuery) with the Operation/Any response envelope, through
the repo pb stack (seaweedfs_tpu/pb/proto/ydb_*.proto). The data model
matches the reference exactly:

  * one `filemeta` table: (dir_hash Int64, name Utf8, directory Utf8,
    meta String, expire_at Optional<Uint32>), PK (dir_hash, name)
    (ydb_types.go:38 createTableOptions)
  * dir_hash = md5-prefix int64 of the directory
    (util.HashStringToLong, weed/util/bytes.go:77)
  * the six YQL statements are the reference's verbatim
    (ydb_queries.go): DECLARE'd parameters, UPSERT upserts,
    paged LIKE-prefixed listings with Truncated() continuation
  * kv_*: key -> (base64(key[:8]) dir, int64 head hash, base64 tail
    name) through the same upsert/find/delete statements
    (abstract_sql.GenDirAndName, ydb_store_kv.go:17)
  * sessions: created lazily, recreated on BAD_SESSION/SESSION_EXPIRED
    (the sdk's session pool collapsed to pool-size 1 — the filer's
    store SPI is lock-serialized per connection here like the other
    wire stores)
"""

from __future__ import annotations

import base64
import hashlib
import struct
import threading
from typing import Iterator

import grpc

from ...pb import filer_pb2, rpc
from ...pb import ydb_operation_pb2 as O
from ...pb import ydb_table_pb2 as T
from ...pb import ydb_value_pb2 as V
from ..entry import Entry
from ..filerstore import register_store
from .abstract_sql import like_escape
from .wire_common import split_dir_name

TABLE = "filemeta"

# ydb_queries.go — kept verbatim modulo the PRAGMA prefix value
_UPSERT = """
PRAGMA TablePathPrefix("{p}");
DECLARE $dir_hash AS int64;
DECLARE $directory AS Utf8;
DECLARE $name AS Utf8;
DECLARE $meta AS String;
DECLARE $expire_at AS Optional<uint32>;

UPSERT INTO filemeta
    (dir_hash, name, directory, meta, expire_at)
VALUES
    ($dir_hash, $name, $directory, $meta, $expire_at);"""

_DELETE = """
PRAGMA TablePathPrefix("{p}");
DECLARE $dir_hash AS int64;
DECLARE $name AS Utf8;

DELETE FROM filemeta
WHERE dir_hash = $dir_hash AND name = $name;"""

_FIND = """
PRAGMA TablePathPrefix("{p}");
DECLARE $dir_hash AS int64;
DECLARE $name AS Utf8;

SELECT meta
FROM filemeta
WHERE dir_hash = $dir_hash AND name = $name;"""

_DELETE_FOLDER_CHILDREN = """
PRAGMA TablePathPrefix("{p}");
DECLARE $dir_hash AS int64;
DECLARE $directory AS Utf8;

DELETE FROM filemeta
WHERE dir_hash = $dir_hash AND directory = $directory;"""

_LIST = """
PRAGMA TablePathPrefix("{p}");
DECLARE $dir_hash AS int64;
DECLARE $directory AS Utf8;
DECLARE $start_name AS Utf8;
DECLARE $prefix AS Utf8;
DECLARE $limit AS Uint64;

SELECT name, meta
FROM filemeta
WHERE dir_hash = $dir_hash AND directory = $directory and name > $start_name and name LIKE $prefix ESCAPE '!'
ORDER BY name ASC LIMIT $limit;"""
# ESCAPE '!' + like_escape'd prefix: a literal '_'/'%' in the prefix
# must not act as a YQL wildcard — unescaped, 'my_' also matched 'myX',
# and those rows were then dropped client-side WITHOUT advancing
# `emitted`, so real matches past the server page silently vanished
# from listings (the reference inherits this; abstract_sql here escapes)

_LIST_INCLUSIVE = _LIST.replace("name > $start_name", "name >= $start_name")

_CREATE_TABLE = """
PRAGMA TablePathPrefix("{p}");
CREATE TABLE filemeta (
    dir_hash Int64,
    directory Utf8,
    name Utf8,
    meta String,
    expire_at Uint32,
    PRIMARY KEY (dir_hash, name)
)
WITH (
    TTL = Interval("PT0S") ON expire_at AS SECONDS
);"""
# The WITH TTL clause is createTableOptions' TimeToLiveSettings
# (ydb_types.go:46: expire_at, unit seconds, value-since-epoch) in YQL
# form — a real server purges rows once expire_at passes. NB the
# reference writes entry.TtlSec (a DURATION) into this epoch-seconds
# column; the value layout is kept verbatim for data compatibility.


class YdbError(IOError):
    def __init__(self, status: int, issues: str):
        self.status = status
        super().__init__(f"ydb status {status}: {issues}")


def hash_string_to_long(s: str) -> int:
    """util.HashStringToLong (weed/util/bytes.go:77): the md5 prefix
    folded big-endian into a SIGNED int64."""
    b = hashlib.md5(s.encode()).digest()
    v = 0
    for i in range(8):
        v = (v << 8) + b[i]
    return struct.unpack(">q", struct.pack(">Q", v & 0xFFFFFFFFFFFFFFFF))[0]


def gen_dir_and_name(key: bytes) -> tuple[str, int, str]:
    """abstract_sql.GenDirAndName: kv keys ride the filemeta table."""
    key = key + b"\x00" * max(0, 8 - len(key))
    dir_hash = struct.unpack(">q", key[:8])[0]
    return (base64.b64encode(key[:8]).decode(), dir_hash,
            base64.b64encode(key[8:]).decode())


# -- typed parameter helpers (types.Int64Value etc., ydb_types.go) ---------

def _int64(v: int) -> V.TypedValue:
    return V.TypedValue(type=V.Type(type_id=V.Type.INT64),
                        value=V.Value(int64_value=v))


def _utf8(s: str) -> V.TypedValue:
    return V.TypedValue(type=V.Type(type_id=V.Type.UTF8),
                        value=V.Value(text_value=s))


def _string(b: bytes) -> V.TypedValue:
    return V.TypedValue(type=V.Type(type_id=V.Type.STRING),
                        value=V.Value(bytes_value=b))


def _uint64(v: int) -> V.TypedValue:
    return V.TypedValue(type=V.Type(type_id=V.Type.UINT64),
                        value=V.Value(uint64_value=v))


def _opt_uint32(v: int | None) -> V.TypedValue:
    t = V.Type(optional_type=V.OptionalType(
        item=V.Type(type_id=V.Type.UINT32)))
    if v is None:
        return V.TypedValue(type=t, value=V.Value(null_flag_value=0))
    return V.TypedValue(type=t, value=V.Value(uint32_value=v))


_RO_TX = T.TransactionControl(
    begin_tx=T.TransactionSettings(online_read_only=T.OnlineModeSettings()),
    commit_tx=True)
_RW_TX = T.TransactionControl(
    begin_tx=T.TransactionSettings(
        serializable_read_write=T.SerializableModeSettings()),
    commit_tx=True)

# session loss -> recreate the session, then retry; transient server
# states -> plain retry (the ydb-go-sdk retryer the reference rides via
# DB.Table().Do does both transparently)
_SESSION_GONE = {O.BAD_SESSION, O.SESSION_EXPIRED}
_TRANSIENT = {O.ABORTED, O.OVERLOADED, O.UNAVAILABLE}


class YdbStore:
    """FilerStore over Ydb.Table.V1.TableService (YdbStore,
    ydb_store.go:40)."""

    name = "ydb"

    def __init__(self, *, dsn: str = "grpc://localhost:2136/local",
                 prefix: str = "", timeout: int = 10, **_kwargs):
        # dsn: grpc://host:port/database (command/scaffold.go [ydb] dsn);
        # grpcs:// dials TLS like the reference SDK — silently downgrading
        # a secure DSN to plaintext would leak metadata on the wire
        scheme, sep, rest = dsn.partition("://")
        if not sep:
            scheme, rest = "grpc", dsn
        endpoint, _, database = rest.partition("/")
        self._database = "/" + database if database else "/local"
        self._prefix = (self._database + "/" + prefix.strip("/")
                        if prefix else self._database)
        self._timeout = timeout
        if scheme == "grpc":
            self._channel = grpc.insecure_channel(endpoint)
        elif scheme == "grpcs":
            self._channel = grpc.secure_channel(
                endpoint, grpc.ssl_channel_credentials())
        else:
            raise ValueError(
                f"unsupported ydb dsn scheme {scheme!r} "
                f"(use grpc:// or grpcs://)")
        self.table = rpc.Stub(self._channel, rpc.ydb_table_service())
        self._mu = threading.Lock()      # guards _session
        self._op_mu = threading.Lock()   # serializes query round trips
        self._session = ""
        self._ensure_session()
        self._create_table()

    # -- session + operation plumbing --------------------------------------

    def _ensure_session(self) -> str:
        with self._mu:
            if self._session:
                return self._session
            resp = self.table.CreateSession(T.CreateSessionRequest(),
                                            timeout=self._timeout)
            result = self._unwrap(resp.operation, T.CreateSessionResult)
            self._session = result.session_id
            return self._session

    @staticmethod
    def _unwrap(operation: O.Operation, result_cls):
        if operation.status != O.SUCCESS:
            raise YdbError(operation.status,
                           "; ".join(i.message for i in operation.issues))
        out = result_cls()
        if operation.result.value or operation.result.type_url:
            if not operation.result.Unpack(out):
                raise YdbError(operation.status,
                               f"unexpected result type "
                               f"{operation.result.type_url}")
        return out

    def _create_table(self) -> None:
        try:
            self._scheme(_CREATE_TABLE.format(p=self._prefix))
        except YdbError as e:
            # already-exists surfaces as SCHEME_ERROR/GENERIC_ERROR on
            # a live server; the reference logs and continues too
            if e.status not in (O.SCHEME_ERROR, O.GENERIC_ERROR):
                raise

    def _scheme(self, yql: str) -> None:
        with self._op_mu:
            sid = self._ensure_session()
            resp = self.table.ExecuteSchemeQuery(
                T.ExecuteSchemeQueryRequest(session_id=sid, yql_text=yql),
                timeout=self._timeout)
            self._unwrap(resp.operation, T.ExecuteSchemeQueryResponse)

    def _execute(self, yql: str, params: dict, tx=_RW_TX
                 ) -> T.ExecuteQueryResult:
        # one in-flight query per session: a real YDB answers
        # SESSION_BUSY to concurrent queries on one session, so the
        # whole round trip is serialized like the sibling wire stores
        with self._op_mu:
            last: YdbError | None = None
            for attempt in range(3):
                sid = self._ensure_session()
                resp = self.table.ExecuteDataQuery(
                    T.ExecuteDataQueryRequest(
                        session_id=sid, tx_control=tx,
                        query=T.Query(yql_text=yql), parameters=params,
                        query_cache_policy=T.QueryCachePolicy(
                            keep_in_cache=True)),
                    timeout=self._timeout)
                try:
                    return self._unwrap(resp.operation,
                                        T.ExecuteQueryResult)
                except YdbError as e:
                    last = e
                    if e.status in _SESSION_GONE:
                        with self._mu:
                            self._session = ""  # stale: recreate
                        continue
                    if e.status in _TRANSIENT:
                        continue  # e.g. tx-lock ABORTED on a write race
                    raise
            raise last

    # -- FilerStore SPI ----------------------------------------------------

    _split = staticmethod(split_dir_name)

    def insert_entry(self, entry: Entry) -> None:
        d, n = self._split(entry.full_path)
        ttl = entry.attr.ttl_sec if entry.attr else 0
        self._execute(_UPSERT.format(p=self._prefix), {
            "$dir_hash": _int64(hash_string_to_long(d)),
            "$directory": _utf8(d),
            "$name": _utf8(n),
            "$meta": _string(entry.to_pb().SerializeToString()),
            "$expire_at": _opt_uint32(ttl if ttl > 0 else None),
        })

    update_entry = insert_entry

    def _find_meta(self, dir_hash: int, name: str) -> bytes | None:
        res = self._execute(_FIND.format(p=self._prefix), {
            "$dir_hash": _int64(dir_hash),
            "$name": _utf8(name),
        }, tx=_RO_TX)
        for rs in res.result_sets:
            for row in rs.rows:
                return row.items[0].bytes_value
        return None

    def find_entry(self, full_path: str) -> Entry | None:
        d, n = self._split(full_path)
        blob = self._find_meta(hash_string_to_long(d), n)
        if blob is None:
            return None
        return Entry.from_pb(d, filer_pb2.Entry.FromString(blob))

    def delete_entry(self, full_path: str) -> None:
        d, n = self._split(full_path)
        self._execute(_DELETE.format(p=self._prefix), {
            "$dir_hash": _int64(hash_string_to_long(d)),
            "$name": _utf8(n),
        })

    def _all_subdir_names(self, d: str) -> list[str]:
        """Every subdirectory child of `d`, paged to exhaustion — a
        fixed listing cap would strand subtrees past it as orphans once
        the parent rows are deleted."""
        out: list[str] = []
        start, inclusive = "", True
        while True:
            page = list(self.list_directory_entries(
                d, start, include_start=inclusive, limit=4096))
            out.extend(e.name for e in page if e.is_directory)
            if len(page) < 4096:
                return out
            start, inclusive = page[-1].name, False

    def delete_folder_children(self, full_path: str) -> None:
        """One dir_hash bucket per call in the reference; this repo's
        store contract is whole-subtree, so recurse through listings
        (same shape as the tikv store)."""
        stack = [full_path.rstrip("/") or "/"]
        while stack:
            d = stack.pop()
            subdirs = self._all_subdir_names(d)
            self._execute(
                _DELETE_FOLDER_CHILDREN.format(p=self._prefix), {
                    "$dir_hash": _int64(hash_string_to_long(d)),
                    "$directory": _utf8(d),
                })
            stack.extend((d.rstrip("/") or "") + "/" + s for s in subdirs)

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> Iterator[Entry]:
        base = dir_path.rstrip("/") or "/"
        dir_hash = hash_string_to_long(base)
        yql = (_LIST_INCLUSIVE if include_start else _LIST)
        start = start_file_name
        emitted = 0
        while emitted < limit:
            res = self._execute(yql.format(p=self._prefix), {
                "$dir_hash": _int64(dir_hash),
                "$directory": _utf8(base),
                "$start_name": _utf8(start),
                "$prefix": _utf8(like_escape(prefix) + "%"),
                "$limit": _uint64(limit - emitted),
            }, tx=_RO_TX)
            rows = [row for rs in res.result_sets for row in rs.rows]
            truncated = any(rs.truncated for rs in res.result_sets)
            for row in rows:
                name = row.items[0].text_value
                blob = row.items[1].bytes_value
                start = name
                if prefix and not name.startswith(prefix):
                    # YQL LIKE treats '_'/'%' as wildcards; the siblings
                    # all re-verify the literal prefix client-side
                    continue
                yield Entry.from_pb(base,
                                    filer_pb2.Entry.FromString(blob))
                emitted += 1
                if emitted >= limit:
                    return
            if not truncated or not rows:
                return
            yql = _LIST  # continuation pages are strictly-greater

    # -- kv (ydb_store_kv.go via abstract_sql.GenDirAndName) ---------------

    def kv_put(self, key: bytes, value: bytes) -> None:
        d, dir_hash, name = gen_dir_and_name(key)
        self._execute(_UPSERT.format(p=self._prefix), {
            "$dir_hash": _int64(dir_hash),
            "$directory": _utf8(d),
            "$name": _utf8(name),
            "$meta": _string(value),
            "$expire_at": _opt_uint32(None),
        })

    def kv_get(self, key: bytes) -> bytes | None:
        _, dir_hash, name = gen_dir_and_name(key)
        return self._find_meta(dir_hash, name)

    def close(self) -> None:
        try:
            if self._session:
                self.table.DeleteSession(
                    T.DeleteSessionRequest(session_id=self._session),
                    timeout=2)
        except grpc.RpcError:
            pass
        self._channel.close()


register_store("ydb", YdbStore)
