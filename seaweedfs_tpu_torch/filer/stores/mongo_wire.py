"""Pure-python MongoDB wire-protocol client + filer store.

Counterpart of seaweedfs_tpu/filer/stores/mongo_wire.py (SeaweedFS
weed/filer/mongodb/mongodb_store.go, which uses the official
mongo-driver): no pymongo is used, so this speaks OP_MSG (opcode 2013,
the only opcode modern servers accept) with the in-repo BSON codec, like
pg_wire/mysql_wire do for SQL.

Surface — exactly the reference store's command set:

  * ``update`` with upsert (InsertEntry/UpdateEntry,
    mongodb_store.go:103-127)
  * ``find`` with filter/sort/limit + ``getMore`` cursor draining
    (FindEntry :129, ListDirectoryEntries :186)
  * ``delete`` (DeleteEntry :157, DeleteFolderChildren :170)
  * ``createIndexes`` unique (directory, name) (indexUnique :68)
  * SCRAM-SHA-256 auth via saslStart/saslContinue on $db=admin
    (the driver's default for MongoDB >= 4.0)

The kv_* family mirrors mongodb_store_kv.go's genDirAndName split
(first 8 key bytes -> directory, rest -> name); binary keys are mapped
through latin-1 so they stay valid BSON UTF-8 strings losslessly (the
Go driver writes raw bytes into the string, which is out-of-spec BSON).

DeleteFolderChildren in the reference removes only the exact directory
row set (the filer recurses); this store additionally accepts the
repo-wide subtree contract by matching descendants with an anchored
$regex, matching the other stores' LIKE semantics.
"""

from __future__ import annotations

import re
import socket
import struct
import threading
from typing import Iterator

from ...pb import filer_pb2
from ..entry import Entry
from ..filerstore import register_store
from .bson import Int64, Regex, decode_doc, encode_doc
from .wire_common import ScramClient, split_dir_name

OP_MSG = 2013


class MongoError(Exception):
    def __init__(self, code: int, message: str):
        self.code = code
        self.message = message
        super().__init__(f"({code}) {message}")


class MongoConnection:
    def __init__(self, *, host="localhost", port=27017, user="",
                 password="", connect_timeout=10, **_ignored):
        self._host, self._port = host, int(port)
        self._user, self._password = user, password
        self._connect_timeout = connect_timeout
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._buf = b""
        self._req = 0
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.create_connection(
            (self._host, self._port), timeout=self._connect_timeout)
        self._sock.settimeout(30)
        self._buf = b""
        try:
            if self._user:
                self._auth()
        except Exception:
            self._mark_broken()
            raise

    def _mark_broken(self) -> None:
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._sock = None
        self._buf = b""

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("mongodb server closed connection")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _roundtrip(self, doc: dict) -> dict:
        self._req += 1
        body = b"\x00\x00\x00\x00" + b"\x00" + encode_doc(doc)
        header = struct.pack("<iiii", 16 + len(body), self._req, 0, OP_MSG)
        self._sock.sendall(header + body)
        (length, _rid, _rto, opcode) = struct.unpack("<iiii",
                                                     self._recv_exact(16))
        payload = self._recv_exact(length - 16)
        if opcode != OP_MSG:
            raise ConnectionError(f"unexpected reply opcode {opcode}")
        # flagBits(4) + kind-0 section document
        if payload[4] != 0:
            raise ConnectionError("unsupported OP_MSG section kind")
        reply, _ = decode_doc(payload, 5)
        return reply

    @staticmethod
    def _check_ok(reply: dict, what: str) -> dict:
        if reply.get("ok") != 1:     # covers int 1 and double 1.0
            raise MongoError(int(reply.get("code", 0)),
                             str(reply.get("errmsg", what)))
        # ok:1 with per-document failures is still a failure (the Go
        # driver surfaces writeErrors from UpdateOne/DeleteMany too) —
        # swallowing them would silently lose acknowledged metadata
        werrs = reply.get("writeErrors")
        if werrs:
            first = werrs[0] if isinstance(werrs, list) else {}
            raise MongoError(int(first.get("code", 0)),
                             f"write error: {first.get('errmsg', werrs)}")
        return reply

    def command(self, db: str, doc: dict) -> dict:
        with self._lock:
            if self._sock is None:
                self._connect()
            try:
                reply = self._roundtrip({**doc, "$db": db})
            except MongoError:
                raise
            except Exception:
                self._mark_broken()
                raise
        return self._check_ok(reply, "command failed")

    def _auth(self) -> None:
        scram = ScramClient(self._password, username=self._user)
        first = self._check_ok(self._roundtrip({
            "saslStart": 1, "mechanism": "SCRAM-SHA-256",
            "payload": scram.client_first(), "$db": "admin"}),
            "saslStart failed")
        final = self._check_ok(self._roundtrip({
            "saslContinue": 1,
            "conversationId": first.get("conversationId", 1),
            "payload": scram.client_final(first["payload"]),
            "$db": "admin"}), "auth failed")
        scram.verify_server(final["payload"])
        for _ in range(3):           # bounded: a server may want one empty
            if final.get("done"):    # closing exchange, never more
                return
            final = self._check_ok(self._roundtrip({
                "saslContinue": 1,
                "conversationId": first.get("conversationId", 1),
                "payload": b"", "$db": "admin"}), "auth failed")
        if not final.get("done"):
            raise MongoError(0, "SASL conversation never completed")

    def close(self) -> None:
        self._mark_broken()


class MongodbStore:
    """FilerStore over the OP_MSG client (mongodb_store.go:21)."""

    name = "mongodb"
    COLLECTION = "filemeta"

    def __init__(self, *, host="localhost", port=27017, database="seaweedfs",
                 user="", password="", **kwargs):
        self.database = database
        self.conn = MongoConnection(host=host, port=port, user=user,
                                    password=password, **kwargs)
        self.conn.command(self.database, {
            "createIndexes": self.COLLECTION,
            "indexes": [{"key": {"directory": 1, "name": 1},
                         "name": "directory_1_name_1", "unique": True}]})

    _split = staticmethod(split_dir_name)

    def _upsert(self, d: str, n: str, meta: bytes) -> None:
        self.conn.command(self.database, {
            "update": self.COLLECTION,
            "updates": [{"q": {"directory": d, "name": n},
                         "u": {"$set": {"meta": meta}}, "upsert": True}]})

    def insert_entry(self, entry: Entry) -> None:
        d, n = self._split(entry.full_path)
        self._upsert(d, n, entry.to_pb().SerializeToString())

    update_entry = insert_entry

    def _find(self, flt: dict, sort: dict | None = None,
              limit: int = 0) -> Iterator[dict]:
        cmd: dict = {"find": self.COLLECTION, "filter": flt}
        if sort:
            cmd["sort"] = sort
        if limit:
            cmd["limit"] = limit
        reply = self.conn.command(self.database, cmd)
        cursor = reply["cursor"]
        try:
            batch = cursor.get("firstBatch", [])
            yield from batch
            seen = len(batch)
            while cursor.get("id"):
                reply = self.conn.command(self.database, {
                    "getMore": Int64(cursor["id"]),
                    "collection": self.COLLECTION})
                cursor = reply["cursor"]
                batch = cursor.get("nextBatch", [])
                if limit and seen + len(batch) > limit:
                    batch = batch[:limit - seen]
                yield from batch
                seen += len(batch)
                if limit and seen >= limit:
                    break
        finally:
            # consumer may abandon the generator mid-listing; a live
            # server-side cursor would otherwise linger for its full
            # timeout and count against open-cursor limits
            if cursor.get("id"):
                try:
                    self.conn.command(self.database, {
                        "killCursors": self.COLLECTION,
                        "cursors": [Int64(cursor["id"])]})
                # lint: allow-broad-except(closing a cursor is best effort)
                except Exception:
                    pass

    def find_entry(self, full_path: str) -> Entry | None:
        d, n = self._split(full_path)
        for doc in self._find({"directory": d, "name": n}, limit=1):
            meta = doc.get("meta") or b""
            if not meta:
                return None
            pb = filer_pb2.Entry.FromString(meta)
            return Entry.from_pb(d, pb)
        return None

    def delete_entry(self, full_path: str) -> None:
        d, n = self._split(full_path)
        self.conn.command(self.database, {
            "delete": self.COLLECTION,
            "deletes": [{"q": {"directory": d, "name": n}, "limit": 0}]})

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/") or "/"
        q = {"$or": [{"directory": base},
                     {"directory": Regex("^" + re.escape(base) + "/")}]}
        self.conn.command(self.database, {
            "delete": self.COLLECTION, "deletes": [{"q": q, "limit": 0}]})

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> Iterator[Entry]:
        base = dir_path.rstrip("/") or "/"
        name_cond: dict = {"$gte" if include_start else "$gt":
                           start_file_name}
        flt: dict = {"directory": base, "name": name_cond}
        if prefix:
            flt["name"] = {**name_cond,
                           "$regex": Regex("^" + re.escape(prefix))}
        for doc in self._find(flt, sort={"name": 1}, limit=limit):
            meta = doc.get("meta") or b""
            if not meta:
                continue
            pb = filer_pb2.Entry.FromString(meta)
            yield Entry.from_pb(base, pb)

    # -- kv (mongodb_store_kv.go; 8-byte dir/name split) -------------------

    @staticmethod
    def _kv_dir_name(key: bytes) -> tuple[str, str]:
        key = key + b"\x00" * max(0, 8 - len(key))
        return (key[:8].decode("latin-1"), key[8:].decode("latin-1"))

    def kv_put(self, key: bytes, value: bytes) -> None:
        d, n = self._kv_dir_name(key)
        self._upsert(d, n, value)

    def kv_get(self, key: bytes) -> bytes | None:
        d, n = self._kv_dir_name(key)
        for doc in self._find({"directory": d, "name": n}, limit=1):
            # empty value != absent key (matches memory/redis stores)
            return doc.get("meta")
        return None

    def close(self) -> None:
        self.conn.close()


register_store("mongodb", MongodbStore)
