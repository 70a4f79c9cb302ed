"""Cassandra filer store speaking the CQL binary protocol v4.

Counterpart of seaweedfs_tpu/filer/stores/cql_wire.py (SeaweedFS
weed/filer/cassandra/cassandra_store.go, backed by gocql): no
cassandra-driver is used, so the store implements the native protocol
itself — frame codec, STARTUP/READY, PasswordAuthenticator
(AUTHENTICATE/AUTH_RESPONSE/AUTH_SUCCESS), and QUERY with bound values —
the same statement set the reference runs:

  * ``INSERT INTO filemeta (directory,name,meta) VALUES(?,?,?)
    USING TTL ?`` (InsertEntry, cassandra_store.go:108; CQL inserts
    are upserts, so UpdateEntry shares it)
  * ``SELECT meta FROM filemeta WHERE directory=? AND name=?`` (:130)
  * ``DELETE FROM filemeta WHERE directory=? AND name=?`` (:160)
  * ``DELETE FROM filemeta WHERE directory=?`` (:174) — plus
    python-side recursion for the repo-wide subtree contract
  * ``SELECT name, meta FROM filemeta WHERE directory=? AND name>?
    ORDER BY name ASC LIMIT ?`` (:192-194)
  * kv_* via the 8-byte dir/name key split (cassandra_store_kv.go:53);
    binary keys map through latin-1 so they stay valid UTF-8 varchars

The keyspace and table are created IF NOT EXISTS at startup (the
reference asks operators to create them by hand; self-bootstrap is
kinder and harmless when they already exist).
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Iterator

from ...pb import filer_pb2
from ..entry import Entry
from ..filerstore import register_store
from .wire_common import split_dir_name

# opcodes
OP_ERROR, OP_STARTUP, OP_READY, OP_AUTHENTICATE = 0x00, 0x01, 0x02, 0x03
OP_QUERY, OP_RESULT, OP_AUTH_RESPONSE, OP_AUTH_SUCCESS = (
    0x07, 0x08, 0x0F, 0x10)

# result kinds
K_VOID, K_ROWS, K_SET_KEYSPACE = 1, 2, 3

# type option ids
T_BLOB, T_INT, T_VARCHAR = 0x0003, 0x0009, 0x000D


class CqlError(Exception):
    def __init__(self, code: int, message: str):
        self.code = code
        self.message = message
        super().__init__(f"(0x{code:04x}) {message}")


def _prefix_upper(prefix: str) -> str | None:
    """Smallest string greater than every string with this prefix
    (rightmost incrementable char bumped); None if none exists."""
    for i in reversed(range(len(prefix))):
        if ord(prefix[i]) < 0x10FFFF:
            return prefix[:i] + chr(ord(prefix[i]) + 1)
    return None


def _string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">H", len(b)) + b


def _long_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">I", len(b)) + b


def _value(v) -> bytes:
    if v is None:
        return struct.pack(">i", -1)
    if isinstance(v, int):
        raw = struct.pack(">i", v)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        raw = bytes(v)
    else:
        raw = str(v).encode("utf-8")
    return struct.pack(">i", len(raw)) + raw


class CqlConnection:
    def __init__(self, *, host="localhost", port=9042, username="",
                 password="", connect_timeout=10, **_ignored):
        self._host, self._port = host, int(port)
        self._user, self._password = username, password
        self._connect_timeout = connect_timeout
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._buf = b""
        self._keyspace = ""
        self._connect()

    # -- frames ------------------------------------------------------------

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("cassandra server closed connection")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _send_frame(self, opcode: int, body: bytes) -> None:
        self._sock.sendall(struct.pack(">BBhBI", 0x04, 0, 0, opcode,
                                       len(body)) + body)

    def _recv_frame(self) -> tuple[int, bytes]:
        header = self._recv_exact(9)
        _ver, _flags, _stream, opcode, length = struct.unpack(">BBhBI",
                                                              header)
        return opcode, self._recv_exact(length)

    # -- connect + auth ----------------------------------------------------

    def _connect(self) -> None:
        self._sock = socket.create_connection(
            (self._host, self._port), timeout=self._connect_timeout)
        self._sock.settimeout(30)
        self._buf = b""
        try:
            self._send_frame(OP_STARTUP, struct.pack(">H", 1)
                             + _string("CQL_VERSION") + _string("3.0.0"))
            opcode, body = self._recv_frame()
            if opcode == OP_AUTHENTICATE:
                token = (b"\x00" + self._user.encode()
                         + b"\x00" + self._password.encode())
                self._send_frame(OP_AUTH_RESPONSE,
                                 struct.pack(">i", len(token)) + token)
                opcode, body = self._recv_frame()
                if opcode == OP_ERROR:
                    raise self._parse_error(body)
                if opcode != OP_AUTH_SUCCESS:
                    raise CqlError(0, f"unexpected auth opcode {opcode}")
            elif opcode == OP_ERROR:
                raise self._parse_error(body)
            elif opcode != OP_READY:
                raise CqlError(0, f"unexpected startup opcode {opcode}")
            if self._keyspace:
                # a reconnect must replay USE: statements are
                # unqualified, and a fresh session has no keyspace
                self._query_locked(f"USE {self._keyspace}", ())
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

    @staticmethod
    def _parse_error(body: bytes) -> CqlError:
        (code,) = struct.unpack(">i", body[:4])
        (n,) = struct.unpack(">H", body[4:6])
        return CqlError(code, body[6:6 + n].decode("utf-8", "replace"))

    # -- query -------------------------------------------------------------

    def set_keyspace(self, keyspace: str) -> None:
        """USE now and on every reconnect."""
        self.query(f"USE {keyspace}")
        self._keyspace = keyspace

    def query(self, cql: str, params: tuple = ()) -> list[tuple]:
        with self._lock:
            if self._sock is None:
                self._connect()
            try:
                return self._query_locked(cql, params)
            except CqlError:
                raise               # server error: stream is still framed
            except Exception:
                self._mark_broken()
                raise

    def _query_locked(self, cql: str, params: tuple) -> list[tuple]:
        flags = 0x01 if params else 0x00
        body = _long_string(cql) + struct.pack(">HB", 0x0001, flags)
        if params:
            body += struct.pack(">H", len(params))
            body += b"".join(_value(p) for p in params)
        self._send_frame(OP_QUERY, body)
        opcode, rbody = self._recv_frame()
        if opcode == OP_ERROR:
            raise self._parse_error(rbody)
        if opcode != OP_RESULT:
            raise CqlError(0, f"unexpected result opcode {opcode}")
        (kind,) = struct.unpack(">i", rbody[:4])
        if kind != K_ROWS:
            return []
        off = 4
        (mflags, ncols) = struct.unpack_from(">ii", rbody, off)
        off += 8
        if mflags & 0x0001:          # global_tables_spec
            for _ in range(2):       # keyspace + table
                (n,) = struct.unpack_from(">H", rbody, off)
                off += 2 + n
        types = []
        for _ in range(ncols):
            if not mflags & 0x0001:
                for _ in range(2):
                    (n,) = struct.unpack_from(">H", rbody, off)
                    off += 2 + n
            (n,) = struct.unpack_from(">H", rbody, off)   # column name
            off += 2 + n
            (tid,) = struct.unpack_from(">H", rbody, off)
            off += 2
            if tid == 0x0000:        # custom type: string follows
                (n,) = struct.unpack_from(">H", rbody, off)
                off += 2 + n
            types.append(tid)
        (nrows,) = struct.unpack_from(">i", rbody, off)
        off += 4
        rows = []
        for _ in range(nrows):
            vals = []
            for tid in types:
                (ln,) = struct.unpack_from(">i", rbody, off)
                off += 4
                if ln < 0:
                    vals.append(None)
                    continue
                raw = rbody[off:off + ln]
                off += ln
                if tid == T_INT:
                    vals.append(int.from_bytes(raw, "big", signed=True))
                elif tid == T_VARCHAR:
                    vals.append(raw.decode("utf-8", "replace"))
                else:
                    vals.append(bytes(raw))
            rows.append(tuple(vals))
        return rows

    def close(self) -> None:
        self._mark_broken()


class CassandraStore:
    """FilerStore over the CQL client (CassandraStore,
    cassandra_store.go:23)."""

    name = "cassandra"

    def __init__(self, *, host="localhost", port=9042,
                 keyspace="seaweedfs", username="", password="", **kwargs):
        self.conn = CqlConnection(host=host, port=port, username=username,
                                  password=password, **kwargs)
        self.conn.query(
            f"CREATE KEYSPACE IF NOT EXISTS {keyspace} WITH replication = "
            f"{{'class': 'SimpleStrategy', 'replication_factor': 1}}")
        self.conn.set_keyspace(keyspace)
        self.conn.query(
            "CREATE TABLE IF NOT EXISTS filemeta (directory varchar, "
            "name varchar, meta blob, PRIMARY KEY ((directory), name)) "
            "WITH CLUSTERING ORDER BY (name ASC)")

    _split = staticmethod(split_dir_name)

    def insert_entry(self, entry: Entry) -> None:
        d, n = self._split(entry.full_path)
        blob = entry.to_pb().SerializeToString()
        self.conn.query(
            "INSERT INTO filemeta (directory,name,meta) VALUES(?,?,?) "
            "USING TTL ?", (d, n, blob,
                            max(int(entry.attr.ttl_sec or 0), 0)))

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        d, n = self._split(full_path)
        rows = self.conn.query(
            "SELECT meta FROM filemeta WHERE directory=? AND name=?",
            (d, n))
        if not rows or not rows[0][0]:
            return None
        pb = filer_pb2.Entry.FromString(rows[0][0])
        return Entry.from_pb(d, pb)

    def delete_entry(self, full_path: str) -> None:
        d, n = self._split(full_path)
        self.conn.query(
            "DELETE FROM filemeta WHERE directory=? AND name=?", (d, n))

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/") or "/"
        # the reference deletes only the exact partition (:174) and lets
        # the filer recurse; recurse here for the repo-wide contract
        for entry in list(self.list_directory_entries(base,
                                                      limit=1 << 30)):
            if entry.is_directory:
                self.delete_folder_children(entry.full_path)
        self.conn.query("DELETE FROM filemeta WHERE directory=?", (base,))

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> Iterator[Entry]:
        base = dir_path.rstrip("/") or "/"
        op = ">=" if include_start else ">"
        start = start_file_name
        if prefix and prefix > start:
            start, op = prefix, ">="
        # bound the clustering range by the prefix so the server-side
        # LIMIT counts prefix-matching rows (filtering after LIMIT
        # silently truncates prefixed listings)
        upper = _prefix_upper(prefix) if prefix else None
        cql = (f"SELECT name, meta FROM filemeta WHERE directory=? "
               f"AND name{op}?"
               + (" AND name<?" if upper else "")
               + " ORDER BY name ASC LIMIT ?")
        params = ((base, start, upper, limit) if upper
                  else (base, start, limit))
        for name, blob in self.conn.query(cql, params):
            if prefix and not name.startswith(prefix):
                continue  # defensive; range already bounds the prefix
            if not blob:
                continue
            pb = filer_pb2.Entry.FromString(blob)
            yield Entry.from_pb(base, pb)

    # -- kv (cassandra_store_kv.go; 8-byte dir/name split) -----------------

    @staticmethod
    def _kv_dir_name(key: bytes) -> tuple[str, str]:
        key = key + b"\x00" * max(0, 8 - len(key))
        return (key[:8].decode("latin-1"), key[8:].decode("latin-1"))

    def kv_put(self, key: bytes, value: bytes) -> None:
        d, n = self._kv_dir_name(key)
        self.conn.query(
            "INSERT INTO filemeta (directory,name,meta) VALUES(?,?,?) "
            "USING TTL ?", (d, n, value, 0))

    def kv_get(self, key: bytes) -> bytes | None:
        d, n = self._kv_dir_name(key)
        rows = self.conn.query(
            "SELECT meta FROM filemeta WHERE directory=? AND name=?",
            (d, n))
        return rows[0][0] if rows else None

    def close(self) -> None:
        self.conn.close()


register_store("cassandra", CassandraStore)
