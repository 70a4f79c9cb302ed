"""Pure-python PostgreSQL wire-protocol (v3) client, DB-API flavored.

Counterpart of seaweedfs_tpu/filer/stores/pg_wire.py: the client side
that SeaweedFS gets from lib/pq (weed/filer/postgres/postgres_store.go:1
imports _ "github.com/lib/pq"). No psycopg2 is used, so the store speaks
the v3 protocol itself, the same way stores/redis.py speaks RESP.

Scope — exactly what AbstractSqlStore needs, implemented on the real
wire format so the same code path talks to an actual postgres:

  * StartupMessage + auth: trust, cleartext (3), md5 (5), and
    SCRAM-SHA-256 (10/11/12, RFC 7677 via hashlib.pbkdf2_hmac)
  * extended query protocol: Parse/Bind/Describe/Execute/Sync —
    ``%s`` DB-API placeholders are rewritten to ``$N``; parameters are
    sent with per-parameter format codes (text for str, binary for
    bytes) so bytea round-trips without hex-escaping games
  * all-binary result columns, decoded by RowDescription type OID
    (text/varchar/name -> str, bytea -> bytes, int2/4/8 -> int)
  * one statement per Sync; errors surface as PgError with the
    server's SQLSTATE + message

Transactions: like the reference's database/sql usage, statements
autocommit; ``commit()`` is a no-op kept for DB-API shape.
"""

from __future__ import annotations

import hashlib
import socket
import struct
import threading

from .wire_common import (
    ScramClient,
    WireCursor,
    recv_acked,
    rewrite_placeholders,
)


class PgError(Exception):
    def __init__(self, fields: dict[str, str]):
        self.sqlstate = fields.get("C", "")
        self.message = fields.get("M", "postgres error")
        super().__init__(f"{self.sqlstate}: {self.message}")


# binary-format decoders by type OID
_OID_TEXT = {25, 1043, 19, 18, 2275}   # text, varchar, name, char, cstring
_OID_BYTEA = 17
_OID_INT = {20: 8, 23: 4, 21: 2}       # int8/int4/int2
_OID_BOOL = 16


def _decode_col(oid: int, data: bytes | None):
    if data is None:
        return None
    if oid == _OID_BYTEA:
        return bytes(data)
    if oid in _OID_INT:
        return int.from_bytes(data, "big", signed=True)
    if oid == _OID_BOOL:
        return data != b"\x00"
    if oid in _OID_TEXT:
        return data.decode("utf-8", errors="replace")
    return bytes(data)  # unknown: hand back raw


class PgCursor(WireCursor):
    pass


class PgConnection:
    def __init__(self, *, host="localhost", port=5432, user="postgres",
                 password="", dbname="seaweedfs", connect_timeout=10,
                 application_name="seaweedfs_tpu", **_ignored):
        self.user = user
        self.password = password
        self._host, self._port = host, int(port)
        self._dbname, self._appname = dbname, application_name
        self._connect_timeout = connect_timeout
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._buf = b""
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.create_connection(
            (self._host, self._port), timeout=self._connect_timeout)
        self._sock.settimeout(30)
        self._buf = b""
        self._out: list[bytes] = []
        try:
            self._startup(self.user, self._dbname, self._appname)
        except Exception:
            # never keep a half-authenticated socket for the next query
            self._mark_broken()
            raise

    def _mark_broken(self) -> None:
        """A socket error mid-exchange leaves the stream desynchronized —
        drop the connection so the next query reconnects cleanly."""
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._sock = None
        self._buf = b""
        self._out = []

    # -- wire primitives ---------------------------------------------------

    def _send(self, type_byte: bytes, payload: bytes,
              flush: bool = True) -> None:
        """Queue one message; `flush` writes the queue in one send. The
        messages of one extended query go out together, as libpq sends
        them: written one by one, all but the first would wait for the
        server's delayed ACK (Nagle's algorithm)."""
        self._out.append(type_byte + struct.pack(">I", len(payload) + 4)
                         + payload)
        if flush:
            out, self._out = b"".join(self._out), []
            self._sock.sendall(out)

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = recv_acked(self._sock)
            if not chunk:
                raise ConnectionError("postgres server closed connection")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _recv_msg(self) -> tuple[bytes, bytes]:
        head = self._recv_exact(5)
        tag = head[:1]
        (length,) = struct.unpack(">I", head[1:5])
        return tag, self._recv_exact(length - 4)

    # -- startup + auth ----------------------------------------------------

    def _startup(self, user: str, dbname: str, appname: str) -> None:
        kv = (f"user\0{user}\0database\0{dbname}\0"
              f"application_name\0{appname}\0client_encoding\0UTF8\0\0")
        payload = struct.pack(">I", 196608) + kv.encode()
        self._sock.sendall(struct.pack(">I", len(payload) + 4) + payload)
        scram = None
        while True:
            tag, body = self._recv_msg()
            if tag == b"E":
                raise PgError(self._parse_error(body))
            if tag == b"R":
                (code,) = struct.unpack(">I", body[:4])
                if code == 0:            # AuthenticationOk
                    continue
                if code == 3:            # cleartext password
                    self._send(b"p", self.password.encode() + b"\0")
                elif code == 5:          # md5
                    salt = body[4:8]
                    inner = hashlib.md5(
                        self.password.encode() + self.user.encode()
                    ).hexdigest()
                    digest = hashlib.md5(
                        inner.encode() + salt).hexdigest()
                    self._send(b"p", b"md5" + digest.encode() + b"\0")
                elif code == 10:         # SASL: mechanism list
                    mechs = body[4:].split(b"\0")
                    if b"SCRAM-SHA-256" not in mechs:
                        raise PgError({"M": "no supported SASL mechanism",
                                       "C": "28000"})
                    scram = ScramClient(self.password)
                    first = scram.client_first()
                    self._send(b"p", b"SCRAM-SHA-256\0"
                               + struct.pack(">I", len(first)) + first)
                elif code == 11:         # SASL continue
                    final = scram.client_final(body[4:])
                    self._send(b"p", final)
                elif code == 12:         # SASL final
                    scram.verify_server(body[4:])
                else:
                    raise PgError({"M": f"unsupported auth code {code}",
                                   "C": "28000"})
            elif tag == b"Z":            # ReadyForQuery
                return
            # S (ParameterStatus), K (BackendKeyData), N (Notice): skip

    # -- extended-protocol query ------------------------------------------

    def _query(self, sql: str, params: tuple) -> tuple[list[tuple], int]:
        pg_sql = rewrite_placeholders(sql, lambda n: f"${n}")
        with self._lock:
            if self._sock is None:
                self._connect()
            try:
                return self._query_locked(pg_sql, params)
            except PgError:
                raise  # server error: stream was drained to ReadyForQuery
            except Exception:
                # Parse failures (struct.error/IndexError on a malformed
                # RowDescription/DataRow) abort mid-result-stream; the
                # unread messages up to ReadyForQuery would be consumed
                # as the NEXT query's replies. Same discipline as
                # mysql_wire: poison the connection.
                self._mark_broken()
                raise

    def _query_locked(self, pg_sql: str,
                      params: tuple) -> tuple[list[tuple], int]:
        # Parse (unnamed statement)
        self._send(b"P", b"\0" + pg_sql.encode() + b"\0"
                   + struct.pack(">h", 0), flush=False)
        # Bind: per-param format codes, all-binary results
        parts = [b"\0\0", struct.pack(">h", len(params))]
        for p in params:
            parts.append(struct.pack(
                ">h", 1 if isinstance(p, (bytes, bytearray, memoryview))
                else 0))
        parts.append(struct.pack(">h", len(params)))
        for p in params:
            if p is None:
                parts.append(struct.pack(">i", -1))
                continue
            if isinstance(p, (bytes, bytearray, memoryview)):
                raw = bytes(p)
            elif isinstance(p, bool):
                raw = b"true" if p else b"false"
            else:
                raw = str(p).encode("utf-8")
            parts.append(struct.pack(">i", len(raw)) + raw)
        parts.append(struct.pack(">hh", 1, 1))  # results: binary
        self._send(b"B", b"".join(parts), flush=False)
        self._send(b"D", b"P\0", flush=False)  # Describe portal
        self._send(b"E", b"\0" + struct.pack(">i", 0), flush=False)
        self._send(b"S", b"")        # Sync: the five go out together
        rows: list[tuple] = []
        oids: list[int] = []
        rowcount = -1
        err: dict[str, str] | None = None
        while True:
            tag, body = self._recv_msg()
            if tag == b"T":          # RowDescription
                (ncols,) = struct.unpack(">h", body[:2])
                off = 2
                oids = []
                for _ in range(ncols):
                    end = body.index(b"\0", off)
                    off = end + 1 + 18
                    (oid,) = struct.unpack(">I", body[end + 7:end + 11])
                    oids.append(oid)
            elif tag == b"D":        # DataRow
                (ncols,) = struct.unpack(">h", body[:2])
                off = 2
                vals = []
                for ci in range(ncols):
                    (ln,) = struct.unpack(">i", body[off:off + 4])
                    off += 4
                    if ln < 0:
                        vals.append(None)
                    else:
                        oid = oids[ci] if ci < len(oids) else 17
                        vals.append(_decode_col(oid, body[off:off + ln]))
                        off += ln
                rows.append(tuple(vals))
            elif tag == b"C":        # CommandComplete
                words = body.rstrip(b"\0").split()
                if words and words[-1].isdigit():
                    rowcount = int(words[-1])
            elif tag == b"E":
                err = self._parse_error(body)
            elif tag == b"Z":        # ReadyForQuery — done
                break
            # 1/2/n/s (ParseComplete/BindComplete/NoData/Suspended): skip
        if err is not None:
            raise PgError(err)
        return rows, rowcount

    @staticmethod
    def _parse_error(body: bytes) -> dict[str, str]:
        fields: dict[str, str] = {}
        off = 0
        while off < len(body) and body[off:off + 1] != b"\0":
            code = chr(body[off])
            end = body.index(b"\0", off + 1)
            fields[code] = body[off + 1:end].decode("utf-8", "replace")
            off = end + 1
        return fields

    # -- DB-API shape ------------------------------------------------------

    def cursor(self) -> PgCursor:
        return PgCursor(self)

    def commit(self) -> None:
        pass  # autocommit, one statement per Sync

    def close(self) -> None:
        try:
            self._send(b"X", b"")        # Terminate
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
