"""Pure-python MySQL client/server protocol client, DB-API flavored.

Counterpart of seaweedfs_tpu/filer/stores/mysql_wire.py: the client side
that SeaweedFS gets from go-sql-driver/mysql
(weed/filer/mysql/mysql_store.go:1). No pymysql is used, so the store
speaks the wire protocol itself, like stores/pg_wire.py does for
postgres and stores/redis.py for RESP.

Scope — what AbstractSqlStore needs, on the real wire format:

  * handshake v10 + HandshakeResponse41, mysql_native_password
    scramble (SHA1(pw) XOR SHA1(salt + SHA1(SHA1(pw)))), including the
    AuthSwitchRequest path
  * parameterized statements via the prepared-statement BINARY
    protocol (COM_STMT_PREPARE / COM_STMT_EXECUTE) — the same choice
    go-sql-driver makes — so strings, blobs and NULLs are typed on the
    wire, no escaping games; statements are cached per connection
  * parameterless statements (DDL, catalog queries) via COM_QUERY with
    text-resultset decoding (charset 63 -> bytes, else str)
  * ``%s`` placeholders are rewritten to ``?`` outside string literals
  * transparent reconnect after socket drops (autocommit)
"""

from __future__ import annotations

import hashlib
import socket
import struct
import threading

from .wire_common import WireCursor, recv_acked, rewrite_placeholders

_MAX_CACHED_STMTS = 64

# column types
T_TINY, T_SHORT, T_LONG, T_FLOAT, T_DOUBLE, T_LONGLONG = 1, 2, 3, 4, 5, 8
T_VARCHAR, T_VAR_STRING, T_STRING, T_BLOB = 15, 253, 254, 252
# fixed-width binary-protocol integer types: TINY/SHORT/LONG/LONGLONG,
# YEAR (13, 2 bytes) and INT24 (9, sent as 4 bytes on the wire)
_INT_SIZES = {T_TINY: 1, T_SHORT: 2, T_LONG: 4, T_LONGLONG: 8, 13: 2, 9: 4}

CAP_LONG_PASSWORD = 0x1
CAP_CONNECT_WITH_DB = 0x8
CAP_PROTOCOL_41 = 0x200
CAP_TRANSACTIONS = 0x2000
CAP_SECURE_CONNECTION = 0x8000
CAP_PLUGIN_AUTH = 0x80000


class MySqlError(Exception):
    def __init__(self, code: int, message: str, server: bool = False):
        self.code = code
        self.message = message
        # server=True: a well-framed ERR packet — the stream is still in
        # sync. Anything else means our parser lost its place.
        self.server = server
        super().__init__(f"({code}) {message}")


def native_password_scramble(password: str, salt: bytes) -> bytes:
    """mysql_native_password: SHA1(pw) XOR SHA1(salt + SHA1(SHA1(pw)))."""
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(salt + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def _lenenc_int(n: int) -> bytes:
    if n < 0xfb:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def _read_lenenc_int(buf: bytes, off: int) -> tuple[int | None, int]:
    c = buf[off]
    if c < 0xfb:
        return c, off + 1
    if c == 0xfb:                  # NULL (in text rows)
        return None, off + 1
    if c == 0xfc:
        return struct.unpack_from("<H", buf, off + 1)[0], off + 3
    if c == 0xfd:
        return int.from_bytes(buf[off + 1:off + 4], "little"), off + 4
    return struct.unpack_from("<Q", buf, off + 1)[0], off + 9


def _read_lenenc_bytes(buf: bytes, off: int) -> tuple[bytes | None, int]:
    n, off = _read_lenenc_int(buf, off)
    if n is None:
        return None, off
    return buf[off:off + n], off + n


class MySqlCursor(WireCursor):
    pass


class MySqlConnection:
    def __init__(self, *, host="localhost", port=3306, user="root",
                 password="", database="seaweedfs", connect_timeout=10,
                 **_ignored):
        self.user = user
        self.password = password
        self._host, self._port = host, int(port)
        self._database = database
        self._connect_timeout = connect_timeout
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._buf = b""
        self._seq = 0
        self._stmts: dict[str, tuple[int, int]] = {}  # sql -> (id, nparams)
        self._connect()

    # -- packet framing ----------------------------------------------------

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = recv_acked(self._sock)
            if not chunk:
                raise ConnectionError("mysql server closed connection")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _read_packet(self) -> bytes:
        head = self._recv_exact(4)
        length = int.from_bytes(head[:3], "little")
        self._seq = head[3] + 1
        payload = self._recv_exact(length)
        if length == 0xffffff:     # multi-packet payload
            payload += self._read_packet()
        return payload

    def _send_packet(self, payload: bytes) -> None:
        while True:
            chunk, payload = payload[:0xffffff], payload[0xffffff:]
            self._sock.sendall(len(chunk).to_bytes(3, "little")
                               + bytes([self._seq & 0xff]) + chunk)
            self._seq += 1
            if len(chunk) < 0xffffff:
                return

    def _command(self, payload: bytes) -> None:
        self._seq = 0
        self._send_packet(payload)

    @staticmethod
    def _parse_err(payload: bytes) -> MySqlError:
        code = struct.unpack_from("<H", payload, 1)[0]
        msg = payload[3:]
        if msg[:1] == b"#":        # sql-state marker
            msg = msg[6:]
        return MySqlError(code, msg.decode("utf-8", "replace"), server=True)

    # -- connect + auth ----------------------------------------------------

    def _connect(self) -> None:
        self._sock = socket.create_connection(
            (self._host, self._port), timeout=self._connect_timeout)
        self._sock.settimeout(30)
        self._buf = b""
        self._stmts = {}
        try:
            self._handshake()
        except Exception:
            # a half-open unauthenticated socket must not survive — the
            # next query would be sent pre-auth on a desynced stream
            self._mark_broken()
            raise

    def _handshake(self) -> None:
        greeting = self._read_packet()
        if greeting[:1] == b"\xff":
            raise self._parse_err(greeting)
        if greeting[0] != 10:
            raise MySqlError(0, f"unsupported protocol {greeting[0]}")
        off = 1
        end = greeting.index(b"\0", off)
        off = end + 1 + 4                      # server version + conn id
        salt = greeting[off:off + 8]
        off += 8 + 1                           # filler
        off += 2 + 1 + 2 + 2                   # caps-lo, charset, status, hi
        auth_len = greeting[off]
        off += 1 + 10
        salt += greeting[off:off + max(13, auth_len - 8)].rstrip(b"\0")[:12]
        caps = (CAP_LONG_PASSWORD | CAP_CONNECT_WITH_DB | CAP_PROTOCOL_41
                | CAP_TRANSACTIONS | CAP_SECURE_CONNECTION | CAP_PLUGIN_AUTH)
        token = native_password_scramble(self.password, salt)
        resp = (struct.pack("<IIB", caps, 1 << 24, 33) + b"\0" * 23
                + self.user.encode() + b"\0"
                + bytes([len(token)]) + token
                + self._database.encode() + b"\0"
                + b"mysql_native_password\0")
        self._send_packet(resp)
        pkt = self._read_packet()
        if pkt[:1] == b"\xfe":                 # AuthSwitchRequest
            end = pkt.index(b"\0", 1)
            plugin = pkt[1:end].decode()
            if plugin != "mysql_native_password":
                raise MySqlError(0, f"unsupported auth plugin {plugin}")
            new_salt = pkt[end + 1:].rstrip(b"\0")[:20]
            self._send_packet(native_password_scramble(self.password,
                                                       new_salt))
            pkt = self._read_packet()
        if pkt[:1] == b"\xff":
            raise self._parse_err(pkt)
        # make the documented autocommit contract real even on servers
        # configured with autocommit=0
        self._com_query("SET autocommit=1")

    def _mark_broken(self) -> None:
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._sock = None
        self._buf = b""
        self._stmts = {}

    # -- query dispatch ----------------------------------------------------

    def _query(self, sql: str, params: tuple) -> tuple[list[tuple], int]:
        my_sql = rewrite_placeholders(sql, lambda n: "?")
        with self._lock:
            if self._sock is None:
                self._connect()
            try:
                if params:
                    return self._stmt_execute(my_sql, params)
                return self._com_query(my_sql)
            except MySqlError as e:
                if not e.server:
                    # parse desync (unexpected framing): the stream can't
                    # be trusted any more
                    self._mark_broken()
                raise
            except Exception:
                # socket errors AND struct/index parse failures both leave
                # unread response bytes behind — never reuse the stream
                self._mark_broken()
                raise

    # COM_QUERY text protocol (DDL + catalog queries, no params)
    def _com_query(self, sql: str) -> tuple[list[tuple], int]:
        self._command(b"\x03" + sql.encode("utf-8"))
        pkt = self._read_packet()
        if pkt[:1] == b"\xff":
            raise self._parse_err(pkt)
        if pkt[:1] == b"\x00":                 # OK
            affected, _ = _read_lenenc_int(pkt, 1)
            return [], affected or 0
        ncols, _ = _read_lenenc_int(pkt, 0)
        cols = [self._read_coldef() for _ in range(ncols)]
        self._expect_eof()
        rows: list[tuple] = []
        while True:
            pkt = self._read_packet()
            if pkt[:1] == b"\xfe" and len(pkt) < 9:
                break
            if pkt[:1] == b"\xff":
                raise self._parse_err(pkt)
            off, vals = 0, []
            for ctype, charset in cols:
                raw, off = _read_lenenc_bytes(pkt, off)
                vals.append(self._text_value(raw, ctype, charset))
            rows.append(tuple(vals))
        return rows, len(rows)

    @staticmethod
    def _text_value(raw: bytes | None, ctype: int, charset: int):
        if raw is None:
            return None
        if ctype in _INT_SIZES:
            return int(raw)
        if ctype in (T_FLOAT, T_DOUBLE, 0):
            return float(raw)
        if charset == 63:                      # binary
            return bytes(raw)
        return raw.decode("utf-8", "replace")

    def _read_coldef(self) -> tuple[int, int]:
        pkt = self._read_packet()
        off = 0
        for _ in range(6):                     # catalog..org_name
            raw, off = _read_lenenc_bytes(pkt, off)
        off += 1                               # fixed-len 0x0c marker
        charset = struct.unpack_from("<H", pkt, off)[0]
        ctype = pkt[off + 6]
        return ctype, charset

    def _expect_eof(self) -> None:
        pkt = self._read_packet()
        if not (pkt[:1] == b"\xfe" and len(pkt) < 9):
            raise MySqlError(0, "protocol desync: expected EOF")

    # prepared-statement binary protocol
    def _prepare(self, sql: str) -> tuple[int, int]:
        cached = self._stmts.get(sql)
        if cached is not None:
            return cached
        self._command(b"\x16" + sql.encode("utf-8"))
        pkt = self._read_packet()
        if pkt[:1] == b"\xff":
            raise self._parse_err(pkt)
        stmt_id, ncols, nparams = struct.unpack_from("<IHH", pkt, 1)
        for _ in range(nparams):
            self._read_packet()
        if nparams:
            self._expect_eof()
        for _ in range(ncols):
            self._read_packet()
        if ncols:
            self._expect_eof()
        if len(self._stmts) >= _MAX_CACHED_STMTS:
            evict_sql, (evict_id, _) = next(iter(self._stmts.items()))
            self._command(b"\x19" + struct.pack("<I", evict_id))  # CLOSE
            del self._stmts[evict_sql]
        self._stmts[sql] = (stmt_id, nparams)
        return stmt_id, nparams

    def _stmt_execute(self, sql: str,
                      params: tuple) -> tuple[list[tuple], int]:
        stmt_id, nparams = self._prepare(sql)
        if nparams != len(params):
            raise MySqlError(0, f"statement wants {nparams} params, "
                                f"got {len(params)}")
        body = [b"\x17", struct.pack("<IBI", stmt_id, 0, 1)]
        nullmap = bytearray((len(params) + 7) // 8)
        types, values = [], []
        for i, p in enumerate(params):
            if p is None:
                nullmap[i // 8] |= 1 << (i % 8)
                types.append(struct.pack("<BB", T_VAR_STRING, 0))
            elif isinstance(p, (bytes, bytearray, memoryview)):
                types.append(struct.pack("<BB", T_BLOB, 0))
                raw = bytes(p)
                values.append(_lenenc_int(len(raw)) + raw)
            elif isinstance(p, bool):
                types.append(struct.pack("<BB", T_TINY, 0))
                values.append(b"\x01" if p else b"\x00")
            elif isinstance(p, int):
                types.append(struct.pack("<BB", T_LONGLONG, 0))
                values.append(struct.pack("<q", p))
            elif isinstance(p, float):
                types.append(struct.pack("<BB", T_DOUBLE, 0))
                values.append(struct.pack("<d", p))
            else:
                types.append(struct.pack("<BB", T_VAR_STRING, 0))
                raw = str(p).encode("utf-8")
                values.append(_lenenc_int(len(raw)) + raw)
        body += [bytes(nullmap), b"\x01"] + types + values
        self._command(b"".join(body))
        pkt = self._read_packet()
        if pkt[:1] == b"\xff":
            raise self._parse_err(pkt)
        if pkt[:1] == b"\x00":                 # OK
            affected, _ = _read_lenenc_int(pkt, 1)
            return [], affected or 0
        ncols, _ = _read_lenenc_int(pkt, 0)
        cols = [self._read_coldef() for _ in range(ncols)]
        self._expect_eof()
        rows: list[tuple] = []
        while True:
            pkt = self._read_packet()
            if pkt[:1] == b"\xfe" and len(pkt) < 9:
                break
            if pkt[:1] == b"\xff":
                raise self._parse_err(pkt)
            rows.append(self._binary_row(pkt, cols))
        return rows, len(rows)

    def _binary_row(self, pkt: bytes, cols: list[tuple[int, int]]) -> tuple:
        n = len(cols)
        nullmap = pkt[1:1 + (n + 9) // 8]
        off = 1 + (n + 9) // 8
        vals = []
        for i, (ctype, charset) in enumerate(cols):
            if nullmap[(i + 2) // 8] & (1 << ((i + 2) % 8)):
                vals.append(None)
                continue
            if ctype in _INT_SIZES:
                size = _INT_SIZES[ctype]
                vals.append(int.from_bytes(pkt[off:off + size], "little",
                                           signed=True))
                off += size
            elif ctype == T_DOUBLE:
                vals.append(struct.unpack_from("<d", pkt, off)[0])
                off += 8
            elif ctype == T_FLOAT:
                vals.append(struct.unpack_from("<f", pkt, off)[0])
                off += 4
            else:
                raw, off = _read_lenenc_bytes(pkt, off)
                vals.append(bytes(raw) if charset == 63
                            else raw.decode("utf-8", "replace"))
        return tuple(vals)

    # -- DB-API shape ------------------------------------------------------

    def cursor(self) -> MySqlCursor:
        return MySqlCursor(self)

    def commit(self) -> None:
        pass  # autocommit

    def close(self) -> None:
        try:
            if self._sock is not None:
                self._command(b"\x01")         # COM_QUIT
        except OSError:
            pass
        self._mark_broken()
