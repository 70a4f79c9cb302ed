"""Shared pieces of the wire-protocol clients: the DB-API cursor shell and
the %s-placeholder rewriter (pg_wire, mysql_wire), SCRAM (pg_wire,
mongo_wire), key helpers, and the quick acknowledgement that keeps a
server's split replies from waiting out a delayed ACK (pg_wire,
mysql_wire, elastic_wire)."""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import socket
from typing import Callable

_QUICKACK = getattr(socket, "TCP_QUICKACK", None)  # Linux only


def quick_ack(sock: socket.socket | None) -> None:
    """Acknowledge what `sock` receives next at once. A server that
    writes one reply in several small sends has each send after the
    first held by Nagle's algorithm until the previous one is
    acknowledged, and a delayed ACK (about 40 ms on Linux) would then
    stall every request. The bytes exchanged are the same either way."""
    if sock is not None and _QUICKACK is not None:
        try:
            sock.setsockopt(socket.IPPROTO_TCP, _QUICKACK, 1)
        except OSError:
            pass  # not a TCP socket: nothing to acknowledge


def recv_acked(sock: socket.socket, n: int = 65536) -> bytes:
    """`sock.recv(n)`, then `quick_ack` for the reply's next part."""
    chunk = sock.recv(n)
    if chunk:
        quick_ack(sock)
    return chunk


class WireCursor:
    """Minimal DB-API cursor over a connection exposing
    ``_query(sql, params) -> (rows, rowcount)``."""

    def __init__(self, conn):
        self._conn = conn
        self._rows: list[tuple] = []
        self._idx = 0
        self.rowcount = -1

    def execute(self, sql: str, params: tuple = ()) -> "WireCursor":
        self._rows, self.rowcount = self._conn._query(sql, tuple(params))
        self._idx = 0
        return self

    def fetchone(self):
        if self._idx >= len(self._rows):
            return None
        row = self._rows[self._idx]
        self._idx += 1
        return row

    def fetchall(self) -> list[tuple]:
        rows = self._rows[self._idx:]
        self._idx = len(self._rows)
        return rows

    def close(self) -> None:
        self._rows = []


def rewrite_placeholders(sql: str, token: Callable[[int], str]) -> str:
    """Replace DB-API ``%s`` placeholders outside '...' string literals
    with ``token(n)`` (1-based): ``lambda n: "?"`` for mysql,
    ``lambda n: f"${n}"`` for postgres."""
    out, n, i, in_str = [], 0, 0, False
    while i < len(sql):
        ch = sql[i]
        if in_str:
            out.append(ch)
            if ch == "'":
                in_str = False
            i += 1
        elif ch == "'":
            in_str = True
            out.append(ch)
            i += 1
        elif ch == "%" and i + 1 < len(sql) and sql[i + 1] == "s":
            n += 1
            out.append(token(n))
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def split_dir_name(full_path: str) -> tuple[str, str]:
    """'/a/b/c.txt' -> ('/a/b', 'c.txt'); root is ('', '/'). The one
    canonical path splitter for every wire store."""
    if full_path == "/":
        return "", "/"
    d, _, n = full_path.rstrip("/").rpartition("/")
    return d or "/", n


class ScramClient:
    """Client side of SCRAM-SHA-256 (RFC 5802/7677). postgres leaves
    the authzid/username empty (the startup message names the user);
    mongodb sends n=<user>."""

    def __init__(self, password: str, username: str = ""):
        self.password = password.encode("utf-8")
        self.nonce = base64.b64encode(os.urandom(18)).decode()
        user = username.replace("=", "=3D").replace(",", "=2C")
        self.first_bare = f"n={user},r={self.nonce}"
        self.server_sig: bytes | None = None

    def client_first(self) -> bytes:
        return ("n,," + self.first_bare).encode()

    def client_final(self, server_first: bytes) -> bytes:
        sf = server_first.decode()
        attrs = dict(kv.split("=", 1) for kv in sf.split(","))
        r, salt, iters = attrs["r"], base64.b64decode(attrs["s"]), \
            int(attrs["i"])
        if not r.startswith(self.nonce):
            raise ConnectionError("SCRAM server nonce mismatch")
        salted = hashlib.pbkdf2_hmac("sha256", self.password, salt, iters)
        client_key = hmac.new(salted, b"Client Key", hashlib.sha256).digest()
        stored_key = hashlib.sha256(client_key).digest()
        final_bare = f"c=biws,r={r}"
        auth_msg = ",".join([self.first_bare, sf, final_bare]).encode()
        client_sig = hmac.new(stored_key, auth_msg, hashlib.sha256).digest()
        proof = bytes(a ^ b for a, b in zip(client_key, client_sig))
        server_key = hmac.new(salted, b"Server Key", hashlib.sha256).digest()
        self.server_sig = hmac.new(server_key, auth_msg,
                                   hashlib.sha256).digest()
        return (final_bare
                + ",p=" + base64.b64encode(proof).decode()).encode()

    def verify_server(self, server_final: bytes) -> None:
        attrs = dict(kv.split("=", 1)
                     for kv in server_final.decode().split(","))
        if base64.b64decode(attrs.get("v", "")) != self.server_sig:
            raise ConnectionError("SCRAM server signature mismatch")


def prefix_end(prefix: bytes, *, unbounded: bytes = b"") -> bytes:
    """Smallest key greater than every key with `prefix` (etcd
    clientv3.GetPrefixRangeEnd: increment the last non-0xFF byte).
    `unbounded` is returned when no such key exists (all-0xFF prefix):
    etcd's convention is b"\\x00" ("whole keyspace"), tikv's is b""."""
    b = bytearray(prefix)
    for i in reversed(range(len(b))):
        if b[i] < 0xFF:
            b[i] += 1
            return bytes(b[:i + 1])
    return unbounded
