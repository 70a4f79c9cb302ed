"""Redis filer store over a stdlib RESP wire client.

Counterpart of seaweedfs_tpu/filer/stores/redis.py (SeaweedFS
weed/filer/redis2/redis_store.go): the entry protobuf lives at the
full-path key, and each directory keeps a sorted set of child names
(score 0 — member order is the lexical order listings need). redis-py is
not used: the wire client speaks RESP itself over a socket; the store
therefore runs against any real Redis server, and the test suite runs it
against the in-process pure-python RESP server in tests/fake_redis.py.

Registered as `redis` and `redis2` (the reference's redis/ and redis2/
differ only in the member structure — plain set vs sorted set; this
implementation uses the sorted-set layout of redis2 for both names).
"""

from __future__ import annotations

import socket
import threading

from ...pb import filer_pb2
from ..entry import Entry
from ..filerstore import register_store

DIR_SET_SUFFIX = b"\x00"  # per-directory sorted-set key (redis2 layout)
KV_PREFIX = b"kv:"  # path keys always start with '/': no collision


class RespError(IOError):
    """Server-reported error (-ERR ...); the connection stays in sync."""


class RespProtocolError(RespError):
    """Framing/IO failure mid-reply; the connection must be discarded."""


class RespClient:
    """Minimal RESP2 client: encode command arrays, parse replies.
    One in-flight command at a time (lock-serialized), like the
    reference's default non-pipelined go-redis usage."""

    def __init__(self, host: str = "localhost", port: int = 6379, *,
                 db: int = 0, password: str = "", timeout: float = 30):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._f = self._sock.makefile("rb")
        self._lock = threading.Lock()
        if password:
            self.cmd("AUTH", password)
        if db:
            self.cmd("SELECT", str(db))

    def close(self) -> None:
        try:
            self._f.close()
            self._sock.close()
        except OSError:
            pass

    @staticmethod
    def _encode(args) -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            b = a if isinstance(a, bytes) else str(a).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(b), b))
        return b"".join(out)

    def _exchange_locked(self, payload: bytes, read):
        """Send `payload` and return read(); caller holds the lock.
        Any I/O failure (timeout, short read) poisons the connection —
        a stale reply could still be queued on the socket, and parsing
        it as the NEXT command's reply would silently return wrong data
        (redis-py likewise closes on I/O errors). A server -ERR reply
        (RespError) leaves the connection in sync."""
        if self._sock is None:
            raise RespProtocolError(
                "connection is closed (previous I/O error)")
        try:
            self._sock.sendall(payload)
            return read()
        except RespProtocolError:
            self.close()
            self._sock = None
            raise
        except RespError:
            raise  # server -ERR reply: connection is still in sync
        except OSError:  # NB: RespError subclasses OSError — order!
            self.close()
            self._sock = None
            raise

    def cmd(self, *args):
        """-> reply (str for simple strings, int, bytes | None for bulk,
        list for arrays). Raises RespError for server errors."""
        payload = self._encode(args)
        with self._lock:
            return self._exchange_locked(payload, self._read_reply)

    def transaction(self, *cmds):
        """MULTI ... EXEC as one locked unit -> EXEC's reply array.

        The lock is held across the whole exchange: sending MULTI and
        EXEC as separate cmd() calls would let another thread's command
        land inside the open transaction, where the server QUEUEs it
        (its caller then reads '+QUEUED' as its reply) and EXEC's array
        absorbs its result — reply-stream corruption under the filer's
        threaded HTTP server. All frames go out in one sendall and the
        replies (+OK, +QUEUED xN, EXEC array) are read back in order.
        """
        payload = b"".join(self._encode(args) for args in
                           ((("MULTI",),) + cmds + (("EXEC",),)))

        def read_all():
            replies = []
            err = None
            for _ in range(len(cmds) + 2):
                try:
                    replies.append(self._read_reply())
                except RespProtocolError:
                    raise
                except RespError as e:
                    # queue-time error (e.g. bad command): the server
                    # still answers the remaining frames, so keep
                    # draining to stay in sync
                    replies.append(e)
                    err = err or e
            if err is not None:
                raise err
            exec_reply = replies[-1]
            if exec_reply is None:
                # EXEC replied nil: the server aborted the transaction
                # (WATCH conflict, cluster failover). The stream is fully
                # drained, so raising keeps the connection in sync —
                # returning None here let callers (redis3 segment split)
                # mistake an aborted transaction for a commit.
                raise RespError("transaction aborted: EXEC returned nil")
            if isinstance(exec_reply, list):
                # exec-time failures arrive as error ELEMENTS inside
                # the reply array; the stream is fully drained, so
                # raising keeps the connection in sync
                for el in exec_reply:
                    if isinstance(el, RespError):
                        raise el
            return exec_reply

        with self._lock:
            return self._exchange_locked(payload, read_all)

    def _read_reply(self, nested: bool = False):
        line = self._f.readline()
        if not line.endswith(b"\r\n"):
            raise RespProtocolError("connection closed mid-reply")
        kind, rest = line[:1], line[1:-2]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            # Inside an array (EXEC replies): raising here would abandon
            # the remaining elements on the socket and desynchronize the
            # stream — return the error as a value (redis-py does the
            # same) and let the caller decide.
            if nested:
                return RespError(rest.decode())
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n < 0:
                return None
            blob = self._f.read(n + 2)
            if len(blob) != n + 2:
                raise RespProtocolError("short bulk read")
            return blob[:-2]
        if kind == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [self._read_reply(nested=True) for _ in range(n)]
        raise RespProtocolError(f"bad RESP type byte {kind!r}")


def _dir_set_key(dir_path: str) -> bytes:
    return (dir_path.rstrip("/") or "/").encode() + DIR_SET_SUFFIX


class RedisStore:
    name = "redis"

    def __init__(self, host: str = "localhost", port: int = 6379, *,
                 address: str = "", db: int = 0, database: int = 0,
                 password: str = "", **_ignored):
        # `address`/`database` are the filer.toml field names the
        # reference's [redis2] section uses (scaffold.go)
        if address:
            host, _, p = address.partition(":")
            port = int(p or 6379)
        self.client = RespClient(host, port, db=db or database,
                                 password=password)

    # -- child-index hooks (redis3 overrides these with the segmented
    #    layout; entry-blob handling stays shared) -------------------------

    def _index_child(self, dir_path: str, name: str) -> None:
        self.client.cmd("ZADD", _dir_set_key(dir_path), "0", name.encode())

    def _unindex_child(self, dir_path: str, name: str) -> None:
        self.client.cmd("ZREM", _dir_set_key(dir_path), name.encode())

    def _iter_child_names(self, dir_path: str, lo: str,
                          inclusive: bool):
        """Child names >= lo (or > lo), ascending. Paged so an
        emptiness probe never pulls a huge directory over the wire."""
        set_key = _dir_set_key(dir_path)
        if lo:
            bound = (("[" if inclusive else "(") + lo).encode()
        else:
            bound = b"-"
        offset, page_size = 0, 1024
        while True:
            page = self.client.cmd("ZRANGEBYLEX", set_key, bound, b"+",
                                   "LIMIT", str(offset), str(page_size))
            if not page:
                return
            for m in page:
                yield m.decode()
            if len(page) < page_size:
                return
            offset += len(page)

    # -- FilerStore SPI ----------------------------------------------------

    def insert_entry(self, entry: Entry) -> None:
        blob = filer_pb2.FullEntry(
            dir=entry.parent, entry=entry.to_pb()).SerializeToString()
        self.client.cmd("SET", entry.full_path.encode(), blob)
        self._index_child(entry.parent, entry.name)

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        blob = self.client.cmd("GET", full_path.encode())
        if blob is None:
            return None
        fe = filer_pb2.FullEntry.FromString(blob)
        return Entry.from_pb(fe.dir, fe.entry)

    def delete_entry(self, full_path: str) -> None:
        d, _, name = full_path.rpartition("/")
        self.client.cmd("DEL", full_path.encode())
        self._unindex_child(d or "/", name)

    def delete_folder_children(self, full_path: str) -> None:
        """BFS over the per-directory sets: every descendant entry key
        and set key goes (DeleteFolderChildren, redis2_store.go —
        extended to the whole subtree, matching the leveldb store).
        Child entry keys + the set key go in ONE variadic DEL per
        directory; an empty ZRANGEBYLEX means the set key doesn't exist
        (redis removes empty zsets), so no DEL is issued for leaves."""
        stack = [full_path.rstrip("/") or "/"]
        while stack:
            d = stack.pop()
            set_key = _dir_set_key(d)
            members = self.client.cmd("ZRANGEBYLEX", set_key, "-", "+")
            if not members:
                continue
            children = [(d.rstrip("/") or "") + "/" + m.decode()
                        for m in members]
            self.client.cmd("DEL", *[c.encode() for c in children],
                            set_key)
            stack.extend(children)  # any may be a dir: sets get swept

    def list_directory_entries(self, dir_path: str,
                               start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024, prefix: str = ""):
        """Paged ZRANGEBYLEX ... LIMIT: a limit=2 emptiness probe against
        a 100k-child directory must not pull 100k member names over the
        wire (the reference redis2 store pushes LIMIT down the same
        way)."""
        d = dir_path.rstrip("/") or "/"
        lo, inclusive = start_file_name, include_start or not start_file_name
        if prefix and prefix > lo:
            lo, inclusive = prefix, True
        count = 0
        for name in self._iter_child_names(d, lo, inclusive):
            if prefix and not name.startswith(prefix):
                if name > prefix:  # lex-sorted: no more matches
                    return
                continue
            e = self.find_entry((d.rstrip("/") or "") + "/" + name)
            if e is None:
                continue
            yield e
            count += 1
            if count >= limit:
                return

    def kv_get(self, key: bytes) -> bytes | None:
        return self.client.cmd("GET", KV_PREFIX + key)

    def kv_put(self, key: bytes, value: bytes) -> None:
        self.client.cmd("SET", KV_PREFIX + key, value)

    def close(self) -> None:
        self.client.close()


class Redis2Store(RedisStore):
    name = "redis2"


register_store("redis", RedisStore)
register_store("redis2", Redis2Store)
