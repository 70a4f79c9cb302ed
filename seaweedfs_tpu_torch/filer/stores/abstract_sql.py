"""Shared SQL filer-store layer and its sqlite dialect.

Counterpart of seaweedfs_tpu/filer/stores/abstract_sql.py (SeaweedFS
weed/filer/abstract_sql/abstract_sql_store.go): one generic store speaking
DB-API, with per-dialect SQL generation (the reference's SqlGenerator
interface: GetSqlInsert/Find/Delete/List/...). A dialect supplies:

  * the SQL statements (paramstyle differences: ?, %s, $N)
  * a connect() factory returning DB-API connections
  * upsert syntax (ON CONFLICT / ON DUPLICATE KEY)

The port carries the sqlite dialect on the stdlib `sqlite3`. The
reference's mysql and postgres dialects, with the per-bucket tables of
its mysql2/postgres2 stores, speak their servers' wire protocols and are
not part of the port yet (filerstore.WIRE_STORES).
"""

from __future__ import annotations

import threading
from typing import Iterator

from ...pb import filer_pb2
from ...utils import locks
from ..entry import Entry


def like_escape(s: str) -> str:
    """Escape LIKE wildcards in a fixed prefix with '!' (the ESCAPE
    char every dialect statement declares): '/data_1' must not also
    match '/dataX1'."""
    return s.replace("!", "!!").replace("%", "!%").replace("_", "!_")


class SqlDialect:
    """SqlGenerator equivalent (abstract_sql_store.go:15-26)."""

    name = "abstract"
    param = "?"  # DB-API paramstyle placeholder

    def _p(self, n: int) -> list[str]:
        return [self.param] * n

    def qi(self, ident: str) -> str:
        """Quote an identifier."""
        return '"' + ident.replace('"', '""') + '"'

    def kv_table(self, table: str) -> str:
        return f"{table}_kv"

    def create_table(self, table: str) -> str:
        return (f"CREATE TABLE IF NOT EXISTS {self.qi(table)} ("
                f"directory TEXT NOT NULL, name TEXT NOT NULL, meta BLOB, "
                f"PRIMARY KEY (directory, name))")

    def create_kv_table(self, table: str) -> str:
        return (f"CREATE TABLE IF NOT EXISTS {self.qi(self.kv_table(table))} "
                f"(k BLOB PRIMARY KEY, v BLOB)")

    def upsert(self, table: str) -> str:
        a, b, c = self._p(3)
        return (f"INSERT INTO {self.qi(table)}(directory,name,meta) "
                f"VALUES({a},{b},{c}) "
                f"ON CONFLICT(directory,name) DO UPDATE SET meta=excluded.meta")

    def find(self, table: str) -> str:
        a, b = self._p(2)
        return (f"SELECT meta FROM {self.qi(table)} "
                f"WHERE directory={a} AND name={b}")

    def delete(self, table: str) -> str:
        a, b = self._p(2)
        return f"DELETE FROM {self.qi(table)} WHERE directory={a} AND name={b}"

    def delete_folder_children(self, table: str) -> str:
        # ESCAPE '!': directory names may contain SQL wildcards ('_',
        # '%'); callers escape the fixed prefix with like_escape() so
        # '/data_1/%' can't also match '/dataX1/...'
        a, b = self._p(2)
        return (f"DELETE FROM {self.qi(table)} WHERE directory={a} "
                f"OR directory LIKE {b} ESCAPE '!'")

    def list_entries(self, table: str, inclusive: bool) -> str:
        op = ">=" if inclusive else ">"
        a, b, c, d = self._p(4)
        return (f"SELECT name, meta FROM {self.qi(table)} WHERE directory={a} "
                f"AND name {op} {b} AND name LIKE {c} ESCAPE '!' "
                f"ORDER BY name LIMIT {d}")

    def kv_upsert(self, table: str) -> str:
        a, b = self._p(2)
        return (f"INSERT INTO {self.qi(self.kv_table(table))}(k,v) "
                f"VALUES({a},{b}) "
                f"ON CONFLICT(k) DO UPDATE SET v=excluded.v")

    def kv_get(self, table: str) -> str:
        return (f"SELECT v FROM {self.qi(self.kv_table(table))} "
                f"WHERE k={self.param}")

    def connect(self):
        raise NotImplementedError


class SqliteDialect(SqlDialect):
    name = "sqlite"
    param = "?"

    def kv_table(self, table: str) -> str:
        # the reference's sqlite databases name this table plain "kv"
        return "kv"

    _mem_seq = 0
    _mem_lock = threading.Lock()

    def __init__(self, db_path: str = ":memory:"):
        self.uri = False
        if db_path == ":memory:":
            # per-connection private :memory: DBs won't do — every server
            # thread must see one namespace. Use a named shared-cache DB.
            with SqliteDialect._mem_lock:
                SqliteDialect._mem_seq += 1
                db_path = (f"file:filer_mem_{id(self)}_"
                           f"{SqliteDialect._mem_seq}?mode=memory&cache=shared")
            self.uri = True
        self.db_path = db_path

    def connect(self):
        import sqlite3

        c = sqlite3.connect(self.db_path, uri=self.uri,
                            check_same_thread=False)
        if not self.uri:
            c.execute("PRAGMA journal_mode=WAL")
            c.execute("PRAGMA synchronous=NORMAL")
        c.execute("PRAGMA busy_timeout=5000")
        return c


class AbstractSqlStore:
    """FilerStore over any SqlDialect (AbstractSqlStore,
    abstract_sql_store.go:28)."""

    TABLE = "filemeta"

    def __init__(self, dialect: SqlDialect):
        self.dialect = dialect
        self.name = dialect.name
        self._local = threading.local()
        self._lock = locks.wlock("filer.store.mu", rank=500)
        # anchor connection: creates the schema and, for shared-cache
        # in-memory sqlite, pins the database alive
        self._anchor = dialect.connect()
        cur = self._anchor.cursor()
        cur.execute(self.dialect.create_table(self.TABLE))
        cur.execute(self.dialect.create_kv_table(self.TABLE))
        self._anchor.commit()

    def _conn(self):
        c = getattr(self._local, "conn", None)
        if c is None:
            c = self.dialect.connect()
            self._local.conn = c
        return c

    @staticmethod
    def _split(full_path: str) -> tuple[str, str]:
        if full_path == "/":
            return "", "/"
        d, _, n = full_path.rstrip("/").rpartition("/")
        return d or "/", n

    def insert_entry(self, entry: Entry) -> None:
        d, n = self._split(entry.full_path)
        blob = entry.to_pb().SerializeToString()
        c = self._conn()
        with self._lock:
            c.cursor().execute(self.dialect.upsert(self.TABLE), (d, n, blob))
            c.commit()

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        d, n = self._split(full_path)
        cur = self._conn().cursor()
        cur.execute(self.dialect.find(self.TABLE), (d, n))
        row = cur.fetchone()
        if row is None:
            return None
        pb = filer_pb2.Entry.FromString(bytes(row[0]))
        return Entry.from_pb(d, pb)

    def delete_entry(self, full_path: str) -> None:
        d, n = self._split(full_path)
        c = self._conn()
        with self._lock:
            c.cursor().execute(self.dialect.delete(self.TABLE), (d, n))
            c.commit()

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/") or "/"
        c = self._conn()
        # '/' + '/%' would build pattern '//%', which matches no real
        # directory and leaves every deeper descendant row behind on a
        # root-wide wipe; root's descendants all match '/%'
        like = "/%" if base == "/" else like_escape(base) + "/%"
        with self._lock:
            c.cursor().execute(
                self.dialect.delete_folder_children(self.TABLE),
                (base, like))
            c.commit()

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> Iterator[Entry]:
        base = dir_path.rstrip("/") or "/"
        cur = self._conn().cursor()
        cur.execute(self.dialect.list_entries(self.TABLE, include_start),
                    (base, start_file_name,
                     like_escape(prefix or "") + "%", limit))
        for _name, blob in cur.fetchall():
            pb = filer_pb2.Entry.FromString(bytes(blob))
            yield Entry.from_pb(base, pb)

    def kv_get(self, key: bytes) -> bytes | None:
        cur = self._conn().cursor()
        cur.execute(self.dialect.kv_get(self.TABLE), (key,))
        row = cur.fetchone()
        return bytes(row[0]) if row else None

    def kv_put(self, key: bytes, value: bytes) -> None:
        c = self._conn()
        with self._lock:
            c.cursor().execute(self.dialect.kv_upsert(self.TABLE),
                               (key, value))
            c.commit()

    def close(self) -> None:
        c = getattr(self._local, "conn", None)
        if c is not None:
            c.close()
            self._local.conn = None
        self._anchor.close()
