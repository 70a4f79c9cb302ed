"""Shared SQL filer-store layer + dialects.

Counterpart of seaweedfs_tpu/filer/stores/abstract_sql.py (SeaweedFS
weed/filer/abstract_sql/abstract_sql_store.go): one generic store speaking
DB-API, with per-dialect SQL generation (the reference's SqlGenerator
interface: GetSqlInsert/Find/Delete/List/... that mysql/postgres/sqlite
all reuse). A dialect supplies:

  * the SQL statements (paramstyle differences: ?, %s, $N)
  * a connect() factory returning DB-API connections
  * upsert syntax (ON CONFLICT / ON DUPLICATE KEY)

The sqlite dialect runs on the stdlib `sqlite3`. The mysql and postgres
dialects speak their servers' wire protocols themselves (mysql_wire.py,
pg_wire.py), and the "2" stores, mysql2 and postgres2, keep the objects of
each S3 bucket in a table of their own. A server that does not answer
fails the store at its first statement; nothing falls back.
"""

from __future__ import annotations

import threading
from typing import Iterator

from ...pb import filer_pb2
from ...utils import locks
from ..entry import Entry
from ..filerstore import register_store


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
        """Quote an identifier. Bucket tables carry user-chosen names
        ('my-bucket', 'a.b'); every statement must quote, not just DDL."""
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

    def drop_table(self, table: str) -> str:
        return f"DROP TABLE IF EXISTS {self.qi(table)}"

    def list_bucket_tables(self) -> str:
        """Enumerate per-bucket tables (sqlite flavor; postgres overrides).
        Used when a recursive delete covers the whole /buckets tree."""
        return ("SELECT name FROM sqlite_master WHERE type='table' "
                "AND name LIKE 'bucket\\_%' ESCAPE '\\'")

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
        # '/data_1/%' can't also match '/dataX1/...'. '!' is portable
        # across sqlite/mysql/postgres (backslash is not: mysql string
        # syntax vs pg standard_conforming_strings).
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


class MySqlDialect(SqlDialect):
    """mysql/mysql_store.go + mysql_sql_gen.go SQL shapes."""

    name = "mysql"
    param = "%s"

    def qi(self, ident: str) -> str:
        # mysql default sql_mode rejects double-quoted identifiers
        return "`" + ident.replace("`", "``") + "`"

    def list_bucket_tables(self) -> str:
        return ("SELECT table_name FROM information_schema.tables "
                "WHERE table_name LIKE 'bucket\\_%'")

    def __init__(self, *, host="localhost", port=3306, user="root",
                 password="", database="seaweedfs", **_):
        self.kwargs = dict(host=host, port=port, user=user,
                           password=password, database=database)

    def create_table(self, table: str) -> str:
        # 2 x VARCHAR(383) x 4 bytes/char (utf8mb4) = 3064 bytes, inside
        # InnoDB's 3072-byte composite index limit
        return (f"CREATE TABLE IF NOT EXISTS `{table}` ("
                f"`directory` VARCHAR(383) NOT NULL, "
                f"`name` VARCHAR(383) NOT NULL, `meta` LONGBLOB, "
                f"PRIMARY KEY (`directory`, `name`)) CHARACTER SET utf8mb4")

    def create_kv_table(self, table: str) -> str:
        # BLOB cannot be a MySQL key; bounded VARBINARY can
        return (f"CREATE TABLE IF NOT EXISTS `{self.kv_table(table)}` "
                f"(k VARBINARY(255) PRIMARY KEY, v LONGBLOB)")

    def upsert(self, table: str) -> str:
        return (f"INSERT INTO `{table}`(directory,name,meta) "
                f"VALUES(%s,%s,%s) "
                f"ON DUPLICATE KEY UPDATE meta=VALUES(meta)")

    def kv_upsert(self, table: str) -> str:
        return (f"INSERT INTO `{self.kv_table(table)}`(k,v) VALUES(%s,%s) "
                f"ON DUPLICATE KEY UPDATE v=VALUES(v)")

    def connect(self):
        # no pymysql: speak the client/server protocol directly
        # (mysql_wire.MySqlConnection)
        from .mysql_wire import MySqlConnection

        return MySqlConnection(**self.kwargs)


class PostgresDialect(SqlDialect):
    """postgres/postgres_store.go + postgres_sql_gen.go SQL shapes."""

    name = "postgres"
    param = "%s"

    def __init__(self, *, host="localhost", port=5432, user="postgres",
                 password="", database="seaweedfs", sslmode="disable", **_):
        self.kwargs = dict(host=host, port=port, user=user,
                           password=password, dbname=database,
                           sslmode=sslmode)

    def create_table(self, table: str) -> str:
        return (f'CREATE TABLE IF NOT EXISTS "{table}" ('
                f"directory VARCHAR(65535) NOT NULL, "
                f"name VARCHAR(65535) NOT NULL, meta BYTEA, "
                f"PRIMARY KEY (directory, name))")

    def create_kv_table(self, table: str) -> str:
        # Postgres has no BLOB type — BYTEA throughout
        return (f'CREATE TABLE IF NOT EXISTS "{self.kv_table(table)}" '
                f"(k BYTEA PRIMARY KEY, v BYTEA)")

    def list_bucket_tables(self) -> str:
        return ("SELECT tablename FROM pg_tables "
                "WHERE tablename LIKE 'bucket\\_%' ESCAPE '\\'")

    def upsert(self, table: str) -> str:
        return (f'INSERT INTO "{table}"(directory,name,meta) '
                f"VALUES(%s,%s,%s) ON CONFLICT(directory,name) "
                f"DO UPDATE SET meta=EXCLUDED.meta")

    def kv_upsert(self, table: str) -> str:
        return (f'INSERT INTO "{self.kv_table(table)}"(k,v) VALUES(%s,%s) '
                f"ON CONFLICT(k) DO UPDATE SET v=EXCLUDED.v")

    def connect(self):
        # no psycopg2: speak the v3 wire protocol directly
        # (pg_wire.PgConnection — same protocol a real server expects)
        from .pg_wire import PgConnection

        return PgConnection(**self.kwargs)


class AbstractSqlStore:
    """FilerStore over any SqlDialect (AbstractSqlStore,
    abstract_sql_store.go:28).

    ``support_bucket_table`` mirrors the reference's "2"-generation
    stores (postgres2/mysql2: SupportBucketTable=true,
    postgres2_store.go:53): objects under ``/buckets/<name>/...`` live
    in a per-bucket table created on first write and dropped whole on
    bucket deletion — O(1) bucket deletes instead of a LIKE-scan.
    """

    TABLE = "filemeta"

    def __init__(self, dialect: SqlDialect,
                 support_bucket_table: bool = False):
        self.dialect = dialect
        self.name = dialect.name
        self.support_bucket_table = support_bucket_table
        self._bucket_tables: set[str] = set()
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

    # -- bucket tables (abstract_sql_store.go getTxOrDB bucket routing) ---

    @staticmethod
    def _bucket_of(directory: str) -> str | None:
        if not directory.startswith("/buckets/"):
            return None
        bucket = directory[len("/buckets/"):].split("/", 1)[0]
        # identifier-safe only; anything exotic stays in the main table
        if bucket and all(c.isalnum() or c in "-_." for c in bucket):
            return bucket
        return None

    def _table_for(self, directory: str, create: bool = False) -> str:
        if not self.support_bucket_table:
            return self.TABLE
        bucket = self._bucket_of(directory)
        if bucket is None:
            return self.TABLE
        table = f"bucket_{bucket}"
        # only writes materialize the table — a read must never resurrect
        # a dropped bucket (reads on a missing table read as empty)
        if create and table not in self._bucket_tables:
            c = self._conn()
            with self._lock:
                c.cursor().execute(self.dialect.create_table(table))
                c.commit()
                self._bucket_tables.add(table)
        return table

    def on_bucket_creation(self, bucket: str) -> None:
        if self.support_bucket_table:
            self._table_for(f"/buckets/{bucket}/", create=True)

    def on_bucket_deletion(self, bucket: str) -> None:
        if not self.support_bucket_table:
            return
        table = f"bucket_{bucket}"
        c = self._conn()
        with self._lock:
            c.cursor().execute(self.dialect.drop_table(table))
            c.commit()
            self._bucket_tables.discard(table)

    def insert_entry(self, entry: Entry) -> None:
        d, n = self._split(entry.full_path)
        blob = entry.to_pb().SerializeToString()
        table = self._table_for(d, create=True)
        c = self._conn()
        with self._lock:
            try:
                c.cursor().execute(self.dialect.upsert(table), (d, n, blob))
            except Exception as e:
                # another client may have dropped the bucket table since we
                # cached it — recreate once and retry
                if table == self.TABLE or not self._is_missing_table(e):
                    raise
                self._bucket_tables.discard(table)
                c.cursor().execute(self.dialect.create_table(table))
                self._bucket_tables.add(table)
                c.cursor().execute(self.dialect.upsert(table), (d, n, blob))
            c.commit()

    update_entry = insert_entry

    @staticmethod
    def _is_missing_table(exc: Exception) -> bool:
        """Only 'relation/table does not exist' errors may be swallowed —
        connection drops and genuine SQL failures must propagate."""
        sqlstate = getattr(exc, "sqlstate", "")
        if sqlstate == "42P01":          # postgres undefined_table
            return True
        msg = str(exc).lower()
        return ("no such table" in msg          # sqlite
                or "doesn't exist" in msg        # mysql 1146
                or "does not exist" in msg)      # postgres text

    def _bucket_read(self, table: str, fn):
        """Run a read/mutation against a possibly-absent bucket table:
        a dropped bucket's table reads as empty instead of erroring."""
        try:
            return fn()
        except Exception as e:
            if table != self.TABLE and self._is_missing_table(e):
                return None
            raise

    def find_entry(self, full_path: str) -> Entry | None:
        d, n = self._split(full_path)
        table = self._table_for(d)
        cur = self._conn().cursor()

        def go():
            cur.execute(self.dialect.find(table), (d, n))
            return cur.fetchone()

        row = self._bucket_read(table, go)
        if row is None:
            return None
        pb = filer_pb2.Entry.FromString(bytes(row[0]))
        return Entry.from_pb(d, pb)

    def delete_entry(self, full_path: str) -> None:
        d, n = self._split(full_path)
        table = self._table_for(d)
        c = self._conn()
        with self._lock:
            self._bucket_read(table, lambda: (
                c.cursor().execute(self.dialect.delete(table), (d, n)),
                c.commit()))

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/") or "/"
        bucket = self._bucket_of(base + "/") if self.support_bucket_table \
            else None
        if bucket is not None and base == f"/buckets/{bucket}":
            # whole-bucket delete: drop the bucket table (O(1))
            self.on_bucket_deletion(bucket)
            return
        if self.support_bucket_table and base in ("/", "/buckets"):
            # the delete covers every bucket: drop all bucket tables, not
            # just the main-table rows (enumerated server-side so tables
            # created by other clients/processes are included)
            c = self._conn()
            cur = c.cursor()
            cur.execute(self.dialect.list_bucket_tables())
            tables = [row[0] for row in cur.fetchall()]
            with self._lock:
                for t in tables:
                    c.cursor().execute(self.dialect.drop_table(t))
                    self._bucket_tables.discard(t)
                c.commit()
        table = self._table_for(base)
        c = self._conn()
        # '/' + '/%' would build pattern '//%', which matches no real
        # directory and leaves every deeper descendant row behind on a
        # root-wide wipe; root's descendants all match '/%'
        like = "/%" if base == "/" else like_escape(base) + "/%"
        with self._lock:
            self._bucket_read(table, lambda: (
                c.cursor().execute(
                    self.dialect.delete_folder_children(table),
                    (base, like)),
                c.commit()))

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> Iterator[Entry]:
        base = dir_path.rstrip("/") or "/"
        table = self._table_for(base)
        cur = self._conn().cursor()

        def go():
            cur.execute(self.dialect.list_entries(table, include_start),
                        (base, start_file_name,
                         like_escape(prefix or "") + "%", limit))
            return cur.fetchall()

        for _name, blob in self._bucket_read(table, go) or []:
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


def _mysql_store(**kwargs) -> AbstractSqlStore:
    return AbstractSqlStore(MySqlDialect(**kwargs))


def _postgres_store(**kwargs) -> AbstractSqlStore:
    return AbstractSqlStore(PostgresDialect(**kwargs))


def _postgres2_store(**kwargs) -> AbstractSqlStore:
    store = AbstractSqlStore(PostgresDialect(**kwargs),
                             support_bucket_table=True)
    store.name = "postgres2"
    return store


def _mysql2_store(**kwargs) -> AbstractSqlStore:
    store = AbstractSqlStore(MySqlDialect(**kwargs),
                             support_bucket_table=True)
    store.name = "mysql2"
    return store


register_store("mysql", _mysql_store)
register_store("mysql2", _mysql2_store)
register_store("postgres", _postgres_store)
register_store("postgres2", _postgres2_store)
