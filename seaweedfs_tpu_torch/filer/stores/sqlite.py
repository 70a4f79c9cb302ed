"""SQLite filer store — the durable default.

Counterpart of seaweedfs_tpu/filer/stores/sqlite.py (SeaweedFS
weed/filer/sqlite/sqlite_store.go): a thin dialect over the shared SQL
layer (stores/abstract_sql.py), as the reference layers sqlite_store.go on
abstract_sql_store.go. Serialization reuses the filer_pb.Entry wire format,
so the reference's filer.db and the port's are one format.
"""

from __future__ import annotations

from ..filerstore import register_store
from .abstract_sql import AbstractSqlStore, SqliteDialect


class SqliteStore(AbstractSqlStore):
    def __init__(self, db_path: str = ":memory:", **_):
        super().__init__(SqliteDialect(db_path))


register_store("sqlite", SqliteStore)
