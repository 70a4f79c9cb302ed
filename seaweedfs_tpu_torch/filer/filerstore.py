"""FilerStore SPI + registry.

Counterpart of seaweedfs_tpu/filer/filerstore.py (SeaweedFS
weed/filer/filerstore.go:21-44): the 9-method KV/list interface every
metadata backend implements, with stores registered by name: memory,
sqlite and leveldb on the host, and the network stores that speak their
servers' wire protocols (mysql, mysql2, postgres, postgres2, redis,
redis2, redis3, redis_lua, cassandra, mongodb, elastic, elastic7,
arangodb, hbase, etcd, tikv, ydb). A network store whose server does not
answer fails; nothing falls back to another store.
"""

from __future__ import annotations

from typing import Iterator, Protocol

from .entry import Entry


class FilerStore(Protocol):
    name: str

    def insert_entry(self, entry: Entry) -> None: ...

    def update_entry(self, entry: Entry) -> None: ...

    def find_entry(self, full_path: str) -> Entry | None: ...

    def delete_entry(self, full_path: str) -> None: ...

    def delete_folder_children(self, full_path: str) -> None: ...

    def list_directory_entries(
        self, dir_path: str, start_file_name: str = "",
        include_start: bool = False, limit: int = 1024,
        prefix: str = "",
    ) -> Iterator[Entry]: ...

    def kv_get(self, key: bytes) -> bytes | None: ...

    def kv_put(self, key: bytes, value: bytes) -> None: ...

    def close(self) -> None: ...


_REGISTRY: dict[str, type] = {}


def register_store(name: str, cls: type) -> None:
    _REGISTRY[name] = cls


def get_store(name: str, **kwargs) -> FilerStore:
    from .stores import (  # noqa: F401 - registration side effect
        abstract_sql,
        arango_wire,
        cql_wire,
        elastic_wire,
        etcd_store,
        gated,
        leveldb,
        memory,
        mongo_wire,
        redis,
        redis3,
        redis_lua,
        sqlite,
        hbase_store,
        tikv_store,
        ydb_store,
    )

    cls = _REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"unknown filer store {name!r} "
                         f"(available: {sorted(_REGISTRY)})")
    return cls(**kwargs)


def available_stores() -> list[str]:
    from .stores import (  # noqa: F401 - registration side effect
        abstract_sql,
        arango_wire,
        cql_wire,
        elastic_wire,
        etcd_store,
        gated,
        leveldb,
        memory,
        mongo_wire,
        redis,
        redis3,
        redis_lua,
        sqlite,
        hbase_store,
        tikv_store,
        ydb_store,
    )

    return sorted(_REGISTRY)


class StoreWrapper:
    """Instrumented pass-through (filerstore_wrapper.go): per-op counters
    and cumulative latency, exported through utils.stats."""

    def __init__(self, store: FilerStore):
        self.store = store
        self.name = store.name
        from ..utils.stats import FILER_STORE_COUNTER, FILER_STORE_SECONDS

        self._counter = FILER_STORE_COUNTER
        self._seconds = FILER_STORE_SECONDS

    def _timed(self, op: str, fn, *args, **kwargs):
        import time

        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            self._counter.inc(store=self.name, op=op)
            self._seconds.inc(time.perf_counter() - t0,
                              store=self.name, op=op)

    def insert_entry(self, entry):
        return self._timed("insert", self.store.insert_entry, entry)

    def update_entry(self, entry):
        return self._timed("update", self.store.update_entry, entry)

    def find_entry(self, full_path):
        return self._timed("find", self.store.find_entry, full_path)

    def delete_entry(self, full_path):
        return self._timed("delete", self.store.delete_entry, full_path)

    def delete_folder_children(self, full_path):
        return self._timed("deleteFolderChildren",
                           self.store.delete_folder_children, full_path)

    def list_directory_entries(self, *args, **kwargs):
        return self._timed("list", lambda: list(
            self.store.list_directory_entries(*args, **kwargs)))

    def kv_get(self, key):
        return self._timed("kvGet", self.store.kv_get, key)

    def kv_put(self, key, value):
        return self._timed("kvPut", self.store.kv_put, key, value)

    def close(self):
        self.store.close()


class RetryingStore:
    """Transient-fault-absorbing pass-through: every store op retries on
    retryable transport errors (connection loss to a redis/ydb/mysql
    backend, gRPC UNAVAILABLE, injected faults) with exponential backoff
    — behind the per-target circuit breaker in utils.retry so a dead
    metadata backend sheds load instead of being hammered by every
    handler thread. Mutations additionally evaluate the
    `filer.store.mutate` failpoint so the chaos suite can flap the
    backend without monkeypatching.

    Safe to retry because the 9-op SPI is idempotent end to end: inserts
    are UPSERTs, deletes tolerate already-gone rows, reads are reads.
    """

    def __init__(self, store: FilerStore, *, attempts: int = 4,
                 wait_init: float = 0.05):
        self.store = store
        self.name = store.name
        self.attempts = attempts
        self.wait_init = wait_init

    def _run(self, op: str, fn, *, mutate: bool = False):
        from ..utils import failpoint
        from ..utils.retry import retry

        def attempt():
            if mutate:
                failpoint.fail("filer.store.mutate",
                               ctx=f"{self.name} {op}")
            return fn()

        return retry(f"store.{self.name}.{op}", attempt,
                     attempts=self.attempts, wait_init=self.wait_init)

    def insert_entry(self, entry):
        return self._run("insert", lambda: self.store.insert_entry(entry),
                         mutate=True)

    def update_entry(self, entry):
        return self._run("update", lambda: self.store.update_entry(entry),
                         mutate=True)

    def find_entry(self, full_path):
        return self._run("find", lambda: self.store.find_entry(full_path))

    def delete_entry(self, full_path):
        return self._run("delete",
                         lambda: self.store.delete_entry(full_path),
                         mutate=True)

    def delete_folder_children(self, full_path):
        return self._run(
            "deleteFolderChildren",
            lambda: self.store.delete_folder_children(full_path),
            mutate=True)

    def list_directory_entries(self, *args, **kwargs):
        # materialized so a mid-iteration transport error is retryable
        # as a unit instead of surfacing from a half-consumed generator
        return self._run("list", lambda: list(
            self.store.list_directory_entries(*args, **kwargs)))

    def kv_get(self, key):
        return self._run("kvGet", lambda: self.store.kv_get(key))

    def kv_put(self, key, value):
        return self._run("kvPut", lambda: self.store.kv_put(key, value),
                         mutate=True)

    def close(self):
        self.store.close()


class PathTranslatingStore:
    """Mounts a store under a path prefix
    (filerstore_translate_path.go): callers see `/x`, the backing store
    sees `<root>/x`. Used for per-path store routing (fs.configure)."""

    def __init__(self, store: FilerStore, root: str):
        self.store = store
        self.root = root.rstrip("/")
        self.name = f"{store.name}@{root}"

    def _to(self, path: str) -> str:
        return self.root + path if path != "/" else (self.root or "/")

    def _from(self, path: str) -> str:
        if self.root and path.startswith(self.root):
            return path[len(self.root):] or "/"
        return path

    def insert_entry(self, entry):
        import copy

        e = copy.copy(entry)
        e.full_path = self._to(entry.full_path)
        self.store.insert_entry(e)

    def update_entry(self, entry):
        import copy

        e = copy.copy(entry)
        e.full_path = self._to(entry.full_path)
        self.store.update_entry(e)

    def find_entry(self, full_path):
        e = self.store.find_entry(self._to(full_path))
        if e is not None:
            e.full_path = self._from(e.full_path)
        return e

    def delete_entry(self, full_path):
        self.store.delete_entry(self._to(full_path))

    def delete_folder_children(self, full_path):
        self.store.delete_folder_children(self._to(full_path))

    def list_directory_entries(self, dir_path, start_file_name="",
                               include_start=False, limit=1024, prefix=""):
        for e in self.store.list_directory_entries(
                self._to(dir_path), start_file_name, include_start,
                limit, prefix):
            e.full_path = self._from(e.full_path)
            yield e

    def kv_get(self, key):
        return self.store.kv_get(key)

    def kv_put(self, key, value):
        return self.store.kv_put(key, value)

    def close(self):
        self.store.close()
