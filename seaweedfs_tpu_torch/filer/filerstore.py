"""FilerStore SPI + registry.

Counterpart of seaweedfs_tpu/filer/filerstore.py (SeaweedFS
weed/filer/filerstore.go:21-44): the 9-method KV/list interface every
metadata backend implements, with stores registered by name. The port
ships the memory, sqlite and leveldb stores; the reference's network
stores (`WIRE_STORES`) refuse, naming the ROADMAP.md item that will port
them.
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

ROADMAP_WIRE_STORES = "ROADMAP.md A2d (filer stores)"

#: the reference's network-backed stores, by registered name; the port
#: carries none of them (nor their wire helpers bson, thrift_wire and
#: wire_common), and asking for one fails instead of falling back
WIRE_STORES = {
    "mysql": "mysql_wire", "mysql2": "mysql_wire",
    "postgres": "pg_wire", "postgres2": "pg_wire",
    "cassandra": "cql_wire", "mongodb": "mongo_wire",
    "redis": "redis", "redis2": "redis", "redis3": "redis3",
    "redis_lua": "redis_lua", "etcd": "etcd_store", "tikv": "tikv_store",
    "ydb": "ydb_store", "hbase": "hbase_store", "arangodb": "arango_wire",
    "elastic": "elastic_wire", "elastic7": "elastic_wire",
}


def register_store(name: str, cls: type) -> None:
    _REGISTRY[name] = cls


def get_store(name: str, **kwargs) -> FilerStore:
    from .stores import (  # noqa: F401 - registration side effect
        gated,
        leveldb,
        memory,
        sqlite,
    )

    if name in WIRE_STORES:
        raise ValueError(
            f"filer store {name!r} (the reference's "
            f"filer/stores/{WIRE_STORES[name]}.py) is not part of the "
            f"PyTorch port yet: {ROADMAP_WIRE_STORES}")
    cls = _REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"unknown filer store {name!r} "
                         f"(available: {sorted(_REGISTRY)})")
    return cls(**kwargs)


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
