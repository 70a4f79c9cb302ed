"""The filer's metadata stores in the port, against the reference.

The reference's store cases (tests/test_stores.py, all but
its needle-map and meta-aggregation cases) run on the port's stores, each
network store over its in-repo fake server (tests/fake_*.py). Then the two
packages are held to each other store by store: one seeded script of
entries through the reference's store on one fake and through the port's
on another gives equal results and leaves both fakes holding the same
bytes; a fake that one package's postgres2, redis3 or tikv store filled
reads the same through the other's; and the four protocol-trace goldens
(tests/goldens/*.trace) replay byte for byte in both directions through
the port's clients. Last, a fault the port fixes: the reference's SQL and
HTTP clients wait out a delayed ACK on every statement. The table of fakes
at the top (which fake serves each registered name, how a store addresses
it, a dump of what it holds) serves tests/test_torch_filer.py too. Run on
the CPU: `JAX_PLATFORMS=cpu python -m pytest tests/test_torch_stores.py
-q`.
"""

import importlib
import os
import random
import socket
import time

import pytest
import requests

from seaweedfs_tpu.filer import entry as ref_entry_mod
from seaweedfs_tpu.filer.entry import Attr as RefAttr, Entry as RefEntry
from seaweedfs_tpu.filer.filerstore import (
    available_stores as ref_available_stores,
    get_store as ref_get_store,
)
from seaweedfs_tpu_torch.filer import Attr, Entry, Filer
from seaweedfs_tpu_torch.filer import entry as port_entry_mod
from seaweedfs_tpu_torch.filer.filerstore import (
    PathTranslatingStore,
    StoreWrapper,
    available_stores,
    get_store,
)
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.server.filer import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from tests import wire_goldens as wg
from tests import torch_ports


# -- the network stores and their fakes ----------------------------------------

#: registered name -> (fake module, fake class, how a store addresses it)
FAKES = {
    "mysql": ("fake_mysql", "FakeMySqlServer", "host"),
    "mysql2": ("fake_mysql", "FakeMySqlServer", "host"),
    "postgres": ("fake_postgres", "FakePostgresServer", "host"),
    "postgres2": ("fake_postgres", "FakePostgresServer", "host"),
    "redis": ("fake_redis", "FakeRedisServer", "host"),
    "redis2": ("fake_redis", "FakeRedisServer", "host"),
    "redis3": ("fake_redis", "FakeRedisServer", "host"),
    "redis_lua": ("fake_redis", "FakeRedisServer", "host"),
    "cassandra": ("fake_cassandra", "FakeCassandraServer", "host"),
    "mongodb": ("fake_mongo", "FakeMongoServer", "host"),
    "elastic": ("fake_elastic", "FakeElasticServer", "host"),
    "elastic7": ("fake_elastic", "FakeElasticServer", "host"),
    "arangodb": ("fake_arango", "FakeArangoServer", "host"),
    "hbase": ("fake_hbase", "FakeHbaseThriftServer", "zkquorum"),
    "etcd": ("fake_etcd", "FakeEtcdServer", "servers"),
    "tikv": ("fake_tikv", "FakeTikvCluster", "pdaddrs"),
    "ydb": ("fake_ydb", "FakeYdbServer", "dsn"),
}

NETWORK_STORES = sorted(FAKES)


def open_fake(kind: str, **kwargs):
    """A fresh fake server for store `kind` (stop() it when done)."""
    mod, cls, _ = FAKES[kind]
    return getattr(importlib.import_module(f"tests.{mod}"), cls)(**kwargs)


def store_kwargs(kind: str, port: int) -> dict:
    """The get_store keyword arguments that point `kind` at a fake's
    port."""
    how = FAKES[kind][2]
    if how == "host":
        return dict(host="localhost", port=port)
    if how == "dsn":
        return dict(dsn=f"grpc://localhost:{port}/local")
    return {how: f"localhost:{port}"}


def fake_state(kind: str, srv) -> str:
    """Everything the fake holds, as one deterministic string."""
    mod = FAKES[kind][0]
    if mod in ("fake_mysql", "fake_postgres", "fake_cassandra"):
        with srv._dblock:
            return "\n".join(srv.db.iterdump())
    if mod == "fake_redis":
        with srv._lock:
            return repr((sorted(srv.kv.items()),
                         sorted((k, v) for k, v in srv.zsets.items() if v),
                         sorted(srv.scripts.items())))
    if mod == "fake_mongo":
        with srv._dblock:
            return repr(srv.docs)
    if mod == "fake_elastic":
        with srv._lock:
            return repr(sorted((i, sorted(d.items()))
                               for i, d in srv.indices.items()))
    if mod == "fake_arango":
        with srv._lock:
            return repr(sorted((c, sorted(d.items()))
                               for c, d in srv.collections.items()))
    if mod == "fake_hbase":
        with srv.lock:
            return repr(sorted((t, sorted(rows.items()))
                               for t, rows in srv.tables.items()))
    if mod == "fake_etcd":
        with srv.servicer.lock:
            return repr((srv.servicer.rev, sorted(srv.data.items())))
    if mod == "fake_tikv":
        return repr(sorted(srv.data.items()))
    if mod == "fake_ydb":
        s = srv.servicer
        with s.lock:
            return repr((sorted(s.tables), sorted(s.rows.items())))
    raise KeyError(kind)


_PORTS = random.Random(os.getpid() + 31)
_HANDED: set[int] = set()  # ports this process handed out, never again
# the reference's default ports and the gRPC (+10000) and admin (+11000)
# ports derived from them
_RESERVED = {p + d for p in (8888, 9333, 8080) for d in (0, 10000, 11000)}


def _free_port() -> int:
    """A free HTTP port whose gRPC twin (+10000) is free too, both below
    the kernel's ephemeral range, so no port-0 bind elsewhere can take
    one between this pick and the server's bind."""
    for _ in range(400):
        port = torch_ports.draw(_PORTS, 12000, 21000)
        if port in _HANDED or {port, port + 10000, port + 11000} & _RESERVED:
            continue
        try:
            for p in (port, port + 10000):
                with socket.socket() as s:
                    s.bind(("", p))
        except OSError:
            continue
        _HANDED.add(port)
        return port
    raise RuntimeError("no free port pair")


def _volume_server(**kwargs) -> VolumeServer:
    """The port's volume server on the CPU coder (no card here)."""
    return VolumeServer(coder=RSCodecTorch(10, 4, device="cpu"), **kwargs)


# -- leveldb-style store ---------------------------------------------------

def test_leveldb_store_crud_and_persistence(tmp_path):
    store = get_store("leveldb", directory=str(tmp_path / "ldb"))
    f = Filer(store)
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=11)))
    for i in range(5):
        f.create_entry(Entry(full_path=f"/a/b/f{i}"))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 11
    names = [e.name for e in f.list_entries("/a/b")]
    assert names == ["c.txt", "f0", "f1", "f2", "f3", "f4"]
    assert [e.name for e in f.list_entries("/a/b", start="f1")] == \
        ["f2", "f3", "f4"]
    assert len(list(f.list_entries("/a/b", prefix="f"))) == 5
    f.delete_entry("/a/b/f0")
    store.kv_put(b"k", b"v")
    store.close()
    # reopen: the log replays
    store2 = get_store("leveldb", directory=str(tmp_path / "ldb"))
    f2 = Filer(store2)
    assert f2.find_entry("/a/b/c.txt").attr.mtime == 11
    assert [e.name for e in f2.list_entries("/a/b")] == \
        ["c.txt", "f1", "f2", "f3", "f4"]
    assert store2.kv_get(b"k") == b"v"
    store2.close()


def test_leveldb_store_compaction(tmp_path):
    store = get_store("leveldb", directory=str(tmp_path / "ldb"))
    # churn enough overwrites to trip compaction (threshold 4096)
    for round_ in range(3):
        for i in range(2048):
            store.insert_entry(Entry(full_path=f"/x/e{i}",
                                     attr=Attr(mtime=round_)))
    import os

    log_size = os.path.getsize(str(tmp_path / "ldb" / "filer.log"))
    entries = list(store.list_directory_entries("/x", limit=4096))
    assert len(entries) == 2048
    assert all(e.attr.mtime == 2 for e in entries)
    # compaction kept the log near one generation of entries
    store2 = get_store("leveldb", directory=str(tmp_path / "ldb"))
    assert len(list(store2.list_directory_entries("/x", limit=4096))) == 2048
    store.close()
    store2.close()


def test_leveldb_store_torn_tail_repair(tmp_path):
    store = get_store("leveldb", directory=str(tmp_path / "ldb"))
    store.insert_entry(Entry(full_path="/ok/a", attr=Attr(mtime=1)))
    store.close()
    # simulate a crash mid-append: tear the last record
    log = tmp_path / "ldb" / "filer.log"
    blob = log.read_bytes()
    log.write_bytes(blob + b"\x01\xff\xff\x00\x00\x10\x00\x00\x00part")
    store2 = get_store("leveldb", directory=str(tmp_path / "ldb"))
    assert store2.find_entry("/ok/a").attr.mtime == 1
    # the torn tail was truncated; new writes append cleanly
    store2.insert_entry(Entry(full_path="/ok/b"))
    store2.close()
    store3 = get_store("leveldb", directory=str(tmp_path / "ldb"))
    assert store3.find_entry("/ok/b") is not None
    store3.close()


def test_gated_stores_fail_with_guidance():
    # the network stores register; the one gated kind fails at
    # construction with clear guidance
    avail = available_stores()
    for kind in ("tikv", "hbase", "ydb", "redis_lua"):
        assert kind in avail
    # rocksdb is the one remaining gate (cgo-gated in the reference too)
    with pytest.raises(RuntimeError, match="client library"):
        get_store("rocksdb")


# -- redis store (real RESP wire against an in-process server) -------------

@pytest.fixture
def redis_server():
    from tests.fake_redis import FakeRedisServer

    srv = FakeRedisServer()
    yield srv
    srv.stop()


def test_redis_store_crud_listing_and_kv(redis_server):
    """The same coverage the leveldb CRUD test has, through the real
    RESP client (redis2_store.go layout: path-keyed blobs + a sorted
    set per directory)."""
    store = get_store("redis", host="localhost", port=redis_server.port)
    f = Filer(store)
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=11)))
    for i in range(5):
        f.create_entry(Entry(full_path=f"/a/b/f{i}"))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 11
    assert [e.name for e in f.list_entries("/a/b")] == \
        ["c.txt", "f0", "f1", "f2", "f3", "f4"]
    assert [e.name for e in f.list_entries("/a/b", start="f1")] == \
        ["f2", "f3", "f4"]
    assert len(list(f.list_entries("/a/b", prefix="f"))) == 5
    f.delete_entry("/a/b/f0")
    assert [e.name for e in f.list_entries("/a/b")] == \
        ["c.txt", "f1", "f2", "f3", "f4"]
    store.kv_put(b"k", b"v")
    assert store.kv_get(b"k") == b"v"
    assert store.kv_get(b"absent") is None
    # a second client sees the same state (it's a real server, not
    # in-process dicts behind the SPI)
    store2 = get_store("redis2", host="localhost", port=redis_server.port)
    assert Filer(store2).find_entry("/a/b/c.txt").attr.mtime == 11
    store2.close()
    store.close()


def test_redis_store_subtree_delete(redis_server):
    store = get_store("redis", host="localhost", port=redis_server.port)
    f = Filer(store)
    for p in ("/t/x/1", "/t/x/sub/2", "/t/x/sub/deep/3", "/t/keep"):
        f.create_entry(Entry(full_path=p))
    store.delete_folder_children("/t/x")
    assert store.find_entry("/t/x/1") is None
    assert store.find_entry("/t/x/sub/2") is None
    assert store.find_entry("/t/x/sub/deep/3") is None
    assert store.find_entry("/t/keep") is not None
    store.close()


def test_redis_store_auth_and_errors(redis_server):
    from tests.fake_redis import FakeRedisServer

    from seaweedfs_tpu_torch.filer.stores.redis import RespClient, RespError

    locked = FakeRedisServer(password="sekret")
    try:
        with pytest.raises(RespError, match="NOAUTH|invalid"):
            c = RespClient("localhost", locked.port)
            c.cmd("GET", b"x")
        c = RespClient("localhost", locked.port, password="sekret")
        assert c.cmd("PING") == "PONG"
        c.close()
    finally:
        locked.stop()
    # server-side errors surface as RespError, not protocol desync
    c = RespClient("localhost", redis_server.port)
    with pytest.raises(RespError, match="unknown command"):
        c.cmd("NOPE")
    assert c.cmd("PING") == "PONG"  # connection still in sync
    c.close()


def test_redis3_segmented_listing(redis_server):
    """redis3: directory listings in size-bounded ZSET segments (the
    reference's skiplist-of-batches invariant). A tiny batch forces
    real splits; ordering, pagination, prefix, and removal-driven
    segment collapse must all hold across segment boundaries."""
    store = get_store("redis3", host="localhost", port=redis_server.port,
                      batch=4)
    f = Filer(store)
    names = [f"e{i:03d}" for i in range(40)]
    import random

    shuffled = names[:]
    random.Random(7).shuffle(shuffled)  # splits under random order
    for n in shuffled:
        f.create_entry(Entry(full_path=f"/big/dir/{n}"))
    # every segment key stays bounded at 2*batch
    seg_keys = [k for k in redis_server.zsets
                if k.startswith(b"/big/dir\x00seg:")]
    assert len(seg_keys) >= 3, "tiny batch must have split segments"
    assert all(len(redis_server.zsets[k]) <= 8 for k in seg_keys)
    # full ordered listing across segments
    assert [e.name for e in
            store.list_directory_entries("/big/dir", limit=1024)] == names
    # start/include_start pagination across a segment boundary
    assert [e.name for e in store.list_directory_entries(
        "/big/dir", "e019", include_start=False, limit=3)] == \
        ["e020", "e021", "e022"]
    assert [e.name for e in store.list_directory_entries(
        "/big/dir", "e019", include_start=True, limit=2)] == \
        ["e019", "e020"]
    # prefix narrowing
    assert [e.name for e in store.list_directory_entries(
        "/big/dir", prefix="e03", limit=1024)] == \
        [f"e{i:03d}" for i in range(30, 40)]
    # removal shrinks/collapses segments without losing order
    for n in names[10:30]:
        f.delete_entry(f"/big/dir/{n}")
    assert [e.name for e in
            store.list_directory_entries("/big/dir", limit=1024)] == \
        names[:10] + names[30:]
    # subtree delete clears every segment + index key
    store.delete_folder_children("/big")
    assert store.find_entry("/big/dir/e000") is None
    assert not any(k.startswith(b"/big/dir\x00")
                   for k in redis_server.zsets if redis_server.zsets[k])
    store.close()


def test_redis3_crud_and_kv(redis_server):
    store = get_store("redis3", host="localhost", port=redis_server.port)
    f = Filer(store)
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=11)))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 11
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=99)))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 99
    store.kv_put(b"k3", b"v3")
    assert store.kv_get(b"k3") == b"v3"
    # entry blobs share the redis/redis2 layout: readable cross-store
    other = get_store("redis", host="localhost", port=redis_server.port)
    assert Filer(other).find_entry("/a/b/c.txt").attr.mtime == 99
    other.close()
    store.close()


def test_filer_toml_selects_store(redis_server, tmp_path, monkeypatch):
    """filer.toml's enabled section selects + configures the store —
    the reference's only store-selection mechanism (command/filer.go
    LoadConfiguration('filer'), scaffold [redis2] address field)."""
    from seaweedfs_tpu_torch.filer.stores.redis import RedisStore

    (tmp_path / "filer.toml").write_text(
        f'[redis]\nenabled = true\n'
        f'address = "localhost:{redis_server.port}"\n')
    monkeypatch.chdir(tmp_path)
    fs = FilerServer(ip="localhost", port=_free_port(),
                     master="localhost:1", store="sqlite")
    try:
        # the server always interposes the transient-fault retry layer;
        # the toml-selected backend sits right under it
        from seaweedfs_tpu_torch.filer.filerstore import RetryingStore

        assert isinstance(fs.filer.store, RetryingStore)
        assert isinstance(fs.filer.store.store, RedisStore)
        # and it actually works against the live RESP server
        fs.filer.create_entry(Entry(full_path="/toml/picked",
                                    attr=Attr(mtime=7)))
        assert fs.filer.find_entry("/toml/picked").attr.mtime == 7
    finally:
        if fs.filer.meta_log is not None:
            fs.filer.meta_log.close()  # flushes through the store
        fs.filer.store.close()


def test_redis_store_backs_live_filer(redis_server, tmp_path):
    """A full filer server (HTTP + gRPC) running on the redis store."""
    mport = _free_port()
    master = MasterServer(ip="localhost", port=mport,
                          volume_size_limit_mb=64)
    master.start(vacuum_interval=3600)
    vsrv = _volume_server(directories=[str(tmp_path / "rvol")],
                        master=f"localhost:{mport}", ip="localhost",
                        port=_free_port())
    vsrv.start()
    deadline = time.time() + 10
    while time.time() < deadline and not master.topo.nodes:
        time.sleep(0.05)
    from seaweedfs_tpu_torch.filer import Filer

    fs = FilerServer(ip="localhost", port=_free_port(),
                     master=f"localhost:{mport}", store="memory")
    # replace the whole Filer BEFORE start: its MetaLog binds to the
    # store at construction, so a post-hoc store swap would leave the
    # persisted event log on the discarded memory store
    fs.filer = Filer(get_store("redis", host="localhost",
                               port=redis_server.port))
    fs.start()
    try:
        base = f"http://{fs.address}"
        r = requests.put(f"{base}/rd/x.bin", data=b"redis-backed",
                         timeout=30)
        assert r.status_code in (200, 201)
        g = requests.get(f"{base}/rd/x.bin", timeout=30)
        assert g.status_code == 200 and g.content == b"redis-backed"
        # listing via the real store
        names = [e.name for e in fs.filer.list_entries("/rd")]
        assert names == ["x.bin"]
    finally:
        fs.stop()
        vsrv.stop()
        master.stop()
        rpc.reset_channels()


def test_store_wrapper_counts_ops():
    from seaweedfs_tpu_torch.utils.stats import FILER_STORE_COUNTER

    w = StoreWrapper(get_store("memory"))
    before = FILER_STORE_COUNTER.value(store="memory", op="insert")
    w.insert_entry(Entry(full_path="/w/x"))
    assert w.find_entry("/w/x") is not None
    assert FILER_STORE_COUNTER.value(store="memory", op="insert") == \
        before + 1


def test_path_translating_store():
    backing = get_store("memory")
    t = PathTranslatingStore(backing, "/mnt/sub")
    t.insert_entry(Entry(full_path="/hello.txt", attr=Attr(mtime=5)))
    assert backing.find_entry("/mnt/sub/hello.txt").attr.mtime == 5
    got = t.find_entry("/hello.txt")
    assert got is not None and got.full_path == "/hello.txt"
    assert [e.full_path for e in t.list_directory_entries("/")] == \
        ["/hello.txt"]








def test_abstract_sql_dialect_layer(tmp_path):
    """The shared SQL layer (abstract_sql_store.go rebuild): dialects only
    supply SQL + connections; the store logic is dialect-agnostic."""
    from seaweedfs_tpu_torch.filer.entry import Entry
    from seaweedfs_tpu_torch.filer.stores.abstract_sql import (
        AbstractSqlStore,
        MySqlDialect,
        PostgresDialect,
        SqliteDialect,
    )

    # mysql/postgres dialects generate their exact SQL shapes...
    my = MySqlDialect()
    assert "ON DUPLICATE KEY UPDATE" in my.upsert("filemeta")
    assert my.find("filemeta").count("%s") == 2
    pg = PostgresDialect()
    assert "ON CONFLICT(directory,name)" in pg.upsert("filemeta")
    assert "BYTEA" in pg.create_table("filemeta")
    # both dialects speak their wire protocols themselves now (pg_wire /
    # mysql_wire) — with no server listening the failure is a socket
    # error, not a gated RuntimeError
    import pytest as _pytest

    my_free = MySqlDialect(port=1)  # nothing listens on port 1
    with _pytest.raises(OSError):
        my_free.connect()
    pg_free = PostgresDialect(port=1)
    with _pytest.raises(OSError):
        pg_free.connect()

    # a foreign-paramstyle dialect runs through the same store logic:
    # translate the pyformat placeholders onto sqlite at execute() time
    class _PyformatCursor:
        def __init__(self, cur):
            self._cur = cur

        def execute(self, sql, params=()):
            return self._cur.execute(sql.replace("%s", "?"), params)

        def __getattr__(self, a):
            return getattr(self._cur, a)

    class _PyformatConn:
        def __init__(self, conn):
            self._conn = conn

        def cursor(self):
            return _PyformatCursor(self._conn.cursor())

        def __getattr__(self, a):
            return getattr(self._conn, a)

    class FakeMySqlDialect(MySqlDialect):
        def __init__(self, path):
            super().__init__()
            self._sqlite = SqliteDialect(path)

        def create_table(self, table):  # mysql DDL isn't sqlite-valid
            return self._sqlite.create_table(table)

        def create_kv_table(self, table):
            return self._sqlite.create_kv_table(table)

        def kv_table(self, table):
            return self._sqlite.kv_table(table)

        def upsert(self, table):
            return self._sqlite.upsert(table).replace("?", "%s")

        def kv_upsert(self, table):
            return self._sqlite.kv_upsert(table).replace("?", "%s")

        def connect(self):
            return _PyformatConn(self._sqlite.connect())

    store = AbstractSqlStore(FakeMySqlDialect(str(tmp_path / "f.db")))
    store.insert_entry(Entry(full_path="/a/b.txt", content=b"dialect!"))
    store.insert_entry(Entry(full_path="/a/c.txt"))
    got = store.find_entry("/a/b.txt")
    assert got is not None and got.content == b"dialect!"
    names = [e.name for e in store.list_directory_entries("/a")]
    assert names == ["b.txt", "c.txt"]
    store.kv_put(b"k", b"v")
    assert store.kv_get(b"k") == b"v"
    store.delete_folder_children("/a")
    assert store.find_entry("/a/b.txt") is None
    store.close()


def test_mysql_postgres_registered():
    from seaweedfs_tpu_torch.filer.filerstore import available_stores

    avail = available_stores()
    assert "mysql" in avail and "postgres" in avail and "sqlite" in avail
    assert "postgres2" in avail


# -- postgres store (real v3 wire against an in-process server) ------------

@pytest.fixture
def pg_server():
    from tests.fake_postgres import FakePostgresServer

    srv = FakePostgresServer()
    yield srv
    srv.stop()


def test_postgres_store_crud_listing_and_kv(pg_server):
    """Same coverage as the leveldb/redis CRUD tests, through the real
    postgres v3 extended query protocol (postgres_store.go via lib/pq;
    here pg_wire.py via Parse/Bind/Execute with typed binary params)."""
    store = get_store("postgres", host="localhost", port=pg_server.port)
    f = Filer(store)
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=11)))
    for i in range(5):
        f.create_entry(Entry(full_path=f"/a/b/f{i}"))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 11
    assert [e.name for e in f.list_entries("/a/b")] == \
        ["c.txt", "f0", "f1", "f2", "f3", "f4"]
    assert [e.name for e in f.list_entries("/a/b", start="f1")] == \
        ["f2", "f3", "f4"]
    assert len(list(f.list_entries("/a/b", prefix="f"))) == 5
    f.delete_entry("/a/b/f0")
    assert [e.name for e in f.list_entries("/a/b")] == \
        ["c.txt", "f1", "f2", "f3", "f4"]
    # bytea kv round-trip, incl. bytes that would break text escaping
    gnarly = bytes(range(256))
    store.kv_put(b"k\x00bin", gnarly)
    assert store.kv_get(b"k\x00bin") == gnarly
    assert store.kv_get(b"absent") is None
    # upsert path: same (directory,name) twice
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=99)))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 99
    # second client sees the same state over its own connection
    store2 = get_store("postgres", host="localhost", port=pg_server.port)
    assert Filer(store2).find_entry("/a/b/c.txt").attr.mtime == 99
    store2.close()
    store.close()


def test_postgres_store_subtree_delete(pg_server):
    store = get_store("postgres", host="localhost", port=pg_server.port)
    f = Filer(store)
    for p in ("/t/x/1", "/t/x/sub/2", "/t/x/sub/deep/3", "/t/keep"):
        f.create_entry(Entry(full_path=p))
    store.delete_folder_children("/t/x")
    assert store.find_entry("/t/x/1") is None
    assert store.find_entry("/t/x/sub/2") is None
    assert store.find_entry("/t/x/sub/deep/3") is None
    assert store.find_entry("/t/keep") is not None
    store.close()


def test_postgres_scram_and_md5_auth():
    """SCRAM-SHA-256 and md5 challenge flows; the fake server verifies
    the SCRAM proof with its own independent RFC 7677 math."""
    from tests.fake_postgres import FakePostgresServer

    from seaweedfs_tpu_torch.filer.stores.pg_wire import PgConnection, PgError

    for mode in ("scram", "md5"):
        srv = FakePostgresServer(auth=mode, user="weed", password="sekret")
        try:
            c = PgConnection(host="localhost", port=srv.port, user="weed",
                             password="sekret", dbname="x")
            cur = c.cursor()
            cur.execute("SELECT 1 + 1")
            assert cur.fetchone()[0] == 2
            c.close()
            with pytest.raises((PgError, ConnectionError)):
                PgConnection(host="localhost", port=srv.port, user="weed",
                             password="wrong", dbname="x")
        finally:
            srv.stop()


def test_postgres_server_errors_keep_connection_usable(pg_server):
    from seaweedfs_tpu_torch.filer.stores.pg_wire import PgConnection, PgError

    c = PgConnection(host="localhost", port=pg_server.port)
    cur = c.cursor()
    with pytest.raises(PgError, match="sqlite"):
        cur.execute("SELECT * FROM no_such_table")
    # protocol stays in sync after an ErrorResponse
    cur.execute("SELECT 40 + 2")
    assert cur.fetchone()[0] == 42
    c.close()


def test_postgres2_bucket_tables(pg_server):
    """postgres2 = SupportBucketTable (postgres2_store.go:53): objects
    under /buckets/<name>/ land in a per-bucket table; deleting the
    bucket drops the table O(1) without touching other buckets."""
    store = get_store("postgres2", host="localhost", port=pg_server.port)
    f = Filer(store)
    f.create_entry(Entry(full_path="/buckets/red/obj1", content=b"r1"))
    f.create_entry(Entry(full_path="/buckets/red/deep/obj2", content=b"r2"))
    f.create_entry(Entry(full_path="/buckets/blue/obj3", content=b"b3"))
    f.create_entry(Entry(full_path="/plain/file", content=b"p"))
    assert store.find_entry("/buckets/red/obj1").content == b"r1"
    assert store.find_entry("/buckets/red/deep/obj2").content == b"r2"
    assert [e.name for e in store.list_directory_entries("/buckets/red")] \
        == ["deep", "obj1"]
    # the bucket rows really live in their own table
    with pg_server._dblock:
        cur = pg_server.db.cursor()
        cur.execute("SELECT count(*) FROM bucket_red")
        in_bucket = cur.fetchone()[0]
        cur.execute("SELECT count(*) FROM filemeta WHERE "
                    "directory LIKE '/buckets/red%'")
        in_main = cur.fetchone()[0]
    assert in_bucket >= 2 and in_main == 0
    # whole-bucket delete drops the table, leaves others intact
    store.delete_folder_children("/buckets/red")
    assert store.find_entry("/buckets/red/obj1") is None
    assert store.find_entry("/buckets/blue/obj3").content == b"b3"
    assert store.find_entry("/plain/file").content == b"p"
    with pg_server._dblock:
        cur = pg_server.db.cursor()
        cur.execute("SELECT name FROM sqlite_master WHERE name='bucket_red'")
        assert cur.fetchone() is None
    store.close()


def test_postgres2_hyphenated_buckets_and_ancestor_delete(pg_server):
    """S3 bucket names routinely carry '-' and '.'; every statement must
    quote the bucket table identifier. And a recursive delete of the
    whole /buckets tree must drop bucket tables, not just main rows."""
    store = get_store("postgres2", host="localhost", port=pg_server.port)
    f = Filer(store)
    f.create_entry(Entry(full_path="/buckets/my-bucket.v2/obj", content=b"x"))
    got = store.find_entry("/buckets/my-bucket.v2/obj")
    assert got is not None and got.content == b"x"
    assert [e.name for e in
            store.list_directory_entries("/buckets/my-bucket.v2")] == ["obj"]
    store.delete_entry("/buckets/my-bucket.v2/obj")
    assert store.find_entry("/buckets/my-bucket.v2/obj") is None
    # ancestor delete: /buckets wipe drops every bucket table
    f.create_entry(Entry(full_path="/buckets/one/a", content=b"1"))
    f.create_entry(Entry(full_path="/buckets/two/b", content=b"2"))
    store.delete_folder_children("/buckets")
    assert store.find_entry("/buckets/one/a") is None
    assert store.find_entry("/buckets/two/b") is None
    with pg_server._dblock:
        cur = pg_server.db.cursor()
        cur.execute("SELECT name FROM sqlite_master WHERE type='table' "
                    "AND name LIKE 'bucket_%'")
        assert cur.fetchall() == []
    # stale-cache heal: drop a table behind the store's back; insert must
    # recreate it rather than failing forever
    f.create_entry(Entry(full_path="/buckets/heal/a", content=b"h1"))
    with pg_server._dblock:
        pg_server.db.execute('DROP TABLE "bucket_heal"')
        pg_server.db.commit()
    f.create_entry(Entry(full_path="/buckets/heal/b", content=b"h2"))
    assert store.find_entry("/buckets/heal/b").content == b"h2"
    store.close()


def test_postgres_reconnects_after_socket_drop(pg_server):
    """A killed connection reads as a ConnectionError once, then the
    client transparently reconnects (autocommit — no txn state lost)."""
    from seaweedfs_tpu_torch.filer.stores.pg_wire import PgConnection

    c = PgConnection(host="localhost", port=pg_server.port)
    cur = c.cursor()
    cur.execute("SELECT 1 + 1")
    assert cur.fetchone()[0] == 2
    c._sock.close()  # simulate server-side drop / timeout
    with pytest.raises((OSError, ConnectionError)):
        cur.execute("SELECT 2 + 2")
    cur.execute("SELECT 3 + 3")  # reconnected under the hood
    assert cur.fetchone()[0] == 6
    c.close()


# -- mongodb store (real OP_MSG/BSON wire against an in-process server) ----

@pytest.fixture
def mongo_server():
    from tests.fake_mongo import FakeMongoServer

    srv = FakeMongoServer()
    yield srv
    srv.stop()


def test_mongodb_store_crud_listing_and_kv(mongo_server):
    """Same coverage as the other wire-store CRUD tests through OP_MSG
    (mongodb_store.go via mongo-driver; here mongo_wire.py). The fake
    returns 3-document batches, so listings exercise getMore."""
    store = get_store("mongodb", host="localhost", port=mongo_server.port)
    f = Filer(store)
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=11)))
    for i in range(9):
        f.create_entry(Entry(full_path=f"/a/b/f{i}"))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 11
    assert [e.name for e in f.list_entries("/a/b")] == \
        ["c.txt"] + [f"f{i}" for i in range(9)]
    assert [e.name for e in f.list_entries("/a/b", start="f5")] == \
        ["f6", "f7", "f8"]
    assert len(list(f.list_entries("/a/b", prefix="f"))) == 9
    f.delete_entry("/a/b/f0")
    assert store.find_entry("/a/b/f0") is None
    # upsert
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=99)))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 99
    # kv: 8-byte dir/name split, binary-safe
    gnarly = bytes(range(256))
    store.kv_put(b"\x01\x02k", gnarly)
    assert store.kv_get(b"\x01\x02k") == gnarly
    assert store.kv_get(b"absent-key") is None
    # empty value stays distinguishable from an absent key
    store.kv_put(b"empty-key", b"")
    assert store.kv_get(b"empty-key") == b""
    # subtree delete (regex descendant matching)
    for p in ("/t/x/1", "/t/x/sub/2", "/t/keep"):
        f.create_entry(Entry(full_path=p))
    store.delete_folder_children("/t/x")
    assert store.find_entry("/t/x/1") is None
    assert store.find_entry("/t/x/sub/2") is None
    assert store.find_entry("/t/keep") is not None
    store.close()


def test_mongodb_scram_auth(mongo_server):
    """SCRAM-SHA-256 over saslStart/saslContinue; the fake verifies the
    proof with independent math and gates commands on auth."""
    from tests.fake_mongo import FakeMongoServer

    from seaweedfs_tpu_torch.filer.stores.mongo_wire import (
        MongoConnection,
        MongoError,
    )

    locked = FakeMongoServer(user="weed", password="sekret")
    try:
        store = get_store("mongodb", host="localhost", port=locked.port,
                          user="weed", password="sekret")
        f = Filer(store)
        f.create_entry(Entry(full_path="/auth/ok", attr=Attr(mtime=5)))
        assert f.find_entry("/auth/ok").attr.mtime == 5
        store.close()
        with pytest.raises((MongoError, ConnectionError)):
            MongoConnection(host="localhost", port=locked.port,
                            user="weed", password="wrong")
        # unauthenticated commands are refused
        c = MongoConnection(host="localhost", port=locked.port)
        with pytest.raises(MongoError, match="authentication"):
            c.command("seaweedfs", {"find": "filemeta", "filter": {}})
        c.close()
    finally:
        locked.stop()


# -- arangodb store (REST + AQL against an in-process server) --------------

@pytest.fixture
def arango_server():
    from tests.fake_arango import FakeArangoServer

    srv = FakeArangoServer()
    yield srv
    srv.stop()


def test_arangodb_store_crud_listing_and_kv(arango_server):
    """arangodb_store.go layout over REST+AQL: md5 _key docs, collection
    per bucket, AQL listings batched small enough to exercise cursor
    paging (PUT /_api/cursor)."""
    store = get_store("arangodb", host="localhost",
                      port=arango_server.port)
    f = Filer(store)
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=11)))
    for i in range(9):
        f.create_entry(Entry(full_path=f"/a/b/f{i}"))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 11
    assert [e.name for e in f.list_entries("/a/b")] == \
        ["c.txt"] + [f"f{i}" for i in range(9)]
    assert [e.name for e in f.list_entries("/a/b", start="f5")] == \
        ["f6", "f7", "f8"]
    assert len(list(f.list_entries("/a/b", prefix="f"))) == 9
    f.delete_entry("/a/b/f0")
    assert store.find_entry("/a/b/f0") is None
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=99)))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 99
    # kv
    gnarly = bytes(range(256))
    store.kv_put(b"\x00kv\xffkey", gnarly)
    assert store.kv_get(b"\x00kv\xffkey") == gnarly
    assert store.kv_get(b"nope") is None
    # subtree delete through the AQL REMOVE template
    for p in ("/t/x/1", "/t/x/sub/2", "/t/keep"):
        f.create_entry(Entry(full_path=p))
    store.delete_folder_children("/t/x")
    assert store.find_entry("/t/x/1") is None
    assert store.find_entry("/t/x/sub/2") is None
    assert store.find_entry("/t/keep") is not None
    # bucket objects land in their own collection; bucket wipe drops it
    f.create_entry(Entry(full_path="/buckets/bk1/obj", content=b"b1"))
    assert "bucket_bk1" in arango_server.collections
    assert store.find_entry("/buckets/bk1/obj").content == b"b1"
    # bucket DIR entries stay in the default collection so that listing
    # /buckets (S3 ListAllMyBuckets) actually works
    f.create_entry(Entry(full_path="/buckets/bk2", is_directory=True))
    names = [e.name for e in store.list_directory_entries("/buckets")]
    assert "bk2" in names
    store.delete_folder_children("/buckets/bk1")
    assert store.find_entry("/buckets/bk1/obj") is None
    assert "bucket_bk1" not in arango_server.collections
    # /buckets-wide wipe drops every bucket collection
    f.create_entry(Entry(full_path="/buckets/bk3/deep/obj", content=b"x"))
    store.delete_folder_children("/buckets")
    assert store.find_entry("/buckets/bk3/deep/obj") is None
    assert not any(n.startswith("bucket_")
                   for n in arango_server.collections)
    # root-wide wipe reaches the whole tree (sub prefix "/" not "//")
    f.create_entry(Entry(full_path="/deep/er/file", content=b"d"))
    store.delete_folder_children("/")
    assert store.find_entry("/deep/er/file") is None
    store.close()


def test_arangodb_auth(arango_server):
    from tests.fake_arango import FakeArangoServer

    from seaweedfs_tpu_torch.filer.stores.elastic_wire import ElasticError

    locked = FakeArangoServer(username="weed", password="sekret")
    try:
        with pytest.raises(ElasticError, match="401"):
            get_store("arangodb", host="localhost", port=locked.port)
        store = get_store("arangodb", host="localhost", port=locked.port,
                          username="weed", password="sekret")
        f = Filer(store)
        f.create_entry(Entry(full_path="/auth/ok", attr=Attr(mtime=5)))
        assert f.find_entry("/auth/ok").attr.mtime == 5
        store.close()
    finally:
        locked.stop()


# -- etcd store (etcdserverpb.KV gRPC against an in-process server) --------

@pytest.fixture
def etcd_server():
    from tests.fake_etcd import FakeEtcdServer

    srv = FakeEtcdServer()
    yield srv
    srv.stop()


def test_etcd_store_crud_listing_and_kv(etcd_server):
    """etcd_store.go's dir\\x00name key layout over the real
    etcdserverpb.KV gRPC surface (Range/Put/DeleteRange)."""
    store = get_store("etcd", servers=f"localhost:{etcd_server.port}")
    f = Filer(store)
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=11)))
    for i in range(5):
        f.create_entry(Entry(full_path=f"/a/b/f{i}"))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 11
    assert [e.name for e in f.list_entries("/a/b")] == \
        ["c.txt", "f0", "f1", "f2", "f3", "f4"]
    assert [e.name for e in f.list_entries("/a/b", start="f1")] == \
        ["f2", "f3", "f4"]
    assert [e.name for e in
            store.list_directory_entries("/a/b", "f1",
                                         include_start=True)] == \
        ["f1", "f2", "f3", "f4"]
    assert len(list(f.list_entries("/a/b", prefix="f"))) == 5
    f.delete_entry("/a/b/f0")
    assert store.find_entry("/a/b/f0") is None
    # the dir\x00name layout is really on the wire
    assert b"/a/b\x00c.txt" in etcd_server.data
    # kv: raw key bytes are the etcd key (etcd_store_kv.go)
    gnarly = bytes(range(256))
    store.kv_put(b"\x01raw\xffkey", gnarly)
    assert store.kv_get(b"\x01raw\xffkey") == gnarly
    assert store.kv_get(b"absent") is None
    # subtree delete: children + descendants, sibling prefixes survive
    for p in ("/t/x/1", "/t/x/sub/2", "/t/x/sub/deep/3", "/t/xy/keep"):
        f.create_entry(Entry(full_path=p))
    store.delete_folder_children("/t/x")
    assert store.find_entry("/t/x/1") is None
    assert store.find_entry("/t/x/sub/2") is None
    assert store.find_entry("/t/x/sub/deep/3") is None
    assert store.find_entry("/t/xy/keep") is not None
    store.close()


def test_etcd_and_cassandra_prefix_listing_beyond_limit(etcd_server,
                                                        cass_server):
    """A prefixed listing must find matches past the first `limit`
    non-matching names (server-side limit + client-side filter would
    silently return nothing)."""
    for store in (
        get_store("etcd", servers=f"localhost:{etcd_server.port}"),
        get_store("cassandra", host="localhost", port=cass_server.port),
    ):
        f = Filer(store)
        for i in range(60):
            f.create_entry(Entry(full_path=f"/plim/dir/a{i:03d}"))
        f.create_entry(Entry(full_path="/plim/dir/zfile.txt"))
        names = [e.name for e in store.list_directory_entries(
            "/plim/dir", prefix="z", limit=50)]
        assert names == ["zfile.txt"], (store.name, names)
        store.close()


# -- cassandra store (CQL protocol v4 against an in-process server) --------

@pytest.fixture
def cass_server():
    from tests.fake_cassandra import FakeCassandraServer

    srv = FakeCassandraServer()
    yield srv
    srv.stop()


def test_cassandra_store_crud_listing_and_kv(cass_server):
    """cassandra_store.go's exact statement set over the real CQL v4
    wire (frames, bound values, Rows results)."""
    store = get_store("cassandra", host="localhost", port=cass_server.port)
    f = Filer(store)
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=11)))
    for i in range(5):
        f.create_entry(Entry(full_path=f"/a/b/f{i}"))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 11
    assert [e.name for e in f.list_entries("/a/b")] == \
        ["c.txt", "f0", "f1", "f2", "f3", "f4"]
    assert [e.name for e in f.list_entries("/a/b", start="f1")] == \
        ["f2", "f3", "f4"]
    assert len(list(f.list_entries("/a/b", prefix="f"))) == 5
    f.delete_entry("/a/b/f0")
    assert store.find_entry("/a/b/f0") is None
    # upsert (CQL INSERT semantics)
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=99)))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 99
    # kv with binary keys through the 8-byte split
    gnarly = bytes(range(256))
    store.kv_put(b"\xfe\xffkey", gnarly)
    assert store.kv_get(b"\xfe\xffkey") == gnarly
    assert store.kv_get(b"absent!") is None
    # subtree delete (python recursion over partitions)
    for p in ("/t/x/1", "/t/x/sub/2", "/t/keep"):
        f.create_entry(Entry(full_path=p))
    store.delete_folder_children("/t/x")
    assert store.find_entry("/t/x/1") is None
    assert store.find_entry("/t/x/sub/2") is None
    assert store.find_entry("/t/keep") is not None
    store.close()


def test_cassandra_auth_and_errors(cass_server):
    from tests.fake_cassandra import FakeCassandraServer

    from seaweedfs_tpu_torch.filer.stores.cql_wire import (
        CqlConnection,
        CqlError,
    )

    locked = FakeCassandraServer(username="weed", password="sekret")
    try:
        store = get_store("cassandra", host="localhost", port=locked.port,
                          username="weed", password="sekret")
        f = Filer(store)
        f.create_entry(Entry(full_path="/auth/ok", attr=Attr(mtime=5)))
        assert f.find_entry("/auth/ok").attr.mtime == 5
        store.close()
        with pytest.raises((CqlError, ConnectionError)):
            CqlConnection(host="localhost", port=locked.port,
                          username="weed", password="wrong")
    finally:
        locked.stop()
    # server-side errors keep the connection framed and usable
    c = CqlConnection(host="localhost", port=cass_server.port)
    with pytest.raises(CqlError, match="sqlite"):
        c.query("SELECT * FROM no_such_table")
    assert c.query("CREATE KEYSPACE IF NOT EXISTS x WITH replication = "
                   "{'class': 'SimpleStrategy'}") == []
    c.close()


# -- elastic store (REST/JSON against an in-process fake ES) ---------------

@pytest.fixture
def es_server():
    from tests.fake_elastic import FakeElasticServer

    srv = FakeElasticServer()
    yield srv
    srv.stop()


def test_elastic_store_crud_listing_and_kv(es_server):
    """elastic_store.go layout over plain REST: index per top-level dir,
    md5 ids, ParentId term queries; Name-sorted listings (the reference
    sorts md5-of-path descending — an upstream wart this store fixes)."""
    store = get_store("elastic", host="localhost", port=es_server.port)
    f = Filer(store)
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=11)))
    for i in range(5):
        f.create_entry(Entry(full_path=f"/a/b/f{i}"))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 11
    assert [e.name for e in f.list_entries("/a/b")] == \
        ["c.txt", "f0", "f1", "f2", "f3", "f4"]
    assert [e.name for e in f.list_entries("/a/b", start="f1")] == \
        ["f2", "f3", "f4"]
    assert len(list(f.list_entries("/a/b", prefix="f"))) == 5
    f.delete_entry("/a/b/f0")
    assert store.find_entry("/a/b/f0") is None
    # docs really live in the per-top-dir index
    assert any(k.startswith(".seaweedfs_a") for k in es_server.indices)
    # kv round-trip
    gnarly = bytes(range(256))
    store.kv_put(b"\x00weird\xffkey", gnarly)
    assert store.kv_get(b"\x00weird\xffkey") == gnarly
    assert store.kv_get(b"absent") is None
    # subtree delete: top-level wipe drops the index
    store.delete_folder_children("/a")
    assert store.find_entry("/a/b/c.txt") is None
    assert ".seaweedfs_a" not in es_server.indices
    store.close()


def test_elastic_case_variants_and_file_delete_isolation(es_server):
    """/Data and /data must not share an index (ES index names are
    forcibly lowercase; the reference's plain lower() makes an index
    drop for one destroy the other), and deleting a top-level FILE must
    never drop a directory's index."""
    store = get_store("elastic", host="localhost", port=es_server.port)
    f = Filer(store)
    f.create_entry(Entry(full_path="/data/keep.txt", content=b"lower"))
    f.create_entry(Entry(full_path="/Data/other.txt", content=b"upper"))
    assert store.find_entry("/data/keep.txt").content == b"lower"
    assert store.find_entry("/Data/other.txt").content == b"upper"
    # deleting the UPPER-case tree leaves the lower-case one intact
    store.delete_folder_children("/Data")
    store.delete_entry("/Data")
    assert store.find_entry("/Data/other.txt") is None
    assert store.find_entry("/data/keep.txt").content == b"lower"
    # a top-level FILE named like a directory must not wipe the dir
    f.create_entry(Entry(full_path="/data2", content=b"plain file"))
    f.create_entry(Entry(full_path="/data2x/deep.txt", content=b"tree"))
    store.delete_entry("/data2")
    assert store.find_entry("/data2") is None
    assert store.find_entry("/data2x/deep.txt").content == b"tree"
    store.close()


def test_elastic_store_auth_and_pagination(es_server):
    from tests.fake_elastic import FakeElasticServer

    from seaweedfs_tpu_torch.filer.stores.elastic_wire import ElasticError

    locked = FakeElasticServer(username="weed", password="sekret")
    try:
        with pytest.raises(ElasticError, match="401"):
            get_store("elastic", host="localhost", port=locked.port)
        store = get_store("elastic", host="localhost", port=locked.port,
                          username="weed", password="sekret")
        # force multi-page listing through search_after
        store.max_page_size = 3
        f = Filer(store)
        for i in range(10):
            f.create_entry(Entry(full_path=f"/pg/dir/e{i:02d}"))
        names = [e.name for e in
                 store.list_directory_entries("/pg/dir", limit=1024)]
        assert names == [f"e{i:02d}" for i in range(10)]
        store.close()
    finally:
        locked.stop()


# -- mysql store (real client/server protocol against an in-process
#    server) ---------------------------------------------------------------

@pytest.fixture
def mysql_server():
    from tests.fake_mysql import FakeMySqlServer

    srv = FakeMySqlServer()
    yield srv
    srv.stop()


def test_mysql_store_crud_listing_and_kv(mysql_server):
    """Same coverage as the postgres CRUD test, through the MySQL binary
    prepared-statement protocol (mysql_store.go via go-sql-driver; here
    mysql_wire.py via COM_STMT_PREPARE/EXECUTE)."""
    store = get_store("mysql", host="localhost", port=mysql_server.port)
    f = Filer(store)
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=11)))
    for i in range(5):
        f.create_entry(Entry(full_path=f"/a/b/f{i}"))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 11
    assert [e.name for e in f.list_entries("/a/b")] == \
        ["c.txt", "f0", "f1", "f2", "f3", "f4"]
    assert [e.name for e in f.list_entries("/a/b", start="f1")] == \
        ["f2", "f3", "f4"]
    assert len(list(f.list_entries("/a/b", prefix="f"))) == 5
    f.delete_entry("/a/b/f0")
    assert [e.name for e in f.list_entries("/a/b")] == \
        ["c.txt", "f1", "f2", "f3", "f4"]
    # ON DUPLICATE KEY UPDATE upsert path
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=99)))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 99
    # binary blob round-trip
    gnarly = bytes(range(256))
    store.kv_put(b"k\x00bin", gnarly)
    assert store.kv_get(b"k\x00bin") == gnarly
    assert store.kv_get(b"absent") is None
    store.delete_folder_children("/a")
    assert store.find_entry("/a/b/c.txt") is None
    store.close()


def test_mysql_auth_and_reconnect(mysql_server):
    from tests.fake_mysql import FakeMySqlServer

    from seaweedfs_tpu_torch.filer.stores.mysql_wire import (
        MySqlConnection,
        MySqlError,
    )

    locked = FakeMySqlServer(user="weed", password="sekret")
    try:
        c = MySqlConnection(host="localhost", port=locked.port,
                            user="weed", password="sekret", database="x")
        cur = c.cursor()
        cur.execute("SELECT 20 + 3")
        assert cur.fetchone()[0] == 23
        # reconnect after a dropped socket (stmt cache must not leak
        # stale ids across the reconnect)
        cur.execute("SELECT 1 + %s", (1,))
        c._sock.close()
        with pytest.raises((OSError, ConnectionError)):
            cur.execute("SELECT 2 + %s", (2,))
        cur.execute("SELECT 2 + %s", (2,))
        assert cur.fetchone()[0] == 4
        c.close()
        with pytest.raises(MySqlError, match="Access denied"):
            MySqlConnection(host="localhost", port=locked.port,
                            user="weed", password="wrong", database="x")
    finally:
        locked.stop()


def test_mysql2_bucket_tables(mysql_server):
    """mysql2 = SupportBucketTable through the backtick-quoting dialect
    (information_schema.tables enumeration on ancestor deletes)."""
    store = get_store("mysql2", host="localhost", port=mysql_server.port)
    f = Filer(store)
    f.create_entry(Entry(full_path="/buckets/my-bkt/obj", content=b"m1"))
    f.create_entry(Entry(full_path="/buckets/other/obj", content=b"m2"))
    assert store.find_entry("/buckets/my-bkt/obj").content == b"m1"
    with mysql_server._dblock:
        cur = mysql_server.db.cursor()
        cur.execute("SELECT count(*) FROM `bucket_my-bkt`")
        assert cur.fetchone()[0] >= 1
    store.delete_folder_children("/buckets/my-bkt")
    assert store.find_entry("/buckets/my-bkt/obj") is None
    assert store.find_entry("/buckets/other/obj").content == b"m2"
    # ancestor wipe drops every bucket table via information_schema
    store.delete_folder_children("/buckets")
    assert store.find_entry("/buckets/other/obj") is None
    with mysql_server._dblock:
        cur = mysql_server.db.cursor()
        cur.execute("SELECT name FROM sqlite_master WHERE type='table' "
                    "AND name LIKE 'bucket_%'")
        assert cur.fetchall() == []
    store.close()


def test_postgres_store_backs_live_filer(pg_server, tmp_path):
    """A full filer server (HTTP data path) running on the postgres
    store over the wire protocol."""
    mport = _free_port()
    master = MasterServer(ip="localhost", port=mport,
                          volume_size_limit_mb=64)
    master.start(vacuum_interval=3600)
    vsrv = _volume_server(directories=[str(tmp_path / "pgvol")],
                        master=f"localhost:{mport}", ip="localhost",
                        port=_free_port())
    vsrv.start()
    deadline = time.time() + 10
    while time.time() < deadline and not master.topo.nodes:
        time.sleep(0.05)
    fs = FilerServer(ip="localhost", port=_free_port(),
                     master=f"localhost:{mport}", store="memory")
    fs.filer = Filer(get_store("postgres", host="localhost",
                               port=pg_server.port))
    fs.start()
    try:
        base = f"http://{fs.address}"
        r = requests.put(f"{base}/pg/x.bin", data=b"postgres-backed",
                         timeout=30)
        assert r.status_code in (200, 201)
        g = requests.get(f"{base}/pg/x.bin", timeout=30)
        assert g.status_code == 200 and g.content == b"postgres-backed"
        assert [e.name for e in fs.filer.list_entries("/pg")] == ["x.bin"]
    finally:
        fs.stop()
        vsrv.stop()
        master.stop()
        rpc.reset_channels()


def test_sqlite_kv_table_backcompat(tmp_path):
    """The reference's sqlite stores use a table named plain 'kv'; the
    port's store must keep reading it."""
    import sqlite3

    db = str(tmp_path / "old.db")
    c = sqlite3.connect(db)
    c.execute("CREATE TABLE filemeta (directory TEXT NOT NULL, "
              "name TEXT NOT NULL, meta BLOB, PRIMARY KEY(directory,name))")
    c.execute("CREATE TABLE kv (k BLOB PRIMARY KEY, v BLOB)")
    c.execute("INSERT INTO kv(k,v) VALUES(?,?)", (b"old-key", b"old-value"))
    c.commit()
    c.close()

    from seaweedfs_tpu_torch.filer.filerstore import get_store

    store = get_store("sqlite", db_path=db)
    assert store.kv_get(b"old-key") == b"old-value"
    store.kv_put(b"new-key", b"new-value")
    assert store.kv_get(b"new-key") == b"new-value"
    store.close()


def test_filer_sync_across_heterogeneous_wire_stores(pg_server,
                                                     mongo_server,
                                                     tmp_path):
    """filer.sync between a postgres-wire-backed filer and a
    mongo-wire-backed filer: the metadata event log, sync loop, and
    entry model must be store-agnostic end to end (the reference gets
    this property from its FilerStore SPI; here both sides run live
    wire protocols)."""
    from seaweedfs_tpu_torch.filer import Filer
    from seaweedfs_tpu_torch.replication import FilerSyncLoop

    clusters = []
    try:
        filers = []
        for tag, store in (("pg", get_store("postgres", host="localhost",
                                            port=pg_server.port)),
                           ("mg", get_store("mongodb", host="localhost",
                                            port=mongo_server.port))):
            mport = _free_port()
            master = MasterServer(ip="localhost", port=mport,
                                  volume_size_limit_mb=64)
            master.start(vacuum_interval=3600)
            vsrv = _volume_server(
                directories=[str(tmp_path / f"v-{tag}")],
                master=f"localhost:{mport}", ip="localhost",
                port=_free_port(), pulse_seconds=1)
            vsrv.start()
            fs = FilerServer(ip="localhost", port=_free_port(),
                             master=f"localhost:{mport}", store="memory")
            fs.filer = Filer(store)
            fs.start()
            deadline = time.time() + 10
            while time.time() < deadline and not master.topo.nodes:
                time.sleep(0.05)
            clusters.append((master, vsrv, fs))
            filers.append(fs)
        fa, fb = filers
        t0 = time.time_ns()
        r = requests.put(f"http://{fa.address}/x/doc.txt",
                         data=b"cross-store sync", timeout=30)
        assert r.status_code in (200, 201)
        loop = FilerSyncLoop(fa.address, fb.address, source_path="/x")
        loop.run_once(since_ns=t0)
        assert loop.replicated >= 1
        g = requests.get(f"http://{fb.address}/x/doc.txt", timeout=30)
        assert g.status_code == 200 and g.content == b"cross-store sync"
        # the entry really landed in the MONGO store on the target side
        assert any(d.get("name") == "doc.txt" for d in mongo_server.docs)
        # and originated from rows in the POSTGRES store on the source
        with pg_server._dblock:
            cur = pg_server.db.cursor()
            cur.execute("SELECT count(*) FROM filemeta WHERE name=?",
                        ("doc.txt",))
            assert cur.fetchone()[0] == 1
    finally:
        for master, vsrv, fs in reversed(clusters):
            fs.stop()
            vsrv.stop()
            master.stop()
        rpc.reset_channels()


# -- regressions ---------------------------------------------------------------

def test_resp_transaction_is_atomic_under_concurrency(redis_server):
    """MULTI..EXEC must hold the client lock for the whole exchange: a
    concurrent thread's command landing between MULTI and EXEC would be
    QUEUED into the open transaction (its caller reads '+QUEUED' as its
    reply and EXEC's array absorbs its result)."""
    import threading

    from seaweedfs_tpu_torch.filer.stores.redis import RespClient

    c = RespClient("localhost", redis_server.port)
    c.cmd("SET", b"stable", b"expected")
    stop = threading.Event()
    bad: list = []

    def reader():
        # a corrupted stream can also surface as a RAISED error (e.g. a
        # misattributed EXEC element) — capture it, don't die silently
        try:
            while not stop.is_set():
                got = c.cmd("GET", b"stable")
                if got != b"expected":
                    bad.append(got)
                    return
        except Exception as e:  # noqa: BLE001
            bad.append(e)

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    for i in range(200):
        c.transaction(("ZADD", b"txz", "0", f"m{i}".encode()),
                      ("ZREM", b"txz", f"m{i}".encode()))
    stop.set()
    for t in threads:
        t.join()
    assert bad == [], f"reply-stream corruption: GET returned {bad[0]!r}"
    c.close()


def test_postgres_parse_failure_poisons_connection(pg_server):
    """A malformed reply that aborts _query_locked mid-result-stream must
    mark the connection broken (like mysql_wire): the unread messages up
    to ReadyForQuery would otherwise be consumed as the NEXT query's
    replies and silently return wrong rows."""
    import struct as _struct

    from seaweedfs_tpu_torch.filer.stores.pg_wire import PgConnection

    c = PgConnection(host="localhost", port=pg_server.port)
    cur = c.cursor()
    cur.execute("SELECT 1 + 1")
    assert cur.fetchone()[0] == 2

    def malformed():
        raise _struct.error("truncated DataRow")

    c._recv_msg = malformed
    with pytest.raises(_struct.error):
        c.cursor().execute("SELECT 2 + 2")
    assert c._sock is None, "parse failure must poison the connection"
    del c.__dict__["_recv_msg"]  # restore the class method
    # next query reconnects cleanly and reads ITS OWN reply
    cur = c.cursor()
    cur.execute("SELECT 40 + 2")
    assert cur.fetchone()[0] == 42
    c.close()


def test_arangodb_dotted_bucket_collections_distinct(arango_server):
    """Buckets 'a.b' and 'a_b' must not share a collection: S3 bucket
    names legitimately contain dots, and deleting one bucket must not
    wipe the other's objects."""
    store = get_store("arangodb", host="localhost",
                      port=arango_server.port)
    f = Filer(store)
    f.create_entry(Entry(full_path="/buckets/a.b/one", content=b"dot"))
    f.create_entry(Entry(full_path="/buckets/a_b/two", content=b"under"))
    assert store.find_entry("/buckets/a.b/one").content == b"dot"
    assert store.find_entry("/buckets/a_b/two").content == b"under"
    store.delete_folder_children("/buckets/a.b")
    assert store.find_entry("/buckets/a.b/one") is None
    assert store.find_entry("/buckets/a_b/two") is not None, \
        "deleting bucket 'a.b' destroyed bucket 'a_b'"
    store.close()


def test_sql_root_delete_wipes_descendants(tmp_path):
    """delete_folder_children('/') must remove DEEP descendants too:
    base '/' + '/%' builds LIKE '//%', which matches nothing, leaving
    every row below the first level behind."""
    store = get_store("sqlite", db_path=str(tmp_path / "root.db"))
    f = Filer(store)
    for p in ("/top", "/a/b/c/deep.txt", "/a/b/mid.txt", "/a/shallow"):
        f.create_entry(Entry(full_path=p))
    store.delete_folder_children("/")
    for p in ("/top", "/a/b/c/deep.txt", "/a/b/mid.txt", "/a/shallow"):
        assert store.find_entry(p) is None, f"{p} survived root wipe"
    store.close()


def test_resp_transaction_exec_error_keeps_stream_in_sync(redis_server):
    """Exec-time failures arrive as error ELEMENTS inside EXEC's reply
    array; the client must drain the whole array (staying in sync) and
    then raise — not abort mid-array and leave elements on the socket."""
    from seaweedfs_tpu_torch.filer.stores.redis import RespClient, RespError

    c = RespClient("localhost", redis_server.port)
    c.cmd("SET", b"stable", b"expected")
    with pytest.raises(RespError, match="unknown command"):
        c.transaction(("ZADD", b"txz2", "0", b"m"), ("NOPE",))
    # the connection is still usable and replies are OUR replies
    assert c.cmd("GET", b"stable") == b"expected"
    assert c.cmd("PING") == "PONG"
    c.close()


def test_sql_like_wildcards_in_directory_names(tmp_path):
    """'_'/'%' in directory names are data, not wildcards: deleting
    /data_1 must not also wipe /dataX1, and a '_'-containing listing
    prefix must not match arbitrary characters."""
    store = get_store("sqlite", db_path=str(tmp_path / "wild.db"))
    f = Filer(store)
    f.create_entry(Entry(full_path="/data_1/doomed", content=b"x"))
    f.create_entry(Entry(full_path="/dataX1/survivor", content=b"y"))
    store.delete_folder_children("/data_1")
    assert store.find_entry("/data_1/doomed") is None
    assert store.find_entry("/dataX1/survivor") is not None, \
        "wildcard '_' in LIKE wiped a sibling directory"
    # prefix with '_' in listings
    f.create_entry(Entry(full_path="/d/x_1"))
    f.create_entry(Entry(full_path="/d/xa1"))
    names = [e.name for e in
             store.list_directory_entries("/d", prefix="x_")]
    assert names == ["x_1"]
    store.close()


# -- tikv store (RawKV gRPC + PD routing against an in-process cluster) ----

@pytest.fixture
def tikv_cluster():
    from tests.fake_tikv import FakeTikvCluster

    c = FakeTikvCluster()
    yield c
    c.stop()


def test_tikv_store_crud_listing_and_kv(tikv_cluster):
    """tikv_store.go's sha1(dir)+name key layout over the real kvproto
    wire (pdpb routing + tikvpb RawKV); the fake cluster splits the
    keyspace into two regions on separate gRPC servers, so every op
    exercises the PD key->region->store loop with epoch validation."""
    store = get_store("tikv", pdaddrs=f"localhost:{tikv_cluster.port}")
    f = Filer(store)
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=11)))
    for i in range(30):
        f.create_entry(Entry(full_path=f"/a/b/f{i:02d}"))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 11
    names = [e.name for e in
             store.list_directory_entries("/a/b", limit=1000)]
    assert names == ["c.txt"] + [f"f{i:02d}" for i in range(30)]
    assert [e.name for e in store.list_directory_entries(
        "/a/b", "f05", include_start=False, limit=3)] == \
        ["f06", "f07", "f08"]
    assert [e.name for e in store.list_directory_entries(
        "/a/b", "f05", include_start=True, limit=2)] == ["f05", "f06"]
    assert [e.name for e in store.list_directory_entries(
        "/a/b", prefix="f1", limit=1000)] == \
        [f"f1{i}" for i in range(10)]
    f.delete_entry("/a/b/f00")
    assert store.find_entry("/a/b/f00") is None
    # upsert
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=99)))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 99
    # kv api: raw bytes straight into the keyspace
    gnarly = bytes(range(256))
    store.kv_put(b"kv\x00bin", gnarly)
    assert store.kv_get(b"kv\x00bin") == gnarly
    assert store.kv_get(b"absent") is None
    # the sha1'd keys really did land on BOTH regions' servers
    split = b"\x80"
    sides = {k < split for k in tikv_cluster.data}
    assert sides == {True, False}, "expected keys on both regions"
    store.close()


def test_tikv_store_subtree_delete(tikv_cluster):
    store = get_store("tikv", pdaddrs=f"localhost:{tikv_cluster.port}")
    f = Filer(store)
    for p in ("/t/x/1", "/t/x/sub/2", "/t/x/sub/deep/3", "/t/keep"):
        f.create_entry(Entry(full_path=p))
    store.delete_folder_children("/t/x")
    for p in ("/t/x/1", "/t/x/sub/2", "/t/x/sub/deep/3"):
        assert store.find_entry(p) is None, p
    assert store.find_entry("/t/keep") is not None
    store.close()


def test_tikv_store_backs_live_filer(tikv_cluster, tmp_path):
    """A full filer server (HTTP data path) on the tikv store."""
    mport = _free_port()
    master = MasterServer(ip="localhost", port=mport,
                          volume_size_limit_mb=64)
    master.start(vacuum_interval=3600)
    vsrv = _volume_server(directories=[str(tmp_path / "tikvvol")],
                        master=f"localhost:{mport}", ip="localhost",
                        port=_free_port())
    vsrv.start()
    deadline = time.time() + 10
    while time.time() < deadline and not master.topo.nodes:
        time.sleep(0.05)
    fs = FilerServer(ip="localhost", port=_free_port(),
                     master=f"localhost:{mport}", store="memory")
    fs.filer = Filer(get_store("tikv",
                               pdaddrs=f"localhost:{tikv_cluster.port}"))
    fs.start()
    try:
        base = f"http://{fs.address}"
        r = requests.put(f"{base}/tk/x.bin", data=b"tikv-backed",
                         timeout=30)
        assert r.status_code in (200, 201)
        g = requests.get(f"{base}/tk/x.bin", timeout=30)
        assert g.status_code == 200 and g.content == b"tikv-backed"
        assert [e.name for e in fs.filer.list_entries("/tk")] == ["x.bin"]
    finally:
        fs.stop()
        vsrv.stop()
        master.stop()
        rpc.reset_channels()


# -- hbase store (Thrift2 gateway wire against an in-process server) -------

@pytest.fixture
def hbase_server():
    from tests.fake_hbase import FakeHbaseThriftServer

    srv = FakeHbaseThriftServer()
    yield srv
    srv.stop()


def test_hbase_store_crud_listing_and_kv(hbase_server):
    """hbase_store.go's full-path row keys (meta/kv families, single
    'a' qualifier) over the real Thrift strict binary protocol against
    an independently-implemented THBaseService fake."""
    store = get_store("hbase", zkquorum=f"localhost:{hbase_server.port}")
    f = Filer(store)
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=11)))
    for i in range(30):
        f.create_entry(Entry(full_path=f"/a/b/f{i:02d}"))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 11
    names = [e.name for e in
             store.list_directory_entries("/a/b", limit=1000)]
    assert names == ["c.txt"] + [f"f{i:02d}" for i in range(30)]
    assert [e.name for e in store.list_directory_entries(
        "/a/b", "f05", include_start=False, limit=3)] == \
        ["f06", "f07", "f08"]
    assert [e.name for e in store.list_directory_entries(
        "/a/b", "f05", include_start=True, limit=2)] == ["f05", "f06"]
    assert [e.name for e in store.list_directory_entries(
        "/a/b", prefix="f1", limit=1000)] == \
        [f"f1{i}" for i in range(10)]
    f.delete_entry("/a/b/f00")
    assert store.find_entry("/a/b/f00") is None
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=99)))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 99
    # kv rides the separate 'kv' family: no collision with a meta row
    # at the same byte key
    store.kv_put(b"/a/b/c.txt", b"kv-value")
    assert store.kv_get(b"/a/b/c.txt") == b"kv-value"
    assert f.find_entry("/a/b/c.txt").attr.mtime == 99
    gnarly = bytes(range(256))
    store.kv_put(b"bin\x00key", gnarly)
    assert store.kv_get(b"bin\x00key") == gnarly
    assert store.kv_get(b"absent") is None
    store.close()


def test_hbase_store_subtree_delete(hbase_server):
    store = get_store("hbase", zkquorum=f"localhost:{hbase_server.port}")
    f = Filer(store)
    for p in ("/t/x/1", "/t/x/sub/2", "/t/x/sub/deep/3", "/t/keep"):
        f.create_entry(Entry(full_path=p))
    store.delete_folder_children("/t/x")
    for p in ("/t/x/1", "/t/x/sub/2", "/t/x/sub/deep/3"):
        assert store.find_entry(p) is None, p
    assert store.find_entry("/t/keep") is not None
    store.close()


def test_hbase_thrift_errors(hbase_server):
    """TableNotFound surfaces as a declared TIOError; unknown methods
    as TApplicationException — both as ThriftError, with the connection
    still usable afterwards."""
    from seaweedfs_tpu_torch.filer.stores.thrift_wire import (
        STRING,
        ThriftClient,
        ThriftError,
    )

    with pytest.raises(ThriftError):
        get_store("hbase", zkquorum=f"localhost:{hbase_server.port}",
                  table="no_such_table")
    c = ThriftClient("localhost", hbase_server.port)
    with pytest.raises(ThriftError, match="unknown method"):
        c.call("bogusMethod", [(1, STRING, b"x")])
    # connection stays in sync after both error kinds
    reply = c.call("exists", [
        (1, STRING, b"seaweedfs"),
        (2, 12, [(1, STRING, b"never")]),
    ])
    assert reply.get(0) is False
    c.close()


def test_hbase_store_backs_live_filer(hbase_server, tmp_path):
    """A full filer server (HTTP data path) on the hbase store."""
    mport = _free_port()
    master = MasterServer(ip="localhost", port=mport,
                          volume_size_limit_mb=64)
    master.start(vacuum_interval=3600)
    vsrv = _volume_server(directories=[str(tmp_path / "hbvol")],
                        master=f"localhost:{mport}", ip="localhost",
                        port=_free_port())
    vsrv.start()
    deadline = time.time() + 10
    while time.time() < deadline and not master.topo.nodes:
        time.sleep(0.05)
    fs = FilerServer(ip="localhost", port=_free_port(),
                     master=f"localhost:{mport}", store="memory")
    fs.filer = Filer(get_store(
        "hbase", zkquorum=f"localhost:{hbase_server.port}"))
    fs.start()
    try:
        base = f"http://{fs.address}"
        r = requests.put(f"{base}/hb/x.bin", data=b"hbase-backed",
                         timeout=30)
        assert r.status_code in (200, 201)
        g = requests.get(f"{base}/hb/x.bin", timeout=30)
        assert g.status_code == 200 and g.content == b"hbase-backed"
        assert [e.name for e in fs.filer.list_entries("/hb")] == ["x.bin"]
    finally:
        fs.stop()
        vsrv.stop()
        master.stop()
        rpc.reset_channels()


# -- ydb store (Table-service gRPC against an in-process server) -----------

@pytest.fixture
def ydb_server():
    from tests.fake_ydb import FakeYdbServer

    srv = FakeYdbServer()
    yield srv
    srv.stop()


def test_ydb_store_crud_listing_and_kv(ydb_server):
    """ydb_store.go's (dir_hash, name) filemeta layout over the real
    Ydb.Table.V1.TableService wire — sessions, Operation/Any envelope,
    typed YQL parameters validated by the fake against the declared
    types, paged truncated listings."""
    store = get_store("ydb", dsn=f"grpc://localhost:{ydb_server.port}/local")
    f = Filer(store)
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=11)))
    for i in range(30):
        f.create_entry(Entry(full_path=f"/a/b/f{i:02d}"))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 11
    names = [e.name for e in
             store.list_directory_entries("/a/b", limit=1000)]
    assert names == ["c.txt"] + [f"f{i:02d}" for i in range(30)]
    assert [e.name for e in store.list_directory_entries(
        "/a/b", "f05", include_start=False, limit=3)] == \
        ["f06", "f07", "f08"]
    assert [e.name for e in store.list_directory_entries(
        "/a/b", "f05", include_start=True, limit=2)] == ["f05", "f06"]
    assert [e.name for e in store.list_directory_entries(
        "/a/b", prefix="f1", limit=1000)] == \
        [f"f1{i}" for i in range(10)]
    f.delete_entry("/a/b/f00")
    assert store.find_entry("/a/b/f00") is None
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=99)))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 99
    gnarly = bytes(range(256))
    store.kv_put(b"kv\x00bin", gnarly)
    assert store.kv_get(b"kv\x00bin") == gnarly
    assert store.kv_get(b"absent") is None
    # short kv keys are zero-padded to the 8-byte dir_hash head
    store.kv_put(b"k", b"short")
    assert store.kv_get(b"k") == b"short"
    store.close()


def test_ydb_store_subtree_delete_and_session_recovery(ydb_server):
    store = get_store("ydb", dsn=f"grpc://localhost:{ydb_server.port}/local")
    f = Filer(store)
    for p in ("/t/x/1", "/t/x/sub/2", "/t/x/sub/deep/3", "/t/keep"):
        f.create_entry(Entry(full_path=p))
    store.delete_folder_children("/t/x")
    for p in ("/t/x/1", "/t/x/sub/2", "/t/x/sub/deep/3"):
        assert store.find_entry(p) is None, p
    assert store.find_entry("/t/keep") is not None
    # server-side session loss: the next op must transparently
    # recreate the session (the sdk's retryer behavior, ydb_store.go
    # rides DB.Table().Do)
    ydb_server.expire_sessions()
    assert store.find_entry("/t/keep") is not None
    store.close()


def test_ydb_store_backs_live_filer(ydb_server, tmp_path):
    """A full filer server (HTTP data path) on the ydb store."""
    mport = _free_port()
    master = MasterServer(ip="localhost", port=mport,
                          volume_size_limit_mb=64)
    master.start(vacuum_interval=3600)
    vsrv = _volume_server(directories=[str(tmp_path / "ydbvol")],
                        master=f"localhost:{mport}", ip="localhost",
                        port=_free_port())
    vsrv.start()
    deadline = time.time() + 10
    while time.time() < deadline and not master.topo.nodes:
        time.sleep(0.05)
    fs = FilerServer(ip="localhost", port=_free_port(),
                     master=f"localhost:{mport}", store="memory")
    fs.filer = Filer(get_store(
        "ydb", dsn=f"grpc://localhost:{ydb_server.port}/local"))
    fs.start()
    try:
        base = f"http://{fs.address}"
        r = requests.put(f"{base}/yd/x.bin", data=b"ydb-backed",
                         timeout=30)
        assert r.status_code in (200, 201)
        g = requests.get(f"{base}/yd/x.bin", timeout=30)
        assert g.status_code == 200 and g.content == b"ydb-backed"
        assert [e.name for e in fs.filer.list_entries("/yd")] == ["x.bin"]
    finally:
        fs.stop()
        vsrv.stop()
        master.stop()
        rpc.reset_channels()


def test_ydb_prefix_like_wildcards_escaped(ydb_server):
    """a listing prefix containing '_' must match literally.
    Unescaped, LIKE 'my_%' also matched every 'myX...' sibling; the
    wildcard rows consumed the server-side LIMIT ('myA' sorts before
    'my_', so they fill the entire first page), were dropped
    client-side without advancing `emitted`, and the loop then stopped
    on the LIMIT-completed (non-truncated) page — silently dropping
    every real match from the listing."""
    store = get_store("ydb", dsn=f"grpc://localhost:{ydb_server.port}/local")
    f = Filer(store)
    for i in range(8):
        f.create_entry(Entry(full_path=f"/like/esc/my_{i}"))
        f.create_entry(Entry(full_path=f"/like/esc/myA{i}"))
    assert [e.name for e in store.list_directory_entries(
        "/like/esc", prefix="my_", limit=5)] == \
        [f"my_{i}" for i in range(5)]
    assert [e.name for e in store.list_directory_entries(
        "/like/esc", prefix="my_", limit=1000)] == \
        [f"my_{i}" for i in range(8)]
    # '%' in a name is data, not an any-run wildcard
    f.create_entry(Entry(full_path="/like/esc/p%q"))
    f.create_entry(Entry(full_path="/like/esc/pXq"))
    assert [e.name for e in store.list_directory_entries(
        "/like/esc", prefix="p%", limit=10)] == ["p%q"]
    store.close()


def test_ydb_grpcs_dsn_dials_tls(ydb_server, monkeypatch):
    """a grpcs:// DSN must dial a secure channel — silently
    downgrading to plaintext leaks metadata on the wire — and unknown
    schemes must raise instead of being ignored."""
    import grpc

    dialed = {}
    insecure = grpc.insecure_channel

    def fake_secure(endpoint, creds, *args, **kwargs):
        dialed["endpoint"] = endpoint
        dialed["creds"] = creds
        return insecure(endpoint)  # the fake server speaks plaintext

    monkeypatch.setattr(grpc, "secure_channel", fake_secure)
    store = get_store(
        "ydb", dsn=f"grpcs://localhost:{ydb_server.port}/local")
    assert dialed["endpoint"] == f"localhost:{ydb_server.port}"
    assert isinstance(dialed["creds"], grpc.ChannelCredentials)
    f = Filer(store)
    f.create_entry(Entry(full_path="/tls/x", attr=Attr(mtime=5)))
    assert store.find_entry("/tls/x").attr.mtime == 5
    store.close()
    with pytest.raises(ValueError, match="scheme"):
        get_store("ydb", dsn=f"http://localhost:{ydb_server.port}/local")


def test_resp_transaction_abort_surfaces_as_error(redis_server):
    """EXEC replying nil (transaction aborted server-side,
    e.g. a WATCH conflict or cluster failover) must raise — returning
    None let callers like redis3's segment split mistake an aborted
    transaction for a commit."""
    from seaweedfs_tpu_torch.filer.stores.redis import RespClient, RespError

    c = RespClient("localhost", redis_server.port)
    redis_server.abort_next_exec = True
    with pytest.raises(RespError, match="aborted"):
        c.transaction(("SET", b"aborted-key", b"v"))
    # the queued commands were NOT applied, and the reply stream is
    # still in sync (the nil was fully consumed)
    assert c.cmd("GET", b"aborted-key") is None
    assert c.cmd("PING") == "PONG"
    c.close()


def test_redis_lua_store_scripts(redis_server):
    """redis_lua: the three mutations run as server-side scripts over
    EVALSHA (NOSCRIPT -> EVAL loads, later calls hit the sha cache);
    layout and blobs stay redis2-compatible (universal_redis_store.go
    + stored_procedure/*.lua)."""
    store = get_store("redis_lua", host="localhost",
                      port=redis_server.port)
    f = Filer(store)
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=11)))
    for i in range(10):
        f.create_entry(Entry(full_path=f"/a/b/f{i}"))
    assert f.find_entry("/a/b/c.txt").attr.mtime == 11
    assert [e.name for e in
            store.list_directory_entries("/a/b", limit=100)] == \
        ["c.txt"] + [f"f{i}" for i in range(10)]
    assert [e.name for e in store.list_directory_entries(
        "/a/b", "f3", include_start=False, limit=3)] == \
        ["f4", "f5", "f6"]
    f.delete_entry("/a/b/f0")
    assert store.find_entry("/a/b/f0") is None
    # upsert + blob compat with the plain redis store
    f.create_entry(Entry(full_path="/a/b/c.txt", attr=Attr(mtime=99)))
    other = get_store("redis", host="localhost", port=redis_server.port)
    assert Filer(other).find_entry("/a/b/c.txt").attr.mtime == 99
    other.close()
    # kv rides the parent's plain SET/GET
    store.kv_put(b"lk", bytes(range(64)))
    assert store.kv_get(b"lk") == bytes(range(64))
    # subtree delete clears entries, sets, and the subdir entries
    f.create_entry(Entry(full_path="/t/x/sub/deep.txt"))
    f.create_entry(Entry(full_path="/t/keep"))
    store.delete_folder_children("/t/x")
    assert store.find_entry("/t/x/sub/deep.txt") is None
    assert store.find_entry("/t/keep") is not None
    assert not any(k.startswith(b"/t/x") and redis_server.zsets[k]
                   for k in redis_server.zsets)
    # by now all three scripts were loaded and cached by sha
    assert len(redis_server.scripts) == 3
    store.close()


def test_redis_lua_evalsha_cache(redis_server):
    """Second store on the same server: its first mutation EVALSHAs a
    sha the server already knows — no EVAL needed (go-redis Script.Run
    semantics over the RESP wire)."""
    s1 = get_store("redis_lua", host="localhost", port=redis_server.port)
    Filer(s1).create_entry(Entry(full_path="/warm/a"))
    s1.close()
    pre = dict(redis_server.scripts)
    s2 = get_store("redis_lua", host="localhost", port=redis_server.port)
    Filer(s2).create_entry(Entry(full_path="/warm/b"))
    assert redis_server.scripts == pre, "no new script loads expected"
    assert s2.find_entry("/warm/b") is not None
    s2.close()


# -- the two packages, store by store ------------------------------------------

PKGS = {"ref": (ref_get_store, RefEntry, RefAttr),
        "port": (get_store, Entry, Attr)}


class _Clock:
    """One fake wall clock for both packages' filer.entry."""

    def __init__(self):
        self.now = 1_700_000_000.0

    def time(self):
        self.now += 1
        return self.now

    def time_ns(self):
        return int(self.time() * 1e9)

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture
def pinned_time(monkeypatch):
    for mod in (ref_entry_mod, port_entry_mod):
        monkeypatch.setattr(mod, "time", _Clock())


SCRIPT_DIRS = ("/s/a", "/s/a/sub", "/s/a/sub/deep", "/s/b", "/s/b_1",
               "/buckets/bk1", "/buckets/bk1/x", "/buckets/bk-2")


def _seeded_entries(seed: int, per_dir: int = 7
                    ) -> list[tuple[str, bytes, int]]:
    """(path, content, mtime) of the script's entries, from `seed`. The
    reference's SQL and HTTP clients wait out a delayed ACK per statement
    (about 40 ms, `recv_acked` in the port's wire_common.py), so the
    script stays small."""
    rng = random.Random(seed)
    out = []
    for d in SCRIPT_DIRS:
        names = [f"{rng.choice('abcn')}{i:02d}" for i in range(per_dir)]
        rng.shuffle(names)
        for n in names:
            out.append((f"{d}/{n}", rng.randbytes(rng.randrange(0, 96)),
                        1_700_000_000 + rng.randrange(1 << 20)))
    return out


def _blob(e) -> tuple | None:
    return None if e is None else (
        e.full_path, e.to_pb().SerializeToString(deterministic=True))


def _listing(store, d, **kw) -> list:
    return [_blob(e) for e in store.list_directory_entries(d, **kw)]


def _paged(store, d, page: int, prefix: str = "") -> list:
    """Every name of `d`, `page` at a time, as a client pages."""
    names, last = [], ""
    while True:
        got = [e.name for e in store.list_directory_entries(
            d, last, include_start=False, limit=page, prefix=prefix)]
        names += got
        if len(got) < page:
            return names
        last = got[-1]


def _run_script(pkg: str, kind: str, port: int, seed: int) -> list:
    """The seeded script through `pkg`'s store `kind` on a fake at
    `port`: insert, update, find, paged and prefixed listings, kv,
    delete, subtree delete; -> what every read returned."""
    open_store, entry, attr = PKGS[pkg]
    store = open_store(kind, **store_kwargs(kind, port))
    rng = random.Random(seed + 1)
    items = _seeded_entries(seed)
    out = []

    def mk(path, content, mtime):
        return entry(full_path=path, content=content,
                     attr=attr(mtime=mtime, crtime=mtime, mode=0o644,
                               uid=1000, gid=1000, mime="text/plain"))

    try:
        for p, c, t in items:
            store.insert_entry(mk(p, c, t))
        for p, c, t in rng.sample(items, 10):
            store.update_entry(mk(p, c[::-1] + b"v2", t + 7))
        out += [_blob(store.find_entry(p)) for p, _, _ in items]
        out.append(_blob(store.find_entry("/s/a/absent")))
        for d in SCRIPT_DIRS:
            out.append(_listing(store, d, limit=1000))
            out.append(_paged(store, d, 3))
            out.append(_paged(store, d, 2, prefix="n"))
            first = sorted(p.rsplit("/", 1)[1] for p, _, _ in items
                           if p.rsplit("/", 1)[0] == d)[5]
            out.append(_listing(store, d, start_file_name=first,
                                include_start=True, limit=5))
            out.append(_listing(store, d, prefix="a0", limit=1000))
        keys = [rng.randbytes(rng.randrange(1, 24)) for _ in range(12)]
        for k in keys:
            store.kv_put(k, rng.randbytes(rng.randrange(0, 200)))
        store.kv_put(keys[0], b"overwritten")
        out += [store.kv_get(k) for k in keys + [b"absent-key"]]
        for p, _, _ in rng.sample(items, 8):
            store.delete_entry(p)
        store.delete_folder_children("/s/a")
        store.delete_folder_children("/buckets/bk1")
        out += [_blob(store.find_entry(p)) for p, _, _ in items]
        for d in SCRIPT_DIRS:
            out.append(_listing(store, d, limit=1000))
    finally:
        store.close()
    return out


@pytest.mark.parametrize("kind", NETWORK_STORES)
def test_one_script_gives_the_same_answers_and_state(kind, pinned_time):
    """The seeded script through the reference's store on one fake and
    through the port's on another: equal answers, and the two fakes hold
    the same rows, keys and documents, byte for byte."""
    got, state = {}, {}
    for pkg in PKGS:
        srv = open_fake(kind)
        try:
            got[pkg] = _run_script(pkg, kind, srv.port, seed=16)
            state[pkg] = fake_state(kind, srv)
        finally:
            srv.stop()
    assert got["port"] == got["ref"]
    assert state["port"] == state["ref"]
    assert any(x is not None for x in got["port"])  # the script did read


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
@pytest.mark.parametrize("kind", ["postgres2", "redis3", "tikv"])
def test_a_fake_filled_by_one_package_reads_the_same_in_the_other(
        kind, writer, reader, pinned_time):
    """One package's store fills a fake; the other package's store on
    the same fake finds the same entries and lists the same pages."""
    srv = open_fake(kind)
    try:
        open_w, entry, attr = PKGS[writer]
        w = open_w(kind, **store_kwargs(kind, srv.port))
        items = _seeded_entries(7)
        for p, c, t in items:
            w.insert_entry(entry(full_path=p, content=c,
                                 attr=attr(mtime=t, crtime=t, mode=0o600)))
        w.kv_put(b"carried", b"across")
        want = [_blob(w.find_entry(p)) for p, _, _ in items] + [
            _listing(w, d, limit=1000) for d in SCRIPT_DIRS] + [
            _paged(w, d, 3) for d in SCRIPT_DIRS]
        w.close()
        r = PKGS[reader][0](kind, **store_kwargs(kind, srv.port))
        got = [_blob(r.find_entry(p)) for p, _, _ in items] + [
            _listing(r, d, limit=1000) for d in SCRIPT_DIRS] + [
            _paged(r, d, 3) for d in SCRIPT_DIRS]
        assert r.kv_get(b"carried") == b"across"
        r.close()
    finally:
        srv.stop()
    assert got == want
    assert len([x for x in want[:len(items)] if x]) == len(items)


def test_both_packages_register_the_same_stores():
    assert available_stores() == ref_available_stores()
    assert set(NETWORK_STORES) <= set(available_stores())
    for open_store in (get_store, ref_get_store):
        with pytest.raises(RuntimeError, match="client library"):
            open_store("rocksdb")


# -- the protocol-trace goldens through the port's clients ---------------------


def _port_session(store) -> None:
    """tests/wire_goldens.py's canonical_session with the port's Entry."""
    def entry(path, mtime, content=b""):
        return Entry(full_path=path, content=content,
                     attr=Attr(mtime=mtime, crtime=mtime, mode=0o644,
                               uid=1000, gid=1000))

    store.insert_entry(entry("/g/a.txt", 1_700_000_001, b"golden-a"))
    store.insert_entry(entry("/g/b.txt", 1_700_000_002, b"golden-b"))
    assert store.find_entry("/g/a.txt").content == b"golden-a"
    assert store.find_entry("/g/missing") is None
    store.insert_entry(entry("/g/a.txt", 1_700_000_009, b"golden-a2"))
    names = [e.name for e in store.list_directory_entries("/g", limit=16)]
    assert names == ["a.txt", "b.txt"], names
    store.kv_put(b"gkey", bytes(range(32)))
    assert store.kv_get(b"gkey") == bytes(range(32))
    assert store.kv_get(b"absent") is None
    store.delete_entry("/g/b.txt")
    store.delete_folder_children("/g")
    assert store.find_entry("/g/a.txt") is None


def _port_conversation(kind: str, fake_port: int, **kwargs) -> list:
    proxy = wg.RecordingProxy(fake_port)
    try:
        with wg.pinned_entropy():
            store = get_store(kind, host="localhost", port=proxy.port,
                              **kwargs)
            _port_session(store)
            store.close()
        for t in list(proxy.pumps):
            t.join(timeout=10)
        return list(proxy.conversation)
    finally:
        proxy.stop()


def _streams(convo) -> tuple[bytes, bytes]:
    return (b"".join(b for d, b in convo if d == "C"),
            b"".join(b for d, b in convo if d == "S"))


GOLDENS = wg.golden_cases()


@pytest.mark.parametrize("name,mk,kwargs", GOLDENS,
                         ids=[c[0] for c in GOLDENS])
def test_the_port_replays_the_golden_trace(name, mk, kwargs):
    """The port's client speaks, and is answered, byte for byte as the
    committed golden of the reference's client: both directions."""
    golden_c, golden_s = _streams(wg.load_trace(name))
    srv = mk()
    try:
        got_c, got_s = _streams(_port_conversation(name, srv.port, **kwargs))
    finally:
        srv.stop()
    assert got_c == golden_c, f"{name}: client->server stream differs"
    assert got_s == golden_s, f"{name}: server->client stream differs"


# -- a fault shared with the reference, fixed in the port ----------------------


@pytest.mark.parametrize("kind", ["postgres", "mysql", "elastic", "arangodb"])
def test_a_statement_does_not_wait_out_a_delayed_ack(kind):
    """The reference's postgres, mysql, elastic and arangodb clients take
    about 40 ms a statement against a server that writes its reply in
    several sends (the fakes do): each send after the first waits, by
    Nagle's algorithm, for the client's delayed ACK, and the reference's
    postgres client writes a statement's five messages one by one too.
    The port acknowledges at once and sends the messages together
    (wire_common.quick_ack, pg_wire._send): the same bytes, without the
    wait."""
    per = {}
    for pkg in PKGS:
        srv = open_fake(kind)
        try:
            store = PKGS[pkg][0](kind, **store_kwargs(kind, srv.port))
            store.insert_entry(PKGS[pkg][1](full_path="/ack/a",
                                            content=b"x"))
            t0 = time.perf_counter()
            for _ in range(20):
                assert store.find_entry("/ack/a").content == b"x"
            per[pkg] = (time.perf_counter() - t0) / 20
            store.close()
        finally:
            srv.stop()
    assert per["ref"] > 0.02, per  # the reference's wait, shown
    assert per["port"] < 0.01, per
