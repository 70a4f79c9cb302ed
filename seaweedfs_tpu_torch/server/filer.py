"""Filer server: HTTP namespace gateway + gRPC metadata API.

Counterpart of seaweedfs_tpu/server/filer.py (SeaweedFS
weed/server/filer_server.go, filer_server_handlers_{read,write,
write_autochunk}.go and filer_grpc_server*.go).

HTTP plane: POST/PUT auto-chunks the body (autoChunk,
filer_server_handlers_write_autochunk.go:24): assign fid per chunk, upload
to volume servers, then save the entry. GET streams chunks back through the
resolved view (StreamContent, stream.go:69); directories list as JSON.
DELETE removes entries (recursive with ?recursive=true) and GCs chunks.

An entry mounted from remote storage and not cached streams from the
remote store on each read (remote_storage.RemoteGateway.read_through),
exactly its declared size or an error; CacheRemoteObjectToLocalCluster
writes it into the filer's volumes. Every event is published to the queue
notification.toml enables.

Given the co-located volume server's C++ plane (`native_volume_plane=`,
as `server -filer` passes it), the filer runs the C++ hot plane on its
public port: whole-object PUTs and GETs under /buckets/ are served from
C++ straight off the volume plane, with their entries logged to
`filer-hot.log` and absorbed into the store; everything else is
307-redirected to the Python listener on the admin port.

The store is the one filer.toml enables (sqlite, leveldb, or a network
store such as postgres2, mysql2, redis2/3, cassandra, etcd or tikv; see
filerstore.available_stores), else `-store`. A network store whose server
does not answer stops the filer at start; nothing falls back to sqlite.
A directory GET with `?ui` or `Accept: text/html` answers the HTML
listing (server/ui.py).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler

from ..utils.httpd import TunedThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

import grpc
import requests as rq

from ..cluster.metaring import (
    EPOCH_HEADER,
    WRONG_SHARD_STATUS,
    MetaRing,
    WrongShardError,
)
from ..filer import Attr, Entry, Filer, chunk_pipeline
from ..filer.filechunks import etag as chunks_etag, view_from_chunks
from ..filer.filer import (
    NotEmpty,
    NotFound,
    new_directory_entry,
    normalize,
    parent_of,
)
from ..filer.filerstore import RetryingStore, get_store
from ..operation import assign, delete_files, upload_data
from ..pb import filer_pb2, master_pb2, rpc
from ..qos.pressure import SIGNAL as PRESSURE_SIGNAL
from ..remote_storage import REMOTE_ENTRY_KEY, RemoteConf, RemoteGateway
from ..utils import glog, trace
from ..utils.chunk_cache import TieredChunkCache
from ..utils.http import not_modified, parse_range, range_applies, url_for
from ..utils.stats import (
    FILER_CHUNK_CACHE_COUNTER,
    FILER_REQUEST_HISTOGRAM,
    FILER_SHARD_QOS_OPS,
    META_RING_RENAMES,
    META_RING_WRONG_SHARD,
    chunk_cache_stats,
    chunk_pipeline_stats,
    fid_lease_stats,
    gather,
    metrics_content_type,
    status_base,
)
from ..wdclient import MasterClient
from ..wdclient.lease import FidLeasePool

CHUNK_SIZE = 4 * 1024 * 1024  # maxMB default (command/filer.go)
# fids leased from the master per Assign RPC
FID_LEASE_BATCH = 128

def is_remote_only(entry: Entry) -> bool:
    """Mounted from remote storage and never cached into volumes."""
    return not entry.chunks and not entry.content and (
        entry.extended.get(REMOTE_ENTRY_KEY) is not None
        or entry.extended.get(REMOTE_ENTRY_KEY.encode()) is not None)


class FilerServer:
    def __init__(self, *, ip: str = "localhost", port: int = 8888,
                 master: str = "localhost:9333", store_dir: str = "",
                 store: str = "sqlite", collection: str = "",
                 replication: str = "", chunk_size: int = CHUNK_SIZE,
                 peers: list[str] | None = None, filer_group: str = "",
                 native_volume_plane=None):
        self.ip = ip
        self.port = port
        self.store_dir = store_dir
        self.grpc_port = rpc.derived_grpc_port(port)
        self.master = master
        self.collection = collection
        self.replication = replication
        self.chunk_size = chunk_size
        from ..notification import load_configuration
        from ..utils.config import enabled_notification_queue, load_config

        # every event is published to the queue that notification.toml
        # enables (filer.go LoadConfiguration("notification")). A file
        # that does not parse is ignored with a warning, as in the
        # reference; a queue that cannot initialize (an unreachable
        # broker, a missing SQS queue) stops the filer here, before the
        # store opens, where the reference warns and publishes nothing
        # (ROADMAP.md C)
        try:
            notification_conf = load_config("notification")
        except (ValueError, OSError) as e:
            glog.warning(f"notification config ignored: {e}")
            notification_conf = {}
        queue, name = None, enabled_notification_queue(notification_conf)
        if name:
            try:
                queue = load_configuration(notification_conf)
            except Exception as e:
                raise RuntimeError(f"notification queue {name!r} "
                                   f"(notification.toml): {e}") from e
        # filer.toml's enabled section selects + configures the store
        # (command/filer.go LoadConfiguration("filer") — the reference's
        # only store-selection mechanism; the -store flag remains as the
        # default when no section is enabled). A store whose server does
        # not answer fails in get_store and stops the filer, never falls
        # back. A filer.toml that does not parse is ignored with a warning
        # and the -store default serves, as in the reference.
        store_kwargs: dict = {}
        try:
            sections = load_config("filer")
        except (ValueError, OSError) as e:
            glog.warning(f"filer config ignored: {e}")
            sections = {}
        for kind, section in sections.items():
            if isinstance(section, dict) and section.get("enabled"):
                store = kind
                store_kwargs = {k: v for k, v in section.items()
                                if k != "enabled"}
                break
        if store == "sqlite":
            import os

            db = store_kwargs.pop("dbFile", "") or ":memory:"
            if store_dir and db == ":memory:":
                os.makedirs(store_dir, exist_ok=True)
                db = os.path.join(store_dir, "filer.db")
            backing = get_store("sqlite", db_path=db)
        elif store.startswith("leveldb"):
            backing = get_store(
                store, directory=store_kwargs.pop("dir", "")
                or store_dir or "./filerldb")
        else:
            # a network store dials its server here: one that refuses or
            # fails its handshake stops the filer with its error
            try:
                backing = get_store(store, **store_kwargs)
            except ValueError:
                raise
            except Exception as e:  # noqa: BLE001 - re-raised with context
                raise RuntimeError(f"filer store {store!r} (filer.toml or "
                                   f"-store) did not open: {e}") from e
        # transient backend hiccups (and injected chaos) retry with
        # backoff instead of surfacing as 500s from handler threads
        self.filer = Filer(RetryingStore(backing))
        self.filer.notification_queue = queue
        # the remote-only read-through and CacheRemoteObjectToLocalCluster
        # read the mount table in process, never through this filer's
        # own gRPC (a nested loopback call from a gRPC worker could take
        # the last thread of its pool)
        self.remote_gateway = RemoteGateway(
            self.address, conf=RemoteConf(
                self.address, entry_reader=self._local_entry_content))
        self.master_client = MasterClient(master)
        # batched fid leasing: N small-file chunk saves cost ~1
        # master Assign RPC
        import os as _os

        self.fid_pool = FidLeasePool(master, batch=FID_LEASE_BATCH)
        # QoS plane: per-tenant (collection / bucket /
        # anonymous) token-bucket admission at the HTTP ingress;
        # over-budget requests answer 429 + Retry-After EARLY instead of
        # timing out deep in the chunk planes. Unconfigured env =
        # observe-only, never rejects.
        from ..qos import TenantAdmission

        self.qos_admission = TenantAdmission("filer")
        # fleet-scale metadata plane: with SWFS_META_SHARD=1
        # this filer serves ONE PARTITION of the namespace — it joins the
        # master-published consistent-hash ring and answers 410 for
        # routing keys that hash elsewhere. Deliberately explicit (never
        # implied by having peers): classic multi-filer deployments have
        # EVERY filer serving the full namespace via peer aggregation.
        self.meta_shard = _os.environ.get("SWFS_META_SHARD", "") == "1"
        self.meta_ring: MetaRing | None = None
        self._ring_mu = threading.Lock()
        self._ring_wake = threading.Event()
        # directories already materialized on their owning shards — the
        # deep-path storm re-walks the same ancestor chains per file
        self._ensured_dirs: set[str] = set()
        self._ensured_mu = threading.Lock()
        self._rename_mu = threading.Lock()
        self._rename_recovered = False
        self.rename_recovery: dict | None = None
        # filer-side chunk cache: the mount-only
        # TieredChunkCache promoted to the filer's chunk-read ladder
        # (and thereby the S3 gateway GET path, which streams through
        # the filer). Keyed by fid; invalidated on chunk GC so an
        # overwritten entry can never serve stale bytes.
        cache_mb = int(_os.environ.get("SWFS_FILER_CACHE_MB", "64") or 0)
        self.chunk_cache = (TieredChunkCache(mem_bytes=cache_mb << 20)
                            if cache_mb > 0 else None)
        self._http_server = None
        self._grpc_server = None
        # multi-filer peer aggregation (meta_aggregator.go)
        self.meta_aggregator = None
        self._peers = [p for p in (peers or []) if p]
        # cluster membership: announce to the master's KeepConnected stream
        # under this group; peers in the same group are discovered from the
        # master's ClusterNodeUpdate pushes (weed/cluster/cluster.go)
        self.filer_group = filer_group
        self._announce_stop = threading.Event()
        self._announce_thread: threading.Thread | None = None
        self._subscribed_peers: set[str] = set()
        # native filer hot plane (C++ PUT/GET of whole objects under
        # /buckets/ straight off the CO-LOCATED volume plane — `weed
        # server` wires its volume plane in here). See the design note in
        # native/dataplane.cpp "filer hot plane".
        self.native_volume_plane = native_volume_plane
        self.hot_plane = None
        self.admin_port = port  # public port when no hot plane
        self._hot_lock = threading.Lock()
        self._hot_mark = 0
        # call-stack-scoped (NOT process-global): a genuine mutation on
        # another thread must still invalidate the hot map while the
        # absorber thread replays log records through create_entry
        self._hot_absorbing = threading.local()
        self._hot_log_corrupt = False
        self._hot_stop = threading.Event()
        self._hot_threads: list[threading.Thread] = []
        self._started_at = time.time()

    def _start_aggregator(self) -> None:
        if not self._peers and not self.filer_group:
            return
        from ..filer.meta_aggregator import MetaAggregator

        self.meta_aggregator = MetaAggregator(self.filer,
                                              self.filer.signature)
        for peer in self._peers:
            self._subscribe_peer(peer)

    def _subscribe_peer(self, peer: str) -> None:
        if peer == self.address or peer in self._subscribed_peers:
            return
        self._subscribed_peers.add(peer)
        self.meta_aggregator.subscribe_to_peer(rpc.grpc_address(peer))

    def _on_keepalive_update(self, resp) -> None:
        u = resp.cluster_node_update
        if u.node_type == "metaRingShard":
            # ring membership changed: renew NOW (the join RPC's answer
            # carries the bumped epoch + layout) instead of waiting out
            # a renewal period while routing on a stale picture
            self._ring_wake.set()
            return
        if (u.address and u.node_type == "filer"
                and u.filer_group == self.filer_group
                and u.is_add and self.meta_aggregator is not None):
            self._subscribe_peer(u.address)

    def _discover_existing_peers(self) -> None:
        """Subscribe to group peers that joined BEFORE us — their add
        events were broadcast before our stream existed (the reference
        filer lists existing peers at startup, filer.go ListExistingPeerUpdates)."""
        try:
            stub = rpc.master_stub(rpc.grpc_address(self.master_client.current_master))
            resp = stub.ListClusterNodes(
                master_pb2.ListClusterNodesRequest(
                    client_type="filer", filer_group=self.filer_group),
                timeout=10)
            for n in resp.cluster_nodes:
                self._subscribe_peer(n.address)
        except Exception as e:  # master not up yet: updates will cover it
            glog.v(1, f"filer peer discovery: {e}")

    def _start_announce(self) -> None:
        """KeepConnected to the master as a filer (filer.go keeps the same
        stream open so the master tracks filer membership)."""
        def run():
            if self.meta_aggregator is not None:
                self._discover_existing_peers()
            self.master_client.keep_connected(
                client_type="filer", client_address=self.address,
                filer_group=self.filer_group,
                on_update=self._on_keepalive_update,
                stop_event=self._announce_stop)

        self._announce_thread = threading.Thread(target=run, daemon=True)
        self._announce_thread.start()

    @property
    def address(self) -> str:
        return f"{self.ip}:{self.port}"

    def start(self) -> None:
        trace.set_identity("filer", self.address)
        self._grpc_server = rpc.new_server()
        creds = rpc.add_servicer(self._grpc_server, rpc.FILER_SERVICE,
                                 FilerGrpc(self), component="filer",
                                 address=self.address)
        rpc.serve_port(self._grpc_server, f"[::]:{self.grpc_port}",
                       "filer", creds=creds)
        self._grpc_server.start()
        from ..security.tls import load_http_server_context

        https_ctx = load_http_server_context("filer")
        http_port = self.port
        # the C++ hot plane speaks plain HTTP only — with TLS configured
        # the python listener owns the encrypted public port and
        # whole-object serving uses the buffered path
        if self.native_volume_plane is not None and https_ctx is None:
            try:
                http_port = self._start_hot_plane()
            except Exception as e:
                glog.warning(f"filer hot plane unavailable: {e}")
                http_port = self.port
        if self._http_server is None:
            # _start_hot_plane binds the admin listener itself (it must
            # know the REAL admin port before the C++ plane learns its
            # redirect target); this path is hot-plane-off / fallback
            self._http_server = TunedThreadingHTTPServer(
                ("", http_port), _make_http_handler(self),
                ssl_context=https_ctx)
        threading.Thread(target=self._http_server.serve_forever,
                         daemon=True).start()
        self._start_aggregator()
        self._start_announce()
        if self.meta_shard:
            threading.Thread(target=self._meta_ring_loop, daemon=True,
                             name="filer-meta-ring").start()
        glog.info(f"filer started on {self.address} (grpc :{self.grpc_port})"
                  + (" (https)" if https_ctx is not None else "")
                  + (f" (native hot plane, admin :{self.admin_port})"
                     if self.hot_plane else ""))

    def stop(self) -> None:
        self._announce_stop.set()
        self._ring_wake.set()  # unblock the renew loop's wait
        if self.meta_shard:
            try:  # polite leave: clients stop routing here immediately.
                # A crash skips this — rejoin is idempotent (no epoch
                # bump), so a restarted shard resumes its ring position.
                from ..pb import meta_ring_pb2

                rpc.master_stub(rpc.grpc_address(
                    self.master_client.current_master)).JoinMetaRing(
                    meta_ring_pb2.JoinMetaRingRequest(
                        address=self.address, leave=True), timeout=2)
            except Exception as err:
                # master already gone: epoch churn, not correctness
                glog.v(1, f"meta ring polite leave: {err}")
        self._hot_stop.set()
        if self.hot_plane is not None:
            self.hot_plane.stop()
        for t in self._hot_threads:
            t.join(timeout=5)
        if self.hot_plane is not None:
            self._absorb_hot_log()  # drain acknowledged PUTs to the store
        if self.meta_aggregator is not None:
            self.meta_aggregator.close()
        if self._http_server:
            self._http_server.shutdown()
        if self._grpc_server:
            self._grpc_server.stop(grace=0.5)
        if self.filer.meta_log is not None:
            self.filer.meta_log.close()
        self.filer.store.close()

    # -- fleet-scale metadata plane -----------------------------

    META_RING_RENEW_S = 2.0
    _INTENT_KEY = b"meta.rename.intents"

    def _meta_ring_loop(self) -> None:
        """Join the master's metadata ring and keep renewing on the
        shard heartbeat cadence — every answer carries the current
        epoch + membership, so ring updates ride the same loop. A
        `metaRingShard` KeepConnected push wakes the loop early so a
        membership change propagates in one RTT, not one period."""
        from ..pb import meta_ring_pb2
        from ..utils.stats import META_RING_EPOCH, META_RING_SHARDS

        while not self._announce_stop.is_set():
            try:
                stub = rpc.master_stub(rpc.grpc_address(
                    self.master_client.current_master))
                resp = stub.JoinMetaRing(
                    meta_ring_pb2.JoinMetaRingRequest(address=self.address),
                    timeout=10)
                ring = MetaRing.from_response(resp)
                with self._ring_mu:
                    old = self.meta_ring
                    if old is None or ring.epoch >= old.epoch:
                        self.meta_ring = ring
                if old is None or ring.epoch != old.epoch:
                    META_RING_EPOCH.set(ring.epoch)
                    META_RING_SHARDS.set(len(ring))
                    # ownership may have shifted: cached already-
                    # materialized ancestors are now suspect
                    with self._ensured_mu:
                        self._ensured_dirs.clear()
                    glog.v(1, f"meta ring epoch {ring.epoch}: "
                              f"{list(ring.shards)}")
                if not self._rename_recovered:
                    # first successful join after (re)start: resolve the
                    # rename intents an unclean shutdown left stranded
                    self._rename_recovered = True
                    self._resolve_rename_intents()
            except Exception as e:
                glog.v(1, f"meta ring join: {e}")
            self._ring_wake.wait(self.META_RING_RENEW_S)
            self._ring_wake.clear()

    def ring_snapshot(self) -> MetaRing | None:
        with self._ring_mu:
            return self.meta_ring

    def shard_check_entry(self, full_path: str, *,
                          lenient: bool = False) -> "WrongShardError | None":
        """None when this shard may serve an ENTRY operation on
        full_path (routing key = its parent directory). `lenient` (HTTP
        GET, where one verb serves both stats and listings) also
        accepts the directory-key owner."""
        if not self.meta_shard:
            return None
        ring = self.ring_snapshot()
        if ring is None or len(ring) <= 1:
            return None
        p = normalize(full_path)
        owner = ring.shard_for_entry(p)
        if owner == self.address:
            return None
        if lenient and ring.shard_for_directory(p) == self.address:
            return None
        META_RING_WRONG_SHARD.inc(shard=self.address)
        return WrongShardError(ring.epoch, owner)

    def shard_check_dir(self, directory: str) -> "WrongShardError | None":
        """None when this shard owns a directory LISTING key — the same
        key its children were created under, so one shard answers the
        whole listing."""
        if not self.meta_shard:
            return None
        ring = self.ring_snapshot()
        if ring is None or len(ring) <= 1:
            return None
        owner = ring.shard_for_directory(directory)
        if owner == self.address:
            return None
        META_RING_WRONG_SHARD.inc(shard=self.address)
        return WrongShardError(ring.epoch, owner)

    def ensure_parent_dirs(self, full_path: str) -> None:
        """A directory's ENTRY lives on the shard owning ITS parent —
        generally not the shard that just stored a child deep below it.
        Materialize each ancestor on its owning shard so stats and
        listings of intermediate directories resolve from anywhere
        (create_entry's _ensure_parents already covers THIS shard's
        local store). Memoized: deep-path storms re-walk one chain per
        file; steady state costs zero RPCs."""
        if not self.meta_shard:
            return
        ring = self.ring_snapshot()
        if ring is None or len(ring) <= 1:
            return
        chain: list[str] = []
        d = parent_of(normalize(full_path))
        with self._ensured_mu:
            while d != "/" and d not in self._ensured_dirs:
                chain.append(d)
                d = parent_of(d)
        for a in reversed(chain):  # shallowest first: parents land first
            owner = ring.shard_for_entry(a)
            try:
                if owner and owner != self.address:
                    e = new_directory_entry(a)
                    r = rpc.filer_stub(rpc.grpc_address(owner)).CreateEntry(
                        filer_pb2.CreateEntryRequest(
                            directory=e.parent, entry=e.to_pb()),
                        timeout=10)
                    if r.error:
                        raise IOError(r.error)
                with self._ensured_mu:
                    self._ensured_dirs.add(a)
            except Exception as err:  # best-effort: a miss costs a stat
                glog.v(1, f"ensure parent {a} on {owner}: {err}")
                return

    # -- cross-shard two-phase rename --------------------------------------

    def _load_intents(self) -> dict:
        try:
            raw = self.filer.store.kv_get(self._INTENT_KEY)
            return json.loads(raw) if raw else {}
        except Exception as err:  # fresh store: no intents yet
            glog.v(1, f"rename intents load: {err}")
            return {}

    def _store_intents(self, intents: dict) -> None:
        self.filer.store.kv_put(self._INTENT_KEY,
                                json.dumps(intents).encode())

    def shard_rename(self, old: str, new: str) -> None:
        """THE single two-phase cross-shard operation,
        executed on the shard owning the SOURCE entry: durable intent
        record locally, apply on the destination shard, then retire the
        source. An interruption between apply and retire (the
        `meta.rename.commit` crash seam) is resolved by the startup
        recovery sweep — destination exists -> roll forward, else roll
        back — so a kill leaves neither a lost nor a doubled entry."""
        from ..utils import failpoint

        old, new = normalize(old), normalize(new)
        ring = self.ring_snapshot() if self.meta_shard else None
        if ring is None or len(ring) <= 1:
            self.filer.rename(old, new)
            return
        src_owner = ring.shard_for_entry(old)
        if src_owner and src_owner != self.address:
            META_RING_WRONG_SHARD.inc(shard=self.address)
            raise WrongShardError(ring.epoch, src_owner)
        entry = self.filer.find_entry(old)  # NotFound surfaces upstream
        if entry.is_directory:
            self._shard_rename_dir(old, new, ring)
            return
        dest = ring.shard_for_entry(new)
        if (not dest) or dest == self.address:
            self.filer.rename(old, new)  # both ends live here
            return
        # phase 1: durable intent on the source shard
        with self._rename_mu:
            intents = self._load_intents()
            intents[old] = {"old": old, "new": new}
            self._store_intents(intents)
        try:
            # phase 2: apply on the destination shard
            pb_entry = entry.to_pb()
            pb_entry.name = new.rsplit("/", 1)[-1]
            resp = rpc.filer_stub(rpc.grpc_address(dest)).CreateEntry(
                filer_pb2.CreateEntryRequest(
                    directory=parent_of(new), entry=pb_entry), timeout=30)
            if resp.error:
                raise IOError(f"rename apply on {dest}: {resp.error}")
        except Exception:
            with self._rename_mu:  # roll back: destination never saw it
                intents = self._load_intents()
                intents.pop(old, None)
                self._store_intents(intents)
            META_RING_RENAMES.inc(outcome="error")
            raise
        # the commit seam: a crash HERE leaves both copies + the intent;
        # recovery rolls forward (destination wins, source retired)
        failpoint.fail("meta.rename.commit")
        # phase 3: retire the source — chunks now belong to the moved
        # entry, so the data is NOT garbage-collected
        try:
            self.filer.delete_entry(old, is_delete_data=False)
        except NotFound:
            pass
        with self._rename_mu:
            intents = self._load_intents()
            intents.pop(old, None)
            self._store_intents(intents)
        META_RING_RENAMES.inc(outcome="commit")

    def _shard_rename_dir(self, old: str, new: str, ring) -> None:
        """Directory move on a sharded namespace: the destination dir
        entry lands first (so moved children have a parent), then every
        direct child — all living on shard(old) — moves via its own
        routed two-phase (subdirectories recurse shard-by-shard), then
        the emptied source retires. Leftover LOCAL parent scaffolding
        under old on non-owner shards is invisible garbage: listings
        only ever route to owners."""
        dnew = new_directory_entry(new)
        dest = ring.shard_for_entry(new)
        if (not dest) or dest == self.address:
            self.filer.create_entry(dnew)
        else:
            r = rpc.filer_stub(rpc.grpc_address(dest)).CreateEntry(
                filer_pb2.CreateEntryRequest(
                    directory=dnew.parent, entry=dnew.to_pb()), timeout=30)
            if r.error:
                raise IOError(f"rename mkdir on {dest}: {r.error}")
        home = ring.shard_for_directory(old)  # the children's shard
        if (not home) or home == self.address:
            names = [e.name for e in self.filer.list_entries(
                old, limit=1_000_000)]
            for n in names:
                self.shard_rename(f"{old}/{n}", f"{new}/{n}")
        else:
            stub = rpc.filer_stub(rpc.grpc_address(home))
            names = [r.entry.name for r in stub.ListEntries(
                filer_pb2.ListEntriesRequest(
                    directory=old, limit=1_000_000), timeout=60)]
            for n in names:
                stub.AtomicRenameEntry(filer_pb2.AtomicRenameEntryRequest(
                    old_directory=old, old_name=n,
                    new_directory=new, new_name=n), timeout=60)
        try:  # recursive clears only local scaffolding: real children
            # moved above, and nothing is garbage-collected here
            self.filer.delete_entry(old, recursive=True,
                                    is_delete_data=False)
        except NotFound:
            pass

    def _resolve_rename_intents(self) -> None:
        """The crash-recovery ladder applied to the metadata plane: an
        unclean shutdown can strand two-phase rename intents. Rungs:
        load the intent set, probe the destination shard for each, roll
        forward (destination has the entry — the crash seam sits after
        apply, so destination wins and the source retires) or roll back
        (apply never landed; the source is intact and the intent is
        simply forgotten)."""
        with self._rename_mu:
            intents = self._load_intents()
        report = {"intents": len(intents), "rolledForward": 0,
                  "rolledBack": 0, "errors": 0}
        if intents:
            ring = self.ring_snapshot()
            for old, it in list(intents.items()):
                new = it.get("new", "")
                try:
                    if self._entry_exists_routed(ring, new):
                        try:
                            self.filer.delete_entry(old,
                                                    is_delete_data=False)
                        except NotFound:
                            pass
                        report["rolledForward"] += 1
                        META_RING_RENAMES.inc(outcome="rollforward")
                    else:
                        report["rolledBack"] += 1
                        META_RING_RENAMES.inc(outcome="rollback")
                    intents.pop(old)
                except Exception as e:  # shard down: keep the intent —
                    # the next restart's sweep gets another chance
                    report["errors"] += 1
                    glog.warning(f"rename intent {old} -> {new}: {e}")
            with self._rename_mu:
                self._store_intents(intents)
            glog.info(f"rename intent recovery: {report}")
        self.rename_recovery = report

    def _entry_exists_routed(self, ring, full_path: str) -> bool:
        owner = ring.shard_for_entry(full_path) \
            if ring is not None and len(ring) > 1 else ""
        if not owner or owner == self.address:
            try:
                self.filer.find_entry(full_path)
                return True
            except NotFound:
                return False
        try:
            rpc.filer_stub(rpc.grpc_address(owner)).LookupDirectoryEntry(
                filer_pb2.LookupDirectoryEntryRequest(
                    directory=parent_of(full_path),
                    name=full_path.rsplit("/", 1)[-1]), timeout=10)
            return True
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.NOT_FOUND:
                return False
            raise

    def meta_shard_status(self) -> dict | None:
        if not self.meta_shard:
            return None
        ring = self.ring_snapshot()
        return {
            "address": self.address,
            "ring": ring.describe() if ring is not None else None,
            "renameRecovery": self.rename_recovery,
            "pendingRenameIntents": len(self._load_intents()),
            "ensuredParentDirs": len(self._ensured_dirs),
        }

    # -- native hot plane --------------------------------------------------

    def _hot_log_path(self) -> str:
        import os

        base = self.store_dir or "."
        os.makedirs(base, exist_ok=True)
        return os.path.join(base, "filer-hot.log")

    def _start_hot_plane(self) -> int:
        """Bind the C++ plane on the public port, move python to the admin
        port. -> the port python should bind."""
        import os

        from ..native import NativeFilerPlane

        log_path = self._hot_log_path()
        # a previous run may have crashed with acknowledged-but-unabsorbed
        # PUTs in the log: absorb them BEFORE truncating for the new plane
        if os.path.exists(log_path) and os.path.getsize(log_path):
            self._hot_mark = 0
            self._absorb_hot_log(log_path=log_path)
            if self._hot_log_corrupt:
                # records past the corruption point were never absorbed:
                # truncating would silently discard acked writes. Keep
                # the bytes for forensics/manual recovery.
                aside = log_path + ".corrupt"
                os.replace(log_path, aside)
                glog.error(f"corrupt hot log preserved at {aside}")
        open(log_path, "wb").close()
        self._hot_mark = 0
        self._hot_log_corrupt = False  # fresh log: clear any replay alarm
        # high-port guard: a filer on e.g. :57000 must not derive an
        # admin port past 65535 (that crashed the whole server)
        self.admin_port = rpc.derived_admin_port(self.port)
        # bind the python admin listener BEFORE the C++ plane learns its
        # redirect target: the deterministic +11000 port can be taken by
        # another process (volume.py's start has the same fallback), and
        # a 307 target must never point at a port we failed to bind
        try:
            self._http_server = TunedThreadingHTTPServer(
                ("", self.admin_port), _make_http_handler(self))
        except OSError:
            self._http_server = TunedThreadingHTTPServer(
                ("", 0), _make_http_handler(self))
            self.admin_port = self._http_server.server_address[1]
        try:
            self.hot_plane = NativeFilerPlane(
                "", self.port, self.admin_port,
                self.native_volume_plane.plane_id, log_path,
                max_body=min(self.chunk_size, 4 << 20))
        except Exception:
            # plane failed AFTER the admin bind: release it so the
            # fallback path can bind the PUBLIC port instead
            self._http_server.server_close()
            self._http_server = None
            raise
        self.filer.on_mutate = self._on_python_mutation
        t1 = threading.Thread(target=self._lease_loop, daemon=True,
                              name="filer-hot-leases")
        t2 = threading.Thread(target=self._absorb_loop, daemon=True,
                              name="filer-hot-absorber")
        self._hot_threads = [t1, t2]
        t1.start()
        t2.start()
        return self.admin_port

    def _on_python_mutation(self, path: str, recursive: bool) -> None:
        if self.hot_plane is None or getattr(self._hot_absorbing, "active",
                                             False):
            return  # absorption re-creates hot entries; keep their cache
        if recursive:
            self.hot_plane.invalidate_prefix(path)
        else:
            self.hot_plane.invalidate(path)

    def _lease_loop(self) -> None:
        """Keep the plane stocked with fid blocks (batched assigns)."""
        from ..operation import assign
        from ..storage.file_id import parse_file_id

        low, batch = 16384, 8192
        while not self._hot_stop.is_set():
            try:
                if self.hot_plane.lease_remaining() < low:
                    a = assign(self.master, count=batch,
                               collection=self.collection,
                               replication=self.replication)
                    if not a.error:
                        fid = parse_file_id(a.fid)
                        self.hot_plane.add_lease(
                            fid.volume_id, fid.key, fid.cookie,
                            max(1, int(a.count or batch)))
                        continue  # refill until above the low-water mark
            except Exception as e:
                glog.v(1, f"hot lease refill: {e}")
            self._hot_stop.wait(0.02)

    def _absorb_loop(self) -> None:
        while not self._hot_stop.is_set():
            try:
                self._absorb_hot_log()
            except Exception as e:
                glog.warning(f"hot log absorb: {e}")
            self._hot_stop.wait(0.05)

    def hot_sync(self) -> None:
        """Absorb any pending hot-log records so metadata reads see every
        acknowledged native PUT (read-your-writes across planes)."""
        if self.hot_plane is not None:
            self._absorb_hot_log()

    def _absorb_hot_log(self, log_path: str | None = None) -> None:
        """Tail the C++ plane's entry log into the real store (the
        filer-side analogue of NeedleMap.catchup_from_idx). Emits the
        normal metadata events at absorption time."""
        import os
        import struct as _struct

        path = log_path or (self.hot_plane.log_path if self.hot_plane
                            else None)
        if path is None or self._hot_log_corrupt:
            return  # corrupt: halted (and the plane stood down) — don't
            #         keep re-reading an ever-growing tail every poll
        try:  # lock-free fast path: nothing new appended
            if os.path.getsize(path) <= self._hot_mark:
                return
        except OSError:
            return
        with self._hot_lock:
            try:
                size = os.path.getsize(path)
            except OSError:
                return
            if size <= self._hot_mark:
                return
            with open(path, "rb") as f:
                f.seek(self._hot_mark)
                buf = f.read(size - self._hot_mark)
            if self._hot_log_corrupt:
                return
            HDR = 41
            off = 0
            self._hot_absorbing.active = True
            try:
                while off + HDR <= len(buf):
                    (op, plen, mlen, vid, key, cookie, fsize, crc,
                     mtime_ns) = _struct.unpack_from("<BHHIQIQIQ", buf, off)
                    # the C++ writer enforces plen < 4096 and mlen < 256,
                    # so out-of-range lengths are corruption (not a torn
                    # tail) — without this, a garbage length would stall
                    # absorption forever while PUTs keep being acked
                    if op != 1 or plen >= 4096 or mlen >= 256:
                        # full header available with a bad op byte is NOT
                        # a torn tail (the C++ plane truncates failed
                        # writes): the log itself is corrupt. Alarm and
                        # stand the plane down — it must stop ACKING PUTs
                        # whose metadata can never be absorbed.
                        self._hot_log_corrupt = True
                        if self.hot_plane is not None:
                            self.hot_plane.disable_log()
                        glog.error(
                            f"hot log corrupt at offset "
                            f"{self._hot_mark + off} (op={op}); absorption "
                            f"halted and native PUTs disabled — restart "
                            f"the filer to resync")
                        break
                    end = off + HDR + plen + mlen
                    if end > len(buf):
                        break  # torn tail: wait for the rest
                    p = buf[off + HDR:off + HDR + plen].decode(
                        errors="replace")
                    mime = buf[off + HDR + plen:end].decode(errors="replace")
                    self._absorb_one(p, vid, key, cookie, fsize, crc,
                                     mtime_ns, mime)
                    off = end
            finally:
                self._hot_absorbing.active = False
            self._hot_mark += off

    def _absorb_one(self, path: str, vid: int, key: int, cookie: int,
                    fsize: int, crc: int, mtime_ns: int, mime: str) -> None:
        from ..storage.file_id import FileId

        fid = str(FileId(vid, key, cookie))
        old_fids: list[str] = []
        try:
            old = self.filer.find_entry(path)
            old_fids = [c.file_id for c in old.chunks]
        except NotFound:
            pass
        chunk = filer_pb2.FileChunk(
            file_id=fid, size=fsize, modified_ts_ns=mtime_ns,
            e_tag=f"{crc & 0xFFFFFFFF:08x}")
        entry = Entry(
            full_path=normalize(path),
            attr=Attr(mtime=mtime_ns // 1_000_000_000,
                      crtime=mtime_ns // 1_000_000_000,
                      mode=0o660, mime=mime),
            chunks=[chunk],
        )
        self.filer.create_entry(entry)
        if old_fids and old_fids != [fid]:
            self._gc_chunks(old_fids)

    # -- chunk IO ----------------------------------------------------------

    def save_chunk(self, data: bytes, *, ttl: str = "") -> filer_pb2.FileChunk:
        last_err = ""
        for attempt in (0, 1):
            a = self.fid_pool.acquire(collection=self.collection,
                                      replication=self.replication, ttl=ttl)
            if a.error:
                raise IOError(f"assign: {a.error}")
            r = upload_data(url_for(a.url, a.fid), data, ttl=ttl,
                            auth=a.auth)
            if not r.error:
                break
            # the leased volume may have filled/moved/gone read-only
            # since the batch assign: drop THIS key's leases and re-ask
            # the (possibly failed-over) master for a fresh target once
            # (other collections' healthy leases stay pooled)
            last_err = r.error
            self.fid_pool.invalidate(collection=self.collection,
                                     replication=self.replication, ttl=ttl)
        else:
            raise IOError(f"upload: {last_err}")
        if self.chunk_cache is not None and not ttl \
                and len(data) < self.chunk_cache.mem_threshold:
            # write-through for SMALL chunks only: the small-file
            # PUT->GET hot path hits memory on first read, while one
            # bulk upload's 4MB chunks must not evict the whole
            # small-file working set (large chunks still enter the
            # cache on the read path, where a hit is proven demand).
            # TTL'd chunks stay uncached — the cache has no expiry
            # sweep.
            self.chunk_cache.put(a.fid, bytes(data))
            FILER_CHUNK_CACHE_COUNTER.inc(result="put")
        return filer_pb2.FileChunk(
            file_id=a.fid, size=len(data),
            modified_ts_ns=time.time_ns(), e_tag=r.etag,
        )

    def write_file(self, path: str, body: bytes, *, mime: str = "",
                   ttl: str = "", mode: int = 0o660,
                   from_other_cluster: bool = False,
                   extended: dict | None = None) -> Entry:
        import io

        return self.write_stream(path, io.BytesIO(body), len(body),
                                 mime=mime, ttl=ttl, mode=mode,
                                 from_other_cluster=from_other_cluster,
                                 extended=extended)

    def write_stream(self, path: str, reader, length: int | None, *,
                     mime: str = "", ttl: str = "", mode: int = 0o660,
                     from_other_cluster: bool = False,
                     extended: dict | None = None) -> Entry:
        """autoChunk + saveAsChunk + CreateEntry, reading `length` bytes
        (or until EOF when length is None — chunked transfer encoding)
        from `reader` one chunk at a time (uploadReaderToChunks in
        filer_server_handlers_write_autochunk.go): a multi-GB PUT never
        materializes in filer RAM. On failure the chunks saved so far are
        garbage-collected before the error surfaces.

        Pipelined: multi-chunk bodies overlap the client-body
        read of chunk N+1 with the assign+upload of chunk N — up to W
        `save_chunk` calls in flight on the shared executor (the
        reference's `uploadReaderToChunks` concurrency). md5/offset
        accounting stays strictly ordered (the body is still read
        sequentially on this thread); single-chunk bodies keep the
        direct path (no executor hop on the small-file hot path).

        A known `length` whose body ends short raises ShortBodyError
        (mapped to 4xx at the HTTP/S3 handlers) instead of silently
        committing a TRUNCATED entry — the saved chunks are GC'd."""
        chunks: list = []
        win = None
        md5 = hashlib.md5()
        off = 0
        try:
            while True:
                want = self.chunk_size if length is None \
                    else min(self.chunk_size, length - off)
                if off and want <= 0:
                    break
                piece = reader.read(want) if want > 0 else b""
                if off and not piece:
                    break
                md5.update(piece)
                final = len(piece) < want or want <= 0 or (
                    length is not None and off + len(piece) >= length)
                if final and win is None and not chunks:
                    # single-chunk body: save inline, no executor hop
                    c = self.save_chunk(piece, ttl=ttl)
                    c.offset = off
                    chunks.append(c)
                else:
                    if win is None:
                        win = chunk_pipeline.UploadWindow(
                            lambda data: self.save_chunk(data, ttl=ttl))
                    win.add(piece, off)
                off += len(piece)
                if len(piece) < want or want <= 0:
                    break
            if length is not None and off < length:
                # reader.read() returned short of the declared
                # Content-Length: the client died mid-body. Committing
                # would truncate silently (a truncated entry).
                raise chunk_pipeline.ShortBodyError(off, length)
            if win is not None:
                chunks.extend(win.finish())
        except Exception:
            fids = [c.file_id for c in chunks]
            if win is not None:
                fids.extend(win.saved_fids())
            self._gc_chunks(fids)
            raise
        return self._finish_entry(path, chunks, md5, mime=mime, ttl=ttl,
                                  mode=mode,
                                  from_other_cluster=from_other_cluster,
                                  extended=extended)

    def _finish_entry(self, path, chunks, md5, *, mime, ttl, mode,
                      from_other_cluster, extended=None):
        now = int(time.time())
        entry = Entry(
            full_path=normalize(path),
            attr=Attr(mtime=now, crtime=now, mode=mode, mime=mime,
                      md5=md5.digest(),
                      ttl_sec=_ttl_seconds(ttl)),
            chunks=chunks,
            extended=dict(extended) if extended else {},
        )
        old_fids = []
        try:
            old = self.filer.find_entry(entry.full_path)
            old_fids = [c.file_id for c in old.chunks]
        except NotFound:
            pass
        try:
            self.filer.create_entry(entry,
                                    from_other_cluster=from_other_cluster)
        except Exception:
            # metadata write failed: the fresh chunks are unreachable
            self._gc_chunks([c.file_id for c in chunks])
            raise
        if old_fids:
            self._gc_chunks(old_fids)
        self.ensure_parent_dirs(entry.full_path)
        return entry

    def _local_entry_content(self, directory: str, name: str
                             ) -> bytes | None:
        try:
            return self.filer.find_entry(
                directory.rstrip("/") + "/" + name).content
        except NotFound:
            return None

    def stream_file(self, entry: Entry, offset: int = 0,
                    size: int | None = None):
        """Yield the file's bytes one chunk view at a time (StreamContent,
        stream.go:69) — a multi-GB file never materializes in filer RAM."""
        if entry.content:
            end = len(entry.content) if size is None else offset + size
            yield memoryview(entry.content)[offset:end]
            return
        if is_remote_only(entry):
            # mounted but not cached: stream through from the remote store
            # on demand (the reference's IsInRemoteOnly read fallback),
            # capped at the entry's declared size so Content-Length holds;
            # a remote that is now shorter raises (read_through)
            cap = entry.size() - offset if size is None else size
            yield from self.remote_gateway.read_through(
                entry.full_path, offset, max(cap, 0))
            return
        # TTL'd entries never enter the chunk cache: their needles expire
        # volume-side and nothing would ever invalidate the cached copy
        # (TTL expiry doesn't pass through _gc_chunks)
        cacheable = not entry.attr.ttl_sec
        views = view_from_chunks(entry.chunks, offset, size)
        window = chunk_pipeline.get_window(len(views))
        if window <= 1:
            for view in views:
                yield self._read_chunk_view(view, cacheable=cacheable)
            return
        # pipelined readahead: prefetch upcoming views on the
        # shared executor while the current one streams to the client.
        # Large-object prefetches BYPASS read-through cache population
        # (populate=False) — a streaming read must not evict the
        # small-file working set — but still consult the cache for hits.
        # Chunk-read spans keep their trace via the captured parent ctx
        # (executor threads have no span TLS).
        sp = trace.current()
        parent_ctx = sp.context() if sp is not None else None

        def fetch(v):
            return self._read_chunk_view(v, cacheable=cacheable,
                                         populate=False,
                                         parent_ctx=parent_ctx)

        yield from chunk_pipeline.readahead(views, fetch, span=sp)

    def _read_chunk_view(self, view, cacheable: bool = True,
                         populate: bool = True,
                         parent_ctx=None) -> bytes:
        """One chunk view's bytes: the filer chunk cache first (rung 0 —
        zero volume-server round-trips on a hit), then full failover:
        every replica in the cached location map, a cache-invalidating
        re-lookup (the map may be stale after a replica died), then
        servers holding ANY EC shard of the volume — which reconstruct
        from any k shards server-side (the LookupFileIdWithFallback read
        ladder this rebuild previously lacked: first dead replica was
        fatal).

        `populate=False` (pipelined large-object reads) still
        CONSULTS the cache but never populates it on a miss — streaming
        a big object must not evict the small-file working set.
        `parent_ctx` is the request span's `.context()` when this runs
        on a prefetch executor thread (no span TLS there).

        Traced: inside a request span each rung becomes
        attributable — the `filer.chunk_read` child carries the
        cache hit/miss verdict, and the volume-server fetches below
        propagate the trace over their HTTP headers."""
        with trace.span("filer.chunk_read", child_only=True,
                        parent=parent_ctx,
                        fid=view.file_id, size=view.size) as tsp:
            return self._read_chunk_view_traced(view, cacheable, tsp,
                                                populate)

    def _read_chunk_view_traced(self, view, cacheable: bool, tsp,
                                populate: bool = True) -> bytes:
        cache = self.chunk_cache
        if cache is not None and cacheable:
            cached = cache.get(view.file_id)
            if cached is not None and \
                    len(cached) >= view.chunk_offset + view.size:
                FILER_CHUNK_CACHE_COUNTER.inc(result="hit")
                tsp.set_attr(cache="hit")
                # zero-copy hot path: a memoryview SLICE of
                # the immutable cached bytes — the payload is never
                # copied between the cache and the response socket
                # (eviction only drops the dict reference; the view
                # keeps the buffer alive)
                return memoryview(cached)[view.chunk_offset:
                                          view.chunk_offset + view.size]
            FILER_CHUNK_CACHE_COUNTER.inc(result="miss")
            tsp.set_attr(cache="miss")
        headers = {"Range": f"bytes={view.chunk_offset}-"
                            f"{view.chunk_offset + view.size - 1}"} \
            if not view.is_full_chunk else {}
        trace.inject_headers(headers)
        last_err: Exception | None = None

        def filled(data: bytes) -> bytes:
            # read-through population: only whole chunks of non-TTL'd
            # entries (a ranged fetch can't serve later full-chunk
            # reads; expired needles would linger in cache forever).
            # Pipelined large-object reads pass populate=False: one
            # streaming GET's chunks must not evict the whole
            # small-file working set.
            if cache is not None and cacheable and populate \
                    and view.is_full_chunk:
                cache.put(view.file_id, data)
                FILER_CHUNK_CACHE_COUNTER.inc(result="put")
            return data

        def try_urls(urls):
            """-> (data | None, every-replica-replied-404). A sweep that
            was ONLY definitive 404s means the needle is absent, not
            that replicas are down — distinguishing the two keeps a
            deleted-file poll from escalating into master re-lookups
            and EC sweeps on every read.

            The volume fetch rides the wdclient keep-alive pool
           : no per-chunk TCP/TLS setup on the filer→volume
            leg. Pool/transport failures are OSErrors classified by
            utils.retry exactly like the requests paths — including
            fail-fast certificate rejections under SWFS_HTTPS."""
            nonlocal last_err
            from ..utils.retry import _ssl_error_of, ssl_error_is_retryable
            from ..wdclient import pool

            all_notfound = bool(urls)
            for url in urls:
                try:
                    r = pool.get(url, timeout=60, headers=headers)
                    _note_pressure_header(r.headers)
                    if r.status in (200, 206):
                        data = r.data
                        if r.status == 200 and not view.is_full_chunk:
                            data = data[view.chunk_offset:
                                        view.chunk_offset + view.size]
                        if len(data) == view.size:
                            return data, False
                        # a replica serving the wrong byte count (e.g.
                        # flag-corrupted needle) must read as a FAILED
                        # replica, not stream short into a body whose
                        # Content-Length was already computed
                        all_notfound = False
                        last_err = IOError(
                            f"{url}: wrong chunk size "
                            f"{len(data)} != {view.size}")
                    elif r.status == 404:
                        last_err = IOError(f"{url}: 404")
                    else:
                        all_notfound = False
                        last_err = IOError(f"{url}: {r.status}")
                        if r.status in (429, 503):
                            # a throttling volume server is the hot
                            # signal the pipelined readahead collapses
                            # on
                            PRESSURE_SIGNAL.report_shed()
                        elif r.status >= 500:
                            # a flapping/erroring replica: prefetch
                            # fan-out must degrade to sequential while
                            # the ladder absorbs the failures
                            PRESSURE_SIGNAL.report_strain()
                except (OSError, rq.RequestException) as e:
                    all_notfound = False
                    last_err = e
                    PRESSURE_SIGNAL.report_strain()
                    sslerr = _ssl_error_of(e)
                    if sslerr is not None \
                            and not ssl_error_is_retryable(sslerr):
                        # a certificate rejection is a trust decision,
                        # not a down replica: walking more replicas of
                        # the same misconfigured cluster hides it
                        raise
            return None, all_notfound

        notfound = False
        try:
            data, _ = try_urls(
                self.master_client.lookup_file_id(view.file_id))
            if data is not None:
                return filled(data)
            # all cached replicas failed: the map may be stale — drop it,
            # re-ask the master, and walk the fresh replica set once more
            # (a 404 sweep still refreshes once: the volume may have
            # MOVED and the old holder answers 404 for it)
            vid = view.file_id.split(",")[0]
            glog.v(1, f"chunk {view.file_id}: cached replicas failed "
                      f"({last_err}); refreshing volume {vid} locations")
            # needing the failover ladder at all means the cluster is
            # struggling: degrade prefetch fan-out to sequential for a
            # few seconds rather than multiplying the error load
            PRESSURE_SIGNAL.report_strain()
            data, notfound = try_urls(self.master_client.lookup_file_id(
                view.file_id, refresh=True))
            if data is not None:
                return filled(data)
        except LookupError as e:
            last_err = e
            notfound = False
        if not notfound:
            # last resort: the volume may live on (only) as EC shards.
            # Skipped when every FRESH replica answered a definitive 404
            # — the needle is deleted/absent, and LookupEcVolume has no
            # negative cache to absorb a polling client.
            data, _ = try_urls(
                self.master_client.ec_fallback_urls(view.file_id))
            if data is not None:
                return filled(data)
        raise IOError(f"chunk {view.file_id} unreadable: {last_err}")

    def read_file(self, entry: Entry, offset: int = 0,
                  size: int | None = None) -> bytes:
        return b"".join(self.stream_file(entry, offset, size))

    def _gc_chunks(self, fids: list[str]) -> None:
        if not fids:
            return
        if self.chunk_cache is not None:
            # invalidate BEFORE the needles die: between a delete and a
            # re-write that recycles nothing (fids are never reused by
            # the filer path) a stale cache entry could otherwise serve
            # bytes the namespace no longer references
            for fid in fids:
                if self.chunk_cache.delete(fid):
                    FILER_CHUNK_CACHE_COUNTER.inc(result="invalidate")
        try:
            delete_files(self.master, fids)
        except Exception as e:  # noqa: BLE001 - GC is best-effort
            glog.warning(f"chunk gc failed: {e}")


def _note_pressure_header(resp_headers) -> None:
    """Feed a volume server's X-Swfs-Pressure response stamp (ROADMAP
    5(b)) into the process-local hot signal: the pipelined chunk engine
    collapses its readahead/overlap windows when the score crosses the
    shed threshold — BEFORE the first 429 arrives. Per-process signal =
    per-shard independence on the partitioned metadata plane."""
    try:
        v = resp_headers.get("X-Swfs-Pressure")
        if v:
            PRESSURE_SIGNAL.report_score(float(v))
    except (TypeError, ValueError, AttributeError):
        pass


def _read_all(reader, cap: int = 1 << 30) -> bytes:
    out = bytearray()
    while True:
        piece = reader.read(1 << 20)
        if not piece:
            break
        out += piece
        if len(out) > cap:
            raise IOError(f"body exceeds the {cap}-byte buffered limit")
    return bytes(out)


class _ChunkedReader:
    """Minimal streaming Transfer-Encoding: chunked decoder over rfile
    (read(n) semantics; b"" at end-of-body after consuming the trailer)."""

    def __init__(self, rfile):
        self._f = rfile
        self._remaining = 0
        self._done = False

    def _next_chunk(self) -> bool:
        line = self._f.readline(1024).strip()
        if not line:
            line = self._f.readline(1024).strip()  # tolerate blank sep
        try:
            size = int(line.split(b";")[0], 16)
        except ValueError:
            raise IOError(f"malformed chunk-size line {line[:32]!r}")
        if size == 0:
            # consume trailer lines through the terminating blank line
            while True:
                t = self._f.readline(1024)
                if t in (b"\r\n", b"\n", b""):
                    break
            self._done = True
            return False
        self._remaining = size
        return True

    def read(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n and not self._done:
            if self._remaining == 0:
                if not self._next_chunk():
                    break
            take = min(n - len(out), self._remaining)
            piece = self._f.read(take)
            if not piece:
                # EOF inside a chunk: the 0-size terminator never arrived,
                # so the body is TRUNCATED — storing it would turn a
                # detectable client failure into silent data corruption
                raise IOError("truncated chunked body")
            out += piece
            self._remaining -= len(piece)
            if self._remaining == 0:
                self._f.readline(1024)  # CRLF after each chunk
        return bytes(out)


# RFC 7233 span parsing now lives in utils.http (the volume
# handler shares it so both planes answer ranges identically)
_parse_range = parse_range


def _ttl_seconds(ttl: str) -> int:
    if not ttl:
        return 0
    from ..storage.ttl import TTL

    return TTL.parse(ttl).minutes() * 60


# -- gRPC servicer ---------------------------------------------------------

class FilerGrpc:
    def __init__(self, srv: FilerServer):
        self.srv = srv
        self.filer = srv.filer

    def _shard_gate(self, context, err) -> None:
        """Abort FAILED_PRECONDITION with WrongShardError-parseable
        details (the gRPC face of the HTTP 410)."""
        if err is not None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(err))

    def LookupDirectoryEntry(self, request, context):
        self.srv.hot_sync()
        path = request.directory.rstrip("/") + "/" + request.name
        self._shard_gate(context,
                         self.srv.shard_check_entry(path, lenient=True))
        try:
            e = self.filer.find_entry(path)
        except NotFound:
            context.abort(grpc.StatusCode.NOT_FOUND, "not found")
        return filer_pb2.LookupDirectoryEntryResponse(entry=e.to_pb())

    def ListEntries(self, request, context):
        self.srv.hot_sync()
        self._shard_gate(context,
                         self.srv.shard_check_dir(request.directory))
        limit = request.limit or 1024
        for e in self.filer.list_entries(
                request.directory, request.start_from_file_name,
                request.inclusive_start_from, limit, request.prefix):
            yield filer_pb2.ListEntriesResponse(entry=e.to_pb())

    def CreateEntry(self, request, context):
        self.srv.hot_sync()
        e = Entry.from_pb(request.directory, request.entry)
        self._shard_gate(context, self.srv.shard_check_entry(e.full_path))
        try:
            self.filer.create_entry(
                e, o_excl=request.o_excl,
                skip_parents=request.skip_check_parent_directory,
                from_other_cluster=request.is_from_other_cluster)
        except Exception as err:  # noqa: BLE001
            return filer_pb2.CreateEntryResponse(error=str(err))
        if not request.entry.is_directory:
            # files trigger the cross-shard ancestor walk; directory
            # creates are themselves that walk's building blocks (a
            # recursion guard as much as an optimization)
            self.srv.ensure_parent_dirs(e.full_path)
        return filer_pb2.CreateEntryResponse()

    def UpdateEntry(self, request, context):
        self.srv.hot_sync()
        e = Entry.from_pb(request.directory, request.entry)
        self._shard_gate(context, self.srv.shard_check_entry(e.full_path))
        try:
            self.filer.update_entry(
                e, from_other_cluster=request.is_from_other_cluster)
        except NotFound:
            context.abort(grpc.StatusCode.NOT_FOUND, "not found")
        return filer_pb2.UpdateEntryResponse()

    def AppendToEntry(self, request, context):
        self.srv.hot_sync()
        path = request.directory.rstrip("/") + "/" + request.entry_name
        self._shard_gate(context, self.srv.shard_check_entry(path))
        try:
            e = self.filer.find_entry(path)
        except NotFound:
            e = Entry(full_path=path,
                      attr=Attr(mtime=int(time.time()),
                                crtime=int(time.time())))
            self.filer.create_entry(e)
        offset = e.size()
        for c in request.chunks:
            c.offset = offset
            offset += c.size
            e.chunks.append(c)
        self.filer.update_entry(e)
        return filer_pb2.AppendToEntryResponse()

    def DeleteEntry(self, request, context):
        self.srv.hot_sync()
        path = request.directory.rstrip("/") + "/" + request.name
        self._shard_gate(context, self.srv.shard_check_entry(path))
        try:
            fids = self.filer.delete_entry(
                path, recursive=request.is_recursive,
                is_delete_data=request.is_delete_data,
                from_other_cluster=request.is_from_other_cluster)
            if request.is_delete_data and fids:
                self.srv._gc_chunks(fids)
        except NotFound:
            pass
        except NotEmpty as e:
            return filer_pb2.DeleteEntryResponse(error=str(e))
        return filer_pb2.DeleteEntryResponse()

    def AtomicRenameEntry(self, request, context):
        self.srv.hot_sync()
        old = request.old_directory.rstrip("/") + "/" + request.old_name
        new = request.new_directory.rstrip("/") + "/" + request.new_name
        try:
            # the one two-phase cross-shard operation:
            # executed on the shard owning the SOURCE entry; local
            # renames fall straight through to filer.rename
            self.srv.shard_rename(old, new)
        except WrongShardError as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        except NotFound:
            context.abort(grpc.StatusCode.NOT_FOUND, "source not found")
        return filer_pb2.AtomicRenameEntryResponse()

    def StreamRenameEntry(self, request, context):
        """filer_grpc_server_rename.go:51 — same move as
        AtomicRenameEntry, but each moved entry streams back as a rename
        event so subscribers (mounts, sync loops) can track a large
        directory move incrementally."""
        self.srv.hot_sync()
        old = request.old_directory.rstrip("/") + "/" + request.old_name
        new = request.new_directory.rstrip("/") + "/" + request.new_name
        ring = self.srv.ring_snapshot() if self.srv.meta_shard else None
        if ring is not None and len(ring) > 1:
            # sharded namespace: delegate to the routed two-phase move —
            # per-entry events reach subscribers from each shard's own
            # mutation log rather than this stream
            try:
                self.srv.shard_rename(old, new)
            except WrongShardError as e:
                context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
            except NotFound:
                context.abort(grpc.StatusCode.NOT_FOUND,
                              "source not found")
            return
        try:
            # complete the WHOLE move before streaming: the generator is
            # only advanced as the client reads, so a cancel/deadline
            # mid-stream would otherwise leave the namespace half-moved
            moves = list(self.filer.rename_stream(old, new))
        except NotFound:
            context.abort(grpc.StatusCode.NOT_FOUND, "source not found")
        for old_e, moved in moves:
            ev = filer_pb2.EventNotification(
                old_entry=old_e.to_pb(), new_entry=moved.to_pb(),
                new_parent_path=moved.parent,
                signatures=[*request.signatures, self.filer.signature])
            yield filer_pb2.StreamRenameEntryResponse(
                directory=old_e.parent, event_notification=ev,
                ts_ns=time.time_ns())

    def AssignVolume(self, request, context):
        a = assign(self.srv.master, count=max(request.count, 1),
                   collection=request.collection or self.srv.collection,
                   replication=request.replication or self.srv.replication,
                   data_center=request.data_center)
        if a.error:
            return filer_pb2.AssignVolumeResponse(error=a.error)
        return filer_pb2.AssignVolumeResponse(
            file_id=a.fid, count=a.count, auth=a.auth,
            collection=request.collection or self.srv.collection,
            replication=request.replication or self.srv.replication,
            location=filer_pb2.Location(url=a.url, public_url=a.public_url),
        )

    def LookupVolume(self, request, context):
        resp = filer_pb2.LookupVolumeResponse()
        for vid_str in request.volume_ids:
            try:
                locs = self.srv.master_client.lookup_volume(int(vid_str))
            except (LookupError, ValueError):
                continue
            ll = filer_pb2.Locations()
            for l in locs:
                ll.locations.append(filer_pb2.Location(
                    url=l.url, public_url=l.public_url,
                    grpc_port=l.grpc_port, data_center=l.data_center))
            resp.locations_map[vid_str].CopyFrom(ll)
        return resp

    def CollectionList(self, request, context):
        stub = rpc.master_stub(rpc.grpc_address(self.srv.master))
        mresp = stub.CollectionList(master_pb2.CollectionListRequest(
            include_normal_volumes=request.include_normal_volumes,
            include_ec_volumes=request.include_ec_volumes), timeout=10)
        return filer_pb2.CollectionListResponse(
            collections=[filer_pb2.Collection(name=c.name)
                         for c in mresp.collections])

    def DeleteCollection(self, request, context):
        stub = rpc.master_stub(rpc.grpc_address(self.srv.master))
        stub.CollectionDelete(master_pb2.CollectionDeleteRequest(
            name=request.collection), timeout=60)
        return filer_pb2.DeleteCollectionResponse()

    def Statistics(self, request, context):
        stub = rpc.master_stub(rpc.grpc_address(self.srv.master))
        m = stub.Statistics(master_pb2.StatisticsRequest(
            collection=request.collection), timeout=10)
        return filer_pb2.StatisticsResponse(
            total_size=m.total_size, used_size=m.used_size,
            file_count=m.file_count)

    def GetFilerConfiguration(self, request, context):
        return filer_pb2.GetFilerConfigurationResponse(
            masters=[self.srv.master], collection=self.srv.collection,
            replication=self.srv.replication,
            max_mb=self.srv.chunk_size // (1024 * 1024),
            dir_buckets="/buckets", signature=self.filer.signature,
            version="seaweedfs-tpu 0.1", cluster_id="")

    def SubscribeMetadata(self, request, context):
        since = request.since_ns
        prefixes = list(request.path_prefixes) or (
            [request.path_prefix] if request.path_prefix else [])
        while context.is_active():
            events, since = self.filer.read_events(since, timeout=1.0)
            for msg in events:
                if request.until_ns and msg.ts_ns > request.until_ns:
                    return
                # a rename matches where it left and where it went
                # (filer_grpc_server_sub_meta.go)
                new_parent = msg.event_notification.new_parent_path
                if prefixes and not any(
                        msg.directory.startswith(p) or new_parent and
                        new_parent.startswith(p) for p in prefixes):
                    continue
                yield msg

    def SubscribeLocalMetadata(self, request, context):
        """Locally-originated events only (filer.proto:62): peers use this
        to aggregate without re-receiving events that were themselves
        folded in from other peers (the origin filer's signature is the
        first entry in the event's signature list)."""
        own = self.filer.signature
        for msg in self.SubscribeMetadata(request, context):
            sigs = msg.event_notification.signatures
            if sigs and sigs[0] != own:
                continue
            yield msg

    def KvGet(self, request, context):
        v = self.filer.store.kv_get(request.key)
        if v is None:
            return filer_pb2.KvGetResponse(error="not found")
        return filer_pb2.KvGetResponse(value=v)

    def KvPut(self, request, context):
        self.filer.store.kv_put(request.key, request.value)
        return filer_pb2.KvPutResponse()

    def CacheRemoteObjectToLocalCluster(self, request, context):
        """filer_grpc_server_remote.go: materialize a remote-mounted
        entry's bytes into local volumes and return the updated entry
        (the wire contract behind `weed shell remote.cache`).

        Everything runs in-process (find/update via self.filer, bytes
        via srv.write_file): nested loopback gRPC from inside a gRPC
        worker could exhaust the 32-thread pool under concurrency."""
        path = request.directory.rstrip("/") + "/" + request.name
        try:
            e = self.filer.find_entry(path)
        except NotFound:
            context.abort(grpc.StatusCode.NOT_FOUND, f"{path} not found")
        marker = e.extended.get(REMOTE_ENTRY_KEY)
        if not marker:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"{path} is not a remote entry")
        try:
            client, rpath = self.srv.remote_gateway._remote_location(path)
            data = client.read_file(rpath)
            # the marker rides the SAME store write as the content: a
            # crash between "write bytes" and a follow-up marker update
            # must not leave a cached entry that is no longer recognized
            # as remote (breaking remote.uncache / meta sync for it)
            e = self.srv.write_file(
                path, data, extended={REMOTE_ENTRY_KEY: marker})
        except Exception as err:  # noqa: BLE001 - remote IO failures
            context.abort(grpc.StatusCode.INTERNAL, str(err))
        return filer_pb2.CacheRemoteObjectToLocalClusterResponse(
            entry=e.to_pb())

    def GetMetaRing(self, request, context):
        """Ring proxy: any filer serves the ring it routes
        under, so S3/mount/WebDAV gateways bootstrap from their seed
        filer without ever holding a master address."""
        from ..pb import meta_ring_pb2

        resp = meta_ring_pb2.MetaRingResponse()
        ring = self.srv.ring_snapshot()
        if ring is None:
            try:  # non-shard filer: relay the master's published ring
                return rpc.master_stub(rpc.grpc_address(
                    self.srv.master_client.current_master)).GetMetaRing(
                    request, timeout=10)
            except grpc.RpcError:
                ring = MetaRing([])  # empty = unsharded to callers
        ring.fill_response(resp)
        return resp

    def Ping(self, request, context):
        now = time.time_ns()
        return filer_pb2.PingResponse(start_time_ns=now, remote_time_ns=now,
                                      stop_time_ns=time.time_ns())


# -- HTTP plane ------------------------------------------------------------

def _make_http_handler(srv: FilerServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            glog.v(2, f"filer http: {fmt % args}")

        def _reply(self, code: int, body: bytes = b"",
                   ctype: str = "application/json", headers=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            tid = getattr(self, "_trace_id", "")
            if tid:
                self.send_header("X-Trace-Id", tid)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            if body and self.command != "HEAD":
                self.wfile.write(body)

        def _json(self, obj, code=200):
            self._reply(code, json.dumps(obj).encode())

        def _stream_reply(self, code: int, length: int, chunks,
                          ctype: str = "application/octet-stream",
                          headers=None):
            """Send headers, then write the body chunk by chunk (the
            reference's StreamContent): filer memory stays one chunk deep
            regardless of file size. The FIRST chunk is primed before the
            status line so a fully-unreadable file still gets a clean 500;
            a later mid-stream failure can only drop the connection (the
            short body is detectable by Content-Length)."""
            it = iter(chunks)
            first = None
            if self.command != "HEAD":
                try:
                    first = next(it)
                except StopIteration:
                    pass
                except IOError as e:
                    return self._json({"error": str(e)}, 500)
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(length))
            tid = getattr(self, "_trace_id", "")
            if tid:
                self.send_header("X-Trace-Id", tid)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            if self.command == "HEAD":
                return
            try:
                if first:
                    self.wfile.write(first)
                for piece in it:
                    if piece:
                        self.wfile.write(piece)
            except IOError as e:
                glog.warning(f"stream aborted for {self.path}: {e}")
                self.close_connection = True

        def _path_q(self):
            u = urlparse(self.path)
            return unquote(u.path), {k: v[0] for k, v in
                                     parse_qs(u.query).items()}

        def do_GET(self):
            self._trace_id = ""  # never leak across keep-alive requests
            path, q = self._path_q()
            if path == "/metrics":
                ex = "exemplars" in q
                return self._reply(200, gather(exemplars=ex).encode(),
                                   metrics_content_type(ex))
            if path == "/debug/traces":
                return self._json(trace.debug_traces_payload(q))
            if path == "/healthz":
                return self._json({"ok": True})
            if path == "/status":
                from ..utils.stats import http_pool_stats, qos_stats

                hot = srv.hot_plane.stats() if srv.hot_plane else None
                return self._json({
                    **status_base(srv._started_at),
                    "Version": "seaweedfs-tpu",
                    # filer→volume keep-alive pool economics:
                    # hit rate + client TLS handshake amortization
                    "HttpPool": http_pool_stats(),
                    "ChunkCache": chunk_cache_stats(),
                    "ChunkCacheEnabled": srv.chunk_cache is not None,
                    # pipelined chunk data path: window
                    # activity + the hot signal that collapses it
                    "ChunkPipeline": chunk_pipeline_stats(),
                    "FidLease": {
                        **fid_lease_stats(),
                        "remaining": srv.fid_pool.remaining(),
                        "batch": srv.fid_pool.batch,
                    },
                    # the C++ hot plane's stats (null without one)
                    "NativeHotPlane": hot,
                    "Trace": trace.STORE.stats(),
                    # QoS plane: tenant buckets + rejections
                    "Qos": {
                        **qos_stats(),
                        "tenantAdmission": srv.qos_admission.status(),
                    },
                    # partitioned-namespace mode: this
                    # shard's ring picture + rename-intent recovery
                    "MetaShard": srv.meta_shard_status(),
                })
            srv.hot_sync()  # see native PUTs not yet absorbed
            with trace.span("filer.read", carrier=self.headers,
                            component="filer", server=srv.address,
                            path=path) as tsp:
                self._trace_id = tsp.trace_id
                # lenient: one verb serves both stats (entry key) and
                # listings (directory key) — either owner may answer
                if self._wrong_shard_rejected(
                        srv.shard_check_entry(path, lenient=True)):
                    return
                if self._qos_rejected(path, q, tsp, "GET"):
                    return
                return self._do_get(path, q)

        def _wrong_shard_rejected(self, err) -> bool:
            """Answer 410 + the current ring epoch when the routing key
            belongs to another shard — the client drops its
            cached ring, refetches, and retries once (the vid-cache
            invalidation ladder). True = reply already sent."""
            if err is None:
                return False
            self._reply(WRONG_SHARD_STATUS, json.dumps({
                "error": str(err), "ringEpoch": err.epoch,
                "owner": err.owner,
            }).encode(), headers={EPOCH_HEADER: str(err.epoch)})
            return True

        def _qos_rejected(self, path, q, tsp, verb: str) -> bool:
            """Per-tenant ingress admission: True = the 429
            was already sent. The rejection is attributable — the span
            carries the verdict and the X-Trace-Id header rides the 429
            (the client's `trace.dump` handle)."""
            from ..qos import filer_tenant

            if self.headers.get("X-Swfs-Qos-Charged"):
                # internal leg from the S3 gateway: the tenant's budget
                # was already charged at the S3 ingress — billing the
                # same request twice halves every tenant's effective
                # rate and surfaces the second 429 mid-request. A
                # direct-to-filer client spoofing the header skips this
                # plane's budget; the filer is the cluster-internal
                # surface (the S3 gateway is the authenticated public
                # ingress), matching the admission module's declared
                # unverified-at-admission trust model.
                return False

            d = srv.qos_admission.admit(
                filer_tenant(path, q.get("collection", "")),
                trace_id=tsp.trace_id, detail=f"{verb} {path}")
            if srv.meta_shard:
                # per-shard accounting: buckets are already
                # per-process, so shards shed independently — the
                # counter makes that isolation observable per shard
                FILER_SHARD_QOS_OPS.inc(
                    shard=srv.address,
                    result="admit" if d.admitted else "reject")
            if d.admitted:
                return False
            # an attribute, not set_error: a flood sheds hundreds of
            # these per second and must not flush keep-if-error
            # retention (the master assignError policy)
            tsp.set_attr(qosRejected=d.reason, tenant=d.tenant)
            self._reply(
                429, json.dumps({
                    "error": "rate limited", "tenant": d.tenant,
                    "retryAfterSeconds": round(d.retry_after_s, 3),
                }).encode(),
                headers={"Retry-After":
                         str(max(int(d.retry_after_s + 0.999), 1))})
            return True

        def _do_get(self, path, q):
            with FILER_REQUEST_HISTOGRAM.time(type="read"):
                try:
                    entry = srv.filer.find_entry(path)
                except NotFound:
                    return self._json({"error": "not found"}, 404)
                if entry.is_directory:
                    limit = int(q.get("limit", 1000))
                    if "ui" in q or "text/html" in (
                            self.headers.get("Accept") or ""):
                        from .ui import filer_ui

                        listed = list(srv.filer.list_entries(
                            path, q.get("lastFileName", ""), limit=limit))
                        return self._reply(
                            200, filer_ui(srv, path, listed),
                            "text/html; charset=utf-8")
                    entries = [{
                        "FullPath": e.full_path,
                        "Mtime": e.attr.mtime, "Crtime": e.attr.crtime,
                        "Mode": e.attr.mode, "Mime": e.attr.mime,
                        "IsDirectory": e.is_directory,
                        "FileSize": e.size(),
                    } for e in srv.filer.list_entries(
                        path, q.get("lastFileName", ""), limit=limit)]
                    return self._json({
                        "Path": path, "Entries": entries,
                        "ShouldDisplayLoadMore": len(entries) >= limit,
                    })
                # the stored whole-body md5 is THE entity-tag when the
                # upload recorded one (it is what S3 PUT/HEAD advertise
                # and what Content-MD5 carries — a client revalidating
                # with its PUT-returned ETag must get the 304); chunk-
                # combined CRC etags cover md5-less gRPC-created entries
                etag = f'"{entry.attr.md5.hex()}"' if entry.attr.md5 \
                    else f'"{chunks_etag(entry.chunks)}"'
                headers = {"ETag": etag}
                if entry.attr.mtime:
                    headers["Last-Modified"] = time.strftime(
                        "%a, %d %b %Y %H:%M:%S GMT",
                        time.gmtime(entry.attr.mtime))
                # conditional GETs before Range (filer_server_handlers_read
                # .go:65-80); RFC 7232 §3.3: If-Modified-Since is consulted
                # only when no If-None-Match was sent — and If-None-Match
                # is a weak-compared entity-tag LIST (utils.http)
                if not_modified(self.headers, etag, entry.attr.mtime):
                    from ..utils.stats import HTTP_CONDITIONAL_OPS

                    HTTP_CONDITIONAL_OPS.inc(plane="filer", result="304")
                    return self._reply(304, b"", headers=headers)
                rng_h = self.headers.get("Range")
                size = entry.size()
                ctype = entry.attr.mime or "application/octet-stream"
                if rng_h and not range_applies(self.headers, etag,
                                               entry.attr.mtime):
                    # If-Range with a stale validator (RFC 7233 §3.2):
                    # the Range header is IGNORED, the full current
                    # representation is served
                    from ..utils.stats import HTTP_CONDITIONAL_OPS

                    HTTP_CONDITIONAL_OPS.inc(plane="filer",
                                             result="if_range_stale")
                    rng_h = None
                if rng_h and rng_h.startswith("bytes="):
                    span = _parse_range(rng_h, size)
                    if span == "invalid":
                        return self._reply(
                            416, b"", headers={
                                "Content-Range": f"bytes */{size}"})
                    if span is not None:  # malformed ranges fall through
                        start, stop = span
                        headers["Content-Range"] = \
                            f"bytes {start}-{stop - 1}/{size}"
                        return self._stream_reply(
                            206, stop - start,
                            srv.stream_file(entry, start, stop - start),
                            ctype, headers)
                if entry.attr.md5:
                    headers["Content-MD5"] = entry.attr.md5.hex()
                return self._stream_reply(200, size,
                                          srv.stream_file(entry),
                                          ctype, headers)

        do_HEAD = do_GET

        def do_PUT(self):
            self._trace_id = ""
            path, q = self._path_q()
            srv.hot_sync()  # ordering: older hot records absorb first
            with trace.span("filer.write", carrier=self.headers,
                            component="filer", server=srv.address,
                            path=path) as tsp:
                self._trace_id = tsp.trace_id
                if self._wrong_shard_rejected(srv.shard_check_entry(path)):
                    # the unread body would desync keep-alive parsing
                    self.close_connection = True
                    return
                if self._qos_rejected(path, q, tsp, "PUT"):
                    # the unread body would desync keep-alive parsing
                    self.close_connection = True
                    return
                return self._do_put(path, q)

        def _do_put(self, path, q):
            with FILER_REQUEST_HISTOGRAM.time(type="write"):
                chunked = "chunked" in (
                    self.headers.get("Transfer-Encoding") or "").lower()
                length = None if chunked else int(
                    self.headers.get("Content-Length") or 0)
                ctype = self.headers.get("Content-Type") or ""
                kwargs = dict(
                    ttl=q.get("ttl", ""),
                    from_other_cluster=bool(
                        self.headers.get("X-From-Other-Cluster")))
                try:
                    reader = _ChunkedReader(self.rfile) if chunked \
                        else self.rfile
                    if "multipart/form-data" in ctype:
                        # form uploads must be parsed whole for boundaries
                        from .volume import _extract_upload

                        body = reader.read(length) if length is not None \
                            else _read_all(reader)
                        fname, body = _extract_upload(self.headers, body)
                        if path.endswith("/") and fname:
                            path = path + fname.decode(errors="replace")
                        entry = srv.write_file(path, body, mime="", **kwargs)
                    else:
                        # raw bodies stream straight into the autochunker
                        entry = srv.write_stream(path, reader, length,
                                                 mime=ctype, **kwargs)
                except chunk_pipeline.ShortBodyError as e:
                    # the CLIENT sent fewer bytes than it declared: a
                    # 4xx, not a server error (the saved chunks were
                    # already GC'd by write_stream). The socket is
                    # desynced by definition — close it.
                    self.close_connection = True
                    return self._json({"error": str(e)}, 400)
                except Exception as e:
                    # any failure (assign errors incl. "no writable
                    # volumes", mid-body IO) must answer 500 JSON, never
                    # abort the connection; a mid-body failure also leaves
                    # unread bytes on the socket, so the next pipelined
                    # request would parse garbage — close it
                    self.close_connection = True
                    return self._json({"error": str(e)}, 500)
                self._json({"name": entry.name, "size": entry.size()}, 201)

        do_POST = do_PUT

        def do_DELETE(self):
            self._trace_id = ""
            path, q = self._path_q()
            srv.hot_sync()
            with trace.span("filer.delete", carrier=self.headers,
                            component="filer", server=srv.address,
                            path=path) as tsp:
                self._trace_id = tsp.trace_id
                if self._wrong_shard_rejected(srv.shard_check_entry(path)):
                    return
                if self._qos_rejected(path, q, tsp, "DELETE"):
                    return
                return self._do_delete(path, q)

        def _do_delete(self, path, q):
            recursive = q.get("recursive") == "true"
            try:
                fids = srv.filer.delete_entry(path, recursive=recursive)
            except NotFound:
                return self._reply(204)
            except NotEmpty as e:
                return self._json({"error": str(e)}, 409)
            srv._gc_chunks(fids)
            self._reply(204)

    return Handler
