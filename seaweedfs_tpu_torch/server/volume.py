"""Volume server: HTTP data plane + gRPC admin plane + master heartbeat.

Counterpart of seaweedfs_tpu/server/volume.py (SeaweedFS
weed/server/volume_server.go, volume_server_handlers_{read,write}.go,
volume_grpc_*.go and volume_grpc_client_to_master.go:50-92). The data
plane speaks HTTP (PUT/GET/DELETE of "/vid,fid" needles, replica fan-out
with `?type=replicate`); the admin plane is gRPC (vacuum, allocate, mount,
copy, tail, scrub and the erasure-coding RPCs, whose shard math runs on
the store's coder: the hand-written CUDA kernels by default, through the
EC dispatch scheduler).

With `native=True` the C++ data plane (native/dataplane.py) binds the
public port and serves needle GET/PUT/DELETE itself; everything else
(status pages, EC volumes, ranges it does not take, replicated and TTL
volumes' writes) is 307-redirected to the Python listener on the admin
port (public + 11000, or an ephemeral one when that is taken).

Every RPC of the service is registered and answers as the reference's
does, tiering (`tier_backends=`, VolumeTierMoveDat*) and Query among
them; `/` and `/ui` serve the status page (server/ui.py) and `?width=` /
`?height=` resize images on read (images/). A server without a reachable master
keeps serving: the heartbeat retries and EC shard lookups cache an empty
answer, so the local shards encode, serve degraded reads, rebuild and
scrub on their own.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler

from ..utils.httpd import TunedThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import grpc
import numpy as np

from ..operation import sync_stride_marker
from ..ops import dispatch
from ..pb import master_pb2, rpc, scrub_pb2, volume_server_pb2 as vs
from ..scrub import Scrubber
from ..scrub import digest as scrub_digest
from ..storage import types
from ..storage.crc import implementation as crc_implementation
from ..storage.ec_files import (
    find_dat_file_size,
    rebuild_ec_files,
    to_host,
    write_dat_file,
    write_ec_files,
    write_idx_file_from_ec_index,
    write_sorted_file_from_idx,
)
from ..storage.ec_locate import Geometry, locate_data
from ..storage.ec_volume import EcVolume
from ..storage.errors import (
    CookieMismatch,
    DeletedError,
    NotFoundError,
    QuarantinedError,
)
from ..storage.file_id import parse_file_id
from ..storage.needle import CrcError, Needle
from ..storage.store import Store
from ..storage.ttl import TTL
from ..utils import failpoint, fanout, glog, numa, trace
from ..utils.http import not_modified, parse_range, range_applies, url_for
from ..utils.stats import (
    VOLUME_REPLICA_DELETE_FAILURES,
    VOLUME_SERVER_EC_ENCODE_BYTES,
    VOLUME_SERVER_NATIVE_REQUESTS,
    VOLUME_SERVER_REQUEST_HISTOGRAM,
    VOLUME_SERVER_VOLUME_COUNTER,
    gather,
    metrics_content_type,
    status_base,
)

BUFFER_SIZE_LIMIT = 2 * 1024 * 1024  # streaming chunk (volume_grpc_copy.go:25)
# how long the master's EC shard map of a volume is kept
# (cachedLookupEcShardLocations, store_ec.go:238), and how long a failed
# or empty answer is
EC_LOCATION_TTL_S = 10.0
EC_LOCATION_RETRY_S = 1.0



class _RateMeter:
    """Sliding-window foreground request rate — the signal the scrub
    plane backs off on (scrub must yield to client traffic). note() is
    amortized O(1): each timestamp is appended once and popped once, so
    the hot data path never pays a window-sized rebuild under the lock."""

    def __init__(self, window_s: float = 2.0):
        from collections import deque

        self.window = window_s
        self._events: "deque[float]" = deque()
        self._lock = threading.Lock()

    def note(self) -> None:
        now = time.monotonic()
        cut = now - self.window
        with self._lock:
            self._events.append(now)
            while self._events and self._events[0] < cut:
                self._events.popleft()

    def qps(self) -> float:
        cut = time.monotonic() - self.window
        with self._lock:
            while self._events and self._events[0] < cut:
                self._events.popleft()
            return len(self._events) / self.window


class VolumeServer:
    def __init__(self, *, directories: list[str], master: str,
                 ip: str = "localhost", port: int = 8080,
                 public_url: str = "", data_center: str = "", rack: str = "",
                 max_volume_counts: list[int] | None = None,
                 pulse_seconds: int = 5, coder=None,
                 ec_geometry: Geometry = Geometry(),
                 tier_backends: dict | None = None,
                 needle_map_kind: str = "memory",
                 write_jwt_key: bytes = b"",
                 guard=None, native: bool = False):
        self.write_jwt_key = write_jwt_key
        self.guard = guard  # IP whitelist (security.Guard) or None
        # C++ data plane: serves needle GET/PUT/DELETE on the public port,
        # 307s everything else to the Python listener on admin_port. Only
        # meaningful when neither JWT auth nor an IP guard is configured
        # (those checks live in the Python handlers).
        # SEAWEEDFS_TPU_NATIVE=1 forces it on process-wide, =0 forces it
        # off; unset respects the constructor argument.
        env_native = os.environ.get("SEAWEEDFS_TPU_NATIVE", "").lower()
        if env_native in ("1", "true", "on"):
            native = True
        elif env_native in ("0", "false", "off"):
            native = False
        # the C++ plane speaks 16-byte idx entries only; in large-disk
        # (5-byte offset) mode it could never serve a volume, so don't
        # bind it at all — clients keep the direct python port. Under
        # SWFS_HTTPS the public port must speak TLS, which the C++ plane
        # does not: the python listener owns the (encrypted) data plane.
        from ..utils.http import https_on

        self.native_enabled = (bool(native) and not write_jwt_key
                               and guard is None and types.OFFSET_SIZE == 4
                               and not https_on())
        self.native_plane = None
        if self.native_enabled:
            self.admin_port = rpc.derived_admin_port(port)
        else:
            self.admin_port = port
        if tier_backends:
            from ..storage.backend import load_tier_backends

            load_tier_backends(tier_backends)
        self.ip = ip
        self.port = port
        self.grpc_port = rpc.derived_grpc_port(port)
        self.masters = [m.strip() for m in master.split(",") if m.strip()]
        self.master = self.masters[0]  # HTTP address; gRPC is +10000
        self.master_grpc = rpc.grpc_address(self.master)
        self.pulse_seconds = pulse_seconds
        self.ec_geometry = ec_geometry
        self.store = Store(
            directories, coder=coder, max_volume_counts=max_volume_counts,
            ip=ip, port=port, public_url=public_url, grpc_port=self.grpc_port,
            data_center=data_center, rack=rack,
            needle_map_kind=needle_map_kind,
        )
        self.volume_size_limit = 30_000 * 1024 * 1024
        self._grpc_server = None
        self._http_server = None
        self._stop = threading.Event()
        self._hb_wake = threading.Event()
        self._native_lock = threading.Lock()
        self._native_vids: dict[int, bool] = {}
        # volumes whose .dat is moving to a tier backend: the plane must
        # not take them while the move holds the volume's lock
        self._native_moving: set[int] = set()
        # vid -> {shard_id: [addresses]} with expiry (store_ec.go:238 cache)
        self._ec_loc_cache: dict[int, tuple[float, dict[int, list[str]]]] = {}
        self._loc_cache: dict[int, tuple[float, list[str]]] = {}
        # reconstructed-interval LRU for degraded EC reads: a hot lost
        # shard pays the k-survivor fetch + device dispatch once per
        # block; invalidated on shard mount/unmount/delete (the gRPC
        # handlers below). SWFS_EC_RECON_CACHE_MB=0 disables it.
        self.ec_recon_cache = dispatch.ReconstructIntervalCache()
        # integrity plane: the paced background scrubber —
        # needle CRC sweeps, EC syndrome verification, anti-entropy and
        # the self-healing repair ladder (scrub/scrubber.py). The
        # foreground rate meter is what it backs off on.
        self._fg_rate = _RateMeter()
        self.scrubber = Scrubber(self.store, self)
        # QoS plane: every background byte (repair > scrub /
        # archival, strict priority) passes through the governor, which
        # leases cluster-wide budgets from the master over QosGrant and
        # reports this server's pressure score on each refresh.
        # Unconfigured env = no-op gate.
        from ..qos import BackgroundGovernor

        self.qos_governor = BackgroundGovernor(self)
        # response-stamped pressure: ordinary
        # read/write replies carry the live score so clients learn about
        # building backpressure from traffic they already have in
        # flight, BEFORE the first 429
        self._pressure_stamp = "0.0"
        self._pressure_stamp_at = 0.0
        self._started_at = time.time()

    @property
    def address(self) -> str:
        return f"{self.ip}:{self.port}"

    def ec_dispatch_depths(self) -> dict[str, int]:
        """Live queued-slab depth per chip lane of this store's EC
        dispatch scheduler ({} until EC work has attached one) — the
        /status signal that shows which chips' queues are filling."""
        sched = getattr(self.store.coder, "_ec_dispatch_sched", None)
        if sched is None or sched.closed:
            return {}
        return sched.chip_depths()

    def ec_dispatch_arena(self) -> dict:
        """Live stack-arena snapshot of this store's scheduler:
        pooled/in-use/quarantined buffers — the host memory plane's
        working-set view, complementing the cumulative counters in
        ec_dispatch_stats()."""
        sched = getattr(self.store.coder, "_ec_dispatch_sched", None)
        if sched is None or sched.closed:
            return {}
        return sched.arena_stats()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        trace.set_identity("volume", self.address)
        self._grpc_server = rpc.new_server()
        creds = rpc.add_servicer(self._grpc_server, rpc.VOLUME_SERVICE,
                                 VolumeGrpc(self), component="volume",
                                 address=self.address)
        rpc.serve_port(self._grpc_server, f"[::]:{self.grpc_port}",
                       "volume", creds=creds)
        self._grpc_server.start()
        handler = _make_http_handler(self)
        # HTTPS data plane: TLS on the public listener when
        # SWFS_HTTPS / security.toml [https.volume] configure it
        from ..security.tls import load_http_server_context

        https_ctx = load_http_server_context("volume")
        try:
            self._http_server = TunedThreadingHTTPServer(
                ("", self.admin_port), handler, ssl_context=https_ctx)
        except OSError:
            if not self.native_enabled:
                raise
            # deterministic admin port (public+11000) taken by another
            # process: fall back to an ephemeral one — only redirects
            # reference it, via the Location header
            self._http_server = TunedThreadingHTTPServer(
                ("", 0), handler, ssl_context=https_ctx)
            self.admin_port = self._http_server.server_address[1]
        threading.Thread(target=self._http_server.serve_forever, daemon=True).start()
        if self.native_enabled:
            from ..native import NativeDataPlane

            self.native_plane = NativeDataPlane(
                "", self.port, self.admin_port, nthreads=8)
            self._sync_native_registry()
        threading.Thread(target=self._heartbeat_loop, daemon=True).start()
        threading.Thread(target=self._check_with_master, daemon=True).start()
        report_s = float(os.environ.get("SWFS_QOS_REPORT_S", "0") or 0)
        if report_s <= 0 and (self.qos_governor.enabled()
                              or float(os.environ.get(
                                  "SWFS_QOS_SHED_PRESSURE", "0") or 0) > 0):
            report_s = 1.0  # QoS plane active: default 1s pressure feed
        if report_s > 0:
            threading.Thread(target=self._qos_report_loop,
                             args=(report_s,), daemon=True).start()
        self.scrubber.start()
        # crash-consistency handoff: every volume the mount
        # ladder repaired gets a targeted verify — the fabric re-checks
        # it against replicas and re-replicates acked-but-local-lost
        # needles, closing the zero-acked-loss contract cluster-wide
        for vid in getattr(self.store.recovery_report, "suspects", []):
            self.scrubber.report_suspect(vid)
        glog.info(f"volume server started on {self.address} "
                  f"(grpc :{self.grpc_port}"
                  + (", https" if https_ctx is not None else "")
                  + (f", native data plane, admin :{self.admin_port})"
                     if self.native_plane else ", python data plane)"))

    def _sync_native_registry(self) -> None:
        """Reconcile the C++ plane's volume registry with the store: add
        new volumes, drop gone ones, track read-only flips. Called at
        start, every heartbeat, and after volume lifecycle RPCs."""
        plane = self.native_plane
        if plane is None:
            return
        with self._native_lock:  # heartbeat + gRPC handlers race here
            current: dict[int, object] = {}
            for loc in self.store.locations:
                current.update(loc.volumes)
            registered = self._native_vids
            for vid, v in current.items():
                if (v.is_tiered or v._dat is None or v._gc_frozen
                        or vid in self._native_moving):
                    # frozen: un-flushable buffered bytes — handing the
                    # plane write authority (attach flushes) would raise
                    continue
                if types.OFFSET_SIZE != 4:
                    # the C++ plane reads/writes 16-byte idx entries only;
                    # large-disk (5-byte offset, 17B stride) volumes stay
                    # on the python engine
                    continue
                writable = (not v.read_only
                            and v.super_block.replica_placement.copy_count == 1
                            and not str(v.ttl))
                if vid not in registered:
                    base = v.file_name()
                    try:
                        plane.add_volume(vid, base + ".dat", base + ".idx",
                                         v.version, writable)
                    except OSError:
                        continue
                    v.native_writable = writable
                    v.attach_native(plane)
                    registered[vid] = writable
                elif registered[vid] != writable:
                    plane.set_writable(vid, writable)
                    v.native_writable = writable
                    registered[vid] = writable
            for vid in list(registered):
                if vid not in current:
                    plane.remove_volume(vid)
                    registered.pop(vid)
            # absorb C++-appended idx entries so nm counters (heartbeats,
            # vacuum decisions) stay authoritative
            for vid in registered:
                v = current.get(vid)
                if v is not None:
                    v.sync_native()

    @contextlib.contextmanager
    def _native_released(self, vid: int):
        """Keep one volume out of the C++ plane's registry while its
        `.dat` moves to a tier backend. The plane holds the `.dat` open,
        and the move holds the volume's lock for the whole upload, which
        a registry sync that took the volume back would wait on. Once
        the `.dat` is remote, `_sync_native_registry` skips the volume
        because it is tiered; after a download it takes it back."""
        with self._native_lock:
            self._native_moving.add(vid)
            if self._native_vids.pop(vid, None) is not None:
                self.native_plane.remove_volume(vid)
                v = self.store.find_volume(vid)
                if v is not None:
                    v.detach_native()
        try:
            yield
        finally:
            with self._native_lock:
                self._native_moving.discard(vid)

    def _check_with_master(self) -> None:
        """checkWithMaster (volume_grpc_client_to_master.go:28-47): pull
        cluster config — start pushing metrics if the master names a
        push gateway."""
        from ..utils.stats import start_push

        while not self._stop.is_set():
            try:
                resp = rpc.master_stub(self.master_grpc) \
                    .GetMasterConfiguration(
                        master_pb2.GetMasterConfigurationRequest(),
                        timeout=10)
                if resp.metrics_address:
                    self._stop_metrics_push = start_push(
                        resp.metrics_address,
                        f"volumeServer-{self.port}",
                        resp.metrics_interval_seconds or 15)
                return
            except grpc.RpcError:
                if self._stop.wait(2.0):
                    return

    def stop(self) -> None:
        self._stop.set()
        self._hb_wake.set()
        self.scrubber.stop()
        stop_push = getattr(self, "_stop_metrics_push", None)
        if stop_push is not None:
            stop_push()
        if self._http_server:
            self._http_server.shutdown()
        if self._grpc_server:
            self._grpc_server.stop(grace=0.5)
        if self.native_plane is not None:
            self.native_plane.stop()
            self.native_plane = None
        self.store.close()

    # -- heartbeat client (volume_grpc_client_to_master.go:50-92) ----------

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._do_heartbeat()
            except grpc.RpcError as e:
                glog.v(1, f"heartbeat to {self.master} failed: {e.code()}")
                # rotate to the next configured master; a leader redirect
                # may have pointed self.master outside the configured list
                if len(self.masters) > 1:
                    if self.master in self.masters:
                        i = self.masters.index(self.master)
                        nxt = self.masters[(i + 1) % len(self.masters)]
                    else:
                        nxt = self.masters[0]
                    self.master = nxt
                    self.master_grpc = rpc.grpc_address(nxt)
            if not self._stop.is_set():
                self._stop.wait(1.0)

    def _do_heartbeat(self) -> None:
        stub = rpc.master_stub(self.master_grpc)

        def requests():
            while not self._stop.is_set():
                self._sync_native_registry()
                yield self.store.collect_heartbeat()
                self._hb_wake.wait(self.pulse_seconds)
                self._hb_wake.clear()

        for resp in stub.SendHeartbeat(requests()):
            if resp.volume_size_limit:
                self.volume_size_limit = resp.volume_size_limit
            if resp.leader and resp.leader != self.master:
                # follow the Raft leader (checkWithMaster redirect)
                glog.info(f"heartbeat redirected to leader {resp.leader}")
                self.master = resp.leader
                self.master_grpc = rpc.grpc_address(resp.leader)
                return
            VOLUME_SERVER_VOLUME_COUNTER.set(
                sum(len(l.volumes) for l in self.store.locations)
            )
            plane = self.native_plane  # stop() may null it concurrently
            if plane is not None:
                from ..utils.stats import HTTP_NATIVE_SENDFILE

                VOLUME_SERVER_NATIVE_REQUESTS.set(plane.request_count())
                HTTP_NATIVE_SENDFILE.set(plane.sendfile_count())
            if self._stop.is_set():
                return

    def trigger_heartbeat(self) -> None:
        self._hb_wake.set()

    # -- needle read incl. EC (store.go:410 / store_ec.go:136) -------------

    def foreground_qps(self) -> float:
        """Client data-plane request rate; the scrubber backs off on it."""
        return self._fg_rate.qps()

    # -- QoS plane -----------------------------------------------

    def qos_group_commit_depth(self) -> int:
        """Writes registered for a group-commit flush but not yet covered
        by one, summed over volumes — the write-plane half of the
        pressure score (the aggregate view of the gcWaitMs spans)."""
        total = 0
        for loc in self.store.locations:
            for v in list(loc.volumes.values()):
                total += max(0, v._gc_seq - v._gc_flushed)
        return total

    def pressure_header_value(self) -> str:
        """Cached [0,1] score for per-reply stamping: recomputed at most
        every 0.25s, so the per-request cost is one field read instead
        of a full volume walk."""
        import time as _time

        now = _time.monotonic()
        if now >= self._pressure_stamp_at:
            self._pressure_stamp = f"{self.qos_pressure():.4f}"
            self._pressure_stamp_at = now + 0.25
        return self._pressure_stamp

    def qos_pressure(self, gc_depth: int | None = None,
                     dispatch_depth: int | None = None) -> float:
        """This server's [0,1] backpressure score: group-commit buffer
        depth folded with EC-dispatch queue depth (qos/pressure.py).
        Rides every QosGrant refresh to the master, which folds it into
        assign placement and early shedding. Callers that already
        sampled the depths pass them in (one volume walk, one score)."""
        from ..qos import pressure_score
        from ..qos.pressure import SIGNAL
        from ..utils.stats import QOS_PRESSURE

        if gc_depth is None:
            gc_depth = self.qos_group_commit_depth()
        if dispatch_depth is None:
            dispatch_depth = sum(self.ec_dispatch_depths().values())
        p = pressure_score(gc_depth, dispatch_depth)
        QOS_PRESSURE.set(p)
        # feed the process-local hot signal: in combined
        # topologies (`weed server -filer` — filer + volume in one
        # process) the pipelined chunk engine collapses its windows
        # when this server's own queues cross the shed threshold,
        # BEFORE the first 429/503 is ever emitted
        SIGNAL.report_score(p)
        return p

    def qos_acquire(self, work_class: str, nbytes: int) -> float:
        """Background-work admission: delegate to the governor (no-op
        when the cluster budget is unconfigured). QosUnavailable
        propagates — callers pause their background work (fail closed),
        never surface it to a foreground client."""
        return self.qos_governor.acquire(work_class, nbytes)

    def _qos_report_loop(self, interval: float) -> None:
        """Periodic pressure-only QosGrant (work_class "") so the master
        sees THIS server's pressure even while no background work is
        drawing tokens — foreground-induced pressure must reach assign
        placement too."""
        from ..pb import qos_pb2, rpc as _rpc

        while not self._stop.wait(interval):
            try:
                gc_depth = self.qos_group_commit_depth()
                dispatch_depth = sum(self.ec_dispatch_depths().values())
                _rpc.master_stub(self.master_grpc).QosGrant(
                    qos_pb2.QosGrantRequest(
                        address=self.address, work_class="",
                        requested_bytes=0,
                        pressure=self.qos_pressure(gc_depth,
                                                   dispatch_depth),
                        gc_depth=gc_depth,
                        dispatch_depth=dispatch_depth),
                    timeout=5)
            # lint: allow-broad-except(best-effort pressure telemetry;
            # the next 1s tick retries and a down master is routine —
            # real token draws fail closed through the governor)
            except Exception:  # noqa: BLE001
                continue

    def read_needle(self, vid: int, needle_id: int, cookie: int | None):
        v = self.store.find_volume(vid)
        if v is not None:
            try:
                return v.read_needle(needle_id, cookie)
            except QuarantinedError:
                # scrub quarantined the local record mid-repair: answer
                # from a healthy replica so the client never sees either
                # the corrupt bytes or an error
                n = self._read_needle_from_replica(v, needle_id, cookie)
                if n is not None:
                    return n
                raise
        ev = self.store.find_ec_volume(vid)
        if ev is not None:
            return self._read_ec_needle(ev, vid, needle_id, cookie)
        raise NotFoundError(f"volume {vid} not found")

    def _read_needle_from_replica(self, v, needle_id: int,
                                  cookie: int | None) -> Needle | None:
        from ..scrub.scrubber import fetch_needle_from_replicas

        n = fetch_needle_from_replicas(self, v.id, needle_id, v.version)
        if n is None:
            return None
        if cookie is not None and n.cookie != cookie:
            raise CookieMismatch("cookie mismatch on replica read")
        if n.has_expired():
            raise NotFoundError(f"needle {needle_id:x} expired")
        return n

    def _read_ec_needle(self, ev: EcVolume, vid: int, needle_id: int,
                        cookie: int | None) -> Needle:
        offset, size = ev.find_needle(needle_id)
        if types.size_is_deleted(size):
            raise DeletedError(f"needle {needle_id:x} deleted")
        length = types.actual_size(size, ev.version)

        def parse_verified(blob: bytes) -> Needle:
            n = Needle.from_bytes(blob, ev.version, expected_size=size)
            if cookie is not None and n.cookie != cookie:
                # under suspected rot a cookie mismatch is ambiguous
                # (rotten header byte vs bad client) — let the ladder
                # decide by reconstructing; a genuine bad cookie fails
                # the same way against the reconstructed bytes too
                raise CookieMismatch("cookie mismatch on EC read")
            return n

        # extent-read failures (unreachable shards, failed reconstruct)
        # propagate directly: the self-heal ladder below is ONLY for
        # bytes that were read but failed verification — retrying an
        # infrastructure failure per candidate shard would turn one
        # failing read into N expensive k-survivor gathers
        blob = self._read_ec_extent(ev, vid, offset, length)
        try:
            return parse_verified(blob)
        except (CrcError, ValueError, IOError, CookieMismatch) as first:
            # The record failed verification straight off local shard
            # files (IOError here is parse-level: a flipped size byte
            # reads as SizeMismatch/short-body, not a CRC error;
            # CookieMismatch covers cookie-byte rot). One of the shards
            # this needle touches has rotted on disk — but which one
            # isn't knowable from the failure alone. Retry once per
            # candidate shard, reconstructing the extent with that shard
            # excluded everywhere (13 survivors still >= k): the
            # candidate whose exclusion yields a verified parse is the
            # rotten one. The client gets clean bytes; the volume is
            # queued for a targeted scrub + durable rebuild.
            intervals = locate_data(ev.geo, ev.dat_size_estimate, offset,
                                    length)
            sids = list(dict.fromkeys(
                iv.to_shard_id_and_offset(ev.geo)[0] for iv in intervals))
            if isinstance(first, CookieMismatch):
                # the cookie lives in the record HEADER, i.e. the first
                # interval's shard — one candidate bounds the work, so a
                # client sending a genuinely wrong cookie costs one
                # reconstruction, not one per shard (request
                # amplification)
                sids = sids[:1]
            for suspect in sids:
                try:
                    n = parse_verified(self._read_ec_extent(
                        ev, vid, offset, length, exclude_shard=suspect))
                except (CrcError, ValueError, IOError, CookieMismatch):
                    continue
                self.scrubber.report_suspect(vid)
                glog.warning(
                    f"ec vol {vid} needle {needle_id:x}: local shard "
                    f"bytes failed verification (suspect shard "
                    f"{suspect}); served via reconstruction, scrub "
                    f"queued")
                return n
            raise

    def _read_ec_extent(self, ev: EcVolume, vid: int, offset: int,
                        length: int,
                        exclude_shard: int | None = None) -> bytes:
        """readEcShardIntervals (store_ec.go:176): local shard file, else
        remote peer holding the shard, else reconstruct from any k. With
        `exclude_shard`, that shard's local bytes are treated as rotten:
        its intervals reconstruct around it and it is never used as a
        survivor (scrub self-heal)."""
        intervals = locate_data(ev.geo, ev.dat_size_estimate, offset, length)
        out = bytearray()
        for iv in intervals:
            sid, soff = iv.to_shard_id_and_offset(ev.geo)
            if exclude_shard is not None and sid == exclude_shard:
                out += self._reconstruct_range(
                    ev, vid, sid, soff, iv.size,
                    self._lookup_ec_shards(vid), exclude={exclude_shard})
            else:
                out += self._read_ec_interval(ev, vid, sid, soff, iv.size)
        return bytes(out)

    def _read_ec_interval(self, ev: EcVolume, vid: int, sid: int,
                          soff: int, size: int) -> bytes:
        f = ev.shard_files.get(sid)
        if f is not None:
            try:
                # chaos hook: a lost/unreadable local shard pushes the
                # read down the remote-peer / reconstruct-from-any-k path
                failpoint.fail("ec.shard.read",
                               ctx=f"{self.address}, shard={sid},")
                data = f.read_at(soff, size)
                return data + b"\0" * (size - len(data))
            except OSError as e:  # includes injected FailpointError
                glog.v(1, f"ec vol {vid} shard {sid} local read failed "
                          f"({e}); degrading to remote/reconstruct")
        locs, cached = self._ec_shard_locations(vid)
        while True:
            for addr in locs.get(sid, []):
                if addr == self.address:
                    continue
                try:
                    return self._remote_shard_read(addr, vid, sid, soff,
                                                   size)
                except grpc.RpcError:
                    # a holder that no longer answers: the next lookup
                    # asks the master
                    self._ec_loc_cache.pop(vid, None)
                    continue
            # degraded: gather k intervals from local+remote shards in
            # parallel (recoverOneRemoteEcShardInterval,
            # store_ec.go:339-393)
            try:
                return self._reconstruct_interval(ev, vid, sid, soff, size,
                                                  locs)
            except IOError:
                if not cached:
                    raise
            # the cached map may predate a lost server, a rebuild or a
            # master that answers again: ask the master once more
            locs, cached = self._ec_shard_locations(vid, refresh=True)

    def _remote_shard_read(self, addr: str, vid: int, sid: int,
                           soff: int, size: int) -> bytes:
        stub = rpc.volume_stub(rpc.grpc_address(addr))
        buf = bytearray()
        for resp in stub.VolumeEcShardRead(vs.VolumeEcShardReadRequest(
                volume_id=vid, shard_id=sid, offset=soff, size=size), timeout=60):
            buf += resp.data
        buf += b"\0" * (size - len(buf))
        return bytes(buf)

    def _reconstruct_interval(self, ev: EcVolume, vid: int, sid: int,
                              soff: int, size: int,
                              locs: dict[int, list[str]]) -> bytes:
        """Degraded read: serve [soff, soff+size) of a lost shard.

        Rides the reconstructed-interval cache (block-aligned, LRU,
        invalidated on shard mount/unmount/delete) so repeated degraded
        reads of a hot lost shard stop paying a full k-shard fetch +
        device dispatch each; cache-miss blocks and cache-off reads go
        through `_reconstruct_range`, whose dispatches micro-batch with
        every other concurrent degraded read via the EC dispatch
        scheduler."""
        cache = self.ec_recon_cache
        if (cache is None or not cache.enabled()
                or len(ev.shard_files) < ev.geo.data_shards):
            # remote-survivor reconstructs stay interval-sized: block-
            # aligning them would multiply the remote fetch traffic by
            # up to block/interval per missing local shard
            return self._reconstruct_range(ev, vid, sid, soff, size, locs)
        out = bytearray()
        bs = cache.block_size
        gen = cache.generation(vid)  # before any survivor bytes are read
        for blk in cache.blocks_for(soff, size):
            start = blk * bs
            blen = min(bs, max(ev.shard_size, soff + size) - start)
            data = cache.get(vid, sid, blk)
            if data is None:
                data = self._reconstruct_range(
                    ev, vid, sid, start, blen, locs)
                cache.put(vid, sid, blk, data, gen=gen)
            lo = max(soff, start) - start
            hi = min(soff + size, start + blen) - start
            out += data[lo:hi]
        if len(out) < size:  # interval ran past the cached shard extent
            out += b"\0" * (size - len(out))
        return bytes(out)

    def _reconstruct_range(self, ev: EcVolume, vid: int, sid: int,
                           soff: int, size: int,
                           locs: dict[int, list[str]],
                           exclude: set[int] | None = None) -> bytes:
        """recoverOneRemoteEcShardInterval (store_ec.go:339-393): gather k
        survivor intervals (local + remote, in parallel), then reconstruct
        through the stacked fast path — concurrent calls sharing a
        survivor set coalesce into one device dispatch. Shards in
        `exclude` are never used as survivors (scrub self-heal: their
        bytes exist locally but are suspected rotten)."""
        with trace.span("volume.ec.reconstruct", child_only=True,
                        server=self.address, vid=vid, shard=sid,
                        size=size) as tsp:
            out = self._reconstruct_range_traced(
                ev, vid, sid, soff, size, locs, exclude, tsp)
        return out

    def _reconstruct_range_traced(self, ev, vid, sid, soff, size, locs,
                                  exclude, tsp) -> bytes:
        geo = ev.geo
        exclude = exclude or set()
        out = self._reconstruct_range_planned(ev, vid, sid, soff, size,
                                              locs, exclude, tsp)
        if out is not None:
            return out
        bufs: dict[int, np.ndarray] = {}
        for i, f in ev.shard_files.items():
            if i in exclude:
                continue
            try:
                failpoint.fail("ec.shard.read",
                               ctx=f"{self.address}, shard={i},")
                data = f.read_at(soff, size)
            except OSError:  # includes injected FailpointError
                continue  # survivor set shrinks; any k still suffice
            bufs[i] = np.frombuffer(data + b"\0" * (size - len(data)), np.uint8)

        missing = [
            i for i in range(geo.total_shards)
            if i not in bufs and i != sid and i not in exclude
            and locs.get(i)
        ]

        def fetch(i):
            for addr in locs.get(i, []):
                if addr == self.address:
                    continue
                try:
                    return i, np.frombuffer(
                        self._remote_shard_read(addr, vid, i, soff, size), np.uint8)
                except grpc.RpcError:
                    continue
            return i, None

        from ..models.geometry import UnsolvableError

        try:
            geom = geo.code_geometry()
        except ValueError:
            geom = None

        def solvable() -> bool:
            # RS: any k survivors decode (the historical count check).
            # Non-RS: k survivors may be rank-deficient for THIS shard
            # (e.g. a local parity among them) — ask the solver, so the
            # remote fetch keeps going until sid is actually spanned.
            if geom is None or geom.is_rs:
                return len(bufs) >= geo.data_shards
            if sid in bufs:
                return True
            try:
                geom.repair_matrix(tuple(sorted(bufs)), (sid,))
                return True
            except (UnsolvableError, ValueError):
                return False

        if not solvable() and missing:
            # lint: allow-executor — lazy ex.map + early break once the
            # solver is satisfied needs a scoped pool whose exit joins
            # the stragglers; bounded by the shard count (<= 13 tasks)
            with ThreadPoolExecutor(max_workers=8) as ex:
                for i, arr in ex.map(fetch, missing):
                    if arr is not None:
                        bufs[i] = arr
                    if solvable():
                        break
        if not solvable():
            raise IOError(
                f"ec volume {vid}: {len(bufs)} reachable shards "
                f"({geo.code_name}) cannot reconstruct shard {sid}")
        if sid in bufs:  # a flaky local read healed mid-gather
            return bufs[sid].tobytes()
        pres = tuple(sorted(bufs))  # canonical order -> shared lane
        tsp.set_attr(survivors=len(pres))
        # RS keeps want=None: concurrent readers of DIFFERENT lost
        # shards sharing a survivor set coalesce into one fused dispatch
        # (the micro-batch); non-RS solves just sid — the full
        # complement may be unsolvable even when sid is.
        want = None if (geom is None or geom.is_rs) else (sid,)
        try:
            mids, rows = dispatch.reconstruct_now(
                ev.coder, pres, np.stack([bufs[i] for i in pres]),
                want=want)
        except (UnsolvableError, ValueError) as e:
            raise IOError(
                f"ec volume {vid}: survivors {pres} do not span "
                f"shard {sid}") from e
        return to_host(rows[list(mids).index(sid)]).tobytes()

    def _reconstruct_range_planned(self, ev, vid, sid, soff, size, locs,
                                   exclude, tsp) -> bytes | None:
        """Minimal-read degraded reconstruct: the geometry's
        repair plan names the survivors — a lost shard inside an LRC
        local group gathers its 5 group peers (local reads preferred)
        instead of any k=10. Returns None when a planned read fails or
        the plan is unsolvable; the caller then runs the generic any-k
        gather, which remains the correctness backstop."""
        from ..models.geometry import UnsolvableError
        from ..utils.stats import EC_REPAIR_BYTES, EC_REPAIR_PLANS

        geo = ev.geo
        try:
            geom = geo.code_geometry()
        except ValueError:
            return None
        local = set(ev.shard_files) - exclude - {sid}
        remote = {i for i, addrs in locs.items()
                  if addrs and i not in exclude and i != sid} - local
        plan = None
        for cand in (tuple(sorted(local)),
                     tuple(sorted(local | remote))):
            try:
                plan = geom.repair_plan((sid,), cand)
                break
            except (UnsolvableError, ValueError):
                continue
        if plan is None:
            return None
        bufs: dict[int, np.ndarray] = {}
        need_remote: list[int] = []
        for i in plan.reads:
            f = ev.shard_files.get(i)
            if f is not None and i not in exclude:
                try:
                    failpoint.fail("ec.shard.read",
                                   ctx=f"{self.address}, shard={i},")
                    data = f.read_at(soff, size)
                    bufs[i] = np.frombuffer(
                        data + b"\0" * (size - len(data)), np.uint8)
                    continue
                except OSError:
                    pass  # fall through to a remote copy, if any
            need_remote.append(i)
        n_local = len(bufs)

        def fetch_planned(i):
            for addr in locs.get(i, []):
                if addr == self.address:
                    continue
                try:
                    return i, np.frombuffer(self._remote_shard_read(
                        addr, vid, i, soff, size), np.uint8)
                except grpc.RpcError:
                    continue
            return i, None

        if need_remote:
            # gather the plan's remote survivors CONCURRENTLY — the
            # minimal-read path must pay max(RTT), not sum(RTT), or it
            # loses to the parallel any-k backstop it exists to beat
            # lint: allow-executor — scoped pool: the all-or-nothing
            # early return (None -> generic path) must join every fetch
            with ThreadPoolExecutor(
                    max_workers=min(8, len(need_remote))) as ex:
                for i, arr in ex.map(fetch_planned, need_remote):
                    if arr is None:
                        return None  # planned survivor unreachable:
                        #              generic path takes over
                    bufs[i] = arr
        n_remote = len(need_remote)
        pres = tuple(sorted(bufs))  # canonical order -> shared lane
        tsp.set_attr(survivors=len(pres), repairPlan=geo.code_name)
        # RS: want=None so concurrent readers of different lost shards
        # sharing a survivor set keep coalescing into ONE fused dispatch
        #; non-RS solves exactly sid (the plan's survivor set
        # may not span the full complement)
        want = None if geom.is_rs else (sid,)
        try:
            mids, rows = dispatch.reconstruct_now(
                ev.coder, pres, np.stack([bufs[i] for i in pres]),
                want=want)
        except (UnsolvableError, ValueError, TypeError):
            return None
        if n_local:
            EC_REPAIR_BYTES.inc(n_local * size, geometry=geo.code_name,
                                kind="degraded_read", source="local")
        if n_remote:
            EC_REPAIR_BYTES.inc(n_remote * size, geometry=geo.code_name,
                                kind="degraded_read", source="remote")
        EC_REPAIR_PLANS.inc(geometry=geo.code_name, kind="degraded_read")
        return to_host(rows[list(mids).index(sid)]).tobytes()

    def _lookup_ec_shards(self, vid: int,
                          refresh: bool = False) -> dict[int, list[str]]:
        """cachedLookupEcShardLocations (store_ec.go:238): the master's
        EC shard map of `vid`, cached as _ec_shard_locations says."""
        return self._ec_shard_locations(vid, refresh)[0]

    def _ec_shard_locations(self, vid: int, refresh: bool = False
                            ) -> tuple[dict[int, list[str]], bool]:
        """-> (the master's EC shard map of `vid`, whether it came from
        the cache). A map is kept EC_LOCATION_TTL_S; a failed or empty
        lookup only EC_LOCATION_RETRY_S, as lookup_volume_locations keeps
        its empty answers, so that a master that answers again is asked
        again. `refresh` skips the cache."""
        now = time.time()
        cached = None if refresh else self._ec_loc_cache.get(vid)
        if cached and cached[0] > now:
            return cached[1], True
        out: dict[int, list[str]] = {}
        try:
            stub = rpc.master_stub(self.master_grpc)
            resp = stub.LookupEcVolume(
                master_pb2.LookupEcVolumeRequest(volume_id=vid), timeout=10)
            for sl in resp.shard_id_locations:
                out[sl.shard_id] = [l.url for l in sl.locations]
        except grpc.RpcError as e:
            glog.v(1, f"LookupEcVolume {vid}: {e.code()}")
        ttl = EC_LOCATION_TTL_S if out else EC_LOCATION_RETRY_S
        self._ec_loc_cache[vid] = (now + ttl, out)
        return out, False

    # -- replication (topology/store_replicate.go:24) ----------------------

    def replicate_write(self, fid: str, body: bytes, params: dict,
                        locations: list[str],
                        content_type: str = "",
                        content_encoding: str = "") -> None:
        """Send a write to the volume's other replicas
        (topology/store_replicate.go:24); the first failed leg raises once
        every leg has settled."""
        from ..wdclient import pool

        # the body is forwarded VERBATIM (possibly gzipped, possibly a
        # multipart envelope), so the headers describing it must travel
        # too: without Content-Encoding the replica stores compressed
        # bytes with is_compressed unset and later serves raw gzip to
        # readers (silent corruption on replica failover)
        headers = trace.inject_headers({})  # replicas join the trace
        if content_type:
            headers["Content-Type"] = content_type
        if content_encoding:
            headers["Content-Encoding"] = content_encoding
        # replicas enforce JWT like any write; re-sign with the shared
        # cluster key (the reference re-mints for fan-out the same way)
        if self.write_jwt_key:
            from ..security import gen_write_jwt

            headers["Authorization"] = \
                f"Bearer {gen_write_jwt(self.write_jwt_key, fid)}"

        def send(addr):
            # the replica leg rides the keep-alive pool: the primary
            # holds one warm connection per replica instead of a TCP(+TLS)
            # dial per replicated write
            url = url_for(addr, f"{fid}?type=replicate")
            for k, v in params.items():
                url += f"&{k}={v}"
            try:
                r = pool.put(url, body=body, headers=headers, timeout=30)
            except OSError as e:
                raise IOError(f"replica write to {addr}: {e}") from e
            if r.status >= 300:
                raise IOError(f"replica write to {addr}: {r.status}")

        # shared bounded fan-out executor: no thread spawn per replicated
        # write. run_all waits for every send to settle before raising
        # the first failure. The "replicate" tier, NOT the pipeline tier:
        # in a combined process, pipeline-tier uploads block on this very
        # handler — sharing their pool would be a circular wait.
        fanout.run_all(send, [a for a in locations if a != self.address],
                       pool="replicate")

    def lookup_volume_locations(self, vid: int) -> list[str]:
        """Replica locations for a volume, cached ~10s (the write hot path
        calls this per request; GetWritableRemoteReplications in the
        reference resolves peers from its own topology push instead —
        store_replicate.go:188)."""
        now = time.monotonic()
        hit = self._loc_cache.get(vid)
        if hit and hit[0] > now:
            return hit[1]
        locs: list[str] = []
        ok = False
        try:
            stub = rpc.master_stub(self.master_grpc)
            resp = stub.LookupVolume(
                master_pb2.LookupVolumeRequest(volume_or_file_ids=[str(vid)]),
                timeout=10)
            for e in resp.volume_id_locations:
                locs = [l.url for l in e.locations]
                break
            ok = bool(locs)  # empty list = master still warming: short TTL
        except grpc.RpcError:
            pass
        # a failed/empty lookup must not disable replication for a full
        # TTL — cache it only long enough to ride out a hiccup
        self._loc_cache[vid] = (now + (10.0 if ok else 1.0), locs)
        return locs

    def volume_needs_replication(self, vid: int) -> bool:
        """False when the volume's own superblock says single-copy (the
        common case) — skips the per-write location lookup entirely."""
        v = self.store.find_volume(vid)
        if v is None:
            return True  # unknown here: let the lookup decide
        return v.super_block.replica_placement.copy_count > 1


# -- gRPC admin servicer ---------------------------------------------------

class VolumeGrpc:
    def __init__(self, srv: VolumeServer):
        self.srv = srv
        self.store = srv.store

    # ---- batch delete

    def BatchDelete(self, request, context):
        resp = vs.BatchDeleteResponse()
        for fid in request.file_ids:
            res = resp.results.add(file_id=fid)
            try:
                f = parse_file_id(fid)
                cookie = None if request.skip_cookie_check else f.cookie
                res.size = self.store.delete_needle(f.volume_id, f.key, cookie)
                res.status = 202
            except Exception as e:  # noqa: BLE001
                res.status, res.error = 500, str(e)
        return resp

    # ---- vacuum

    def VacuumVolumeCheck(self, request, context):
        v = self._volume(request.volume_id, context)
        return vs.VacuumVolumeCheckResponse(garbage_ratio=v.garbage_level())

    def VacuumVolumeCompact(self, request, context):
        from ..storage.errors import VacuumCrcError

        v = self._volume(request.volume_id, context)
        try:
            v.compact()
        except VacuumCrcError:
            # the scrub-aware vacuum found ROT while copying (not some
            # environmental IOError): abort is already done (compact
            # never commits bad bytes) — queue the repair ladder so the
            # NEXT vacuum finds a healed volume
            self.srv.scrubber.report_suspect(request.volume_id)
            raise
        yield vs.VacuumVolumeCompactResponse(processed_bytes=v.data_size())

    def VacuumVolumeCommit(self, request, context):
        v = self._volume(request.volume_id, context)
        v.commit_compact()
        return vs.VacuumVolumeCommitResponse(
            is_read_only=v.read_only, volume_size=v.data_size())

    def VacuumVolumeCleanup(self, request, context):
        v = self._volume(request.volume_id, context)
        base = v.file_name()
        for ext in (".cpd", ".cpx"):
            try:
                os.remove(base + ext)
            except FileNotFoundError:
                pass
        v.is_compacting = False
        return vs.VacuumVolumeCleanupResponse()

    # ---- collections / allocation

    def DeleteCollection(self, request, context):
        self.store.delete_collection(request.collection)
        self.srv.trigger_heartbeat()
        return vs.DeleteCollectionResponse()

    def AllocateVolume(self, request, context):
        self.store.add_volume(
            request.volume_id, request.collection,
            request.replication, request.ttl,
        )
        self.srv.trigger_heartbeat()
        self.srv._sync_native_registry()
        return vs.AllocateVolumeResponse()

    # ---- status / sync

    def VolumeSyncStatus(self, request, context):
        v = self._volume(request.volume_id, context)
        return vs.VolumeSyncStatusResponse(
            volume_id=v.id, collection=v.collection,
            replication=str(v.super_block.replica_placement),
            ttl=str(v.ttl), tail_offset=v.data_size(),
            compact_revision=v.super_block.compaction_revision,
            idx_file_size=os.path.getsize(v.nm.idx_path),
        )

    def VolumeIncrementalCopy(self, request, context):
        """Stream .dat bytes appended at/after since_ns (volume_backup.go
        binary-search semantics, linear scan here)."""
        v = self._volume(request.volume_id, context)
        start = None
        for n, off in v.scan_needles():
            if n.append_at_ns >= request.since_ns:
                start = off
                break
        if start is None:
            return
        size = v.data_size()
        while start < size:
            chunk = v._pread(start, min(BUFFER_SIZE_LIMIT, size - start))
            if not chunk:
                break
            yield vs.VolumeIncrementalCopyResponse(file_content=chunk)
            start += len(chunk)

    # ---- mount / unmount / delete / readonly

    def VolumeMount(self, request, context):
        self.store.mount_volume(request.volume_id)
        self.srv.trigger_heartbeat()
        self.srv._sync_native_registry()
        return vs.VolumeMountResponse()

    def VolumeUnmount(self, request, context):
        self.store.unmount_volume(request.volume_id)
        self.srv.trigger_heartbeat()
        self.srv._sync_native_registry()
        return vs.VolumeUnmountResponse()

    def VolumeDelete(self, request, context):
        try:
            self.store.delete_volume(request.volume_id, request.only_empty)
        except NotFoundError:
            pass
        self.srv.trigger_heartbeat()
        self.srv._sync_native_registry()
        return vs.VolumeDeleteResponse()

    def VolumeMarkReadonly(self, request, context):
        self._volume(request.volume_id, context).read_only = True
        self.srv.trigger_heartbeat()
        self.srv._sync_native_registry()
        return vs.VolumeMarkReadonlyResponse()

    def VolumeMarkWritable(self, request, context):
        self._volume(request.volume_id, context).read_only = False
        self.srv.trigger_heartbeat()
        self.srv._sync_native_registry()
        return vs.VolumeMarkWritableResponse()

    def VolumeConfigure(self, request, context):
        from ..storage.super_block import ReplicaPlacement

        v = self._volume(request.volume_id, context)
        v.super_block.replica_placement = ReplicaPlacement.parse(request.replication)
        return vs.VolumeConfigureResponse()

    def VolumeStatus(self, request, context):
        v = self._volume(request.volume_id, context)
        return vs.VolumeStatusResponse(
            is_read_only=v.read_only, volume_size=v.data_size(),
            file_count=v.file_count(), file_deleted_count=v.deleted_count(),
        )

    # ---- copy

    def VolumeCopy(self, request, context):
        """Pull a whole volume from source_data_node (volume_grpc_copy.go)."""
        vid = request.volume_id
        if self.store.has_volume(vid):
            context.abort(grpc.StatusCode.ALREADY_EXISTS, f"volume {vid} exists")
        src = rpc.volume_stub(rpc.grpc_address(request.source_data_node))
        status = src.ReadVolumeFileStatus(
            vs.ReadVolumeFileStatusRequest(volume_id=vid), timeout=30)
        loc = self.store._pick_location(request.disk_type or None)
        base = loc.base_name(status.collection, vid)
        total = 0
        for ext in (".dat", ".idx"):
            with open(base + ext, "wb") as f:
                for chunk in src.CopyFile(vs.CopyFileRequest(
                        volume_id=vid, ext=ext, collection=status.collection,
                        stop_offset=(status.dat_file_size if ext == ".dat" else 0)),
                        timeout=3600):
                    f.write(chunk.file_content)
                    total += len(chunk.file_content)
            yield vs.VolumeCopyResponse(processed_bytes=total)
        # the copied bytes carry the SOURCE's offset width — mirror its
        # marker rather than stamping local mode (operation docstring)
        sync_stride_marker(src, vid, status.collection, base)
        self.store.mount_volume(vid)
        self.srv.trigger_heartbeat()
        v = self.store.find_volume(vid)
        yield vs.VolumeCopyResponse(last_append_at_ns=v.last_append_at_ns)

    def ReadVolumeFileStatus(self, request, context):
        v = self._volume(request.volume_id, context)
        base = v.file_name()
        return vs.ReadVolumeFileStatusResponse(
            volume_id=v.id, collection=v.collection,
            dat_file_size=v.data_size(),
            idx_file_size=os.path.getsize(base + ".idx"),
            file_count=v.file_count(),
            compaction_revision=v.super_block.compaction_revision,
        )

    def CopyFile(self, request, context):
        """Stream any volume/EC file by extension in 2MB chunks."""
        vid, ext = request.volume_id, request.ext
        path = None
        for loc in self.store.locations:
            vols, ecs = loc.scan()
            col = request.collection
            cand = loc.base_name(col, vid) + ext
            if os.path.exists(cand):
                path = cand
                break
            # collection may be unknown to caller: scan both maps
            if vid in vols and os.path.exists(loc.base_name(vols[vid][0], vid) + ext):
                path = loc.base_name(vols[vid][0], vid) + ext
                break
            if vid in ecs and os.path.exists(loc.base_name(ecs[vid][0], vid) + ext):
                path = loc.base_name(ecs[vid][0], vid) + ext
                break
        if path is None:
            if request.ignore_source_file_not_found:
                return
            context.abort(grpc.StatusCode.NOT_FOUND, f"{vid}{ext} not found")
        stop = request.stop_offset or os.path.getsize(path)
        sent = 0
        with open(path, "rb") as f:
            while sent < stop:
                chunk = f.read(min(BUFFER_SIZE_LIMIT, stop - sent))
                if not chunk:
                    break
                yield vs.CopyFileResponse(file_content=chunk)
                sent += len(chunk)

    # ---- needle blob

    def ReadNeedleBlob(self, request, context):
        v = self._volume(request.volume_id, context)
        offset, size = request.offset, request.size
        if offset == 0 and size == 0 and request.needle_id:
            # by-id form (scrub/anti-entropy): callers on OTHER servers
            # can't know local offsets — resolve through the needle map
            nv = v.nm.get(request.needle_id)
            if nv is None or types.size_is_deleted(nv.size):
                context.abort(grpc.StatusCode.NOT_FOUND, "needle not found")
            offset = types.stored_to_actual_offset(nv.offset)
            size = nv.size
        blob = v.read_needle_blob(offset, size)
        return vs.ReadNeedleBlobResponse(needle_blob=blob)

    def WriteNeedleBlob(self, request, context):
        v = self._volume(request.volume_id, context)
        n = Needle.from_bytes(request.needle_blob, v.version, check_crc=False)
        # verbatim record transfer (anti-entropy heal, scrub repair):
        # the blob carries the ORIGINATING write's epoch tag — stamping
        # a fresh one here would forge causality for a copy
        v.write_needle(n, check_cookie=False, stamp=False)
        return vs.WriteNeedleBlobResponse()

    def ReadAllNeedles(self, request, context):
        for vid in request.volume_ids:
            v = self.store.find_volume(vid)
            if v is None:
                continue
            for n, off in v.scan_needles():
                nv = v.nm.get(n.id)
                if nv is None or types.size_is_deleted(nv.size):
                    continue
                if types.stored_to_actual_offset(nv.offset) != off:
                    continue
                yield vs.ReadAllNeedlesResponse(
                    volume_id=vid, needle_id=n.id, cookie=n.cookie,
                    needle_blob=n.data,
                )

    # ---- tail

    def VolumeTailSender(self, request, context):
        v = self._volume(request.volume_id, context)
        deadline = time.time() + (request.idle_timeout_seconds or 2)
        since = request.since_ns
        while time.time() < deadline and context.is_active():
            progressed = False
            for n, _off in v.scan_needles():
                if n.append_at_ns <= since:
                    continue
                since = n.append_at_ns
                progressed = True
                blob = n.to_bytes(v.version)
                yield vs.VolumeTailSenderResponse(
                    needle_header=blob[:types.NEEDLE_HEADER_SIZE],
                    needle_body=blob[types.NEEDLE_HEADER_SIZE:],
                )
            if progressed:
                deadline = time.time() + (request.idle_timeout_seconds or 2)
            else:
                time.sleep(0.1)
        yield vs.VolumeTailSenderResponse(is_last_chunk=True)

    def VolumeTailReceiver(self, request, context):
        v = self._volume(request.volume_id, context)
        src = rpc.volume_stub(rpc.grpc_address(request.source_volume_server))
        for resp in src.VolumeTailSender(vs.VolumeTailSenderRequest(
                volume_id=request.volume_id, since_ns=request.since_ns,
                idle_timeout_seconds=request.idle_timeout_seconds), timeout=600):
            if resp.is_last_chunk:
                break
            n = Needle.from_bytes(resp.needle_header + resp.needle_body,
                                  v.version, check_crc=False)
            v.write_needle(n, check_cookie=False, stamp=False)
        return vs.VolumeTailReceiverResponse()

    # ---- erasure coding (volume_grpc_erasure_coding.go) ------------------

    def _generate_prologue(self, request, context):
        """Head of the generate handler: -> (volume, geometry, coder, pace)."""
        v = self.store.find_volume(request.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"volume {request.volume_id} not found")
        if request.collection and v.collection != request.collection:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "collection mismatch")
        geo = self.srv.ec_geometry
        code = getattr(request, "geometry", "")
        if code:
            # registry-backed validation: an unknown geometry
            # name fails fast, listing what IS registered
            from ..models import geometry as geom_mod

            try:
                cg = geom_mod.get(code)
            except ValueError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            if not cg.volume_capable:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"geometry {code!r} is not volume-capable "
                    f"(stripe-level codec only)")
            if (request.data_shards
                    and request.data_shards != cg.data_shards) or \
                    (request.parity_shards
                     and request.parity_shards != cg.parity_shards):
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"geometry {code!r} is {cg.data_shards}+"
                    f"{cg.parity_shards}; -dataShards/-parityShards "
                    f"disagree")
            geo = Geometry(data_shards=cg.data_shards,
                           parity_shards=cg.parity_shards,
                           large_block=geo.large_block,
                           small_block=geo.small_block,
                           code=cg.name)
        elif request.data_shards:
            geo = Geometry(data_shards=request.data_shards,
                           parity_shards=request.parity_shards or 4,
                           large_block=geo.large_block,
                           small_block=geo.small_block)
        # QoS plane: archival encodes are the lowest priority
        # class. Admission-probe a BOUNDED first chunk before touching
        # data (fail closed: an unreachable master pauses archival
        # instead of letting it contend with foreground I/O); the rest
        # of the volume is drawn slab by slab through `pace` so volumes
        # larger than the wait cap's worth of budget still encode.
        from ..qos import DEFAULT_MAX_GRANT_BYTES, QosUnavailable

        probe = max(min(v.data_size(), DEFAULT_MAX_GRANT_BYTES), 1)
        try:
            self.srv.qos_acquire("archival", probe)
        except QosUnavailable as e:
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        pace = self.srv.qos_governor.pacer("archival", prepaid=probe)
        return v, geo, self._geo_coder(geo), pace

    def _generate_epilogue(self, v, geo, base, t0, enc_stats) -> None:
        write_sorted_file_from_idx(base)
        from ..storage.ec_volume import save_volume_info

        save_volume_info(base, {
            "version": v.version,
            "dataShards": geo.data_shards, "parityShards": geo.parity_shards,
            "largeBlock": geo.large_block, "smallBlock": geo.small_block,
            # the code geometry travels WITH the shard set: readable at
            # mount, so mixed-geometry clusters decode every volume with
            # the right generator matrix
            "geometry": geo.code_name,
        })
        VOLUME_SERVER_EC_ENCODE_BYTES.inc(v.data_size())
        glog.v(0, f"ec encode vol {v.id}: {v.data_size()} bytes in "
                  f"{time.perf_counter() - t0:.2f}s "
                  f"(read {enc_stats.read_s:.2f}s, device-wait "
                  f"{enc_stats.device_wait_s:.2f}s, write {enc_stats.write_s:.2f}s, "
                  f"overlap x{enc_stats.overlap_ratio:.2f})")

    def VolumeEcShardsGenerate(self, request, context):
        """.dat -> .ec00.. + .ecx + .vif (handler :38-81). The stripe math
        runs through the store's coder (the CUDA kernels by default)."""
        from ..qos import QosUnavailable

        v, geo, coder, pace = self._generate_prologue(request, context)
        base = v.file_name()
        t0 = time.perf_counter()
        try:
            enc_stats = write_ec_files(base, coder, geo, pace=pace)
        except QosUnavailable as e:
            # starved mid-encode (budget reserved for higher classes or
            # master lost): same abort surface as the admission probe —
            # the shell's failure path rolls the replica back writable
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        self._generate_epilogue(v, geo, base, t0, enc_stats)
        return vs.VolumeEcShardsGenerateResponse()

    def VolumeEcShardsGenerateStreamed(self, request, context):
        """Generate shards AND push each remote destination's shards to
        it while the encode is still running: network transfer, the GF
        product on the card and destination shard I/O all in flight at
        once (storage/ec_stream.py). Local shard files are still written
        (the source keeps its own shards; they are also the resume
        source after a destination flap)."""
        from ..pb import ec_stream_pb2 as es
        from ..storage.ec_stream import EcStreamDestination, EcStreamSinkSet
        from ..utils.stats import EC_STREAM_OVERLAP_RATIO

        v, geo, coder, pace = self._generate_prologue(request, context)
        base = v.file_name()
        shard_size = geo.shard_size(v.data_size())
        dests = [
            EcStreamDestination(
                t.address, request.volume_id, request.collection,
                list(t.shard_ids), base, geo, shard_size,
                source=self.srv.address)
            for t in request.targets if t.shard_ids
        ]
        t0 = time.perf_counter()
        sinks = EcStreamSinkSet(dests)
        try:
            enc_stats = write_ec_files(base, coder, geo, sinks=sinks,
                                       pace=pace)
        except BaseException as e:
            sinks.abort()
            from ..qos import QosUnavailable

            if isinstance(e, QosUnavailable):
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
            raise
        resp = es.VolumeEcShardsGenerateStreamedResponse()

        def finish_one(d):
            # per-destination verdict; finish() may run a full
            # missing-range resume with retries, so destinations must
            # not serialize behind each other's catch-up
            try:
                d.finish()
                return d, None
            # lint: allow-broad-except(a destination's failure becomes its
            # verdict; the shell falls back to VolumeEcShardsCopy for it)
            except BaseException as e:  # noqa: BLE001
                return d, (d.error or f"{type(e).__name__}: {e}")

        results = []
        if dests:
            # lint: allow-executor — per-conversion admin path (one
            # pool per ec.encode stream, not per request); finish() can
            # block minutes on resume retries, which would starve the
            # shared fan-out budget
            with ThreadPoolExecutor(max_workers=len(dests)) as ex:
                results = list(ex.map(finish_one, dests))
        for d, err in results:
            r = resp.targets.add(address=d.address)
            if err is None:
                r.ok = True
            else:
                r.ok = False
                r.error = err
                glog.warning(f"ec stream vol {v.id} -> {d.address} "
                             f"failed after retries: {err}; caller "
                             f"falls back to VolumeEcShardsCopy")
            r.bytes_streamed = d.bytes_streamed
            r.resumes = d.resumes
            r.resumed_bytes = d.resumed_bytes
            resp.bytes_streamed += d.bytes_streamed
            resp.resumes += d.resumes
        wall = time.perf_counter() - t0
        self._generate_epilogue(v, geo, base, t0, enc_stats)
        resp.encode_seconds = enc_stats.wall_s
        resp.wall_seconds = wall
        resp.overlap_ratio = enc_stats.wall_s / wall if wall > 0 else 0.0
        if dests:
            EC_STREAM_OVERLAP_RATIO.set(resp.overlap_ratio)
        return resp

    # ---- streaming shard receive (ec_stream.proto) -------------------------

    def VolumeEcShardsStream(self, request_iterator, context):
        """Destination side of the pipelined archival encode: append
        shard slabs as they arrive (in offset order per shard), verify
        each slab's crc32c in transit, chain per-shard digests while
        writing, and at commit check them against the source's
        crc32c_combine-folded expectation — then persist the `.dig`
        manifest without re-reading a byte. `resume=True` continues
        after this server's on-disk prefix (the prefix digest is
        re-chained from disk, the only re-read on the resume path)."""
        from ..scrub.digest import ShardCrc, write_ec_manifest
        from ..storage.crc import crc32c, crc32c_combine
        from ..utils.stats import EC_STREAM_BYTES, EC_STREAM_SLABS

        it = iter(request_iterator)
        first = next(it, None)
        if first is None or not first.HasField("header"):
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "first stream message must be the header")
        h = first.header
        loc = self.store.locations[0]
        base = loc.base_name(h.collection, h.volume_id)
        geo = self.srv.ec_geometry
        files: dict[int, object] = {}
        digests: dict[int, int] = {}
        sizes: dict[int, int] = {}
        phase = "resume" if h.resume else "live"
        received = 0
        commit = None
        try:
            for sid in h.shard_ids:
                path = geo.shard_file_name(base, sid)
                if h.resume and os.path.exists(path):
                    f = open(path, "r+b")
                    crc = 0
                    n = 0
                    while True:  # re-chain the digest over the prefix
                        chunk = f.read(1 << 20)
                        if not chunk:
                            break
                        crc = crc32c(chunk, crc)
                        n += len(chunk)
                    digests[sid], sizes[sid] = crc, n
                else:
                    f = open(path, "wb")
                    digests[sid], sizes[sid] = 0, 0
                files[sid] = f
            for msg in it:
                if msg.HasField("slab"):
                    s = msg.slab
                    # chaos hook: a targeted destination drops
                    # mid-stream; the source resumes from this server's
                    # reported on-disk prefix. Matchable per shard AND
                    # per slab range (comma-terminated ctx convention).
                    try:
                        failpoint.fail(
                            "ec.stream.slab",
                            ctx=f"{self.srv.address}, "
                                f"shard={s.shard_id}, off={s.offset},")
                    except failpoint.FailpointError as e:
                        context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
                    f = files.get(s.shard_id)
                    if f is None:
                        context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                      f"shard {s.shard_id} not in header")
                    slab_crc = crc32c(s.data)
                    if slab_crc != s.crc:
                        context.abort(grpc.StatusCode.DATA_LOSS,
                                      f"slab crc mismatch in transit "
                                      f"(shard {s.shard_id} @ {s.offset})")
                    if s.offset != sizes[s.shard_id]:
                        context.abort(
                            grpc.StatusCode.FAILED_PRECONDITION,
                            f"non-contiguous slab for shard {s.shard_id}:"
                            f" offset {s.offset}, have {sizes[s.shard_id]}")
                    if f.tell() != s.offset:  # interleaved shards only
                        f.seek(s.offset)
                    f.write(s.data)
                    sizes[s.shard_id] += len(s.data)
                    # chain via the O(32^2) combine fold instead of a
                    # second full crc pass over the slab bytes
                    digests[s.shard_id] = crc32c_combine(
                        digests[s.shard_id], slab_crc, len(s.data))
                    received += len(s.data)
                    EC_STREAM_BYTES.inc(len(s.data), role="dest",
                                        phase=phase)
                    EC_STREAM_SLABS.inc(role="dest", phase=phase)
                elif msg.HasField("commit"):
                    commit = msg.commit
                    break
            if commit is None:
                context.abort(grpc.StatusCode.ABORTED,
                              "stream ended without commit")
            # flushed, not fsynced: the VolumeEcShardsCopy path the
            # stream replaces never fsyncs either (the source holds every
            # shard until the shell's delete step, so a crashed
            # destination is simply re-streamed)
            for f in files.values():
                f.flush()
            for d in commit.digests:
                if d.shard_id not in files:
                    continue
                if (sizes[d.shard_id], digests[d.shard_id]) != (d.size,
                                                                d.crc):
                    context.abort(
                        grpc.StatusCode.DATA_LOSS,
                        f"shard {d.shard_id} digest mismatch at commit: "
                        f"wrote size={sizes[d.shard_id]} "
                        f"crc={digests[d.shard_id]:#x}, source expects "
                        f"size={d.size} crc={d.crc:#x}")
            # the digest manifest falls out of the digests chained
            # while writing — no second read (cached_ec_digest serves
            # VolumeDigest from it once the shards mount)
            write_ec_manifest(base, {
                sid: ShardCrc(sid, digests[sid], sizes[sid])
                for sid in files})
            from ..pb import ec_stream_pb2 as es

            resp = es.VolumeEcShardsStreamResponse(bytes_received=received)
            for sid in sorted(files):
                resp.shards.add(shard_id=sid, crc=digests[sid],
                                size=sizes[sid])
            return resp
        finally:
            for f in files.values():
                try:
                    f.close()
                except OSError:
                    pass

    def VolumeEcShardsStreamStatus(self, request, context):
        """Resume probe: contiguous bytes of each requested shard durably
        on this server's disk (slabs arrive in offset order, so file
        size IS the complete prefix length)."""
        from ..pb import ec_stream_pb2 as es

        loc = self.store.locations[0]
        base = loc.base_name(request.collection, request.volume_id)
        geo = self.srv.ec_geometry
        resp = es.VolumeEcShardsStreamStatusResponse()
        for sid in request.shard_ids:
            try:
                size = os.path.getsize(geo.shard_file_name(base, sid))
            except OSError:
                size = 0
            resp.shards.add(shard_id=sid, size=size)
        return resp

    def VolumeEcShardsRead(self, request, context):
        """Cross-server syndrome-verify gather source: stream
        the requested shard RANGES as chunked, CRC-stamped,
        offset-addressed slabs — the VolumeEcShardsStream wire shape in
        reverse. Ranges advance in lockstep (offset-major) so a consumer
        assembling verify windows across shards never has to buffer a
        whole shard of one range while another lags."""
        from ..pb import ec_gather_pb2 as eg
        from ..storage.crc import crc32c

        ev = self.store.find_ec_volume(request.volume_id)
        if ev is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"ec volume {request.volume_id} not mounted")
        slab = min(request.slab or BUFFER_SIZE_LIMIT, BUFFER_SIZE_LIMIT)
        cursors = []
        for r in request.ranges:
            f = ev.shard_files.get(r.shard_id)
            if f is None:
                context.abort(grpc.StatusCode.NOT_FOUND,
                              f"shard {r.shard_id} not on this server")
            end = f.size() if not r.size else min(r.offset + r.size,
                                                  f.size())
            cursors.append([r.shard_id, f, r.offset, end])
        progressed = True
        while progressed:
            progressed = False
            for cur in cursors:
                sid, f, off, end = cur
                if off >= end:
                    continue
                n = min(slab, end - off)
                try:
                    # chaos hook: a targeted peer drops mid-gather; the
                    # scrubber resumes only the missing ranges.
                    # Matchable per peer AND per (shard, offset).
                    failpoint.fail(
                        "scrub.gather.range",
                        ctx=f"{self.srv.address}, shard={sid}, "
                            f"off={off},")
                except failpoint.FailpointError as e:
                    context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
                data = f.read_at(off, n)
                data += b"\0" * (n - len(data))
                yield eg.VolumeEcShardsReadResponse(
                    shard_id=sid, offset=off, data=data,
                    crc=crc32c(data))
                cur[2] = off + n
                progressed = True

    def VolumeEcShardsRebuild(self, request, context):
        """Regenerate missing .ecXX from survivors (handler :84-123)."""
        base = self._ec_base(request.volume_id, request.collection, context)
        geo = self._ec_geo(base)
        coder = self._geo_coder(geo)
        # rebuilds are REPAIR-class work: they outrank scrub/archival in
        # the grant ledger (a repair storm must never starve behind an
        # archival backlog), and fail closed like every background class.
        # Probe a BOUNDED first chunk, then draw the rest slab by slab —
        # a lump acquire of the whole survivor set could exceed what the
        # budget can ever accumulate inside one wait cap, making large
        # rebuilds permanently impossible.
        from ..qos import DEFAULT_MAX_GRANT_BYTES, QosUnavailable

        est = sum(os.path.getsize(geo.shard_file_name(base, i))
                  for i in range(geo.total_shards)
                  if os.path.exists(geo.shard_file_name(base, i)))
        probe = max(min(est, DEFAULT_MAX_GRANT_BYTES), 1)
        try:
            self.srv.qos_acquire("repair", probe)
        except QosUnavailable as e:
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        # `shard_ids` (geometry-aware request form): the genuinely-
        # missing set cluster-wide — locally-absent shards that exist on
        # peers need no rebuild, and the minimal-read plan only covers
        # the asked-for shards
        want = list(getattr(request, "shard_ids", [])) or None
        pace = self.srv.qos_governor.pacer("repair", prepaid=probe)
        rstats: dict = {}
        try:
            rebuilt = rebuild_ec_files(base, coder, geo, pace=pace,
                                       want=want, stats=rstats)
        except QosUnavailable as e:
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        from ..pb import ec_geometry_pb2 as eg
        from ..storage.ec_volume import rebuild_ecx_file

        rebuild_ecx_file(base)
        self.srv.scrubber.invalidate_ec_digest(request.volume_id,
                                               remove_manifest=True)
        self.srv.trigger_heartbeat()
        return eg.EcRebuildResponse(
            rebuilt_shard_ids=rebuilt, geometry=geo.code_name,
            survivor_bytes_read=rstats.get("survivor_bytes_read", 0),
            survivor_shards=rstats.get("survivor_shards", 0))

    def VolumeEcShardsCopy(self, request, context):
        """Pull shard files from source_data_node (handler :126-177).
        Instrumented with byte/throughput counters so A/Bs against the
        streaming path compare like for like."""
        from ..utils.stats import (
            EC_COPY_FALLBACK_BYTES,
            EC_COPY_FALLBACK_SECONDS,
        )

        loc = self.store.locations[0]
        base = loc.base_name(request.collection, request.volume_id)
        src = rpc.volume_stub(rpc.grpc_address(request.source_data_node))
        exts = [f".ec{sid:02d}" for sid in request.shard_ids]
        if request.copy_ecx_file:
            exts.append(".ecx")
        if request.copy_ecj_file:
            exts.append(".ecj")
        if request.copy_vif_file:
            exts.append(".vif")
        t0 = time.perf_counter()
        for ext in exts:
            kind = "shard" if ext.startswith(".ec") and ext[3:].isdigit() \
                else "index"
            with open(base + ext, "wb") as f:
                for chunk in src.CopyFile(vs.CopyFileRequest(
                        volume_id=request.volume_id, ext=ext,
                        collection=request.collection, is_ec_volume=True,
                        ignore_source_file_not_found=(ext == ".ecj")),
                        timeout=3600):
                    # simulated-WAN hook, mirror of ec.stream.slab's
                    # delay mode: the stream-vs-copy A/B arms BOTH so a
                    # per-chunk wire latency hits the paths symmetrically
                    failpoint.delay("ec.copy.chunk",
                                    ctx=f"{self.srv.address},")
                    f.write(chunk.file_content)
                    EC_COPY_FALLBACK_BYTES.inc(len(chunk.file_content),
                                               kind=kind)
            if ext == ".ecj" and os.path.getsize(base + ext) == 0:
                os.remove(base + ext)
            if ext == ".ecx":
                # the per-index stride marker travels WITH the .ecx: the
                # SOURCE's offset width decides how its entries parse
                sync_stride_marker(src, request.volume_id,
                                   request.collection, base,
                                   ext=".ecx.lrg", is_ec=True)
        EC_COPY_FALLBACK_SECONDS.inc(time.perf_counter() - t0)
        # an index-only copy (the streaming path ships shard bytes itself
        # and pulls just .ecx/.ecj/.vif here) leaves shard bytes — and
        # therefore the streamed `.dig` manifest — intact
        self.srv.scrubber.invalidate_ec_digest(
            request.volume_id, remove_manifest=bool(request.shard_ids))
        return vs.VolumeEcShardsCopyResponse()

    def VolumeEcShardsDelete(self, request, context):
        """Remove local shard files; drop index files once no shard remains
        (handler :181-264)."""
        for loc in self.store.locations:
            base = loc.base_name(request.collection, request.volume_id)
            if not os.path.exists(base + ".ecx") and not any(
                    os.path.exists(base + f".ec{sid:02d}")
                    for sid in request.shard_ids):
                # (streamed shard files can exist before any .ecx does —
                # a rollback after a failed streamed encode must still
                # be able to clean them up)
                continue
            for sid in request.shard_ids:
                try:
                    os.remove(base + f".ec{sid:02d}")
                except FileNotFoundError:
                    pass
            geo = self._ec_geo(base)
            if not any(os.path.exists(base + f".ec{i:02d}")
                       for i in range(geo.total_shards)):
                # the per-index marker goes with its .ecx — a stale one
                # would falsely refuse a later re-encode in the other mode
                for ext in (".ecx", ".ecj", ".vif", ".ecx.lrg", ".dig"):
                    try:
                        os.remove(base + ext)
                    except FileNotFoundError:
                        pass
            # refresh the mounted runtime so it stops serving (and
            # heartbeating) the deleted shard files
            if self.store.find_ec_volume(request.volume_id) is not None:
                self.store.unmount_ec_shards(request.volume_id)
                if os.path.exists(base + ".ecx"):
                    self.store.mount_ec_shards(
                        request.volume_id, request.collection, [])
        self.srv.ec_recon_cache.invalidate(request.volume_id)
        self.srv.scrubber.invalidate_ec_digest(request.volume_id,
                                               remove_manifest=True)
        self.srv.trigger_heartbeat()
        return vs.VolumeEcShardsDeleteResponse()

    def VolumeEcShardsMount(self, request, context):
        self.store.mount_ec_shards(
            request.volume_id, request.collection, list(request.shard_ids))
        # cached reconstructions may describe shards that just (re)appeared
        self.srv.ec_recon_cache.invalidate(request.volume_id)
        self.srv.scrubber.invalidate_ec_digest(request.volume_id)
        self.srv.trigger_heartbeat()
        return vs.VolumeEcShardsMountResponse()

    def VolumeEcShardsUnmount(self, request, context):
        self.store.unmount_ec_shards(request.volume_id, list(request.shard_ids))
        self.srv.ec_recon_cache.invalidate(request.volume_id)
        self.srv.scrubber.invalidate_ec_digest(request.volume_id)
        self.srv.trigger_heartbeat()
        return vs.VolumeEcShardsUnmountResponse()

    def VolumeEcShardRead(self, request, context):
        """Stream a shard extent in 2MB messages (handler :309-375)."""
        try:
            # same chaos hook as the local path: a peer asking for a
            # "lost" shard here gets UNAVAILABLE and reconstructs instead
            failpoint.fail(
                "ec.shard.read",
                ctx=f"{self.srv.address}, shard={request.shard_id},")
        except failpoint.FailpointError as e:
            context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
        ev = self.store.find_ec_volume(request.volume_id)
        if ev is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"ec volume {request.volume_id} not mounted")
        f = ev.shard_files.get(request.shard_id)
        if f is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"shard {request.shard_id} not on this server")
        if request.file_key:
            _off, size = ev.find_needle(request.file_key)
            if types.size_is_deleted(size):
                yield vs.VolumeEcShardReadResponse(is_deleted=True)
                return
        remaining = request.size
        off = request.offset
        while remaining > 0:
            chunk = f.read_at(off, min(BUFFER_SIZE_LIMIT, remaining))
            if not chunk:
                break
            yield vs.VolumeEcShardReadResponse(data=chunk)
            off += len(chunk)
            remaining -= len(chunk)

    def VolumeEcBlobDelete(self, request, context):
        """Tombstone a needle in a mounted EC volume (handler :377-405)."""
        ev = self.store.find_ec_volume(request.volume_id)
        if ev is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "ec volume not mounted")
        ev.delete_needle(request.file_key)
        return vs.VolumeEcBlobDeleteResponse()

    def VolumeEcShardsToVolume(self, request, context):
        """Decode .ec00-.ec09 back into .dat/.idx (handler :407-446)."""
        base = self._ec_base(request.volume_id, request.collection, context)
        geo = self._ec_geo(base)
        missing = [i for i in range(geo.data_shards)
                   if not os.path.exists(base + f".ec{i:02d}")]
        if missing:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          f"missing data shards {missing}")
        from ..storage.ec_volume import load_volume_info

        version = load_volume_info(base).get("version", types.CURRENT_VERSION)
        dat_size = find_dat_file_size(base, version)
        write_dat_file(base, dat_size, geo)
        write_idx_file_from_ec_index(base)
        self.store.mount_volume(request.volume_id)
        self.srv.trigger_heartbeat()
        return vs.VolumeEcShardsToVolumeResponse()

    # ---- status / leave / ping

    # -- tiered storage (volume_grpc_tier_upload/download.go) --------------

    def VolumeTierMoveDatToRemote(self, request, context):
        from ..storage.backend import get_tier_backend

        v = self.store.find_volume(request.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"volume {request.volume_id} not found")
        try:
            backend = get_tier_backend(request.destination_backend_name)
        except KeyError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        # the C++ plane lets go of the volume before its .dat leaves the
        # disk; Python serves it from the backend after
        with self.srv._native_released(request.volume_id):
            moved = v.tier_to_remote(
                backend, keep_local=request.keep_local_dat_file)
        yield vs.VolumeTierMoveDatToRemoteResponse(
            processed=moved, processed_percentage=100.0)

    def VolumeTierMoveDatFromRemote(self, request, context):
        v = self.store.find_volume(request.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"volume {request.volume_id} not found")
        try:
            moved = v.tier_from_remote(
                keep_remote=request.keep_remote_dat_file)
        except IOError as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        self.srv._sync_native_registry()  # the plane takes it back
        yield vs.VolumeTierMoveDatFromRemoteResponse(
            processed=moved, processed_percentage=100.0)

    def VolumeServerStatus(self, request, context):
        resp = vs.VolumeServerStatusResponse(
            version="seaweedfs-tpu 0.1", data_center=self.store.data_center,
            rack=self.store.rack)
        for loc in self.store.locations:
            st = os.statvfs(loc.directory)
            all_b = st.f_blocks * st.f_frsize
            free_b = st.f_bavail * st.f_frsize
            resp.disk_statuses.append(vs.DiskStatus(
                dir=loc.directory, all=all_b, free=free_b, used=all_b - free_b,
                percent_free=100.0 * free_b / all_b if all_b else 0.0,
                percent_used=100.0 * (all_b - free_b) / all_b if all_b else 0.0,
            ))
        return resp

    def VolumeServerLeave(self, request, context):
        self.srv._stop.set()
        self.srv._hb_wake.set()
        return vs.VolumeServerLeaveResponse()

    def Ping(self, request, context):
        now = time.time_ns()
        return vs.PingResponse(start_time_ns=now, remote_time_ns=now,
                               stop_time_ns=time.time_ns())

    # ---- integrity plane (scrub.proto) ------------------------------------

    def VolumeDigest(self, request, context):
        """Digest manifest of one volume: sorted per-needle stored CRCs +
        rolling digest (anti-entropy compares THIS instead of shipping
        bytes). EC volumes answer per-shard whole-file CRCs instead."""
        vid = request.volume_id
        v = self.store.find_volume(vid)
        if v is not None:
            entries = scrub_digest.volume_digest_entries(v)
            resp = scrub_pb2.VolumeDigestResponse(
                volume_id=vid,
                needle_count=sum(1 for e in entries if e.size >= 0),
                tombstone_count=sum(1 for e in entries if e.size < 0),
                rolling_crc=scrub_digest.rolling_digest(entries))
            if request.include_entries:
                for e in entries:
                    inc, seq, srv = e.epoch or (0, 0, 0)
                    resp.entries.add(needle_id=e.needle_id, crc=e.crc,
                                     size=e.size, epoch_incarnation=inc,
                                     epoch_seq=seq, epoch_server=srv)
            return resp
        ev = self.store.find_ec_volume(vid)
        if ev is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"volume {vid} not found")
        # a fresh syndrome sweep caches fold-combined shard CRCs
        # (invalidated on any shard mount/unmount/delete/rebuild);
        # compute directly when none is cached
        cached = self.srv.scrubber.cached_ec_digest(vid)
        shard_crcs = cached or scrub_digest.ec_shard_crcs(ev)
        resp = scrub_pb2.VolumeDigestResponse(volume_id=vid, is_ec=True)
        for sc in shard_crcs.values():
            resp.shard_digests.add(shard_id=sc.shard_id, crc=sc.crc,
                                   size=sc.size)
        return resp

    def VolumeScrub(self, request, context):
        """On-demand scrub: sweep one volume (or all) now, optionally
        escalating findings into repair (the shell's `volume.scrub`)."""
        report = self.srv.scrubber.run_once(
            vid=request.volume_id or None, full=request.full,
            repair=request.repair)
        resp = scrub_pb2.VolumeScrubResponse(
            volumes_scrubbed=report.volumes,
            needles_checked=report.needles,
            bytes_verified=report.bytes,
            repaired=report.repaired,
            skipped_pairs=report.skipped_pairs)
        for f in report.findings:
            resp.findings.add(
                volume_id=f.volume_id, kind=f.kind, needle_id=f.needle_id,
                shard_id=max(f.shard_id, 0), detail=f.detail,
                state=f.state, found_at_unix=f.found_at)
        return resp

    def ScrubStatus(self, request, context):
        sc = self.srv.scrubber
        st = sc.status()  # one locked snapshot feeds the whole response
        resp = scrub_pb2.ScrubStatusResponse(
            sweeps_completed=sc.sweeps_completed,
            running=sc.running,
            last_sweep_unix=sc.last_sweep_unix,
            suspect_backlog=st["suspectBacklog"])
        for c in st["cursors"]:
            resp.cursors.add(volume_id=c["volumeId"],
                             offset=max(c["offset"], 0),
                             volume_size=0, sweeps=c["sweeps"])
        for f in sc.snapshot_findings():
            resp.findings.add(
                volume_id=f.volume_id, kind=f.kind, needle_id=f.needle_id,
                shard_id=max(f.shard_id, 0), detail=f.detail,
                state=f.state, found_at_unix=f.found_at)
        return resp

    # ---- needle metadata / status (volume_server.proto:289-301,596-607) --

    def _parse_record(self, v, offset: int, size: int, context) -> Needle:
        try:
            blob = v.read_needle_blob(offset, size)
            return Needle.from_bytes(blob, v.version, check_crc=False)
        except (IOError, ValueError) as e:
            context.abort(grpc.StatusCode.INTERNAL, f"needle read: {e}")

    def ReadNeedleMeta(self, request, context):
        """Needle attributes without the body (volume_grpc_read_write.go
        ReadNeedleMeta): callers pass the (offset, size) they learned from
        the index so no lookup is repeated."""
        v = self._volume(request.volume_id, context)
        offset, size = request.offset, request.size
        if offset == 0:
            nv = v.nm.get(request.needle_id)
            if nv is None or types.size_is_deleted(nv.size):
                context.abort(grpc.StatusCode.NOT_FOUND, "needle not found")
            offset = types.stored_to_actual_offset(nv.offset)
            size = nv.size
        n = self._parse_record(v, offset, size, context)
        return vs.ReadNeedleMetaResponse(
            cookie=n.cookie, last_modified=n.last_modified,
            crc=n.checksum & 0xFFFFFFFF, ttl=str(n.ttl),
            append_at_ns=n.append_at_ns)

    def VolumeNeedleStatus(self, request, context):
        """Index + header view of one needle (volume_grpc_read_write.go
        VolumeNeedleStatus)."""
        v = self._volume(request.volume_id, context)
        nv = v.nm.get(request.needle_id)
        if nv is None or types.size_is_deleted(nv.size):
            context.abort(grpc.StatusCode.NOT_FOUND, "needle not found")
        n = self._parse_record(
            v, types.stored_to_actual_offset(nv.offset), nv.size, context)
        return vs.VolumeNeedleStatusResponse(
            needle_id=request.needle_id, cookie=n.cookie, size=nv.size,
            last_modified=n.last_modified, crc=n.checksum & 0xFFFFFFFF,
            ttl=str(n.ttl))

    # ---- remote fetch (volume_grpc_remote.go FetchAndWriteNeedle) --------

    def FetchAndWriteNeedle(self, request, context):
        from ..remote_storage import new_client

        v = self._volume(request.volume_id, context)
        rc = request.remote_conf
        conf = {"type": rc.type or "local", "name": rc.name}
        if conf["type"] == "local":
            # anyone may call this: a fetch reads under a directory that
            # exists and is not "/", and creates none; the reference
            # takes any root and makes it (ROADMAP.md C)
            root = rc.local_root
            if not root or os.path.realpath(root) == "/" or \
                    not os.path.isdir(root):
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              f"remote fetch: local root {root!r} refused")
            conf["root"] = root
        elif conf["type"] == "s3":
            conf.update(endpoint=rc.s3_endpoint,
                        bucket=request.remote_location.bucket,
                        access_key=rc.s3_access_key,
                        secret_key=rc.s3_secret_key,
                        region=rc.s3_region or "us-east-1")
        try:
            client = new_client(conf)
            data = client.read_file(request.remote_location.path,
                                    request.offset,
                                    request.size if request.size else -1)
        except PermissionError as e:
            context.abort(grpc.StatusCode.PERMISSION_DENIED,
                          f"remote fetch: {e}")
        except Exception as e:
            context.abort(grpc.StatusCode.INTERNAL, f"remote fetch: {e}")
        n = Needle.create(request.needle_id, request.cookie, bytes(data))
        v.write_needle(n, check_cookie=False)
        import hashlib as _hashlib

        return vs.FetchAndWriteNeedleResponse(
            e_tag=_hashlib.md5(bytes(data)).hexdigest())

    # ---- select on the volume server (volume_grpc_query.go) --------------

    def Query(self, request, context):
        """Scan the named needles as JSON/CSV records, apply the single
        filter, project `selections`, stream serialized stripes."""
        from ..query import execute_query

        for fid in request.from_file_ids:
            try:
                f = parse_file_id(fid)
            except ValueError:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              f"bad file id {fid}")
            try:
                n = self.srv.read_needle(f.volume_id, f.key, f.cookie)
            except (NotFoundError, KeyError, CookieMismatch, DeletedError):
                continue  # skip unreadable fids like not-found (query semantics)
            data = n.data
            if n.is_compressed:
                from ..utils.compression import maybe_decompress

                data = maybe_decompress(data)
            try:
                out = execute_query(data, request)
            except Exception as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              f"query {fid}: {e}")
            if out:
                yield vs.QueriedStripe(records=out)

    # ---- helpers

    def _volume(self, vid: int, context):
        v = self.store.find_volume(vid)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"volume {vid} not found")
        if v.native is not None:
            # gRPC handlers read v.nm directly; absorb any idx entries the
            # C++ plane appended first (cheap fstat when nothing changed)
            v.sync_native()
        else:
            # admin handlers read the .dat/.idx files (or their sizes)
            # directly; group-commit may still hold bytes in the write
            # buffer (no-op when empty). Under v._lock: an unlocked idx
            # flush could race a writer mid-append and land an idx entry
            # on the OS before its dat record bytes.
            try:
                with v._lock:
                    v._sync_buffers()
            except OSError:
                pass  # surfaced to writers by their own flush
        return v

    def _ec_base(self, vid: int, collection: str, context) -> str:
        for loc in self.store.locations:
            base = loc.base_name(collection, vid)
            if os.path.exists(base + ".ecx") or os.path.exists(base + ".ec00"):
                return base
        context.abort(grpc.StatusCode.NOT_FOUND, f"ec volume {vid} not found")

    def _ec_geo(self, base: str) -> Geometry:
        from ..storage.ec_volume import load_volume_info

        d = self.srv.ec_geometry
        info = load_volume_info(base)
        return Geometry(
            data_shards=info.get("dataShards", d.data_shards),
            parity_shards=info.get("parityShards", d.parity_shards),
            large_block=info.get("largeBlock", d.large_block),
            small_block=info.get("smallBlock", d.small_block),
            code=info.get("geometry", ""),
        )

    def _geo_coder(self, geo: Geometry):
        # per-geometry coders are cached on the store — each
        # owns its own dispatch scheduler, keeping mixed-geometry slabs
        # out of one stacked dispatch
        return self.store.coder_for(geo)


# -- HTTP data plane -------------------------------------------------------

def _make_http_handler(srv: VolumeServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            glog.v(2, f"volume http: {fmt % args}")

        def _reply(self, code: int, body: bytes = b"",
                   content_type: str = "application/json", headers=None) -> None:
            # an error reply to a body-carrying request may leave the
            # body unread on the socket (failpoint/guard/JWT rejections
            # answer before draining) — a keep-alive client's NEXT
            # request would be parsed against those stale bytes and
            # poisoned with a stock HTML 400. Close instead of letting
            # the connection pool recycle a desynced connection.
            if code >= 400 and self.command in ("PUT", "POST"):
                self.close_connection = True
            self.send_response(code)
            if self.close_connection:
                self.send_header("Connection", "close")
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            tid = getattr(self, "_trace_id", "")
            if tid:
                self.send_header("X-Trace-Id", tid)
            # every ordinary reply advertises this server's current
            # backpressure score: the filer's chunk
            # pipeline feeds it into the hot signal, collapsing its
            # readahead/overlap windows BEFORE the first 429
            self.send_header("X-Swfs-Pressure",
                             srv.pressure_header_value())
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            if body and self.command != "HEAD":
                self.wfile.write(body)

        def _json(self, obj, code: int = 200, headers=None) -> None:
            self._reply(code, json.dumps(obj).encode(), headers=headers)

        def _guard_denied(self) -> bool:
            """IP whitelist (privateStoreHandler wrapping, guard.go:52)."""
            if srv.guard is None:
                return False
            if srv.guard.is_allowed(self.client_address[0]):
                return False
            self._json({"error": "forbidden"}, 403)
            return True

        # -- GET/HEAD (volume_server_handlers_read.go:31)

        def do_GET(self):
            self._trace_id = ""  # never leak across keep-alive requests
            if self._guard_denied():
                return
            u = urlparse(self.path)
            if u.path == "/status":
                vols = {}
                for loc in srv.store.locations:
                    for vid, v in loc.volumes.items():
                        vols[vid] = {"size": v.data_size(),
                                     "collection": v.collection,
                                     "fileCount": v.file_count(),
                                     "readOnly": v.read_only
                                     or v._gc_frozen}
                from ..utils.stats import (
                    ec_dispatch_stats,
                    ec_stream_stats,
                    group_commit_stats,
                    http_pool_stats,
                    qos_stats,
                    recovery_stats,
                    scrub_stats,
                )

                plane = srv.native_plane
                return self._json({
                    # unified /status schema:
                    # version/startedAt/uptimeSeconds at top level on
                    # every server
                    **status_base(srv._started_at),
                    "Version": "seaweedfs-tpu", "Volumes": vols,
                    # which plane serves the public port: True = the
                    # C++ data plane, False = the Python listener
                    "NativeDataPlane": plane is not None,
                    "NativeRequests":
                        plane.request_count() if plane else 0,
                    # zero-copy GETs served via sendfile(2)
                    "NativeSendfile":
                        plane.sendfile_count() if plane else 0,
                    # wdclient pool economics + TLS handshake counters
                    # (this process's client legs: replication fan-out)
                    "HttpPool": http_pool_stats(),
                    "Trace": trace.STORE.stats(),
                    # flush-batching factor of the python write engine
                    # (group commit); the native plane writes
                    # through unbuffered pwrite and does not batch
                    "GroupCommit": group_commit_stats(),
                    # EC dispatch plane: stacked-dispatch
                    # batch factors, reconstructed-interval cache ratios,
                    # per-chip dispatch spread + live per-chip queue
                    # depth, host-memory-plane arena health and the
                    # NUMA pinning state of its flush threads
                    "EcDispatch": {
                        **ec_dispatch_stats(),
                        "chipDepth": srv.ec_dispatch_depths(),
                        "arenaLive": srv.ec_dispatch_arena(),
                        "pinning": numa.pinning_stats(),
                    },
                    # streaming replica->EC conversion:
                    # live/resume byte flow, in-flight depth, overlap
                    # ratio, and the copy-fallback comparands
                    # (with the CRC-32C kernel every slab is checked
                    # by: a pure-python one would dominate the encode)
                    "EcStream": {**ec_stream_stats(),
                                 "crc32c": crc_implementation()},
                    # integrity plane: sweep cursors, findings
                    # lifecycle, repair outcomes, pacing
                    "Scrub": {**srv.scrubber.status(),
                              "counters": scrub_stats()},
                    # crash-consistency plane: what the mount
                    # ladder detected/repaired after an unclean shutdown
                    "Recovery": {
                        **srv.store.recovery_report.status(),
                        "counters": recovery_stats(),
                    },
                    # QoS plane: live pressure score, the
                    # governor's leased class budgets, admission/grant
                    # counters
                    "Qos": {
                        **qos_stats(),
                        "pressure": srv.qos_pressure(),
                        "groupCommitDepth": srv.qos_group_commit_depth(),
                        "dispatchDepth": sum(
                            srv.ec_dispatch_depths().values()),
                        "governor": srv.qos_governor.status(),
                    },
                })
            if u.path == "/metrics":
                q = parse_qs(u.query)
                ex = "exemplars" in q
                return self._reply(
                    200, gather(exemplars=ex).encode(),
                    metrics_content_type(ex))
            if u.path == "/debug/traces":
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                return self._json(trace.debug_traces_payload(q))
            if u.path == "/healthz":
                return self._json({"ok": True})
            if u.path in ("/", "/ui"):
                from .ui import volume_ui

                return self._reply(200, volume_ui(srv),
                                   "text/html; charset=utf-8")
            srv._fg_rate.note()  # scrub pacing backs off on this rate
            with trace.span("volume.read", carrier=self.headers,
                            component="volume", server=srv.address,
                            path=u.path) as tsp:
                self._trace_id = tsp.trace_id
                with VOLUME_SERVER_REQUEST_HISTOGRAM.time(type="read"):
                    self._serve_needle(u)

        do_HEAD = do_GET

        def _serve_needle(self, u):
            try:
                fid = parse_file_id(u.path.lstrip("/"))
            except ValueError as e:
                return self._json({"error": str(e)}, 400)
            try:
                # chaos hook: a targeted replica answers 500 (or stalls)
                # so client-side replica failover can be exercised
                failpoint.fail("volume.http.read",
                               ctx=f"{srv.address}, {u.path}")
                n = srv.read_needle(fid.volume_id, fid.key, fid.cookie)
            except (NotFoundError, DeletedError):
                return self._reply(404)
            except CookieMismatch:
                return self._reply(404)
            except IOError as e:  # includes injected FailpointError
                return self._json({"error": str(e)}, 500)
            data = failpoint.corrupt("volume.http.read.corrupt", n.data,
                                     ctx=f"{srv.address},")
            etag = f'"{n.etag()}"'
            headers = {"ETag": etag}
            if n.last_modified:
                headers["Last-Modified"] = time.strftime(
                    "%a, %d %b %Y %H:%M:%S GMT", time.gmtime(n.last_modified))
            # conditional GETs (volume_server_handlers_read.go:163-176;
            # RFC 7232 §3.3 precedence + weak entity-tag lists via
            # utils.http.not_modified) — short-circuits BEFORE any
            # decompress/transform/copy work below
            if not_modified(self.headers, etag, n.last_modified):
                from ..utils.stats import HTTP_CONDITIONAL_OPS

                HTTP_CONDITIONAL_OPS.inc(plane="volume", result="304")
                return self._reply(304, b"", headers=headers)
            rng = self.headers.get("Range")
            if rng and not range_applies(self.headers, etag,
                                         n.last_modified):
                # If-Range with a stale validator (RFC 7233 §3.2): the
                # Range header is ignored, the full body is served
                from ..utils.stats import HTTP_CONDITIONAL_OPS

                HTTP_CONDITIONAL_OPS.inc(plane="volume",
                                         result="if_range_stale")
                rng = None
            stored_mime = n.mime.decode() if n.mime else ""
            ctype = stored_mime or "application/octet-stream"
            if n.is_compressed:
                import gzip as _gz

                if "gzip" in (self.headers.get("Accept-Encoding") or "") and not rng:
                    headers["Content-Encoding"] = "gzip"
                else:
                    data = _gz.decompress(data)
            # on-read image transforms (volume_server_handlers_read.go:294)
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            if ("width" in q or "height" in q) and (
                    stored_mime.startswith("image/") or not stored_mime):
                from ..images import resized

                data, _, _ = resized(
                    data, int(q.get("width", 0)), int(q.get("height", 0)),
                    q.get("mode", ""))
            if rng and rng.startswith("bytes="):
                # shared RFC 7233 span parsing (utils.http): suffix
                # ranges serve the LAST N bytes, unsatisfiable/inverted
                # spans 416, malformed specs serve the full body —
                # identical to the filer plane
                span = parse_range(rng, len(data))
                if span == "invalid":
                    return self._reply(416, b"", headers={
                        **headers,
                        "Content-Range": f"bytes */{len(data)}"})
                if span is None:
                    return self._reply(200, data, ctype, headers)
                start, stop = span
                headers["Content-Range"] = f"bytes {start}-{stop - 1}/{len(data)}"
                # memoryview slice: the range body is a view
                # over the needle bytes, not a copy
                return self._reply(206, memoryview(data)[start:stop],
                                   ctype, headers)
            self._reply(200, data, ctype, headers)

        # -- PUT/POST (volume_server_handlers_write.go:18)

        def do_PUT(self):
            self._trace_id = ""
            srv._fg_rate.note()
            u = urlparse(self.path)
            with trace.span("volume.write", carrier=self.headers,
                            component="volume", server=srv.address,
                            path=u.path) as tsp:
                self._trace_id = tsp.trace_id
                with VOLUME_SERVER_REQUEST_HISTOGRAM.time(type="write"):
                    self._handle_write()

        do_POST = do_PUT

        def _handle_write(self):
            if self._guard_denied():
                return
            u = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            try:
                fid = parse_file_id(u.path.lstrip("/"))
            except ValueError as e:
                return self._json({"error": str(e)}, 400)
            try:
                # chaos hook: flaky/slow writes on a targeted server
                failpoint.fail("volume.http.write",
                               ctx=f"{srv.address}, {u.path}")
            except failpoint.FailpointError as e:
                return self._json({"error": str(e)}, 500)
            # JWT write authorization (security.toml jwt.signing) — also
            # enforced on replica fan-out (the primary re-signs; exempting
            # ?type=replicate would let anyone forge the param)
            if srv.write_jwt_key:
                from ..security import JwtError, verify_fid_jwt

                token = (self.headers.get("Authorization") or "") \
                    .removeprefix("Bearer ").strip() or q.get("auth", "")
                try:
                    verify_fid_jwt(token, srv.write_jwt_key,
                                   u.path.lstrip("/"))
                except JwtError as e:
                    return self._json({"error": f"jwt: {e}"}, 401)
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length)
            name, data = _extract_upload(self.headers, body)
            ttl = TTL.parse(q["ttl"]) if q.get("ttl") else None
            n = Needle.create(
                fid.key, fid.cookie, data,
                name=name or b"",
                mime=(self.headers.get("Content-Type") or "").encode()
                if not _is_multipart(self.headers) else b"",
                ttl=ttl or TTL.parse(""),
                is_compressed=(self.headers.get("Content-Encoding") == "gzip"),
            )
            try:
                _off, size, unchanged = srv.store.write_needle(fid.volume_id, n)
            except NotFoundError as e:
                return self._json({"error": str(e)}, 404)
            except CookieMismatch as e:
                return self._json({"error": str(e)}, 403)
            except IOError as e:
                return self._json({"error": str(e)}, 500)
            if q.get("type") != "replicate" and \
                    srv.volume_needs_replication(fid.volume_id):
                locs = srv.lookup_volume_locations(fid.volume_id)
                if len(locs) > 1:
                    try:
                        srv.replicate_write(
                            u.path.lstrip("/"), body,
                            {k: v for k, v in q.items() if k != "type"},
                            locs,
                            content_type=self.headers.get(
                                "Content-Type") or "",
                            content_encoding=self.headers.get(
                                "Content-Encoding") or "")
                    except IOError as e:
                        return self._json({"error": f"replication: {e}"}, 500)
            self._json({"name": (name or b"").decode(errors="replace"),
                        "size": size, "eTag": n.etag()}, 201)

        # -- DELETE

        def do_DELETE(self):
            self._trace_id = ""
            if self._guard_denied():
                return
            u = urlparse(self.path)
            with trace.span("volume.delete", carrier=self.headers,
                            component="volume", server=srv.address,
                            path=u.path) as tsp:
                self._trace_id = tsp.trace_id
                self._do_delete(u)

        def _do_delete(self, u):
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            try:
                fid = parse_file_id(u.path.lstrip("/"))
            except ValueError as e:
                return self._json({"error": str(e)}, 400)
            if srv.write_jwt_key:  # deletes are writes (jwt.go)
                from ..security import JwtError, verify_fid_jwt

                token = (self.headers.get("Authorization") or "") \
                    .removeprefix("Bearer ").strip() or q.get("auth", "")
                try:
                    verify_fid_jwt(token, srv.write_jwt_key,
                                   u.path.lstrip("/"))
                except JwtError as e:
                    return self._json({"error": f"jwt: {e}"}, 401)
            try:
                size = srv.store.delete_needle(fid.volume_id, fid.key, fid.cookie)
            except NotFoundError:
                # EC volumes: tombstone through the EC path
                ev = srv.store.find_ec_volume(fid.volume_id)
                if ev is None:
                    return self._json({"size": 0}, 404)
                ev.delete_needle(fid.key)
                return self._json({"size": 0}, 202)
            except CookieMismatch as e:
                return self._json({"error": str(e)}, 403)
            if q.get("type") != "replicate" and \
                    srv.volume_needs_replication(fid.volume_id):
                del_headers = {}
                if srv.write_jwt_key:
                    from ..security import gen_write_jwt

                    del_headers["Authorization"] = "Bearer " + \
                        gen_write_jwt(srv.write_jwt_key,
                                      u.path.lstrip("/"))
                for addr in srv.lookup_volume_locations(fid.volume_id):
                    if addr == srv.address:
                        continue
                    try:
                        from ..utils import retry as retry_mod
                        from ..wdclient import pool

                        def _leg(a=addr):
                            r = pool.delete(
                                url_for(a, f"{u.path}?type=replicate"),
                                headers=del_headers, timeout=10)
                            # the peer answering an error IS a failed
                            # leg (store OSError -> 500, jwt -> 401):
                            # pool.delete never raises on status, so
                            # without this check a server-side failure
                            # would count as success — the same silent
                            # divergence the transport arm closes (the
                            # replicate WRITE path has the same guard)
                            if r.status >= 300 and r.status != 404:
                                err = (f"replica delete on {a}: "
                                       f"{r.status} {r.text[:200]}")
                                if r.status >= 500:
                                    # transient (peer restarting):
                                    # ConnectionError classifies as
                                    # retryable, so attempts=2 is real
                                    raise ConnectionError(err)
                                raise IOError(err)  # auth/shape: fast

                        # attempts=2 with a 10s leg timeout: this runs
                        # synchronously before the client's 202, and
                        # anti-entropy converges a peer that stays down
                        # — loudness is the goal here, not durability
                        retry_mod.retry("volume.replicate_delete", _leg,
                                        attempts=2)
                    except Exception as e:  # noqa: BLE001
                        # the local tombstone is durable and
                        # anti-entropy's tombstone-wins pass converges
                        # the peer, so the delete still acks — but a
                        # diverged replica is never silent
                        glog.warning(
                            f"replicate delete {u.path.lstrip('/')} "
                            f"to {addr} failed after retries: {e}")
                        VOLUME_REPLICA_DELETE_FAILURES.inc(peer=addr)
            self._json({"size": size}, 202)

    return Handler


def _is_multipart(headers) -> bool:
    return "multipart/form-data" in (headers.get("Content-Type") or "")


def _extract_upload(headers, body: bytes) -> tuple[bytes, bytes]:
    """-> (filename, data). Accepts raw bodies or multipart/form-data (the
    reference's upload client posts multipart; ours sends raw by default)."""
    ctype = headers.get("Content-Type") or ""
    if "multipart/form-data" not in ctype:
        return b"", body
    import email
    import email.policy

    msg = email.message_from_bytes(
        b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body,
        policy=email.policy.HTTP,
    )
    for part in msg.iter_parts():
        fname = part.get_filename()
        payload = part.get_payload(decode=True)
        if payload is not None:
            return (fname or "").encode(), payload
    return b"", b""
