"""Cluster client: master connection + cached volume-location map.

Counterpart of seaweedfs_tpu/wdclient/__init__.py (SeaweedFS
weed/wdclient/): `MasterClient` keeps a vidMap
cache of volume id -> locations (vid_map.go:72, masterclient.go:44's
5-generation cache becomes a single TTL'd dict; the generations existed to
bound Go map churn) and `LookupFileIdWithFallback` (masterclient.go:59).

Fault handling (utils/retry.py): every master RPC fails over across the
configured master list on UNAVAILABLE/DEADLINE_EXCEEDED (the responder
becomes the new leader hint — masterclient.go's tryAllMasters), stale
vid-cache entries are invalidated on lookup misses, and
`ec_fallback_urls` surfaces EC-shard holders as last-resort read
targets when every plain replica of a volume is gone.

`MetaRingClient` routes namespace operations over the filer shards of
the master-published metadata ring.
"""

from __future__ import annotations

import random
import threading
import time

import grpc

from ..pb import master_pb2, rpc
from ..storage.file_id import parse_file_id
from ..utils import glog, trace
from ..utils.http import url_for
from ..utils.retry import multi_retry


class Location:
    __slots__ = ("url", "public_url", "grpc_port", "data_center")

    def __init__(self, url: str, public_url: str = "", grpc_port: int = 0,
                 data_center: str = ""):
        self.url = url
        self.public_url = public_url or url
        self.grpc_port = grpc_port
        self.data_center = data_center

    @property
    def grpc_address(self) -> str:
        host = self.url.rsplit(":", 1)[0]
        return f"{host}:{self.grpc_port}" if self.grpc_port else rpc.grpc_address(self.url)


class MasterClient:
    """vid -> [Location] cache with master lookup fallback."""

    def __init__(self, masters: list[str] | str, *, cache_ttl: float = 10 * 60):
        if isinstance(masters, str):
            masters = [m for m in masters.split(",") if m]
        self.masters = masters
        self.cache_ttl = cache_ttl
        self._vid_cache: dict[int, tuple[float, list[Location]]] = {}
        self._ec_vid_cache: dict[int, tuple[float, dict[int, list[Location]]]] = {}
        self._lock = threading.Lock()
        self._leader = masters[0] if masters else ""

    @property
    def current_master(self) -> str:
        return self._leader

    def _stub(self):
        return rpc.master_stub(rpc.grpc_address(self._leader))

    # -- leader failover ---------------------------------------------------

    def _with_master(self, op: str, fn):
        """Run fn(stub) against the current leader, failing over across
        the configured masters on transient gRPC errors (UNAVAILABLE /
        DEADLINE_EXCEEDED). Whichever master answers becomes the new
        leader hint, so subsequent calls go straight there."""
        candidates = [self._leader] + [m for m in self.masters
                                       if m != self._leader]

        def attempt(master):
            out = fn(rpc.master_stub(rpc.grpc_address(master)))
            if master != self._leader:
                glog.v(1, f"master failover: {op} answered by {master}")
                self._leader = master
            return out

        return multi_retry(f"master.{op}", candidates, attempt, cycles=2)

    # -- volume lookup -----------------------------------------------------

    def add_location(self, vid: int, loc: Location) -> None:
        with self._lock:
            exp, locs = self._vid_cache.get(vid, (0, []))
            if all(l.url != loc.url for l in locs):
                locs.append(loc)
            self._vid_cache[vid] = (time.time() + self.cache_ttl, locs)

    def delete_location(self, vid: int, url: str) -> None:
        with self._lock:
            entry = self._vid_cache.get(vid)
            if not entry:
                return
            exp, locs = entry
            locs = [l for l in locs if l.url != url]
            if locs:
                self._vid_cache[vid] = (exp, locs)
            else:
                del self._vid_cache[vid]

    def invalidate(self, vid: int) -> None:
        """Drop cached locations for a volume — called when every cached
        replica failed a read, so the next lookup re-asks the master
        instead of replaying a stale map."""
        with self._lock:
            self._vid_cache.pop(vid, None)
            self._ec_vid_cache.pop(vid, None)

    def lookup_volume(self, vid: int, *, refresh: bool = False
                      ) -> list[Location]:
        now = time.time()
        if not refresh:
            with self._lock:
                entry = self._vid_cache.get(vid)
                if entry and entry[0] > now and entry[1]:
                    return list(entry[1])
        # the cache miss is the attributable part: inside a request
        # span the master round-trip becomes a `wdclient.lookup` child
        # (hits return above without a span — they cost nothing)
        with trace.span("wdclient.lookup", child_only=True, vid=vid,
                        refresh=refresh):
            resp = self._with_master(
                "LookupVolume", lambda stub: stub.LookupVolume(
                    master_pb2.LookupVolumeRequest(
                        volume_or_file_ids=[str(vid)]),
                    timeout=10))
        locs = []
        for e in resp.volume_id_locations:
            if e.error:
                self.invalidate(vid)  # a miss means the cache lied too
                raise LookupError(e.error)
            locs = [Location(l.url, l.public_url, l.grpc_port, l.data_center)
                    for l in e.locations]
        with self._lock:
            self._vid_cache[vid] = (now + self.cache_ttl, locs)
        return locs

    def lookup_file_id(self, fid: str, *, refresh: bool = False) -> list[str]:
        """-> http URLs serving this fid (LookupFileIdWithFallback)."""
        f = parse_file_id(fid)
        locs = self.lookup_volume(f.volume_id, refresh=refresh)
        if not locs:
            self.invalidate(f.volume_id)
            raise LookupError(f"volume {f.volume_id} has no locations")
        random.shuffle(locs)
        return [url_for(l.url, fid) for l in locs]

    def ec_fallback_urls(self, fid: str) -> list[str]:
        """Last-resort read targets: HTTP URLs of servers holding ANY EC
        shard of this fid's volume — each can serve the needle by
        reconstructing from any k shards (store_ec.go recover path).
        Empty when the volume was never EC-encoded."""
        f = parse_file_id(fid)
        try:
            shard_locs = self.lookup_ec_volume(f.volume_id)
        except (grpc.RpcError, ConnectionError, TimeoutError):
            return []  # not EC-encoded (NOT_FOUND) or masters unreachable
        servers: list[str] = []
        for locs in shard_locs.values():
            for l in locs:
                if l.url not in servers:
                    servers.append(l.url)
        random.shuffle(servers)
        return [url_for(url, fid) for url in servers]

    def lookup_ec_volume(self, vid: int) -> dict[int, list[Location]]:
        now = time.time()
        with self._lock:
            entry = self._ec_vid_cache.get(vid)
            if entry and entry[0] > now:
                return dict(entry[1])
        with trace.span("wdclient.lookup_ec", child_only=True, vid=vid):
            resp = self._with_master(
                "LookupEcVolume", lambda stub: stub.LookupEcVolume(
                    master_pb2.LookupEcVolumeRequest(volume_id=vid),
                    timeout=10))
        out = {
            sl.shard_id: [Location(l.url, l.public_url, l.grpc_port)
                          for l in sl.locations]
            for sl in resp.shard_id_locations
        }
        with self._lock:
            self._ec_vid_cache[vid] = (now + self.cache_ttl, out)
        return out

    # -- keep-connected stream (masterclient.go KeepConnected) -------------

    def keep_connected(self, client_type: str = "client",
                       on_update=None, stop_event: threading.Event | None = None,
                       client_address: str = "self", filer_group: str = ""):
        """Blocking stream consumer: applies VolumeLocation updates to the
        cache; reconnects on error until stop_event is set. Filers/brokers
        pass their address + filer_group so the master registers them in
        its cluster membership (weed/cluster)."""
        stop = stop_event or threading.Event()
        current_call = [None]  # the live stream, cancelled when stop fires

        def canceller():
            stop.wait()
            call = current_call[0]
            if call is not None:
                try:
                    call.cancel()
                # lint: allow-broad-except(cancelling a stream that already
                # ended may raise anything; the loop is stopping either way)
                except Exception:  # noqa: BLE001
                    pass

        threading.Thread(target=canceller, daemon=True).start()
        while not stop.is_set():
            try:
                stub = self._stub()

                def reqs():
                    yield master_pb2.KeepConnectedRequest(
                        client_type=client_type,
                        client_address=client_address,
                        filer_group=filer_group)
                    while not stop.is_set():
                        time.sleep(1)
                    return

                call = stub.KeepConnected(reqs())
                current_call[0] = call
                if stop.is_set():
                    call.cancel()
                for resp in call:
                    vl = resp.volume_location
                    if vl.url:
                        if vl.leader:
                            self._leader = vl.leader
                        loc = Location(vl.url, vl.public_url, vl.grpc_port,
                                       vl.data_center)
                        for vid in vl.new_vids:
                            self.add_location(vid, loc)
                        for vid in vl.deleted_vids:
                            self.delete_location(vid, vl.url)
                    if on_update is not None:
                        on_update(resp)
                    if stop.is_set():
                        break
            except grpc.RpcError:
                # rotate to the next configured master before redialing —
                # a dead leader must not pin the stream-reconnect loop
                if len(self.masters) > 1:
                    if self._leader in self.masters:
                        i = self.masters.index(self._leader)
                        self._leader = self.masters[
                            (i + 1) % len(self.masters)]
                    else:
                        self._leader = self.masters[0]
                if stop.wait(1.0):
                    break


# -- metadata ring client ------------------------------------------------

# Client-side ring cache TTL in seconds. The TTL only bounds staleness
# BETWEEN invalidations — a 410 wrong-shard answer refreshes immediately.
META_RING_TTL_S = 10.0


class MetaRingClient:
    """TTL'd cache of the master-published metadata ring.

    The vid-cache invalidation ladder applied to namespace
    routing: route from the cached ring; when a shard answers 410 +
    its current epoch, drop the cache if that epoch is newer, refetch,
    and retry ONCE. Fetches go to the master when one is configured,
    else to a seed filer's GetMetaRing proxy — any shard serves the
    ring it routes under, so gateways never need a master address."""

    def __init__(self, *, master: MasterClient | None = None,
                 filer_grpc: str = "", ttl: float | None = None):
        self.master = master
        self.filer_grpc = filer_grpc
        self.ttl = META_RING_TTL_S if ttl is None else ttl
        self._ring = None
        self._expires = 0.0
        self._lock = threading.Lock()

    def _fetch(self, trigger: str):
        from ..cluster.metaring import MetaRing
        from ..pb import meta_ring_pb2
        from ..utils.stats import META_RING_EPOCH, META_RING_FETCHES

        req = meta_ring_pb2.GetMetaRingRequest()
        try:
            if self.master is not None:
                resp = self.master._with_master(
                    "GetMetaRing",
                    lambda stub: stub.GetMetaRing(req, timeout=10))
            else:
                resp = rpc.filer_stub(self.filer_grpc).GetMetaRing(
                    req, timeout=10)
        except grpc.RpcError:
            META_RING_FETCHES.inc(trigger=trigger, result="error")
            raise
        META_RING_FETCHES.inc(trigger=trigger, result="ok")
        ring = MetaRing.from_response(resp)
        META_RING_EPOCH.set(ring.epoch)
        return ring

    def ring(self, *, refresh: bool = False, trigger: str = "ttl"):
        """Current ring snapshot (cached). grpc.RpcError propagates when
        the fetch target is down AND no cached picture exists — callers
        holding a stale ring keep routing on it rather than failing."""
        now = time.time()
        with self._lock:
            if not refresh and self._ring is not None \
                    and self._expires > now:
                return self._ring
        try:
            ring = self._fetch(trigger)
        except grpc.RpcError:
            with self._lock:
                if self._ring is not None:
                    return self._ring  # stale beats unreachable
            raise
        with self._lock:
            # an epoch can only move forward; a lagging answer (e.g. a
            # follower proxy) must not roll the cache back
            if self._ring is None or ring.epoch >= self._ring.epoch:
                self._ring = ring
            self._expires = time.time() + self.ttl
            return self._ring

    def note_epoch(self, epoch: int) -> bool:
        """Feed an epoch observed on a 410 answer; drops the cache when
        it proves the cached ring stale. -> True when invalidated."""
        with self._lock:
            if self._ring is not None and epoch > self._ring.epoch:
                self._expires = 0.0
                return True
        return False

    # -- routing -----------------------------------------------------------

    def route_entry(self, full_path: str, default: str = "") -> str:
        """HTTP address of the shard owning an entry (hashes the parent
        directory); `default` on an empty/unfetchable ring."""
        try:
            ring = self.ring()
        except grpc.RpcError:
            return default
        return ring.shard_for_entry(full_path) or default

    def route_directory(self, directory: str, default: str = "") -> str:
        """HTTP address of the shard owning a directory listing."""
        try:
            ring = self.ring()
        except grpc.RpcError:
            return default
        return ring.shard_for_directory(directory) or default

    def call_routed(self, key: str, fn, *, directory: bool = False,
                    default: str = ""):
        """Run fn(shard_http_address) with the one stale-ring retry:
        a WrongShardError feeds its epoch back, forces a refresh and
        re-routes exactly once — converged clients never loop."""
        from ..cluster.metaring import WrongShardError

        route = (self.route_directory if directory else self.route_entry)
        try:
            return fn(route(key, default))
        except WrongShardError as e:
            self.note_epoch(e.epoch)
            try:
                ring = self.ring(refresh=True, trigger="stale")
            except grpc.RpcError:
                raise e from None
            owner = (ring.shard_for_directory(key) if directory
                     else ring.shard_for_entry(key))
            return fn(owner or default)
