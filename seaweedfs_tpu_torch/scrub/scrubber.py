"""Continuous integrity plane: the per-volume-server background scrubber.

Production stores rot — disks flip bits, replicas diverge after
failovers, EC shards decay silently until a degraded read needs them.
Online-EC studies treat verification/repair as a first-class workload
that must be paced against foreground I/O (arXiv:1709.05365), and
pipelined coding makes repair cheap enough to run continuously
(RapidRAID, arXiv:1207.6744). This module is that workload:

  * **Needle CRC sweep** — walks every volume's .dat needle-by-needle
    (python and native-plane volumes alike), re-computing CRC32C over
    each live record and checking it against the stored checksum. The
    sweep keeps a persistent cursor (`<base>.scb`, JSON) so a restarted
    server resumes mid-volume instead of re-reading from zero.
  * **EC syndrome verify** — re-encodes the data shards of every local
    EC volume through the shared EC dispatch scheduler (ops/dispatch.py)
    and compares the recomputed parity against the on-disk .ec10–.ec13
    bytes. A parity recompute is bit-identical `encode_parity` work, so
    scrub slabs coalesce into the same stacked device dispatches as
    foreground encode traffic. Mismatching slabs are narrowed to the
    culprit shard by leave-one-out reconstruction.
  * **Anti-entropy** — builds digest manifests (scrub/digest.py) and
    compares rolling CRCs with every replica via the VolumeDigest RPC;
    only diverging volumes exchange entry lists, and only diverging
    needles move bytes.
  * **Self-healing repair** — findings escalate: quarantine the needle
    (server answers from a healthy replica mid-repair) or the shard
    (reads degrade-reconstruct around it), then re-replicate /
    EC-rebuild, re-verify, and only then clear the finding.

Pacing: a token bucket (`SWFS_SCRUB_MAX_MBPS`, 0 = unpaced) bounds bytes
read per second, and the sweep backs off whenever the server's
foreground QPS exceeds `SWFS_SCRUB_FG_QPS`. The daemon period is
`SWFS_SCRUB_INTERVAL_S` (0 disables the thread; `run_once` still serves
the on-demand RPC / shell paths). After each paced window the swept
byte range is dropped from the page cache (`SWFS_SCRUB_FADVISE`,
default on) so a cold sweep never evicts the hot working set.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..ops import dispatch
from ..storage import types
from ..storage.crc import crc32c
from ..storage.ec_files import to_host
from ..storage.errors import DeletedError, NotFoundError
from ..storage.needle import CrcError, Needle
from ..utils import atomic_write, glog
from ..utils.locks import wcondition, wlock
from ..utils.stats import (
    SCRUB_BACKOFFS,
    SCRUB_BYTES,
    SCRUB_FINDINGS,
    SCRUB_NEEDLES,
    SCRUB_PACE_WAIT_SECONDS,
    SCRUB_REPAIRS,
    SCRUB_SKIPPED_PAIRS,
    SCRUB_SWEEPS,
)
from . import digest as digest_mod
from . import gather as gather_mod

MAX_FINDINGS_KEPT = 256
DEFAULT_EC_SLAB = 1 << 20


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


def fadvise_enabled() -> bool:
    """SWFS_SCRUB_FADVISE (default ON, satellite): after each
    paced sweep window the scrubber POSIX_FADV_DONTNEEDs the byte range
    it just read. The sweep touches every cold byte of every volume
    exactly once — without the hint that single pass evicts the serving
    working set from the page cache (python AND native-plane reads: the
    hint acts on the inode, not the descriptor)."""
    return os.environ.get("SWFS_SCRUB_FADVISE", "1").lower() not in (
        "0", "false", "off")


def _drop_swept_range(backing, offset: int, length: int) -> None:
    """Best-effort page-cache drop of [offset, offset+length) on a
    volume/shard backing file; only the RANGE the window read is dropped
    so hot pages outside it keep serving reads."""
    if not fadvise_enabled() or backing is None or length <= 0:
        return
    fn = getattr(backing, "drop_page_cache", None)
    if fn is not None:
        fn(offset, length)


def cross_verify_enabled() -> bool:
    """SWFS_SCRUB_CROSS (default ON): EC volumes whose shards
    are split across servers get a cross-server syndrome verify — the
    scrubbing holder gathers a repair-plan's worth of survivor ranges
    from peers instead of skipping the volume."""
    return os.environ.get("SWFS_SCRUB_CROSS", "1").lower() not in (
        "0", "false", "off")


def fetch_verified_needle(stub, vid: int, needle_id: int,
                          version: int) -> Needle | None:
    """ReadNeedleBlob by needle id, parsed + CRC-verified — the ONE
    replica-fetch used by scrub repair, anti-entropy pulls, and the
    server's quarantine failover (never heal FROM rot, never serve it)."""
    import grpc

    from ..pb import volume_server_pb2 as vs

    try:
        resp = stub.ReadNeedleBlob(vs.ReadNeedleBlobRequest(
            volume_id=vid, needle_id=needle_id), timeout=30)
        return Needle.from_bytes(bytes(resp.needle_blob), version)
    except (grpc.RpcError, IOError, ValueError):
        return None


def fetch_needle_from_replicas(srv, vid: int, needle_id: int,
                               version: int) -> Needle | None:
    """Try every replica the master knows (self excluded) until one
    yields a verified copy."""
    from ..pb import rpc

    for addr in srv.lookup_volume_locations(vid):
        if addr == srv.address:
            continue
        n = fetch_verified_needle(
            rpc.volume_stub(rpc.grpc_address(addr)), vid, needle_id,
            version)
        if n is not None:
            return n
    return None


class TokenBucket:
    """Byte-rate pacer: take(n) sleeps long enough to keep the long-run
    rate under `rate_bytes_per_s` (1s burst capacity). rate <= 0 = off."""

    def __init__(self, rate_bytes_per_s: float):
        self.rate = rate_bytes_per_s
        self.capacity = max(rate_bytes_per_s, 1.0)
        self._tokens = self.capacity
        self._last = time.monotonic()
        self._lock = wlock("scrub.pacer", rank=830)

    def take(self, n: int) -> float:
        if self.rate <= 0 or n <= 0:
            return 0.0
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.capacity,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            self._tokens -= n
            wait = -self._tokens / self.rate if self._tokens < 0 else 0.0
        if wait > 0:
            time.sleep(wait)
            SCRUB_PACE_WAIT_SECONDS.inc(wait)
        return wait


@dataclass
class Finding:
    volume_id: int
    kind: str               # needle_crc | ec_parity | replica_divergence
    needle_id: int = 0
    shard_id: int = 0
    detail: str = ""
    state: str = "found"    # found | repaired | failed
    found_at: float = field(default_factory=time.time)

    def set_state(self, state: str) -> None:
        self.state = state
        SCRUB_FINDINGS.inc(kind=self.kind, state=state)


@dataclass
class ScrubReport:
    volumes: int = 0
    needles: int = 0
    bytes: int = 0
    repaired: int = 0
    # anti-entropy peer pairs whose digest probe failed after retry —
    # partial sweep coverage, surfaced instead of silently swallowed
    skipped_pairs: int = 0
    findings: list[Finding] = field(default_factory=list)


class _Cursor:
    """Persistent per-volume sweep position (`<base>.scb`): survives
    restarts so a multi-hour volume resumes mid-sweep. The compaction
    revision is stored alongside — a vacuum shifts every offset, so a
    revision mismatch resets the cursor instead of verifying garbage."""

    # serializes every save() in this process: the anti-clobber guard in
    # save() is read-check-then-replace, and the vacuum publication races
    # a sweep's periodic save within ONE process (the server owning the
    # volume's files), so a lock closes the window completely
    _save_mu = wlock("scrub.cursor_save", rank=840)

    def __init__(self, base: str):
        self.path = base + ".scb"
        self.offset = 0
        self.ec_offset = 0
        self.sweeps = 0
        self.revision = -1
        try:
            with open(self.path) as f:
                d = json.load(f)
            self.offset = int(d.get("offset", 0))
            self.ec_offset = int(d.get("ecOffset", 0))
            self.sweeps = int(d.get("sweeps", 0))
            self.revision = int(d.get("revision", -1))
        except (OSError, ValueError):
            pass

    def save(self) -> None:
        try:
            with _Cursor._save_mu:
                # never clobber a publication from a NEWER compaction
                # revision: a vacuum committing mid-sweep publishes
                # revision N while this sweep still holds N-1 — its
                # periodic saves must lose, so the next pass ADOPTS the
                # published cursor (_sweep_volume) instead of resetting
                try:
                    with open(self.path) as f:
                        if int(json.load(f).get("revision", -1)) \
                                > self.revision:
                            return
                except (OSError, ValueError):
                    pass
                atomic_write.write_json_atomic(
                    self.path, {"offset": self.offset,
                                "ecOffset": self.ec_offset,
                                "sweeps": self.sweeps,
                                "revision": self.revision,
                                "updated": time.time()})
        except OSError:
            pass  # cursor persistence is best-effort


def _publish_completed_pass(v, cur: "_Cursor", verified_end: int,
                            refresh_digest: bool = True) -> None:
    """THE completed-needle-pass publication — the background sweep and
    the scrub-aware vacuum both end here, so the sequence (cursor at the
    end of the verified extent, sweep counted, digest manifest refreshed
    for anti-entropy peers) can never drift between the two paths."""
    cur.offset = verified_end
    cur.sweeps += 1
    SCRUB_SWEEPS.inc(kind="volume")
    if refresh_digest:
        try:
            entries = digest_mod.volume_digest_entries(v)
            digest_mod.write_manifest(v.file_name(), entries)
            SCRUB_BYTES.inc(len(entries) * digest_mod.ENTRY_SIZE,
                            kind="digest")
        except OSError:
            pass  # manifest refresh is best-effort; the next pass retries
    cur.save()


def record_vacuum_pass(v, needles: int, nbytes: int,
                       verified_end: int | None = None) -> None:
    """Publish a CRC-verified vacuum as a completed scrub pass
    (scrub-aware vacuum).

    Volume.compact() re-verified every live record it copied, so the
    fresh .dat is byte-proven at its NEW compaction revision up to
    `verified_end` (captured under the volume lock at commit — appends
    racing the publication are NOT claimed as verified): bump the
    persistent cursor (`.scb`) to that extent at the new revision,
    refresh the digest manifest (`.dig`), and credit the counters. A
    running Scrubber adopts the published cursor instead of resetting
    to zero on the revision bump (_sweep_volume), so a vacuum never
    costs a redundant full re-scrub."""
    cur = _Cursor(v.file_name())
    cur.revision = v.super_block.compaction_revision
    SCRUB_NEEDLES.inc(needles)
    SCRUB_BYTES.inc(nbytes, kind="needle")
    # the inline digest refresh costs one CRC-tail pread per live needle
    # — fine for ordinary volumes, but the vacuum COMMIT reply must stay
    # bounded on huge ones; past the threshold the manifest is left to
    # the next paced background sweep (anti-entropy reads entries live,
    # so only check.disk's manifest freshness waits)
    limit = int(_env_float("SWFS_VACUUM_DIGEST_MAX_NEEDLES", 250_000))
    _publish_completed_pass(
        v, cur, v.data_size() if verified_end is None else verified_end,
        refresh_digest=v.file_count() <= limit)


class Scrubber:
    """One per volume server (constructable over a bare Store for tests).

    `server` (when given) provides replica lookup for repair, the
    foreground-QPS signal for backoff, and the recon-cache invalidation
    hook; without it the scrubber still detects and does local-only
    repair (EC rebuild)."""

    def __init__(self, store, server=None, *,
                 interval_s: float | None = None,
                 max_mbps: float | None = None):
        self.store = store
        self.server = server
        self.interval = _env_float("SWFS_SCRUB_INTERVAL_S", 3600.0) \
            if interval_s is None else interval_s
        mbps = _env_float("SWFS_SCRUB_MAX_MBPS", 64.0) \
            if max_mbps is None else max_mbps
        self.bucket = TokenBucket(mbps * 1024 * 1024)
        self.fg_qps_limit = _env_float("SWFS_SCRUB_FG_QPS", 50.0)
        self.backoff_s = _env_float("SWFS_SCRUB_BACKOFF_MS", 200.0) / 1e3
        self.ec_slab = int(_env_float("SWFS_SCRUB_EC_SLAB",
                                      DEFAULT_EC_SLAB))
        # bytes of needle records verified per volume per pass; 0 =
        # sweep each volume to the end in one pass. A bounded pass keeps
        # any single run_once() short on multi-GB volumes — the cursor
        # carries the position to the next pass (and across restarts).
        self.pass_budget = int(_env_float("SWFS_SCRUB_PASS_BYTES", 0))
        self.findings: list[Finding] = []
        # vid -> {sid: ShardCrc} folded from the last clean syndrome
        # sweep; MUST be invalidated whenever shard files change
        # (mount/unmount/delete/rebuild — server handlers wire it)
        self._ec_digests: dict[int, dict] = {}
        self.sweeps_completed = 0
        self.last_sweep_unix = 0.0
        self.running = False
        self._cursors: dict[str, _Cursor] = {}
        # witnessed: _run_lock is the OUTERMOST lock of a
        # whole scrub pass — sweeps acquire volume.mu (300) and the
        # dispatch plane (100+) under it, so its rank sits below both.
        # _mu is bookkeeping reached from several planes (report_suspect
        # off read paths, status snapshots) and stays unranked: the
        # order witness still convicts any real inversion through it.
        self._run_lock = wlock("scrub.run", rank=20)
        self._mu = wlock("scrub.mu")
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._suspects: set[int] = set()
        self._thread: threading.Thread | None = None

    # -- daemon lifecycle --------------------------------------------------

    def start(self) -> None:
        if self.interval <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="scrub-daemon", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.interval)
            self._wake.clear()
            if self._stop.is_set():
                return
            with self._mu:
                suspects = sorted(self._suspects)
                self._suspects.clear()
            try:
                if suspects:
                    # a read-path CRC failure escalated: verify those
                    # volumes promptly instead of waiting a full period
                    for vid in suspects:
                        self.run_once(vid=vid)
                else:
                    self.run_once()
            except Exception as e:  # noqa: BLE001 — keep the daemon alive
                glog.warning(f"scrub sweep failed: {e}")

    def invalidate_ec_digest(self, vid: int,
                             remove_manifest: bool = False) -> None:
        """Shard files changed: drop the cached per-shard CRCs so
        VolumeDigest never serves stale ones. `remove_manifest` also
        unlinks the on-disk `.dig` EC manifest — pass it from handlers
        that change shard BYTES (copy/rebuild/delete); plain
        mount/unmount only reopen the same files, and the manifest
        fallback below revalidates the shard set + sizes anyway."""
        self._ec_digests.pop(vid, None)
        if remove_manifest:
            for loc in self.store.locations:
                _vols, ecs = loc.scan()
                col = ecs.get(vid, ("",))[0] if vid in ecs else ""
                for base in {loc.base_name(col, vid),
                             loc.base_name("", vid)}:
                    try:
                        os.remove(base + ".dig")
                    except OSError:
                        pass

    def cached_ec_digest(self, vid: int) -> dict | None:
        """Per-shard CRCs folded by the last clean syndrome sweep, or —
        when memory has nothing — read back from the `.dig` manifest the
        streaming-EC destination persisted at commit, validated
        against the mounted shard set and file sizes. None when neither
        source can answer; callers never touch the dict directly."""
        got = self._ec_digests.get(vid)
        if got is not None:
            return got
        ev = self.store.find_ec_volume(vid)
        if ev is None:
            return None
        try:
            manifest = digest_mod.read_ec_manifest(ev.base + ".dig")
        except (IOError, OSError):
            return None
        out: dict[int, digest_mod.ShardCrc] = {}
        for sid, f in ev.shard_files.items():
            sc = manifest.get(sid)
            if sc is None or sc.size != f.size():
                return None  # manifest describes other shard files
            out[sid] = sc
        return out or None

    def report_suspect(self, vid: int) -> None:
        """Serving-path hook: a read smelled corruption in `vid` — queue a
        targeted verify without waiting for the next periodic sweep."""
        with self._mu:
            self._suspects.add(vid)
        self._wake.set()

    # -- findings registry -------------------------------------------------

    def _add_finding(self, f: Finding) -> Finding:
        SCRUB_FINDINGS.inc(kind=f.kind, state="found")
        with self._mu:
            self.findings.append(f)
            del self.findings[:-MAX_FINDINGS_KEPT]
        glog.warning(
            f"scrub finding: vol {f.volume_id} {f.kind} "
            f"needle={f.needle_id:x} shard={f.shard_id}: {f.detail}")
        return f

    def snapshot_findings(self) -> list[Finding]:
        with self._mu:
            return list(self.findings)

    # -- pacing ------------------------------------------------------------

    def _maybe_backoff(self) -> None:
        srv = self.server
        if srv is None or self.fg_qps_limit <= 0:
            return
        qps_fn = getattr(srv, "foreground_qps", None)
        if qps_fn is None:
            return
        while qps_fn() > self.fg_qps_limit and not self._stop.is_set():
            SCRUB_BACKOFFS.inc()
            time.sleep(self.backoff_s)

    def _governor(self):
        """The server's QoS BackgroundGovernor, when one is attached
       : scrub bytes then draw from the CLUSTER background
        budget on top of the local SWFS_SCRUB_MAX_MBPS bucket."""
        return getattr(self.server, "qos_governor", None)

    def _pace(self, nbytes: int, work_class: str = "scrub") -> None:
        """Local pacing + cluster-token admission for `nbytes` of sweep
        work. QosUnavailable propagates (fail closed): run_once turns it
        into a paused pass, never an error to any client."""
        self.bucket.take(nbytes)
        gov = self._governor()
        if gov is not None:
            gov.acquire(work_class, nbytes)

    # -- the sweep ---------------------------------------------------------

    def run_once(self, vid: int | None = None, full: bool = False,
                 repair: bool = True,
                 anti_entropy: bool | None = None) -> ScrubReport:
        """One pass over this server's volumes (or just `vid`): needle CRC
        sweep + EC syndrome verify + (when replicated and a server is
        attached) digest anti-entropy. Serialized: concurrent callers
        queue behind the running pass.

        Traced: each pass is a span — a root when the daemon
        runs it, a child when `volume.scrub` / VolumeScrub drives it —
        so background integrity work shows up in the same plane as the
        foreground requests it competes with."""
        from ..utils import trace

        from ..qos import QosUnavailable

        report = ScrubReport()
        with self._run_lock, \
                trace.span("scrub.run", component="volume",
                           vid=vid or 0, full=full) as tsp:
            self.running = True
            try:
                for loc in self.store.locations:
                    for v_id, v in list(loc.volumes.items()):
                        if vid is not None and v_id != vid:
                            continue
                        self._sweep_volume(v, full, repair, report)
                        report.volumes += 1
                    for v_id, ev in list(loc.ec_volumes.items()):
                        if vid is not None and v_id != vid:
                            continue
                        self._verify_ec_volume(loc, v_id, full, repair,
                                               report)
                        report.volumes += 1
                if anti_entropy or (anti_entropy is None
                                    and self.server is not None):
                    self.run_anti_entropy(vid=vid, repair=repair,
                                          report=report)
                self.sweeps_completed += 1
                self.last_sweep_unix = time.time()
                tsp.set_attr(volumes=report.volumes,
                             needles=report.needles,
                             bytes=report.bytes,
                             findings=len(report.findings),
                             repaired=report.repaired)
            except QosUnavailable as e:
                # fail closed: the cluster withheld background
                # tokens — master unreachable mid-lease or higher-
                # priority demand holds the budget. The pass PAUSES;
                # persisted cursors resume exactly where it stopped.
                glog.warning(f"scrub pass paused by the qos plane: {e}")
                tsp.set_attr(qosPaused=str(e)[:120])
            finally:
                self.running = False
        return report

    # ---- plain volumes: needle-by-needle CRC

    def _cursor_for(self, base: str) -> _Cursor:
        with self._mu:  # status() snapshots this dict concurrently
            cur = self._cursors.get(base)
            if cur is None:
                cur = self._cursors[base] = _Cursor(base)
            return cur

    def _sweep_volume(self, v, full: bool, repair: bool,
                      report: ScrubReport) -> None:
        base = v.file_name()
        if v.is_tiered:
            return  # remote .dat: tier backends carry their own checksums
        cur = self._cursor_for(base)
        with v._lock:
            try:
                v._sync_buffers()  # sweep reads the file under group commit
            except OSError:
                return  # surfaced to writers by their own flush
        if v.native is not None:
            v.sync_native()
        revision = v.super_block.compaction_revision
        if cur.revision != revision:
            # compaction rewrote every offset — but a scrub-aware vacuum
            # (record_vacuum_pass) publishes a cursor AT the new revision
            # covering the bytes it verified; adopt that instead of
            # re-scrubbing a volume the vacuum just proved clean
            disk = _Cursor(base)
            if disk.revision == revision:
                with self._mu:
                    self._cursors[base] = disk
                cur = disk
            else:
                cur.offset = 0
                cur.revision = revision
        dat_size = v.data_size()
        start = cur.offset
        if full or start >= dat_size:
            start = 0
        # The needle MAP drives the walk, in .dat offset order — never
        # on-disk record chaining: a rotten header's bogus size field
        # would stall a chained walk at the first bad record and leave
        # everything past it silently unscrubbed forever. Map-driven,
        # header rot in a live record surfaces as a finding instead
        # (id/size mismatch against the map via expected_size).
        entries = sorted(
            (types.stored_to_actual_offset(nv.offset), nv.size, key)
            for key, nv in list(v.nm)
            if nv.offset != 0 and not types.size_is_deleted(nv.size))
        persist_every = 8 * 1024 * 1024
        since_persist = 0
        verified_this_pass = 0
        completed = True
        # page-cache drop window: swept_end advances ONLY as
        # entries are actually read this pass — cur.offset alone can
        # hold a PREVIOUS pass's cursor when the loop exits early (stop,
        # empty entry list, wrapped full pass), and dropping [0, stale
        # cursor) would evict hot bytes this pass never touched
        window_start = swept_end = start
        for off, size, key in entries:
            if off < start or off >= dat_size:
                continue  # behind the cursor, or appended mid-sweep
            if self._stop.is_set():
                completed = False
                break
            if self.pass_budget and verified_this_pass >= self.pass_budget:
                completed = False  # bounded pass: cursor resumes next run
                break
            self._maybe_backoff()
            length = types.actual_size(size, v.version)
            self._pace(length)
            blob = v._pread_durable(off, length)
            SCRUB_BYTES.inc(len(blob), kind="needle")
            SCRUB_NEEDLES.inc()
            report.needles += 1
            report.bytes += len(blob)
            verified_this_pass += len(blob)
            bad, err = False, ""
            try:
                if len(blob) < length:
                    raise IOError(f"short record read "
                                  f"({len(blob)} < {length})")
                parsed = Needle.from_bytes(blob, v.version,
                                           expected_size=size)
                if parsed.id != key:
                    raise IOError(
                        f"record id {parsed.id:x} != map id {key:x}")
            except (CrcError, ValueError, IOError) as e:
                bad, err = True, str(e)
            else:
                if parsed.has_expired():
                    bad = False  # dying anyway; repair would resurrect
            nv_now = v.nm.get(key)
            still_live = (nv_now is not None
                          and not types.size_is_deleted(nv_now.size)
                          and types.stored_to_actual_offset(nv_now.offset)
                          == off)
            if bad and still_live:
                f = self._add_finding(Finding(
                    v.id, "needle_crc", needle_id=key,
                    detail=f"offset {off}: {err}"))
                report.findings.append(f)
                if repair:
                    if self._repair_needle(v, key, f):
                        report.repaired += 1
            cur.offset = off + length
            swept_end = cur.offset
            since_persist += length
            if since_persist >= persist_every:
                cur.save()
                since_persist = 0
                # paced window complete: evict exactly the cold bytes
                # this window read, before they push hot pages out
                _drop_swept_range(v._dat, window_start,
                                  swept_end - window_start)
                window_start = swept_end
        _drop_swept_range(v._dat, window_start,
                          swept_end - window_start)
        if completed:
            # cursor at the snapshot extent: the next pass wraps to the
            # beginning (and appends landing mid-publication are not
            # claimed as verified)
            _publish_completed_pass(v, cur, dat_size)
        else:
            cur.save()

    def _repair_needle(self, v, needle_id: int, finding: Finding) -> bool:
        """Quarantine -> fetch a CRC-verified copy from a healthy replica
        -> rewrite locally -> re-verify -> clear. The server keeps
        serving the needle from the replica while quarantined."""
        v.quarantine(needle_id)
        try:
            n = None
            if self.server is not None:
                n = fetch_needle_from_replicas(self.server, v.id,
                                               needle_id, v.version)
            if n is None:
                finding.set_state("failed")
                SCRUB_REPAIRS.inc(method="re_replicate", outcome="failed")
                return False
            # repair-class cluster tokens: outranks scrub and
            # archival in the ledger, so a repair backlog drains first.
            # QosUnavailable propagates to run_once (pass pauses).
            self._pace(len(n.data), work_class="repair")
            try:
                # verbatim replica copy: keep the ORIGINATING write's
                # epoch tag (stamping here would forge causality)
                v.write_needle(n, check_cookie=False, stamp=False)
                nv = v.nm.get(needle_id)
                if nv is None:
                    raise IOError("repair write vanished from the map")
                v._read_record(nv)  # re-verify: CRC checked on parse
            except (IOError, ValueError) as e:
                finding.detail += f"; repair failed: {e}"
                finding.set_state("failed")
                SCRUB_REPAIRS.inc(method="re_replicate", outcome="failed")
                return False
            finding.set_state("repaired")
            SCRUB_REPAIRS.inc(method="re_replicate", outcome="ok")
            glog.info(f"scrub: vol {v.id} needle {needle_id:x} "
                      f"re-replicated and verified clean")
            return True
        finally:
            v.unquarantine(needle_id)

    # ---- EC volumes: syndrome verify through the dispatch scheduler

    def _geo_coder(self, geo):
        # per-code-geometry coders cached on the store: the
        # syndrome re-encode must multiply THIS volume's generator
        # matrix — local and global parity rows alike — and its slabs
        # must never stack into another geometry's dispatch lane
        return self.store.coder_for(geo)

    def _verify_ec_volume(self, loc, vid: int, full: bool, repair: bool,
                          report: ScrubReport, _depth: int = 0) -> None:
        ev = loc.ec_volumes.get(vid)
        if ev is None:
            return
        geo = ev.geo
        k = geo.data_shards
        present = set(ev.shard_files)
        parity_present = [k + j for j in range(geo.parity_shards)
                          if k + j in present]
        if not all(i in present for i in range(k)) or not parity_present:
            # shards split across servers: no local re-encode possible.
            # reported these volumes "skipped"; now the holder
            # gathers exactly a repair-plan's worth of survivor ranges
            # from peers and verifies its own shards.
            self._verify_ec_volume_cross(loc, vid, full, repair, report,
                                         _depth)
            return
        coder = self._geo_coder(geo)
        sched = dispatch.maybe_scheduler(coder)
        encode = coder.encode_parity if sched is None else sched.encode_parity
        cur = self._cursor_for(ev.base)
        shard_size = ev.shard_size
        slab = max(4096, self.ec_slab)
        start = 0 if full or cur.ec_offset >= shard_size else cur.ec_offset
        off = start
        # whole-shard CRCs chained slab-to-slab as the sweep reads them
        # in file order — crc32c's incremental form; crc32c_combine
        # stays available for out-of-order/parallel folds but would be
        # pure overhead here (GF(2) matrix math per slab)
        running: dict[int, int] = ({i: 0 for i in sorted(present)}
                                   if start == 0 else {})
        clean = True
        win_start = start  # page-cache drop window
        while off < shard_size:
            if self._stop.is_set():
                return
            self._maybe_backoff()
            n = min(slab, shard_size - off)
            self._pace(n * len(present))
            rows: dict[int, np.ndarray] = {}
            for i in sorted(present):
                data = ev.shard_files[i].read_at(off, n)
                rows[i] = np.frombuffer(
                    data + b"\0" * (n - len(data)), np.uint8)
                if i in running:
                    running[i] = crc32c(rows[i].tobytes(), running[i])
            data_stack = np.stack([rows[i] for i in range(k)])
            # the recompute rides the shared encode lane: scrub slabs
            # stack into the same device dispatches as foreground encodes
            recomputed = to_host(encode(data_stack))
            SCRUB_BYTES.inc(n * len(present), kind="ec_syndrome")
            report.bytes += n * len(present)
            for j, sid in enumerate(range(k, geo.total_shards)):
                if sid not in rows:
                    continue
                if not np.array_equal(recomputed[j], rows[sid]):
                    clean = False
                    culprit = self._identify_bad_shard(ev, coder, off, n)
                    f = self._add_finding(Finding(
                        vid, "ec_parity",
                        shard_id=culprit if culprit is not None else 255,
                        detail=f"syndrome mismatch in shard byte range "
                               f"[{off}, {off + n})"
                               + ("" if culprit is not None
                                  else " (culprit ambiguous)")))
                    report.findings.append(f)
                    if repair and culprit is not None:
                        if self._repair_ec_shard(loc, vid, culprit, f):
                            report.repaired += 1
                            if _depth < 2:
                                # shards were rebuilt: re-verify the whole
                                # volume against the fresh files
                                self._verify_ec_volume(
                                    loc, vid, True, repair, report,
                                    _depth + 1)
                            return
                    break  # one finding per slab is enough
            off += n
            cur.ec_offset = off
            if off - win_start >= 8 << 20:
                # paced window complete: evict the swept range on every
                # shard file before it displaces the hot working set
                for sf in ev.shard_files.values():
                    _drop_swept_range(sf, win_start, off - win_start)
                win_start = off
        for sf in ev.shard_files.values():
            _drop_swept_range(sf, win_start, off - win_start)
        cur.ec_offset = off if off < shard_size else shard_size
        if off >= shard_size and clean:
            cur.sweeps += 1
            SCRUB_SWEEPS.inc(kind="ec")
            if start == 0 and running:
                # whole-shard digests fall out of the slabs we already
                # read — no second pass over the files
                self._ec_digests[vid] = {
                    i: digest_mod.ShardCrc(i, running[i],
                                           ev.shard_files[i].size())
                    for i in running if i in ev.shard_files}
        cur.save()

    def _identify_bad_shard(self, ev, coder, off: int,
                            size: int) -> int | None:
        """Leave-one-out over local shard files (the all-local sweep)."""
        rows: dict[int, np.ndarray] = {}
        for i, f in ev.shard_files.items():
            data = f.read_at(off, size)
            rows[i] = np.frombuffer(data + b"\0" * (size - len(data)),
                                    np.uint8)
        return self._pin_culprit_from_rows(ev.geo, coder, rows)

    def _pin_culprit_from_rows(self, geo, coder,
                               rows: dict[int, np.ndarray]) -> int | None:
        """Leave-one-out: the corrupt shard is the one whose replacement
        by a reconstruction from the others makes every parity equation
        hold again. Exact for single-shard corruption under RS(k, m);
        needs every shard's bytes for the window — rows short of the
        full set return None (ambiguous)."""
        total = geo.total_shards
        if len(rows) < total:
            return None  # missing shards are the rebuild path's business
        k = geo.data_shards
        for cand in range(total):
            pres = tuple(i for i in range(total) if i != cand)
            try:
                missing, out = dispatch.reconstruct_now(
                    coder, pres, np.stack([rows[i] for i in pres]))
                rec = to_host(out[list(missing).index(cand)])
            except (IOError, ValueError, KeyError):
                continue
            trial = dict(rows)
            trial[cand] = rec
            parity = to_host(coder.encode_parity(
                np.stack([trial[i] for i in range(k)])))
            if all(np.array_equal(parity[j], trial[k + j])
                   for j in range(geo.parity_shards)):
                return cand
        return None

    def _repair_ec_shard(self, loc, vid: int, sid: int,
                         finding: Finding) -> bool:
        """Quarantine the shard (reads degrade-reconstruct around it),
        delete its file, EC-rebuild from the survivors, remount, and let
        the caller re-verify the fresh bytes."""
        from ..qos import QosUnavailable

        ev = loc.ec_volumes.get(vid)
        if ev is None:
            return False
        base = ev.base
        collection = getattr(ev, "collection", "")
        geo = ev.geo
        try:
            # atomic replace (no close): in-flight readers iterating the
            # old dict keep a valid mmap; dropping the entry makes every
            # NEW read reconstruct instead of serving rotten bytes
            ev.shard_files = {i: f for i, f in ev.shard_files.items()
                              if i != sid}
            shard_path = geo.shard_file_name(base, sid)
            try:
                os.remove(shard_path)
            except FileNotFoundError:
                pass
            from ..storage.ec_files import rebuild_ec_files

            coder = self._geo_coder(geo)
            # repair-class pacing: the survivor reads are the
            # heaviest I/O burst the scrubber can emit — each slab draws
            # from the local MBPS bucket AND the cluster repair budget
            rebuilt = rebuild_ec_files(
                base, coder, geo,
                pace=lambda n: self._pace(n, work_class="repair"))
            self.store.mount_ec_shards(vid, collection, rebuilt)
            self.invalidate_ec_digest(vid, remove_manifest=True)
            srv = self.server
            if srv is not None:
                srv.ec_recon_cache.invalidate(vid)
                srv.trigger_heartbeat()
        except QosUnavailable:
            # not a failed repair: the cluster withheld tokens — pass
            # pauses (run_once), the quarantined shard reconstructs on
            # read and the next sweep retries the rebuild
            raise
        except (IOError, ValueError, OSError) as e:
            finding.detail += f"; rebuild failed: {e}"
            finding.set_state("failed")
            SCRUB_REPAIRS.inc(method="ec_rebuild", outcome="failed")
            return False
        finding.set_state("repaired")
        SCRUB_REPAIRS.inc(method="ec_rebuild", outcome="ok")
        glog.info(f"scrub: ec vol {vid} shard {sid} rebuilt from survivors")
        return True

    # ---- cross-server syndrome verify

    def _cross_plan(self, ev, vid: int, geom, srv):
        """-> (shard_addrs, all_present, plans) for a split EC volume:
        which peers hold which shards, and — per locally-held shard —
        the geometry's minimal-read verify plan (an LRC local-parity
        holder plans its 5-shard group, never k=10). Targets whose plan
        needs a shard no reachable peer holds are dropped; an empty
        plans dict means nothing is verifiable from here."""
        from ..models.geometry import UnsolvableError

        local = set(ev.shard_files)
        for refresh in (False, True):
            locs = srv._lookup_ec_shards(vid, refresh=refresh)
            shard_addrs = {
                sid: [a for a in addrs if a != srv.address]
                for sid, addrs in locs.items()}
            shard_addrs = {s: a for s, a in shard_addrs.items() if a}
            all_present = tuple(sorted(local | set(shard_addrs)))
            plans = {}
            for sid in sorted(local):
                try:
                    plan = geom.repair_plan(
                        (sid,), tuple(i for i in all_present if i != sid))
                except (UnsolvableError, ValueError):
                    continue
                if all(i in local or i in shard_addrs for i in plan.reads):
                    plans[sid] = plan
            if len(plans) == len(local):
                break
            # a local shard left unverifiable: the cached map may predate
            # a rebuild or a server's return, so ask the master once more
        return shard_addrs, all_present, plans

    def _verify_ec_volume_cross(self, loc, vid: int, full: bool,
                                repair: bool, report: ScrubReport,
                                _depth: int = 0) -> None:
        """Syndrome verify of a split EC volume: every locally-held
        shard is recomputed from its repair plan's survivor ranges —
        local reads where possible, peer ranges gathered through the
        chunked VolumeEcShardsRead transport (slab-resume after a flap),
        recompute riding the volume's own coder dispatch lanes while
        the next window's gather is in flight. Fetch volume is bounded
        by the PLAN, not k: an LRC local-parity verify moves 5 shards'
        ranges. All paced as scrub-class bytes."""
        ev = loc.ec_volumes.get(vid)
        srv = self.server
        if ev is None or srv is None or not cross_verify_enabled():
            return
        geo = ev.geo
        try:
            geom = geo.code_geometry()
        except ValueError:
            return  # unregistered geometry never serves, never verifies
        shard_addrs, all_present, plans = self._cross_plan(ev, vid, geom,
                                                           srv)
        if not plans:
            return  # peers own their shards; nothing verifiable here
        coder = self._geo_coder(geo)
        collection = getattr(ev, "collection", "")
        needed = set()
        for plan in plans.values():
            needed.update(plan.reads)
        local = set(ev.shard_files)
        remote_needed = sorted(needed - local)
        local_read = sorted((needed | set(plans)) & local)
        cur = self._cursor_for(ev.base)
        shard_size = ev.shard_size
        # window stride == wire slab stride: the server clamps slabs to
        # its 2MB streaming chunk, so the consumer must too, or windows
        # would pop at a coarser stride than slabs arrive
        slab = min(max(4096, self.ec_slab), gather_mod.MAX_SLAB)
        start = 0 if full or cur.ec_offset >= shard_size else cur.ec_offset
        running: dict[int, int] = ({i: 0 for i in local_read}
                                   if start == 0 else {})
        g = None
        if remote_needed:
            g = gather_mod.ShardRangeGatherer(
                vid, collection,
                {s: shard_addrs[s] for s in remote_needed},
                shard_size, slab, start=start)
        clean = covered = True
        off = start
        try:
            while off < shard_size:
                if self._stop.is_set():
                    covered = False
                    return
                self._maybe_backoff()
                n = min(slab, shard_size - off)
                rows: dict[int, np.ndarray] = {}
                for i in local_read:
                    data = ev.shard_files[i].read_at(off, n)
                    rows[i] = np.frombuffer(
                        data + b"\0" * (n - len(data)), np.uint8)
                    if i in running:
                        running[i] = crc32c(rows[i].tobytes(), running[i])
                try:
                    remote_rows = g.window(off, n) if g else {}
                except gather_mod.GatherError as e:
                    glog.warning(f"scrub: cross-server verify of ec vol "
                                 f"{vid} degraded: {e}")
                    # a holder that no longer answers: the next lookup
                    # asks the master
                    srv._ec_loc_cache.pop(vid, None)
                    covered = False
                    break
                for i, b in remote_rows.items():
                    rows[i] = np.frombuffer(b, np.uint8)
                # scrub-class pacing covers local AND gathered bytes —
                # a fleet-wide sweep draws the cluster budget, it can't
                # stampede the network
                self._pace(n * len(rows))
                SCRUB_BYTES.inc(n * len(rows), kind="ec_syndrome")
                report.bytes += n * len(rows)
                for sid, plan in plans.items():
                    try:
                        # the recompute rides the shared reconstruct
                        # lanes of THIS volume's coder — scrub slabs
                        # stack with foreground dispatches, overlapped
                        # with the gather threads prefetching off+n
                        missing, out = dispatch.reconstruct_now(
                            coder, plan.reads,
                            np.stack([rows[i] for i in plan.reads]),
                            want=(sid,))
                        rec = to_host(out[list(missing).index(sid)])
                    except (IOError, ValueError):
                        covered = False
                        continue
                    if np.array_equal(rec, rows[sid]):
                        continue
                    clean = False
                    culprit = self._pin_culprit_cross(
                        ev, coder, geom, vid, off, n, rows, shard_addrs)
                    f = self._add_finding(Finding(
                        vid, "ec_parity",
                        shard_id=culprit if culprit is not None else 255,
                        detail=f"cross-server syndrome mismatch against "
                               f"shard {sid} in byte range "
                               f"[{off}, {off + n})"
                               + ("" if culprit is not None
                                  else " (culprit ambiguous)")))
                    report.findings.append(f)
                    if repair and culprit is not None and \
                            self._repair_ec_shard_cross(
                                loc, vid, culprit, f, shard_addrs,
                                all_present):
                        report.repaired += 1
                        if _depth < 2:
                            # shards changed: re-verify the whole volume
                            # against the fresh files
                            self._verify_ec_volume(loc, vid, True,
                                                   repair, report,
                                                   _depth + 1)
                        return
                    # detect-only / ambiguous culprit / failed repair:
                    # one finding per window is enough — keep scanning
                    # the rest of the volume (the local path's contract;
                    # an early return would pin the cursor on the rot
                    # and leave everything past it unverified forever)
                    break
                off += n
                cur.ec_offset = off
        finally:
            if g is not None:
                g.close()
            for i in local_read:
                _drop_swept_range(ev.shard_files.get(i), start,
                                  max(0, off - start))
            cur.ec_offset = min(cur.ec_offset, shard_size)
            cur.save()
        if off >= shard_size and clean and covered:
            cur.sweeps += 1
            SCRUB_SWEEPS.inc(kind="ec")
            if start == 0 and running:
                # whole-shard digests of the LOCAL shards fall out of
                # the slabs already read — VolumeDigest serves them
                self._ec_digests[vid] = {
                    i: digest_mod.ShardCrc(i, running[i],
                                           ev.shard_files[i].size())
                    for i in running if i in ev.shard_files}

    def _pin_culprit_cross(self, ev, coder, geom, vid: int, off: int,
                           n: int, rows: dict, shard_addrs) -> int | None:
        """Leave-one-out culprit pinning needs EVERY shard's bytes for
        the mismatching window — top up the verify rows with one-shot
        fetches of the shards the plan didn't need (local file first,
        any peer holder next). The culprit may be local OR remote."""
        full_rows = dict(rows)
        extra = 0
        for sid in range(geom.total_shards):
            if sid in full_rows:
                continue
            f = ev.shard_files.get(sid)
            if f is not None:
                data = f.read_at(off, n)
                full_rows[sid] = np.frombuffer(
                    data + b"\0" * (n - len(data)), np.uint8)
                continue
            if sid in shard_addrs:
                b = gather_mod.fetch_range_once(
                    shard_addrs[sid], vid,
                    getattr(ev, "collection", ""), sid, off, n)
                if b is not None:
                    full_rows[sid] = np.frombuffer(b, np.uint8)
                    extra += n
                    continue
            return None  # a shard is missing cluster-wide: ambiguous
        if extra:
            self._pace(extra)
        return self._pin_culprit_from_rows(ev.geo, coder, full_rows)

    def _repair_ec_shard_cross(self, loc, vid: int, sid: int,
                               finding: Finding, shard_addrs,
                               all_present) -> bool:
        """Repair a rotten shard when the survivors are split across
        servers: reconstruct the whole shard from its repair plan
        (local reads + gathered peer ranges, repair-class paced), land
        it as a LOCAL shard file on this holder, remount, and — when
        the rotten copy lives on a peer — delete it there (the shard
        migrates to the verifier; topology follows the heartbeats).
        Readers never see a gap: the rotten copy self-heals via
        reconstruct-around until the fresh one is mounted."""
        import grpc

        from ..models.geometry import UnsolvableError
        from ..pb import rpc
        from ..pb import volume_server_pb2 as vs
        from ..qos import QosUnavailable
        from ..utils.stats import EC_REPAIR_BYTES, EC_REPAIR_PLANS

        ev = loc.ec_volumes.get(vid)
        srv = self.server
        if ev is None or srv is None:
            return False
        geo = ev.geo
        geom = geo.code_geometry()
        collection = getattr(ev, "collection", "")
        base = ev.base
        try:
            plan = geom.repair_plan(
                (sid,), tuple(i for i in all_present if i != sid))
        except (UnsolvableError, ValueError) as e:
            finding.detail += f"; unrecoverable: {e}"
            finding.set_state("failed")
            SCRUB_REPAIRS.inc(method="ec_rebuild", outcome="failed")
            return False
        local = set(ev.shard_files) - {sid}
        remote_reads = [i for i in plan.reads if i not in local]
        if any(i not in shard_addrs for i in remote_reads):
            finding.detail += "; a planned survivor has no holder"
            finding.set_state("failed")
            SCRUB_REPAIRS.inc(method="ec_rebuild", outcome="failed")
            return False
        coder = self._geo_coder(geo)
        was_local = sid in ev.shard_files
        if was_local:
            # quarantine: atomic replace (no close) — in-flight readers
            # keep a valid mmap, new reads degrade-reconstruct instead
            # of serving rotten bytes (the repair-ladder contract)
            ev.shard_files = {i: f for i, f in ev.shard_files.items()
                              if i != sid}
        shard_size = ev.shard_size
        slab = min(max(4096, self.ec_slab), gather_mod.MAX_SLAB)
        g = None
        if remote_reads:
            g = gather_mod.ShardRangeGatherer(
                vid, collection,
                {i: shard_addrs[i] for i in remote_reads},
                shard_size, slab)
        tmp = geo.shard_file_name(base, sid) + ".repair"
        try:
            local_b = remote_b = 0
            with open(tmp, "wb") as out_f:
                off = 0
                while off < shard_size:
                    n = min(slab, shard_size - off)
                    # repair-class tokens outrank scrub in the ledger;
                    # QosUnavailable pauses the pass (run_once)
                    self._pace(n * len(plan.reads), work_class="repair")
                    rows: dict[int, np.ndarray] = {}
                    for i in plan.reads:
                        if i in local:
                            data = ev.shard_files[i].read_at(off, n)
                            rows[i] = np.frombuffer(
                                data + b"\0" * (n - len(data)), np.uint8)
                            local_b += n
                    if g is not None:
                        for i, b in g.window(off, n).items():
                            rows[i] = np.frombuffer(b, np.uint8)
                            remote_b += n
                    missing, out = dispatch.reconstruct_now(
                        coder, plan.reads,
                        np.stack([rows[i] for i in plan.reads]),
                        want=(sid,))
                    out_f.write(to_host(
                        out[list(missing).index(sid)]).tobytes())
                    off += n
            os.replace(tmp, geo.shard_file_name(base, sid))
            self.store.mount_ec_shards(vid, collection, [sid])
            self.invalidate_ec_digest(vid, remove_manifest=True)
            srv.ec_recon_cache.invalidate(vid)
            if not was_local:
                # migrate: this holder now serves the verified rebuild;
                # the peer's rotten copy is deleted — ONLY on the first
                # holder, the one whose bytes the gather/pinning
                # actually examined. Other holders of the same shard id
                # (duplicates are a legal state) were never inspected:
                # their copies may be healthy, and a later sweep judges
                # whichever copy it reads on its own evidence.
                for addr in shard_addrs.get(sid, [])[:1]:
                    try:
                        rpc.volume_stub(rpc.grpc_address(addr)) \
                            .VolumeEcShardsDelete(
                                vs.VolumeEcShardsDeleteRequest(
                                    volume_id=vid, collection=collection,
                                    shard_ids=[sid]), timeout=60)
                    except grpc.RpcError as e:
                        glog.warning(
                            f"scrub: could not delete rotten shard "
                            f"{sid} of vol {vid} on {addr}: {e}")
                srv._ec_loc_cache.pop(vid, None)
            srv.trigger_heartbeat()
            EC_REPAIR_PLANS.inc(geometry=geo.code_name,
                                kind="scrub_cross")
            if local_b:
                EC_REPAIR_BYTES.inc(local_b, geometry=geo.code_name,
                                    kind="scrub_cross", source="local")
            if remote_b:
                EC_REPAIR_BYTES.inc(remote_b, geometry=geo.code_name,
                                    kind="scrub_cross", source="remote")
        except QosUnavailable:
            raise  # pass pauses; the quarantined shard reconstructs on
            #        read and the next sweep retries the rebuild
        except (IOError, OSError, ValueError,
                gather_mod.GatherError) as e:
            finding.detail += f"; cross-server rebuild failed: {e}"
            finding.set_state("failed")
            SCRUB_REPAIRS.inc(method="ec_rebuild", outcome="failed")
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False
        finally:
            if g is not None:
                g.close()
        finding.set_state("repaired")
        SCRUB_REPAIRS.inc(method="ec_rebuild", outcome="ok")
        glog.info(f"scrub: ec vol {vid} shard {sid} rebuilt from "
                  f"cross-server survivors "
                  f"({'local' if was_local else 'migrated'} copy)")
        return True

    # ---- anti-entropy: digest comparison across replicas

    def run_anti_entropy(self, vid: int | None = None, repair: bool = True,
                         report: ScrubReport | None = None) -> ScrubReport:
        report = report if report is not None else ScrubReport()
        srv = self.server
        if srv is None:
            return report
        for loc in self.store.locations:
            for v_id, v in list(loc.volumes.items()):
                if vid is not None and v_id != vid:
                    continue
                if v.super_block.replica_placement.copy_count <= 1:
                    continue
                try:
                    self._anti_entropy_volume(v, repair, report)
                except Exception as e:  # noqa: BLE001 — next volume
                    glog.warning(f"anti-entropy vol {v_id}: {e}")
        return report

    def _anti_entropy_volume(self, v, repair: bool,
                             report: ScrubReport) -> None:
        import grpc

        from ..pb import rpc, scrub_pb2

        from ..utils import retry as retry_mod

        srv = self.server
        mine = digest_mod.volume_digest_entries(v)
        my_rolling = digest_mod.rolling_digest(mine)
        my_live = sum(1 for e in mine if e.size >= 0)
        for addr in srv.lookup_volume_locations(v.id):
            if addr == srv.address:
                continue
            stub = rpc.volume_stub(rpc.grpc_address(addr))
            try:
                # one retry through the unified ladder before skipping:
                # a single dropped RPC must not silently shrink sweep
                # coverage (the old bare `continue` hid it entirely)
                resp = retry_mod.retry(
                    "scrub.digest_probe",
                    lambda: stub.VolumeDigest(
                        scrub_pb2.VolumeDigestRequest(volume_id=v.id),
                        timeout=30),
                    attempts=2)
                if resp.rolling_crc == my_rolling \
                        and resp.needle_count == my_live:
                    continue  # replicas agree — ~20 bytes settled it
                resp = retry_mod.retry(
                    "scrub.digest_entries",
                    lambda: stub.VolumeDigest(
                        scrub_pb2.VolumeDigestRequest(
                            volume_id=v.id, include_entries=True),
                        timeout=60),
                    attempts=2)
            except grpc.RpcError as e:
                # counted, never swallowed: the sweep report and the
                # SeaweedFS_scrub_skipped_pairs counter make partial
                # anti-entropy coverage visible
                report.skipped_pairs += 1
                SCRUB_SKIPPED_PAIRS.inc()
                glog.warning(f"anti-entropy vol {v.id}: digest probe to "
                             f"{addr} failed after retry: {e}")
                continue
            theirs = [digest_mod.DigestEntry(
                          e.needle_id, e.crc, e.size,
                          (e.epoch_incarnation, e.epoch_seq,
                           e.epoch_server)
                          if (e.epoch_incarnation or e.epoch_seq
                              or e.epoch_server) else None)
                      for e in resp.entries]
            only_mine, only_theirs, differing = digest_mod.diff_entries(
                mine, theirs)
            # a one-sided tombstone (the other replica never had the id
            # at all) is already-converged deletion history, not
            # divergence — nothing exists to heal, so flagging it would
            # pin a permanently-"repaired-every-sweep" finding
            only_mine = [e for e in only_mine if e.size >= 0]
            only_theirs = [e for e in only_theirs if e.size >= 0]
            if not (only_mine or only_theirs or differing):
                continue
            f = self._add_finding(Finding(
                v.id, "replica_divergence",
                detail=f"vs {addr}: +{len(only_mine)} local-only, "
                       f"+{len(only_theirs)} remote-only, "
                       f"{len(differing)} differing"))
            report.findings.append(f)
            if not repair:
                continue
            misses = self._heal_divergence(v, addr, only_mine,
                                           only_theirs, differing)
            if misses:
                f.detail += (f"; {misses} needle(s) had no fetchable "
                             f"verified copy on any replica")
            # "repaired" is only claimed on PROVEN convergence: recompute
            # the local digest and re-fetch the peer's rolling CRC — the
            # verdict is the digests', not the heal loop's (a miss that
            # another replica pair already healed must not poison this
            # pass). A genuinely unorderable live-vs-live conflict (two
            # pre-epoch records with equal append_at_ns) — or any silent
            # non-heal — leaves the digests apart and the finding
            # honestly failed, instead of an endlessly "repairing"
            # counter that never converges.
            mine = digest_mod.volume_digest_entries(v)
            my_rolling = digest_mod.rolling_digest(mine)
            my_live = sum(1 for e in mine if e.size >= 0)
            try:
                resp = stub.VolumeDigest(scrub_pb2.VolumeDigestRequest(
                    volume_id=v.id), timeout=30)
                ok = (resp.rolling_crc == my_rolling
                      and resp.needle_count == my_live)
            except grpc.RpcError:
                ok = False
            f.set_state("repaired" if ok else "failed")
            SCRUB_REPAIRS.inc(method="anti_entropy",
                              outcome="ok" if ok else "failed")
            if ok:
                report.repaired += 1

    def _fetch_verified_needle_multi(self, v, peer_addr: str,
                                     needle_id: int) -> Needle | None:
        """A CRC-verified copy of a needle: the diffing peer first, then
        every OTHER replica holder via multi_retry — a peer flapping
        mid-heal must not strand a needle the rest of the replica set
        can still supply. With replica-epoch tags, resolution orders by
        the FETCHED record's own stored tag, so any verified copy
        advances convergence."""
        from ..pb import rpc
        from ..utils import retry as retry_mod

        srv = self.server
        targets = [peer_addr]
        if srv is not None:
            targets += [a for a in srv.lookup_volume_locations(v.id)
                        if a not in (peer_addr, srv.address)]

        def attempt(addr):
            n = fetch_verified_needle(
                rpc.volume_stub(rpc.grpc_address(addr)), v.id, needle_id,
                v.version)
            if n is None:
                raise ConnectionError(
                    f"no verified copy of needle {needle_id:x} on {addr}")
            return n

        try:
            return retry_mod.multi_retry("scrub.fetch_needle", targets,
                                         attempt, cycles=2)
        # lint: allow-broad-except(every holder failed/declined after
        # retry cycles; the caller counts the miss per needle and the
        # digest re-probe decides repaired/failed)
        except Exception:  # noqa: BLE001
            return None

    def _heal_divergence(self, v, addr: str, only_mine, only_theirs,
                         differing) -> int:
        """Converge one (local, peer) replica pair; -> the number of
        needles left UNHEALED (0 = full heal). Rules: tombstones win
        over live entries (deletes propagate — the alternative
        resurrects deleted data); live-vs-live conflicts go to the
        newest append_at_ns; EQUAL timestamps resolve by the
        replica-epoch total order (both sides compare the
        same two stored tags, so both pick the same winner); missing
        entries are copied toward the replica that lacks them. Only two
        pre-epoch records with equal timestamps remain unorderable.

        A single unfetchable needle no longer aborts the pass verdict:
        the rest of the diff still heals, the miss is counted, and the
        caller's digest re-probe decides repaired/failed."""
        import grpc

        from ..pb import rpc
        from ..pb import volume_server_pb2 as vs
        from ..storage.epoch import order_key
        from ..storage.file_id import format_needle_id_cookie

        stub = rpc.volume_stub(rpc.grpc_address(addr))
        misses = 0
        try:
            for e in only_theirs:
                if e.size < 0:
                    continue  # their tombstone for an id we never had
                theirs_n = self._fetch_verified_needle_multi(
                    v, addr, e.needle_id)
                if theirs_n is None:
                    misses += 1
                    continue
                v.write_needle(theirs_n, check_cookie=False, stamp=False)
            for e in only_mine:
                if e.size < 0:
                    continue
                nv = v.nm.get(e.needle_id)
                if nv is None:
                    continue
                try:
                    # CRC-verify the LOCAL record before shipping it:
                    # pushing unverified bytes would replicate local rot
                    # onto the healthy peer (never heal FROM rot)
                    v._read_record(nv)
                except (IOError, ValueError):
                    misses += 1  # the needle sweep owns this finding
                    continue
                blob = v.read_needle_blob(
                    types.stored_to_actual_offset(nv.offset), nv.size)
                stub.WriteNeedleBlob(vs.WriteNeedleBlobRequest(
                    volume_id=v.id, needle_id=e.needle_id, size=nv.size,
                    needle_blob=blob), timeout=30)
            for me, them in differing:
                if me.size < 0:  # my tombstone vs their live: delete wins
                    stub.BatchDelete(vs.BatchDeleteRequest(
                        file_ids=[f"{v.id},"
                                  f"{format_needle_id_cookie(me.needle_id, 0)}"],
                        skip_cookie_check=True), timeout=30)
                    continue
                if them.size < 0:  # their tombstone vs my live
                    try:
                        v.delete_needle(me.needle_id)
                    except (NotFoundError, DeletedError):
                        pass
                    continue
                theirs_n = self._fetch_verified_needle_multi(
                    v, addr, me.needle_id)
                if theirs_n is None:
                    misses += 1
                    continue
                nv = v.nm.get(me.needle_id)
                mine_n = None
                if nv is not None:
                    try:
                        mine_n = v._read_record(nv)
                    except (IOError, ValueError):
                        mine_n = None  # local copy rotten: theirs wins

                def push_mine():
                    blob = v.read_needle_blob(
                        types.stored_to_actual_offset(nv.offset), nv.size)
                    stub.WriteNeedleBlob(vs.WriteNeedleBlobRequest(
                        volume_id=v.id, needle_id=me.needle_id,
                        size=nv.size, needle_blob=blob), timeout=30)

                if mine_n is None or \
                        theirs_n.append_at_ns > mine_n.append_at_ns:
                    v.write_needle(theirs_n, check_cookie=False,
                                   stamp=False)
                elif mine_n.append_at_ns > theirs_n.append_at_ns:
                    push_mine()
                else:
                    # equal timestamps: the replica-epoch total order
                    # decides — deterministically, on BOTH sides. Only
                    # two pre-epoch (untagged) records stay unorderable
                    # and surface, honestly, as a failed finding.
                    mk = order_key(mine_n.replica_epoch())
                    tk = order_key(theirs_n.replica_epoch())
                    if tk > mk:
                        v.write_needle(theirs_n, check_cookie=False,
                                       stamp=False)
                    elif mk > tk:
                        push_mine()
                    else:
                        misses += 1
        except (grpc.RpcError, IOError, ValueError) as e:
            glog.warning(f"anti-entropy heal vol {v.id} vs {addr}: {e}")
            return misses + 1
        return misses

    # -- introspection -----------------------------------------------------

    def status(self) -> dict:
        """The /status `Scrub` section + `volume.scrub -status` payload."""
        import re as _re

        cursors = []
        with self._mu:
            snapshot = sorted(self._cursors.items())
        for base, cur in snapshot:
            name = os.path.basename(base)
            m = _re.search(r"(\d+)$", name)
            cursors.append({"base": name,
                            "volumeId": int(m.group(1)) if m else 0,
                            "offset": cur.offset, "ecOffset": cur.ec_offset,
                            "sweeps": cur.sweeps})
        with self._mu:
            findings = [
                {"volumeId": f.volume_id, "kind": f.kind,
                 "needleId": f.needle_id, "shardId": f.shard_id,
                 "state": f.state, "detail": f.detail}
                for f in self.findings[-32:]]
            backlog = len(self._suspects)
        return {
            "running": self.running,
            "intervalSeconds": self.interval,
            "maxMBps": self.bucket.rate / (1024 * 1024)
            if self.bucket.rate > 0 else 0,
            "sweepsCompleted": self.sweeps_completed,
            "lastSweepUnix": self.last_sweep_unix,
            "suspectBacklog": backlog,
            "cursors": cursors,
            "recentFindings": findings,
        }
