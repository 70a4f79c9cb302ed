"""Prometheus-style metrics registry (counterpart of
seaweedfs_tpu/utils/stats.py; SeaweedFS weed/stats/
metrics.go — central Gather registry :31, per-subsystem counters/gauges/
histograms :164-260, pull endpoint StartMetricsServer :293).

Dependency-free: counters, gauges and cumulative histograms rendered in the
Prometheus text exposition format; servers mount the output at /metrics.
"""

from __future__ import annotations

import threading
import time

_REGISTRY: list["_Metric"] = []
_REG_MU = threading.Lock()

_BUCKETS = [0.0001, 0.0003, 0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1, 3, 10]

# lazy handle on utils.trace (histogram exemplars read the active span);
# lazy because trace imports nothing from here but callers may import
# stats first, and the hot observe() path must not re-resolve the module
_TRACE = None


def _trace_mod():
    global _TRACE
    if _TRACE is None:
        from . import trace

        _TRACE = trace
    return _TRACE


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
        with _REG_MU:
            _REGISTRY.append(self)

    def render(self, exemplars: bool = False) -> str:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help_: str):
        super().__init__(name, help_)
        self._values: dict[tuple, float] = {}

    def inc(self, n: float = 1, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0) + n

    def value(self, **labels) -> float:
        """Sum over every entry whose labels INCLUDE `labels` (subset
        match, Prometheus-aggregation style). Exact reads behave as
        before; families that later grow a finer label (e.g. the EC
        dispatch counters' per-chip `chip`) keep answering their old
        coarse queries with the aggregate."""
        want = set(labels.items())
        with self._lock:
            return sum(v for k, v in self._values.items()
                       if want <= set(k))

    def split_by(self, label: str, **labels) -> dict[str, float]:
        """Per-`label`-value sums among entries matching `labels` — e.g.
        split_by("chip", lane="encode") -> {chip: batches}."""
        want = set(labels.items())
        out: dict[str, float] = {}
        with self._lock:
            for k, v in self._values.items():
                if not want <= set(k):
                    continue
                d = dict(k)
                if label in d:
                    out[str(d[label])] = out.get(str(d[label]), 0) + v
        return out

    def render(self, exemplars: bool = False) -> str:
        out = [f"# HELP {self.name} {_escape_help(self.help)}",
               f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            if not self._values:
                out.append(f"{self.name} 0")
            for key, val in sorted(self._values.items()):
                out.append(f"{self.name}{_fmt_labels(key)} {val}")
        return "\n".join(out)


class Gauge(Counter):
    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = v

    def dec(self, n: float = 1, **labels) -> None:
        self.inc(-n, **labels)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_: str, buckets=None):
        super().__init__(name, help_)
        self.buckets = list(buckets or _BUCKETS)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}
        # (label key, bucket index) -> (trace_id, value, unix_ts): the
        # most recent traced observation landing in that bucket. Lets a
        # p99 bucket in /metrics name an actual retained trace id
        # (rendered in the OpenMetrics exemplar syntax when the
        # scrape asks for it).
        self._exemplars: dict[tuple, tuple[str, float, float]] = {}

    def _bucket_index(self, v: float) -> int:
        for i, b in enumerate(self.buckets):
            if v <= b:
                return i
        return len(self.buckets)  # +Inf

    # exemplars exist to explain the TAIL — only LATENCY observations
    # (families named *_seconds; slab-count/byte histograms have no
    # meaningful duration exemplar) at least this slow pay the capture
    # cost; the hot sub-millisecond path never does
    EXEMPLAR_MIN = 0.025

    def observe(self, v: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        exemplar = None
        if v >= self.EXEMPLAR_MIN and self.name.endswith("_seconds"):
            tr = _trace_mod()
            sp = tr.current()
            if sp is not None and sp.sampled:
                exemplar = (sp.trace_id, v, tr.now_unix())
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if v <= b:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0) + v
            self._totals[key] = self._totals.get(key, 0) + 1
            if exemplar is not None:
                self._exemplars[key + (self._bucket_index(v),)] = exemplar

    def snapshot(self, **labels) -> dict:
        """{"count", "sum"} of the observations whose labels include
        `labels` (subset match, like Counter.value)."""
        want = set(labels.items())
        with self._lock:
            keys = [k for k in self._totals if want <= set(k)]
            return {"count": sum(self._totals[k] for k in keys),
                    "sum": sum(self._sums[k] for k in keys)}

    def totals(self, part: str) -> dict[tuple, float]:
        """label key -> the running sum ("sum") or the number of
        observations ("count") of each series."""
        with self._lock:
            return dict(self._sums if part == "sum" else self._totals)

    def time(self, **labels):
        return _Timer(self, labels)

    def exemplars(self, **labels) -> dict[str, dict]:
        """bucket upper bound -> {traceId, value, ts} for one label set
        (the /status and /debug surfaces; render() emits the same in
        OpenMetrics syntax)."""
        key = tuple(sorted(labels.items()))
        out: dict[str, dict] = {}
        with self._lock:
            for k, (tid, v, ts) in self._exemplars.items():
                if k[:-1] != key:
                    continue
                idx = k[-1]
                le = str(self.buckets[idx]) if idx < len(self.buckets) \
                    else "+Inf"
                out[le] = {"traceId": tid, "value": v, "ts": ts}
        return out

    def render(self, exemplars: bool = False) -> str:
        out = [f"# HELP {self.name} {_escape_help(self.help)}",
               f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            for key in sorted(self._counts):
                cum = 0
                for i, b in enumerate(self.buckets):
                    cum = self._counts[key][i]
                    lk = key + (("le", str(b)),)
                    line = f"{self.name}_bucket{_fmt_labels(lk)} {cum}"
                    out.append(line + self._exemplar_suffix(
                        key, i, exemplars))
                lk = key + (("le", "+Inf"),)
                out.append(
                    f"{self.name}_bucket{_fmt_labels(lk)} "
                    f"{self._totals[key]}"
                    + self._exemplar_suffix(key, len(self.buckets),
                                            exemplars))
                out.append(f"{self.name}_sum{_fmt_labels(key)} {self._sums[key]}")
                out.append(f"{self.name}_count{_fmt_labels(key)} {self._totals[key]}")
        return "\n".join(out)

    def _exemplar_suffix(self, key: tuple, idx: int,
                         exemplars: bool) -> str:
        """OpenMetrics exemplar (` # {trace_id="..."} v ts`) for one
        bucket line; "" without an exemplar or when not requested
        (plain 0.0.4 scrapers must keep parsing)."""
        if not exemplars:
            return ""
        ex = self._exemplars.get(key + (idx,))
        if ex is None:
            return ""
        tid, v, ts = ex
        return f' # {{trace_id="{tid}"}} {v:.6g} {ts:.3f}'


class _Timer:
    def __init__(self, hist: Histogram, labels: dict):
        self.hist = hist
        self.labels = labels

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self.t0, **self.labels)


def _escape_label_value(v) -> str:
    """Prometheus text exposition escaping for label VALUES: backslash,
    double-quote and newline must be escaped or a hostile value (e.g. a
    collection named `a"b` or one holding a newline) corrupts the whole
    scrape — every sample after it fails to parse."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """HELP lines escape backslash + newline (exposition format §HELP)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
    return "{" + inner + "}"


def gather(exemplars: bool = False) -> str:
    """Render every registered metric (stats.Gather equivalent). With
    `exemplars`, histogram bucket lines carry OpenMetrics exemplars
    linking to retained trace ids (serve it when the scraper opts in —
    `/metrics?exemplars=1` — so plain 0.0.4 parsers stay safe)."""
    with _REG_MU:
        metrics = list(_REGISTRY)
    rendered = (m.render(exemplars=exemplars) for m in metrics)
    return "\n".join(r for r in rendered if r) + "\n"


# -- the metric families the reference defines (metrics_names.go) ----------

MASTER_RECEIVED_HEARTBEATS = Counter(
    "SeaweedFS_master_received_heartbeats", "Number of heartbeats received.")
VOLUME_REPLICA_DELETE_FAILURES = Counter(
    "SeaweedFS_volume_replica_delete_failures",
    "Replica delete fan-out legs that exhausted retries — the peer "
    "still holds the needle until anti-entropy's tombstone-wins heal.")
MASTER_VOLUME_LAYOUT_WRITABLE = Gauge(
    "SeaweedFS_master_volume_layout_writable", "Writable volumes per layout.")
VOLUME_SERVER_REQUEST_HISTOGRAM = Histogram(
    "SeaweedFS_volumeServer_request_seconds", "Request latency by type.")
VOLUME_SERVER_VOLUME_COUNTER = Gauge(
    "SeaweedFS_volumeServer_volumes", "Volumes managed by this server.")
VOLUME_SERVER_NATIVE_REQUESTS = Gauge(
    "SeaweedFS_volumeServer_native_requests",
    "Requests served by the C++ data plane since start.")
VOLUME_SERVER_EC_ENCODE_BYTES = Counter(
    "SeaweedFS_volumeServer_ec_encode_bytes", "Bytes erasure-encoded.")
VOLUME_SERVER_EC_DEVICE_SECONDS = Counter(
    "SeaweedFS_volumeServer_ec_device_seconds", "Device time in EC kernels.")
FILER_REQUEST_HISTOGRAM = Histogram(
    "SeaweedFS_filer_request_seconds", "Filer request latency by type.")
S3_REQUEST_HISTOGRAM = Histogram(
    "SeaweedFS_s3_request_seconds", "S3 gateway latency by action.")
FILER_STORE_COUNTER = Counter(
    "SeaweedFS_filerStore_ops", "Filer store operations by store and op.")
FILER_STORE_SECONDS = Counter(
    "SeaweedFS_filerStore_seconds",
    "Cumulative filer store time by store and op.")

# -- small-file hot-path instrumentation: every counter below
#    exists to make a bench delta attributable to one optimization -------

CLIENT_ASSIGN_SECONDS = Histogram(
    "SeaweedFS_client_assign_seconds", "Master Assign RPC latency.")
CLIENT_ASSIGN_COUNTER = Counter(
    "SeaweedFS_client_assign_ops",
    "Master Assign calls by outcome (ok/error) and leased fid count.")
CLIENT_FID_LEASE_COUNTER = Counter(
    "SeaweedFS_client_fid_lease_ops",
    "Fid lease pool activity: hit (no RPC), refill, expired, invalidate.")
CLIENT_UPLOAD_SECONDS = Histogram(
    "SeaweedFS_client_upload_seconds", "Volume-server upload latency.")
FILER_CHUNK_CACHE_COUNTER = Counter(
    "SeaweedFS_filer_chunk_cache_ops",
    "Filer chunk-read cache lookups by result (hit/miss) and mutations "
    "(put/invalidate).")
VOLUME_GROUP_COMMIT_WRITES = Counter(
    "SeaweedFS_volumeServer_group_commit_writes",
    "Needle writes acknowledged through the group-commit flush path.")
VOLUME_GROUP_COMMIT_FLUSHES = Counter(
    "SeaweedFS_volumeServer_group_commit_flushes",
    "Batched dat+idx flushes; writes/flushes is the batching factor.")


# -- EC dispatch plane: the scheduler that coalesces encode /
#    reconstruct slabs into stacked device dispatches, plus the
#    reconstructed-interval cache serving repeated degraded reads ---------

EC_DISPATCH_SLABS = Counter(
    "SeaweedFS_ec_dispatch_slabs",
    "Slabs submitted to the EC dispatch scheduler by lane "
    "(encode/reconstruct) and chip ('-' = single-chip lanes).")
EC_DISPATCH_BATCHES = Counter(
    "SeaweedFS_ec_dispatch_batches",
    "Stacked dispatches issued by lane, chip and reason: WHY the lane "
    "ran where it did (cpu_env = host coder pinned by "
    "SEAWEEDFS_TORCH_CODER; cpu_explicit = the call site constructed a "
    "host coder; single_device = one CUDA device, no chip lanes); "
    "slabs/batches is the batch factor.")
EC_DISPATCH_WINDOW_WAIT = Histogram(
    "SeaweedFS_ec_dispatch_window_wait_seconds",
    "Time a slab waited in the scheduler before its dispatch launched, "
    "by lane and chip.")
EC_DISPATCH_STACK_SLABS = Histogram(
    "SeaweedFS_ec_dispatch_stacked_slabs",
    "Slabs per stacked dispatch (the realized batch size).",
    buckets=[1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64])
EC_DISPATCH_STACK_BYTES = Histogram(
    "SeaweedFS_ec_dispatch_stacked_bytes",
    "Input bytes per stacked dispatch.",
    buckets=[4096, 65536, 1 << 20, 4 << 20, 16 << 20, 64 << 20, 256 << 20])
EC_RECON_CACHE_COUNTER = Counter(
    "SeaweedFS_ec_dispatch_recon_cache_ops",
    "Reconstructed-interval cache activity by result "
    "(hit/miss/put/invalidate/evict).")

# -- compiled XOR-schedule codec plane: generator matrices
#    lowered to cached bit-plane XOR programs for the host CPU path ------

EC_SCHED_BATCHES = Counter(
    "SeaweedFS_ec_sched_batches",
    "Compiled XOR-schedule executions by role (encode/reconstruct) and "
    "backend (numpy/native).")
EC_SCHED_BYTES = Counter(
    "SeaweedFS_ec_sched_bytes",
    "Output bytes produced through the compiled-schedule path by role.")
EC_SCHED_SKIPPED = Counter(
    "SeaweedFS_ec_sched_skipped",
    "Host-CPU lanes that stayed on the dense GF path by role and reason "
    "(gate_off / dense_cheaper / unsupported).")
EC_SCHED_CACHE_OPS = Counter(
    "SeaweedFS_ec_sched_cache_ops",
    "Schedule cache activity (hit/compile/evict/wait — wait counts "
    "threads that blocked on another thread's in-flight compile).")


# -- host memory plane: the stack arena that recycles the
#    scheduler's flush buffers instead of allocating + zero-filling a
#    fresh [V, k, B] stack per batch, plus its quarantine (buffers held
#    until an async device dispatch has provably consumed the bytes) ----

EC_DISPATCH_ARENA_OPS = Counter(
    "SeaweedFS_ec_dispatch_arena_ops",
    "Stack-arena buffer events by result: hit (flush packed into a "
    "recycled buffer), miss (fresh allocation), resize (request "
    "outgrew every pooled buffer), recycle (buffer returned to the "
    "pool), drop (buffer abandoned: pool full or still quarantined at "
    "close). hits/(hits+misses) is the recycling rate.")
EC_DISPATCH_ARENA_INUSE = Gauge(
    "SeaweedFS_ec_dispatch_arena_inuse_bytes",
    "Arena bytes currently checked out to in-flight flushes (including "
    "quarantined buffers a device dispatch may still be reading).")
EC_DISPATCH_ARENA_POOLED = Gauge(
    "SeaweedFS_ec_dispatch_arena_pooled_bytes",
    "Arena bytes sitting in the free pool, ready to absorb the next "
    "flush without an allocation.")


# -- streaming replica->EC conversion: the pipelined archival
#    encode that pushes shard slabs to their destinations while the GF
#    matmul is still running (storage/ec_stream.py), plus like-for-like
#    counters on the VolumeEcShardsCopy generate-then-copy fallback ------

EC_STREAM_BYTES = Counter(
    "SeaweedFS_ec_stream_bytes",
    "Shard-slab bytes streamed by role (source/dest) and phase "
    "(live = overlapped with the encode, resume = re-sent after a "
    "destination flap).")
EC_STREAM_SLABS = Counter(
    "SeaweedFS_ec_stream_slabs",
    "Shard slabs streamed by role (source/dest) and phase (live/resume).")
EC_STREAM_INFLIGHT_BYTES = Gauge(
    "SeaweedFS_ec_stream_inflight_bytes",
    "Slab bytes queued for a destination but not yet on its wire.")
EC_STREAM_RESUMES = Counter(
    "SeaweedFS_ec_stream_resumes",
    "Resume streams issued after a destination flap, by peer.")
EC_STREAM_SECONDS = Counter(
    "SeaweedFS_ec_stream_seconds",
    "Wall seconds spent inside shard-stream sends, by peer "
    "(bytes/seconds = per-destination throughput).")
EC_STREAM_STREAMS = Counter(
    "SeaweedFS_ec_stream_streams",
    "Shard streams completed by outcome (ok/failed).")
EC_STREAM_OVERLAP_RATIO = Gauge(
    "SeaweedFS_ec_stream_overlap_ratio",
    "encode-time / wall-time of the last streamed generate "
    "(1.0 = transfer fully hidden under the encode).")
EC_COPY_FALLBACK_BYTES = Counter(
    "SeaweedFS_ec_shards_copy_bytes",
    "Bytes pulled through the VolumeEcShardsCopy (generate-then-copy) "
    "path, by file kind (shard/index).")
EC_COPY_FALLBACK_SECONDS = Counter(
    "SeaweedFS_ec_shards_copy_seconds",
    "Wall seconds inside VolumeEcShardsCopy pulls "
    "(bytes/seconds = copy-path throughput, the A/B comparand).")


# -- code-geometry plane: repair-bandwidth accounting — the
#    number the pluggable geometries (models/geometry.py) exist to
#    shrink. Every survivor byte read to recover lost shard bytes is
#    counted here, labeled by the volume's code geometry -----------------

EC_REPAIR_BYTES = Counter(
    "SeaweedFS_ec_repair_bytes",
    "Survivor bytes read to recover lost EC shard bytes, by code "
    "geometry (rs_10_4/lrc_10_2_2/...), kind (rebuild/degraded_read) "
    "and source (local/remote). Under lrc_10_2_2 a single-shard repair "
    "inside a local group reads 5 survivors where rs_10_4 reads 10.")
EC_REPAIR_PLANS = Counter(
    "SeaweedFS_ec_repair_plans",
    "Minimal-read repair plans executed, by geometry and kind; "
    "repair_bytes/plans tracks the realized per-repair read cost.")


def ec_stream_stats() -> dict:
    """Snapshot for /status pages: streamed bytes by phase, in-flight
    depth, resume counts, overlap ratio, and the copy-fallback
    byte/throughput counters so A/Bs compare like for like."""
    src_s = EC_STREAM_SECONDS.value()
    src_b = EC_STREAM_BYTES.value(role="source")
    copy_b = EC_COPY_FALLBACK_BYTES.value()
    copy_s = EC_COPY_FALLBACK_SECONDS.value()
    return {
        "streamedBytes": {
            "live": int(EC_STREAM_BYTES.value(role="source", phase="live")),
            "resume": int(EC_STREAM_BYTES.value(role="source",
                                                phase="resume")),
            "received": int(EC_STREAM_BYTES.value(role="dest")),
        },
        "slabs": int(EC_STREAM_SLABS.value(role="source")),
        "inflightBytes": int(EC_STREAM_INFLIGHT_BYTES.value()),
        "resumes": int(EC_STREAM_RESUMES.value()),
        "streams": {
            "ok": int(EC_STREAM_STREAMS.value(outcome="ok")),
            "failed": int(EC_STREAM_STREAMS.value(outcome="failed")),
        },
        "overlapRatio": round(EC_STREAM_OVERLAP_RATIO.value(), 4),
        "throughputMBps": round(src_b / src_s / 1e6, 3) if src_s else 0.0,
        "copyFallback": {
            "bytes": int(copy_b),
            "seconds": round(copy_s, 3),
            "throughputMBps": round(copy_b / copy_s / 1e6, 3)
            if copy_s else 0.0,
        },
    }


# -- continuous integrity plane: the background scrubber, the
#    digest/anti-entropy comparisons, and the self-healing repair ladder ---

SCRUB_BYTES = Counter(
    "SeaweedFS_scrub_bytes",
    "Bytes verified by the scrub plane by sweep kind "
    "(needle/ec_syndrome/digest).")
SCRUB_NEEDLES = Counter(
    "SeaweedFS_scrub_needles_checked",
    "Needle records CRC-verified by the background scrubber.")
SCRUB_SWEEPS = Counter(
    "SeaweedFS_scrub_sweeps",
    "Completed scrub sweeps by kind (volume/ec).")
SCRUB_FINDINGS = Counter(
    "SeaweedFS_scrub_findings",
    "Integrity findings by kind (needle_crc/ec_parity/replica_divergence) "
    "and state transition (found/repaired/failed/cleared).")
SCRUB_REPAIRS = Counter(
    "SeaweedFS_scrub_repairs",
    "Repair escalations by method (re_replicate/ec_rebuild/anti_entropy) "
    "and outcome (ok/failed).")
SCRUB_PACE_WAIT_SECONDS = Counter(
    "SeaweedFS_scrub_pace_wait_seconds",
    "Cumulative seconds the scrubber slept in the SWFS_SCRUB_MAX_MBPS "
    "token bucket.")
SCRUB_BACKOFFS = Counter(
    "SeaweedFS_scrub_backoffs",
    "Times the scrubber backed off because foreground QPS was high.")
SCRUB_SKIPPED_PAIRS = Counter(
    "SeaweedFS_scrub_skipped_pairs",
    "Anti-entropy replica pairs skipped because the peer's VolumeDigest "
    "probe failed after retry — partial sweep coverage made visible.")
SCRUB_GATHER_BYTES = Counter(
    "SeaweedFS_scrub_gather_bytes",
    "Remote survivor-range bytes fetched by cross-server syndrome verify "
    "by phase (live/resume) — bounded by the geometry's repair plan.")
SCRUB_GATHER_RESUMES = Counter(
    "SeaweedFS_scrub_gather_resumes",
    "Peer-flap resumes during cross-server syndrome gathers (only the "
    "missing ranges are re-fetched).")


# -- crash-consistency plane: mount-time recovery ladder ---------

RECOVERY_RUNS = Counter(
    "SeaweedFS_recovery_runs",
    "Store startups by outcome (clean/unclean/disabled) — unclean means "
    "the dirty marker survived the previous process and the ladder ran.")
RECOVERY_TRUNCATED_BYTES = Counter(
    "SeaweedFS_recovery_dat_truncated_bytes",
    "Torn .dat tail bytes truncated to the last CRC-valid record "
    "boundary by the recovery ladder.")
RECOVERY_IDX_DROPPED = Counter(
    "SeaweedFS_recovery_idx_entries_dropped",
    "Index suffix entries dropped because their records extend past the "
    "durable .dat prefix (idx-never-ahead-of-dat reconcile).")
RECOVERY_EC_QUARANTINED = Counter(
    "SeaweedFS_recovery_ec_files_quarantined",
    "Half-streamed EC shard/journal files moved to .swfs_quarantine "
    "because their base never saw its .ecx commit.")
RECOVERY_SIDECARS_DISCARDED = Counter(
    "SeaweedFS_recovery_sidecars_discarded",
    "Corrupt sidecars discarded at mount by kind "
    "(vif/dig/scb/tier/incarnation) — each rebuilds on the next pass.")
RECOVERY_TMP_SWEPT = Counter(
    "SeaweedFS_recovery_tmp_files_swept",
    "Orphaned atomic-write *.tmp files swept by the recovery ladder.")
RECOVERY_VACUUM_RESOLVED = Counter(
    "SeaweedFS_recovery_vacuum_resolved",
    "Interrupted vacuum commits resolved at mount by action "
    "(rollback/rollforward).")
RECOVERY_SUSPECTS = Counter(
    "SeaweedFS_recovery_suspects_queued",
    "Volumes handed to Scrubber.report_suspect after the ladder touched "
    "them — the fabric re-verifies and re-replicates from peers.")


def recovery_stats() -> dict:
    """Snapshot for /status pages: what the last mount(s) repaired."""
    return {
        "runs": {o: int(RECOVERY_RUNS.value(outcome=o))
                 for o in ("clean", "unclean", "disabled")},
        "datTruncatedBytes": int(RECOVERY_TRUNCATED_BYTES.value()),
        "idxEntriesDropped": int(RECOVERY_IDX_DROPPED.value()),
        "ecFilesQuarantined": int(RECOVERY_EC_QUARANTINED.value()),
        "sidecarsDiscarded": {
            k: int(RECOVERY_SIDECARS_DISCARDED.value(kind=k))
            for k in ("vif", "dig", "scb", "tier", "incarnation")},
        "tmpSwept": int(RECOVERY_TMP_SWEPT.value()),
        "vacuumResolved": {
            a: int(RECOVERY_VACUUM_RESOLVED.value(action=a))
            for a in ("rollback", "rollforward")},
        "suspectsQueued": int(RECOVERY_SUSPECTS.value()),
    }


# -- QoS / admission plane: per-tenant ingress admission,
#    cluster-wide background token grants, and the backpressure score
#    the master folds into placement ------------------------------------

QOS_ADMISSION_OPS = Counter(
    "SeaweedFS_qos_admission_ops",
    "Ingress admission decisions by plane (s3/filer/master) and result "
    "(admit/reject).")
QOS_GRANT_OPS = Counter(
    "SeaweedFS_qos_grant_ops",
    "QosGrant outcomes by work_class (repair/scrub/archival) and outcome "
    "(ok/denied/error).")
QOS_GRANTED_BYTES = Counter(
    "SeaweedFS_qos_granted_bytes",
    "Background bytes granted by the cluster ledger, by work_class.")
QOS_BG_WAIT_SECONDS = Counter(
    "SeaweedFS_qos_background_wait_seconds",
    "Seconds background work waited on the QoS plane (foreground-QPS "
    "yield + cluster-token waits), by work_class.")
QOS_PRESSURE = Gauge(
    "SeaweedFS_qos_pressure",
    "This volume server's backpressure score in [0,1] (group-commit "
    "buffer depth folded with EC-dispatch queue depth).")


# -- fleet-scale metadata plane: the filer namespace sharded
#    behind a master-published consistent-hash ring --------------------------

META_RING_EPOCH = Gauge(
    "SeaweedFS_meta_ring_epoch",
    "Metadata-ring epoch this process routes under (master: published "
    "epoch; filer shard / client plane: last fetched).")
META_RING_SHARDS = Gauge(
    "SeaweedFS_meta_ring_shards",
    "Filer shards in the metadata ring this process routes under.")
META_RING_FETCHES = Counter(
    "SeaweedFS_meta_ring_fetches",
    "Ring fetches by trigger (ttl/stale/join/bootstrap) and result "
    "(ok/error).")
META_RING_WRONG_SHARD = Counter(
    "SeaweedFS_meta_ring_wrong_shard",
    "Requests this shard refused with 410 because the routing key "
    "belongs to another shard — a stale client ring refreshes and "
    "retries once, mirroring the vid-cache invalidation ladder.")
META_RING_RENAMES = Counter(
    "SeaweedFS_meta_ring_renames",
    "Cross-shard two-phase renames by outcome (commit/rollforward/"
    "rollback/error) — rollforward/rollback count recovery-ladder "
    "resolutions of interrupted intents.")
FILER_SHARD_QOS_OPS = Counter(
    "SeaweedFS_filer_shard_qos_ops",
    "Per-shard admission outcomes on the partitioned metadata plane "
    "(admit/reject) — shards shed independently, so one hot directory "
    "cannot melt its neighbors.")
META_AGGREGATOR_RECONNECTS = Counter(
    "SeaweedFS_filer_meta_aggregator_reconnects",
    "Peer metadata-subscription stream drops that entered the backoff "
    "reconnect loop (one count per reconnect attempt, by peer).")


# -- HTTPS data plane + zero-copy read path: connection-pool
#    economics, TLS handshake amortization, conditional/zero-copy serve
#    outcomes ---------------------------------------------------------------

HTTP_POOL_OPS = Counter(
    "SeaweedFS_http_pool_ops",
    "Keep-alive pool activity on the wdclient HTTP pool by result "
    "(hit/miss/expired/evict/stale_retry/disabled).")
HTTP_POOL_OPEN = Gauge(
    "SeaweedFS_http_pool_open_connections",
    "Idle pooled connections currently held by the wdclient HTTP pool.")
HTTP_CONDITIONAL_OPS = Counter(
    "SeaweedFS_http_conditional_ops",
    "Conditional-GET short circuits on the data planes by plane "
    "(volume/filer) and result (304/if_range_stale).")
HTTP_NATIVE_SENDFILE = Gauge(
    "SeaweedFS_http_native_sendfile",
    "GETs the C++ data plane served zero-copy via sendfile(2) "
    "(cumulative, refreshed from the plane each heartbeat).")
TLS_HANDSHAKES = Counter(
    "SeaweedFS_tls_handshakes",
    "Completed TLS handshakes on the HTTP data planes by role "
    "(server = accepted listener wraps, client = pool dials).")


def http_pool_stats() -> dict:
    """Snapshot for /status pages: pool economics + handshake counts."""
    ops = {r: int(HTTP_POOL_OPS.value(result=r))
           for r in ("hit", "miss", "expired", "evict", "stale_retry",
                     "disabled")}
    total = ops["hit"] + ops["miss"] + ops["disabled"]
    return {
        **ops,
        "openConnections": int(HTTP_POOL_OPEN.value()),
        "hitRate": round(ops["hit"] / total, 4) if total else 0.0,
        "tlsHandshakes": {
            "client": int(TLS_HANDSHAKES.value(role="client")),
            "server": int(TLS_HANDSHAKES.value(role="server")),
        },
    }


# -- pipelined chunk data path: bounded-window GET readahead
#    + overlapped PUT upload fan-out on the filer data legs ------------------

CHUNK_PIPELINE_OPS = Counter(
    "SeaweedFS_chunk_pipeline_ops",
    "Pipelined chunk engine events by direction (get/put) and result "
    "(prefetch_hit/prefetch_wait/launched/collapsed/cancelled/aborted).")
CHUNK_PIPELINE_INFLIGHT = Gauge(
    "SeaweedFS_chunk_pipeline_inflight",
    "Chunk fetches/uploads currently in flight in the pipelined chunk "
    "engine, by direction.")
CHUNK_PIPELINE_BYTES = Counter(
    "SeaweedFS_chunk_pipeline_bytes",
    "Bytes moved through the pipelined chunk engine by direction.")


def chunk_pipeline_stats() -> dict:
    """Snapshot for /status pages: window activity + hot-signal state."""
    from ..qos.pressure import SIGNAL

    out: dict = {"pressureSignal": SIGNAL.status()}
    for d in ("get", "put"):
        out[d] = {
            r: int(CHUNK_PIPELINE_OPS.value(direction=d, result=r))
            for r in ("prefetch_hit", "prefetch_wait", "launched",
                      "collapsed", "cancelled", "aborted")}
        out[d]["inflight"] = int(CHUNK_PIPELINE_INFLIGHT.value(direction=d))
        out[d]["bytes"] = int(CHUNK_PIPELINE_BYTES.value(direction=d))
    return out


def qos_stats() -> dict:
    """Snapshot for /status pages: admission outcomes + grant flow."""
    out = {
        "admission": {}, "grants": {}, "pressure":
        round(QOS_PRESSURE.value(), 4),
    }
    for plane in ("s3", "filer", "master"):
        out["admission"][plane] = {
            r: int(QOS_ADMISSION_OPS.value(plane=plane, result=r))
            for r in ("admit", "reject")}
    for klass in ("repair", "scrub", "archival"):
        out["grants"][klass] = {
            "grantedBytes": int(QOS_GRANTED_BYTES.value(work_class=klass)),
            "ok": int(QOS_GRANT_OPS.value(work_class=klass, outcome="ok")),
            "denied": int(QOS_GRANT_OPS.value(work_class=klass,
                                              outcome="denied")),
            "errors": int(QOS_GRANT_OPS.value(work_class=klass,
                                              outcome="error")),
            "waitSeconds": round(
                QOS_BG_WAIT_SECONDS.value(work_class=klass), 3),
        }
    return out


# -- tracing plane: span recording volume + tail retention,
#    and the hardened metrics-push loop's outcome counter ------------------

class _PullCounter(Counter):
    """Counter whose values are PULLED from a provider at read time —
    for hot-path producers (the span store) that must not pay a metric
    lock per event. The provider returns {label_key_tuple: value}."""

    def __init__(self, name: str, help_: str, provider):
        super().__init__(name, help_)
        self._provider = provider

    def _snap(self) -> dict:
        try:
            return self._provider()
        # lint: allow-broad-except(a scrape must never fail; the provider's
        # family renders empty)
        except Exception:  # noqa: BLE001 — a scrape must never fail
            return {}

    def inc(self, n: float = 1, **labels) -> None:
        raise TypeError(f"{self.name} is pull-based; its producer "
                        f"counts internally")

    def value(self, **labels) -> float:
        want = set(labels.items())
        return sum(v for k, v in self._snap().items() if want <= set(k))

    def split_by(self, label: str, **labels) -> dict[str, float]:
        want = set(labels.items())
        out: dict[str, float] = {}
        for k, v in self._snap().items():
            if not want <= set(k):
                continue
            d = dict(k)
            if label in d:
                out[str(d[label])] = out.get(str(d[label]), 0) + v
        return out

    def render(self, exemplars: bool = False) -> str:
        out = [f"# HELP {self.name} {_escape_help(self.help)}",
               f"# TYPE {self.name} {self.kind}"]
        vals = self._snap()
        if not vals:
            out.append(f"{self.name} 0")
        for key, val in sorted(vals.items()):
            out.append(f"{self.name}{_fmt_labels(key)} {val}")
        return "\n".join(out)


def _trace_span_provider() -> dict:
    return {(("component", c),): n
            for c, n in _trace_mod().STORE.span_counts().items()}


def _trace_retained_provider() -> dict:
    return {(("reason", r),): n
            for r, n in _trace_mod().STORE.retained_counts().items()}


TRACE_SPANS = _PullCounter(
    "SeaweedFS_trace_spans",
    "Spans recorded by the tracing plane, by component "
    "(s3/filer/volume/master/shell).", _trace_span_provider)
TRACE_RETAINED_TRACES = _PullCounter(
    "SeaweedFS_trace_retained_traces",
    "Traces pinned by tail-based retention, by reason (slow/error).",
    _trace_retained_provider)
METRICS_PUSH_OPS = Counter(
    "SeaweedFS_metrics_push_ops",
    "Push-gateway delivery attempts by outcome (ok/error); the push "
    "loop retries with backoff and never dies on a refused connection.")


# the EC plane's phases (utils/trace.phase), and the dispatch scheduler's
# window wait read as counters


def _phase_provider() -> dict:
    return {(("lane", lane), ("phase", name)): s
            for (name, lane), s in _trace_mod().STORE.phase_seconds().items()}


EC_PHASE_SECONDS = _PullCounter(
    "SeaweedFS_ec_phase_seconds",
    "Host seconds inside each phase of the EC plane (utils/trace.phase: "
    "ec.dispatch.section, ec.dispatch.pack, ec.codec.copy_in, "
    "ec.codec.launch, ec.encode.copy_out) by scheduler lane.",
    _phase_provider)


class _HistogramTotals(_PullCounter):
    """The running `_sum` or `_count` of a histogram's series as a counter,
    for readers that snapshot counters alone. /metrics already carries
    both series under the histogram, so this renders nothing."""

    def __init__(self, hist: Histogram, part: str):
        super().__init__(f"{hist.name}_{part}",
                         f"The {part} of {hist.name}.",
                         lambda: hist.totals(part))

    def render(self, exemplars: bool = False) -> str:
        return ""


EC_DISPATCH_WINDOW_WAIT_SUM = _HistogramTotals(EC_DISPATCH_WINDOW_WAIT,
                                               "sum")
EC_DISPATCH_WINDOW_WAIT_COUNT = _HistogramTotals(EC_DISPATCH_WINDOW_WAIT,
                                                 "count")


# the hand-written CUDA kernels' launch counts (ops/_build.py: each
# wrapper counts where it launches), pulled from the kernel modules this
# process has imported — a server process's proof that its EC work ran
# through the kernels on the card. K1's count is split by R, the rows
# of the product (1-2: degraded read, 3: rebuild, 4: encode).
_KERNEL_MODULES = (("gf_xor", "seaweedfs_tpu_torch.ops.rs_xor"),
                   ("gf_bits", "seaweedfs_tpu_torch.ops.rs_bits"),
                   ("gf_sel", "seaweedfs_tpu_torch.ops.rs_sel"))


def _kernel_launch_provider() -> dict:
    import sys

    out: dict = {}
    for name, mod_name in _KERNEL_MODULES:
        mod = sys.modules.get(mod_name)
        if mod is None:
            continue
        k = mod.KERNEL
        by = {key: n for key, n in k.launches_by.items()
              if isinstance(key, int)}
        for rows, n in sorted(by.items()):
            out[(("kernel", name), ("rows", str(rows)))] = n
        rest = k.launches - sum(by.values())
        if rest or not by:
            out[(("kernel", name),)] = rest
    return out


EC_KERNEL_LAUNCHES = _PullCounter(
    "SeaweedFS_ec_kernel_launches",
    "Launches of the hand-written CUDA GF(2^8) kernels by kernel (gf_xor, "
    "gf_bits, gf_sel) and, for gf_xor, by rows R of the product; 0 when "
    "the coder runs on the host.", _kernel_launch_provider)


# snake_case metric LABEL VALUES -> camelCase /status JSON keys (labels
# keep their wire names; the unified /status schema test pins that every
# section key is camelCase)
_CAMEL = {"ec_syndrome": "ecSyndrome", "needle_crc": "needleCrc",
          "ec_parity": "ecParity", "replica_divergence":
          "replicaDivergence", "re_replicate": "reReplicate",
          "ec_rebuild": "ecRebuild", "anti_entropy": "antiEntropy"}


def scrub_stats() -> dict:
    """Snapshot for /status pages: find->repair->clean lifecycle counters."""
    out = {
        "bytesVerified": {
            _CAMEL.get(k, k): int(SCRUB_BYTES.value(kind=k))
            for k in ("needle", "ec_syndrome", "digest")},
        "needlesChecked": int(SCRUB_NEEDLES.value()),
        "sweeps": {k: int(SCRUB_SWEEPS.value(kind=k))
                   for k in ("volume", "ec")},
        "findings": {}, "repairs": {},
        "paceWaitSeconds": round(SCRUB_PACE_WAIT_SECONDS.value(), 3),
        "backoffs": int(SCRUB_BACKOFFS.value()),
        "skippedPairs": int(SCRUB_SKIPPED_PAIRS.value()),
        "gather": {
            "bytes": {p: int(SCRUB_GATHER_BYTES.value(phase=p))
                      for p in ("live", "resume")},
            "resumes": int(SCRUB_GATHER_RESUMES.value()),
        },
    }
    for kind in ("needle_crc", "ec_parity", "replica_divergence"):
        out["findings"][_CAMEL[kind]] = {
            s: int(SCRUB_FINDINGS.value(kind=kind, state=s))
            for s in ("found", "repaired", "failed")}
    for method in ("re_replicate", "ec_rebuild", "anti_entropy"):
        out["repairs"][_CAMEL[method]] = {
            o: int(SCRUB_REPAIRS.value(method=method, outcome=o))
            for o in ("ok", "failed")}
    return out


def ec_dispatch_stats() -> dict:
    """Snapshot for /status pages: per-lane batch factor + cache ratios
    + the per-chip dispatch spread (V-axis lanes: every chip's
    counter non-zero under concurrent load is the distribution proof)."""
    out: dict = {}
    for lane in ("encode", "reconstruct"):
        slabs = EC_DISPATCH_SLABS.value(lane=lane)
        batches = EC_DISPATCH_BATCHES.value(lane=lane)
        out[lane] = {
            "slabs": int(slabs),
            "batches": int(batches),
            "batchFactor": round(slabs / batches, 3) if batches else 0.0,
        }
    per_chip: dict = {}
    for chip, n in EC_DISPATCH_BATCHES.split_by("chip").items():
        per_chip[chip] = {"batches": int(n)}
    for chip, n in EC_DISPATCH_SLABS.split_by("chip").items():
        per_chip.setdefault(chip, {})["slabs"] = int(n)
    out["perChip"] = per_chip
    # WHY lanes ran where they did (the A/B and
    # /status attribution of schedule-path coverage), plus the compiled
    # XOR-schedule plane's own selection/coverage counters. Metric
    # label values stay snake_case (Prometheus idiom); the /status
    # schema is camelCase all the way down, so reason keys are
    # re-spelled at this presentation boundary.
    def _camel(label: str) -> str:
        head, *rest = label.split("_")
        return head + "".join(p.capitalize() for p in rest)

    out["reasons"] = {_camel(r): int(n) for r, n in
                      EC_DISPATCH_BATCHES.split_by("reason").items()}
    sched: dict = {}
    for role in ("encode", "reconstruct"):
        ran = EC_SCHED_BATCHES.value(role=role)
        skipped = EC_SCHED_SKIPPED.value(role=role)
        eligible = ran + skipped
        sched[role] = {
            "batches": int(ran),
            "bytes": int(EC_SCHED_BYTES.value(role=role)),
            "skipped": {_camel(r): int(n) for r, n in
                        EC_SCHED_SKIPPED.split_by("reason",
                                                  role=role).items()},
            "coverage": round(ran / eligible, 4) if eligible else 0.0,
        }
    sched["cache"] = {r: int(EC_SCHED_CACHE_OPS.value(result=r))
                      for r in ("hit", "compile", "evict", "wait")}
    out["sched"] = sched
    hits = EC_RECON_CACHE_COUNTER.value(result="hit")
    misses = EC_RECON_CACHE_COUNTER.value(result="miss")
    total = hits + misses
    out["reconCache"] = {
        "hits": int(hits),
        "misses": int(misses),
        "puts": int(EC_RECON_CACHE_COUNTER.value(result="put")),
        "invalidations": int(
            EC_RECON_CACHE_COUNTER.value(result="invalidate")),
        "evictions": int(EC_RECON_CACHE_COUNTER.value(result="evict")),
        "hitRate": round(hits / total, 4) if total else 0.0,
    }
    # host memory plane: arena recycling health — a steady
    # workload should converge on hitRate ~1.0 with inuse bouncing
    # between 0 and a few lane-cap buffers
    a_hits = EC_DISPATCH_ARENA_OPS.value(result="hit")
    a_miss = EC_DISPATCH_ARENA_OPS.value(result="miss")
    a_total = a_hits + a_miss
    out["arena"] = {
        "hits": int(a_hits),
        "misses": int(a_miss),
        "resizes": int(EC_DISPATCH_ARENA_OPS.value(result="resize")),
        "recycles": int(EC_DISPATCH_ARENA_OPS.value(result="recycle")),
        "drops": int(EC_DISPATCH_ARENA_OPS.value(result="drop")),
        "hitRate": round(a_hits / a_total, 4) if a_total else 0.0,
        "inUseBytes": int(EC_DISPATCH_ARENA_INUSE.value()),
        "pooledBytes": int(EC_DISPATCH_ARENA_POOLED.value()),
    }
    return out


def group_commit_stats() -> dict:
    """Snapshot for /status pages: flush-batching factor provenance."""
    writes = VOLUME_GROUP_COMMIT_WRITES.value()
    flushes = VOLUME_GROUP_COMMIT_FLUSHES.value()
    return {
        "writes": int(writes),
        "flushes": int(flushes),
        "batchFactor": round(writes / flushes, 3) if flushes else 0.0,
    }


def chunk_cache_stats() -> dict:
    hits = FILER_CHUNK_CACHE_COUNTER.value(result="hit")
    misses = FILER_CHUNK_CACHE_COUNTER.value(result="miss")
    total = hits + misses
    return {
        "hits": int(hits),
        "misses": int(misses),
        "puts": int(FILER_CHUNK_CACHE_COUNTER.value(result="put")),
        "invalidations": int(
            FILER_CHUNK_CACHE_COUNTER.value(result="invalidate")),
        "hitRate": round(hits / total, 4) if total else 0.0,
    }


def fid_lease_stats() -> dict:
    return {
        "leaseHits": int(CLIENT_FID_LEASE_COUNTER.value(result="hit")),
        "refills": int(CLIENT_FID_LEASE_COUNTER.value(result="refill")),
        "expired": int(CLIENT_FID_LEASE_COUNTER.value(result="expired")),
        "invalidations": int(
            CLIENT_FID_LEASE_COUNTER.value(result="invalidate")),
        "assignOk": int(CLIENT_ASSIGN_COUNTER.value(outcome="ok")),
        "assignErrors": int(CLIENT_ASSIGN_COUNTER.value(outcome="error")),
        "assignedFids": int(CLIENT_ASSIGN_COUNTER.value(outcome="fids")),
    }


VERSION_STRING = "seaweedfs-tpu 0.1"


def metrics_content_type(exemplars: bool) -> str:
    """Exemplar-annotated bodies are only legal under the OpenMetrics
    media type — a scraper told 0.0.4 would fail the whole scrape at
    the first mid-line `#`; plain scrapes keep the classic type."""
    return ("application/openmetrics-text; version=1.0.0; charset=utf-8"
            if exemplars else "text/plain; version=0.0.4")


def status_base(started_at_unix: float) -> dict:
    """The top-level keys every server's /status shares (satellite: one schema — `version`/`startedAt`/`uptimeSeconds` at top
    level on master, filer, volume and s3 alike; pinned by
    tests/test_observability.py)."""
    return {
        "version": VERSION_STRING,
        "startedAt": int(started_at_unix),
        "uptimeSeconds": round(max(time.time() - started_at_unix, 0.0), 1),
    }


def start_push(gateway_url: str, job: str, interval_sec: int = 15):
    """Push the registry to a Prometheus push gateway on an interval
    (stats.StartPushingMetric / LoopPushingMetric). Returns a stop().

    Hardened: each delivery rides utils/retry with
    backoff — a refused connection (sink not up yet, flapping, mid-
    restart) is a retryable transport error, never the end of the loop.
    After exhausted retries the tick is dropped (counted in
    SeaweedFS_metrics_push_ops{outcome="error"}) and the next interval
    tries fresh; consecutive failures stretch the interval up to 4x so
    a long-dead sink is not hammered every tick."""
    import requests

    from . import retry as _retry

    stop = threading.Event()

    def push_once(url: str) -> None:
        r = requests.put(url, data=gather().encode(),
                         headers={"Content-Type": "text/plain"},
                         timeout=10)
        if r.status_code >= 300:
            # gateway answered but refused: surface as retryable — a
            # mid-restart sink often 503s before it refuses connections
            raise ConnectionError(f"push gateway {r.status_code}")

    def loop():
        url = f"{gateway_url.rstrip('/')}/metrics/job/{job}"
        consecutive_failures = 0
        while True:
            wait = interval_sec * min(1 + consecutive_failures, 4)
            if stop.wait(wait):
                return
            try:
                _retry.retry("metrics.push", lambda: push_once(url),
                             attempts=3, wait_init=0.2, wait_max=2.0)
                METRICS_PUSH_OPS.inc(outcome="ok")
                consecutive_failures = 0
            except Exception:  # noqa: BLE001 — the loop must survive
                METRICS_PUSH_OPS.inc(outcome="error")
                consecutive_failures += 1

    threading.Thread(target=loop, daemon=True).start()
    return stop.set
