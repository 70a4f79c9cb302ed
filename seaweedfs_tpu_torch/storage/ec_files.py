"""EC shard-file pipelines: encode a .dat into .ecNN shards, rebuild
missing shards, and decode shards back into a .dat/.idx.

Counterpart of seaweedfs_tpu/storage/ec_files.py (SeaweedFS's
ec_encoder.go WriteEcFiles / RebuildEcFiles): the same reader /
coordinator / shard-writer pipeline, the same recycled read buffers, the
same bytes. Launches on a CUDA coder are asynchronous, so the pattern

    read slab -> submit encode -> write the previous slab's shards -> wait for parity

keeps disk and card busy at once. Slabs go through the coder's EC
dispatch scheduler (ops/dispatch.py) unless SWFS_EC_DISPATCH=0, so
volumes encoding or rebuilding concurrently through one coder share
stacked launches. Shard bytes are independent of batch size and of
stacking (parity is a per-byte-column GF matmul), so output files are
bit-identical to the reference's 256KB batching.

Not carried over: the reference's `ec.shard.write.corrupt` chaos hook
in the shard writers and its SEAWEEDFS_TPU_EC_WRITERS override.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..ops import dispatch
from ..utils import numa, trace
from . import idx as idx_mod
from . import needle_map, types
from .ec_locate import Geometry

# Per-shard slab size for the pipelined encoder. 4MB/shard => 40MB host reads
# per step for RS(10,4); divides 1GB and 1MB evenly.
DEFAULT_BATCH_SIZE = 4 * 1024 * 1024
# In-flight slabs between the reader thread and the shard writers.
DEFAULT_PIPELINE_DEPTH = 3


def to_host(x) -> np.ndarray:
    """Coder output -> numpy uint8 on the host (a CUDA tensor is copied
    back, which waits for the kernel that produced it; an encode
    EcFuture resolves first)."""
    if hasattr(x, "detach"):  # a torch tensor
        return x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.uint8)


@dataclass
class EncodeStats:
    """Timing breakdown of one pipelined encode."""

    bytes: int = 0
    batches: int = 0
    wall_s: float = 0.0
    read_s: float = 0.0  # reader thread: file reads + zero fill
    dispatch_s: float = 0.0  # reader thread: the encode submit (the slab
    #                          copy into the scheduler, or the direct call)
    device_wait_s: float = 0.0  # coordinator: blocked on parity results
    #                             (scheduler window, copies, kernel)
    copy_out_s: float = 0.0  # the part of device_wait_s that copied the
    #                          parity back to the host
    write_s: float = 0.0  # SUM across all shard-writer threads
    started: float = field(default_factory=time.perf_counter)
    ended: float = 0.0

    @property
    def overlap_ratio(self) -> float:
        """(read + dispatch + device-wait + write) / wall — >1 proves the
        phases ran concurrently (a serial loop is exactly 1.0)."""
        if self.wall_s <= 0:
            return 0.0
        return (
            self.read_s + self.dispatch_s + self.device_wait_s + self.write_s
        ) / self.wall_s


def _writer_thread_count(n_files: int) -> int:
    """Writer parallelism, adaptive to the host: the shard files are
    independent streams, and parallel writing lifts aggregate disk
    bandwidth, up to one thread per shard file."""
    return min(n_files, max(2, 2 * (os.cpu_count() or 1)))


class _ShardWriters:
    """Shard files fanned out over writer threads; each shard maps to
    exactly one thread, so per-shard write order is preserved while
    independent files stream in parallel. Blocks of one slab release the
    recycled read buffer via a countdown once every data-shard row is on
    disk."""

    def __init__(self, files: dict[int, object], stats: EncodeStats,
                 depth: int, numa_node: int | None = None):
        self._files = files
        self._numa_node = numa_node
        self._stats = stats
        self._stats_lock = threading.Lock()
        n = _writer_thread_count(len(files))
        self._lanes: list[queue.Queue] = [
            queue.Queue(maxsize=max(2, depth) * max(1, len(files) // n))
            for _ in range(n)
        ]
        self._qs: dict[int, queue.Queue] = {
            shard_id: self._lanes[i % n]
            for i, shard_id in enumerate(sorted(files))
        }
        self._errors: list[BaseException] = []
        self._threads = [
            threading.Thread(target=self._run, args=(lane,),
                             name=f"ec-shard-writer-{i}", daemon=True)
            for i, lane in enumerate(self._lanes)
        ]
        for t in self._threads:
            t.start()

    def _run(self, q: queue.Queue) -> None:
        # NUMA-affine writers (SWFS_EC_DISPATCH_PIN): every writer pins
        # to the SAME node as its pipeline's reader (the shared numa_node
        # draw), since the rows a writer drains were packed by that
        # reader; a no-op when the gate is closed
        numa.pin_thread(self._numa_node)
        while True:
            item = q.get()
            if item is None:
                return
            shard_id, arr, nbytes, release = item
            if not self._errors:  # fail fast but keep draining queues
                t0 = time.perf_counter()
                try:
                    self._files[shard_id].write(memoryview(arr)[:nbytes])
                except BaseException as e:  # surfaced by close()
                    self._errors.append(e)
                with self._stats_lock:
                    self._stats.write_s += time.perf_counter() - t0
            if release is not None:
                release()

    def put(self, shard_id: int, arr, nbytes: int, release=None) -> None:
        self._qs[shard_id].put((shard_id, arr, nbytes, release))

    def close(self) -> None:
        """Flush all queues, join threads, surface the first write error."""
        for q in self._lanes:
            q.put(None)
        for t in self._threads:
            t.join()
        if self._errors:
            raise self._errors[0]

    def abort(self) -> None:
        """Drain without raising (cleanup on another failure path)."""
        for q in self._lanes:
            try:
                q.put_nowait(None)
            except queue.Full:
                self._errors.append(RuntimeError("abort"))
                while True:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
                q.put(None)
        for t in self._threads:
            t.join(timeout=5)


class _Countdown:
    """Call `cb` after `n` release() calls — frees a recycled read buffer
    only when every data-shard writer has flushed its row view."""

    __slots__ = ("_n", "_cb", "_lock")

    def __init__(self, n: int, cb):
        self._n = n
        self._cb = cb
        self._lock = threading.Lock()

    def __call__(self) -> None:
        with self._lock:
            self._n -= 1
            fire = self._n == 0
        if fire:
            self._cb()


def _pick_batch(block_size: int, requested: int) -> int:
    """Largest batch <= requested that divides block_size (SeaweedFS
    requires blockSize %% bufferSize == 0)."""
    if block_size <= requested:
        return block_size
    b = requested
    while block_size % b != 0:
        b //= 2
    return max(b, 1)


def _read_padded(f, offset: int, length: int, buf: np.ndarray) -> None:
    """ReadAt with zero fill past EOF."""
    f.seek(offset)
    got = f.readinto(memoryview(buf)[:length])
    if got is None:
        got = 0
    if got < length:
        buf[got:length] = 0


def _row_schedule(geo: Geometry, dat_size: int):
    """Yield the per-row block sizes encodeDatFile walks: strict-> large
    rows while remaining > large_row, then small rows while > 0."""
    n_large, n_small = geo.row_counts(dat_size)
    for _ in range(n_large):
        yield geo.large_block
    for _ in range(n_small):
        yield geo.small_block


def _preallocate(files, size: int) -> None:
    """Best-effort contiguous extents for shard files of a known size."""
    fallocate = getattr(os, "posix_fallocate", None)  # absent off-Linux
    if not size or not fallocate:
        return
    for f in files:
        try:
            fallocate(f.fileno(), 0, size)
        except OSError:
            continue  # per file: one ENOSPC/EOPNOTSUPP must not stop the rest


def generate_ec_files(
    base_file_name: str,
    coder,
    geo: Geometry = Geometry(),
    batch_size: int = DEFAULT_BATCH_SIZE,
    pipeline_depth: int = DEFAULT_PIPELINE_DEPTH,
    sinks=None,
    pace=None,
) -> EncodeStats:
    """<base>.dat -> <base>.ec00..ecNN.

    `coder` must expose encode_parity(data[k, B] uint8) -> parity[m, B]
    (models.coder.ErasureCoder; a tensor result is copied to the host).

    Pipeline, `pipeline_depth` slabs deep, with per-shard writer fan-out:

      reader thread:    read slab -> submit encode ─┐ bounded queue
      coordinator:      route data rows to writers -> wait for parity ┘
      shard writers:    one stream per output file

    A recycled buffer pool caps host memory at ~(depth+2) slabs; a slab's
    buffer is recycled only after every data-shard writer flushed its row
    (countdown). The scheduler snapshots each slab when it is submitted
    (and a direct encode call copies it to the device before it returns),
    so the card never reads a recycled buffer. Volumes encoding
    concurrently through one coder each run their own pipeline; their
    slabs meet in the scheduler's encode lane and share launches.

    `sinks` (storage/ec_stream.py EcStreamSinkSet) is the shard-sink
    hook: an object whose put(shard_id, shard_offset, row, nbytes)
    receives every slab row the moment it is on the host (data rows
    before the parity is waited for, parity rows right after), so the
    transfer to the shards' destination servers overlaps the encode. A
    row is always a C-contiguous uint8 numpy row, never a device tensor.
    Sinks copy the bytes synchronously, on this thread (the pipeline
    recycles its buffers); local shard files are written regardless
    (they are the resume source, and keep the bytes identical to the
    generate-then-copy path by construction).

    `pace` (qos/priority.py BackgroundGovernor.pacer) is called with each
    slab's data-byte count before the slab's rows are routed to writers
    and sinks; it may block (waiting on cluster tokens) or raise
    (QosUnavailable mid-job) — the pipeline aborts cleanly either way.
    """
    k, m = geo.data_shards, geo.parity_shards
    dat_path = base_file_name + ".dat"
    dat_size = os.path.getsize(dat_path)
    stats = EncodeStats()
    depth = max(1, pipeline_depth)

    outs = [open(geo.shard_file_name(base_file_name, i), "wb")
            for i in range(k + m)]
    _preallocate(outs, geo.shard_size(dat_size))
    free_q: queue.Queue = queue.Queue()
    max_batch = min(batch_size, max(geo.large_block, geo.small_block))
    for _ in range(depth + 2):
        free_q.put(np.empty((k, max_batch), dtype=np.uint8))
    work_q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    # slabs of this pipeline and of every other volume encoding through
    # the same coder share stacked launches; the futures answer to_host
    # like a direct call's tensor, and shard bytes stay identical
    sched = dispatch.maybe_scheduler(coder)
    encode = coder.encode_parity if sched is None else sched.encode_parity
    # one node per PIPELINE: reader and writers share it, so the recycled
    # read buffers stay node-local end to end; concurrent pipelines
    # round-robin across nodes through their own draws
    pipe_node = numa.next_node()

    def reader() -> None:
        numa.pin_thread(pipe_node)  # reads + encode submits node-local
        try:
            with open(dat_path, "rb") as f:
                processed = 0
                for block_size in _row_schedule(geo, dat_size):
                    batch = _pick_batch(block_size, batch_size)
                    for b in range(0, block_size, batch):
                        if stop.is_set():
                            return
                        buf = free_q.get()
                        if stop.is_set() or buf.shape[1] < batch:
                            return
                        data = buf[:, :batch]
                        t0 = time.perf_counter()
                        # zero so rows fully past EOF stay zero; short reads
                        # are zero-padded by _read_padded
                        data[:] = 0
                        for i in range(k):
                            start = processed + block_size * i + b
                            if start < dat_size:
                                _read_padded(f, start,
                                             min(batch, dat_size - start),
                                             data[i])
                        t1 = time.perf_counter()
                        stats.read_s += t1 - t0
                        parity_fut = encode(data)
                        stats.dispatch_s += time.perf_counter() - t1
                        work_q.put((buf, data, parity_fut, batch))
                    processed += block_size * k
            work_q.put(None)
        except BaseException as e:  # surface in the coordinator/caller
            work_q.put(e)

    writers = _ShardWriters(dict(enumerate(outs)), stats, depth,
                            numa_node=pipe_node)
    t = threading.Thread(target=reader, name="ec-encode-reader", daemon=True)
    t.start()
    ok = False
    shard_off = 0  # every shard advances by the same nbytes per slab
    try:
        while True:
            item = work_q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            buf, data, parity_fut, nbytes = item
            if pace is not None:
                # cluster-budget draw, one slab at a time: may block on
                # higher-priority demand; a raise aborts the pipeline
                # through the normal failure path below
                pace(k * nbytes)
            if sinks is not None:
                # data rows stream BEFORE the writers get the buffer:
                # sinks copy synchronously here, and once writers.put
                # hands rows to the writer threads the countdown can
                # recycle the buffer under a concurrent reader refill
                for i in range(k):
                    sinks.put(i, shard_off, data[i], nbytes)
            release = _Countdown(k, lambda b=buf: free_q.put(b))
            for i in range(k):
                writers.put(i, data[i], nbytes, release)
            t1 = time.perf_counter()
            if isinstance(parity_fut, dispatch.EcFuture):
                # the scheduler's window, its queue, copies and kernel
                parity_fut = parity_fut.result()
            t2 = time.perf_counter()
            with trace.phase("ec.encode.copy_out", lane="encode"):
                parity = to_host(parity_fut)
            t3 = time.perf_counter()
            stats.copy_out_s += t3 - t2
            stats.device_wait_s += t3 - t1
            for j in range(m):
                # parity rows are views of one fresh array; numpy refcounts
                # keep it alive until the last writer drops its view
                writers.put(k + j, parity[j], nbytes)
                if sinks is not None:
                    sinks.put(k + j, shard_off, parity[j], nbytes)
            shard_off += nbytes
            stats.batches += 1
            stats.bytes += k * nbytes
        writers.close()
        ok = True
    finally:
        stop.set()
        if not ok:
            writers.abort()
        # unblock a reader stuck on free_q.get(), then drain
        free_q.put(np.empty((k, 0), dtype=np.uint8))
        while t.is_alive():
            try:
                work_q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.05)
        for f2 in outs:
            f2.close()
    stats.ended = time.perf_counter()
    stats.wall_s = stats.ended - stats.started
    return stats


def write_ec_files(base_file_name: str, coder,
                   geo: Geometry = Geometry(), sinks=None,
                   pace=None) -> EncodeStats:
    """WriteEcFiles equivalent."""
    return generate_ec_files(base_file_name, coder, geo, sinks=sinks,
                             pace=pace)


def write_ecx_stride_marker(base_file_name: str) -> None:
    """Sync the per-index `.ecx.lrg` marker to the active offset width.

    EC index files carry their OWN marker, distinct from the volume's
    `.lrg`: shards travel between servers independently of any .dat
    volume sharing the base name."""
    if types.large_disk():
        with open(base_file_name + ".ecx.lrg", "wb"):
            pass
    else:
        try:
            os.remove(base_file_name + ".ecx.lrg")
        except FileNotFoundError:
            pass


def check_ecx_stride(base_file_name: str) -> None:
    """Refuse to parse a .ecx across an offset-width mismatch — the
    size-modulus heuristic alone misses entry counts that are multiples
    of both strides."""
    has_marker = os.path.exists(base_file_name + ".ecx.lrg")
    if has_marker != types.large_disk():
        raise IOError(
            f"ec volume {base_file_name}: index stride mismatch — .ecx "
            f"was written with {'5' if has_marker else '4'}-byte offsets "
            f"but the process is in "
            f"{'large-disk (5-byte)' if types.large_disk() else '4-byte'} "
            f"mode"
        )


def write_sorted_file_from_idx(base_file_name: str, ext: str = ".ecx") -> None:
    """The sorted .ecx from <base>.idx, stamped with its stride marker."""
    needle_map.write_sorted_file_from_idx(base_file_name, ext)
    write_ecx_stride_marker(base_file_name)


def rebuild_ec_files(
    base_file_name: str,
    coder,
    geo: Geometry = Geometry(),
    batch_size: int = DEFAULT_BATCH_SIZE,
    pace=None,
    want: list[int] | None = None,
    stats: dict | None = None,
) -> list[int]:
    """Regenerate missing .ecNN files from the survivors (RebuildEcFiles).
    Returns the rebuilt shard ids.

    Reads only the geometry's MINIMAL-READ repair plan
    (models/geometry.py): a single lost shard inside an lrc_10_2_2 local
    group reads its 5 group peers; RS reads exactly its first-k decode
    set. `want` restricts the rebuild to those shard ids; `stats`, when
    given, receives survivor_bytes_read / survivor_shards / geometry.
    `pace`, as in generate_ec_files, draws each slab's survivor-read bytes
    from the cluster background budget before the slab is written.
    `coder` must expose reconstruct_stacked(present_ids, stacked, want=)."""
    total = geo.total_shards
    have = [os.path.exists(geo.shard_file_name(base_file_name, i))
            for i in range(total)]
    missing = [i for i in range(total) if not have[i]]
    if want is not None:
        missing = [i for i in missing if i in set(want)]
    if not missing:
        return []
    present = [i for i in range(total) if have[i]]

    from ..models.geometry import UnsolvableError

    geom = geo.code_geometry()
    try:
        plan = geom.repair_plan(tuple(missing), tuple(present))
    except (UnsolvableError, ValueError):
        raise ValueError(
            f"too many shards missing: have {len(present)} "
            f"({geo.code_name}), cannot rebuild {missing}"
        )
    reads = list(plan.reads)
    ins = {i: open(geo.shard_file_name(base_file_name, i), "rb")
           for i in reads}
    outs = {i: open(geo.shard_file_name(base_file_name, i), "wb")
            for i in missing}
    _preallocate(outs.values(),
                 os.path.getsize(geo.shard_file_name(base_file_name,
                                                     reads[0])))
    # Same pipeline shape as the encoder: a reader thread launches
    # reconstructs; the coordinator drains an N-deep queue and fans rebuilt
    # rows out to one writer thread per missing shard.
    work_q: queue.Queue = queue.Queue(maxsize=DEFAULT_PIPELINE_DEPTH)
    stop = threading.Event()
    if stats is not None:
        stats["geometry"] = geo.code_name
        stats["survivor_shards"] = len(reads)
        stats.setdefault("survivor_bytes_read", 0)
    reads_tuple = tuple(reads)
    want_tuple = tuple(missing)
    # share stacked reconstruct launches with any concurrent rebuild of
    # the same survivor set (futures resolve in the coordinator, so the
    # reader keeps working ahead)
    sched = dispatch.maybe_scheduler(coder)
    recon = coder.reconstruct_stacked if sched is None else \
        sched.reconstruct_stacked
    pipe_node = numa.next_node()  # shared by reader + writers

    def reader() -> None:
        numa.pin_thread(pipe_node)  # survivor reads stay node-local
        try:
            offset = 0
            while not stop.is_set():
                # survivors land in ONE contiguous [P, batch] buffer via
                # readinto — the stacked reconstruct then runs a single
                # column-permuted product with no re-stack
                stacked = np.empty((len(reads), batch_size), dtype=np.uint8)
                n = None
                for j, i in enumerate(reads):
                    ins[i].seek(offset)
                    got = ins[i].readinto(memoryview(stacked[j]))
                    if n is None:
                        n = got
                    elif got != n:
                        raise IOError(
                            f"ec shard size mismatch: expected {n} got {got}"
                        )
                if not n:
                    break
                # fresh buffer each loop: a queued slab may reference it
                # without a defensive copy
                work_q.put(recon(reads_tuple, stacked[:, :n],
                                 want=want_tuple))
                offset += n
            work_q.put(None)
        except BaseException as e:
            work_q.put(e)

    writers = _ShardWriters(outs, EncodeStats(), DEFAULT_PIPELINE_DEPTH,
                            numa_node=pipe_node)
    t = threading.Thread(target=reader, name="ec-rebuild-reader", daemon=True)
    t.start()
    ok = False
    try:
        while True:
            item = work_q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            if isinstance(item, dispatch.EcFuture):
                item = item.result()
            mids, rows = item
            rows = to_host(rows)  # waits for the device
            if pace is not None:
                # repair-class budget draw: the survivors read this slab
                pace(len(reads) * rows.shape[1])
            if stats is not None:
                stats["survivor_bytes_read"] += len(reads) * rows.shape[1]
            for j, i in enumerate(mids):
                writers.put(i, rows[j], rows.shape[1])
        writers.close()
        ok = True
    finally:
        stop.set()
        if not ok:
            writers.abort()
        while t.is_alive():
            try:
                work_q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.05)
        for f in ins.values():
            f.close()
        for f in outs.values():
            f.close()
    return missing


def find_dat_file_size(
    base_file_name: str,
    version: int = types.CURRENT_VERSION,
) -> int:
    """True .dat length = max(offset + actual_size) over live .ecx entries
    (FindDatFileSize, ec_decoder.go:48-70)."""
    check_ecx_stride(base_file_name)
    dat_size = 0
    ids, offs, sizes = idx_mod.read_index_file(base_file_name + ".ecx")
    for i in range(len(ids)):
        size = int(sizes[i])
        if types.size_is_deleted(size):
            continue
        entry_stop = types.stored_to_actual_offset(int(offs[i])) + types.actual_size(
            size, version
        )
        dat_size = max(dat_size, entry_stop)
    return dat_size


def write_dat_file(
    base_file_name: str,
    dat_file_size: int,
    geo: Geometry = Geometry(),
    shard_file_names: list[str] | None = None,
) -> None:
    """Re-interleave data shards .ec00..ec<k-1> into <base>.dat
    (WriteDatFile, ec_decoder.go:153-201). Note the reference's large-row
    loop here is `>=` where the encoder's is strict `>` — replicated as-is,
    quirk included."""
    k = geo.data_shards
    names = shard_file_names or [geo.shard_file_name(base_file_name, i) for i in range(k)]
    types.write_stride_marker(base_file_name)
    ins = [open(names[i], "rb") for i in range(k)]
    try:
        with open(base_file_name + ".dat", "wb") as out:
            remaining = dat_file_size
            while remaining >= k * geo.large_block:
                for i in range(k):
                    chunk = ins[i].read(geo.large_block)
                    if len(chunk) != geo.large_block:
                        raise IOError(f"short large block from {names[i]}")
                    out.write(chunk)
                    remaining -= geo.large_block
            while remaining > 0:
                for i in range(k):
                    take = min(remaining, geo.small_block)
                    if take <= 0:
                        break
                    chunk = ins[i].read(take)
                    if len(chunk) != take:
                        raise IOError(f"short small block from {names[i]}")
                    out.write(chunk)
                    remaining -= take
    finally:
        for f in ins:
            f.close()


def write_idx_file_from_ec_index(base_file_name: str) -> None:
    """Reconstruct <base>.idx from .ecx + .ecj tombstones
    (WriteIdxFileFromEcIndex, ec_decoder.go:18-43): copy .ecx, then append a
    tombstone entry per journaled deletion."""
    check_ecx_stride(base_file_name)  # .idx inherits the .ecx entry bytes
    ecx = base_file_name + ".ecx"
    with open(ecx, "rb") as f:
        payload = f.read()
    extra = b""
    ecj = base_file_name + ".ecj"
    if os.path.exists(ecj):
        with open(ecj, "rb") as f:
            j = f.read()
        for i in range(0, len(j) - 7, types.NEEDLE_ID_SIZE):
            nid = int.from_bytes(j[i : i + 8], "big")
            extra += types.pack_needle_map_entry(nid, 0, types.TOMBSTONE_FILE_SIZE)
    with open(base_file_name + ".idx", "wb") as f:
        f.write(payload + extra)
