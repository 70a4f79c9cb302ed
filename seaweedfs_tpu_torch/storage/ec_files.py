"""EC shard-file pipelines: encode a .dat into .ecNN shards and rebuild
missing shards.

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

Not carried over yet: NUMA pinning of the pipeline threads, shard sinks
and pacing (``sinks=``, ``pace=``), and the decode-back path (write_dat_file and friends).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..ops import dispatch
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
    write_s: float = 0.0  # SUM across all shard-writer threads
    started: float = field(default_factory=time.perf_counter)
    ended: float = 0.0


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
                 depth: int):
        self._files = files
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

    def reader() -> None:
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

    writers = _ShardWriters(dict(enumerate(outs)), stats, depth)
    t = threading.Thread(target=reader, name="ec-encode-reader", daemon=True)
    t.start()
    ok = False
    try:
        while True:
            item = work_q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            buf, data, parity_fut, nbytes = item
            release = _Countdown(k, lambda b=buf: free_q.put(b))
            for i in range(k):
                writers.put(i, data[i], nbytes, release)
            t1 = time.perf_counter()
            parity = to_host(parity_fut)  # waits for the scheduler + device
            stats.device_wait_s += time.perf_counter() - t1
            for j in range(m):
                # parity rows are views of one fresh array; numpy refcounts
                # keep it alive until the last writer drops its view
                writers.put(k + j, parity[j], nbytes)
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
                   geo: Geometry = Geometry()) -> EncodeStats:
    """WriteEcFiles equivalent."""
    return generate_ec_files(base_file_name, coder, geo)


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

    def reader() -> None:
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

    writers = _ShardWriters(outs, EncodeStats(), DEFAULT_PIPELINE_DEPTH)
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
