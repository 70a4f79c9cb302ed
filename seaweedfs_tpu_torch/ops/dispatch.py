"""EC dispatch scheduler: share device launches across the EC plane.

Counterpart of seaweedfs_tpu/ops/dispatch.py. The encode
and rebuild pipelines (storage/ec_files.py) and degraded reads
(storage/ec_volume.py) all end in the same shape of work: a GF matmul
over a [rows, B] slab. Parity and reconstruction are per-byte-column
matmuls, so slabs from DIFFERENT volumes or requests can share one
launch by laying their columns side by side, bit-identically.

This module is that sharing point:

  * slabs submitted by concurrent pipelines land in per-kind *lanes*
    (encode slabs share one lane per geometry; reconstruct slabs share a
    lane per survivor set: same fused matrix, so same launch);
  * a lane flushes as ONE stacked product (`encode_parity` /
    `reconstruct_stacked` over the column-packed slabs) when its flush
    window expires (SWFS_EC_DISPATCH_WINDOW_MS, default 2ms), when it
    reaches MAX_SLABS, or the moment a consumer blocks
    on one of its futures (demand flush: a pipeline draining its queue
    never pays the window as latency);
  * submission order is preserved per lane, so each volume's slabs
    dispatch FIFO (a volume's pipeline submits from one thread).

The scheduler changes when products run, never what they compute: the
tests pin .ec00-.ec13 bit-identity with the scheduler on and off
(SWFS_EC_DISPATCH=0).

A flush packs its slabs into a recycled page-aligned `StackArena`
buffer, column-compactly (`[rows, sum(widths)]`, no zero fill: every
byte is payload). The coder copies that buffer to the card and launches
on the flushing thread's current CUDA stream. An arena buffer is
recycled only once the flush provably consumed its bytes: the flush
records a CUDA event after its last kernel, and the buffer waits in
quarantine until that event has completed (host coders' numpy and CPU
tensor results count as consumed at once). Consumers wait on the same
event before they read a result, so ordering never depends on the
flusher and the consumer sharing one stream. The flusher thread can
optionally be NUMA-pinned (`SWFS_EC_DISPATCH_PIN`, utils/numa.py).

Every flush holds one mutex, `_dispatch_mu`, from its lane's pop to its
launch, and is timed there as phases (utils/trace.phase, lane `encode`
or `reconstruct`): `ec.dispatch.section` for the whole hold,
`ec.dispatch.pack` for the arena pack, and inside them the codec's
`ec.codec.copy_in` and `ec.codec.launch` (ops/rs_torch.py).

On a multi-device coder (parallel/mesh.ShardedCoder) the lanes split per
chip, as in the reference: encode slabs round-robin over one lane per
chip, each flushed as one product pinned there (`encode_parity_on`); a
survivor set's lane is pinned to one chip (LRU), where its fused matrix
stays cached (`reconstruct_stacked_on`); a big uniform reconstruct batch
splits its slabs over every device (`reconstruct_stacked_vsharded`); a
lane without a chip keeps the `[V, k, B]` stack (`_pack_vstack`) that the
coder splits by slab. SWFS_EC_DISPATCH_VSHARD=0 turns the chip lanes off.
A flush that read its arena buffer from several devices records its
completion event on each of them. On a host coder a lane runs the
compiled XOR schedule of its matrix when it is predicted cheaper
(`rs_sched.maybe_encode` / `maybe_reconstruct`).

Not carried over: the per-slab paths of the reference for a coder without
stacked products or without the wide chip entry (`encode_parity_on`),
since every port coder has both; and the arena's on/off switch
(SWFS_EC_DISPATCH_ARENA), since the arena is always on. None of these
would change the bytes.
"""

from __future__ import annotations

import atexit
import itertools
import os
import threading
import time
import weakref
from collections import OrderedDict

import numpy as np
import torch

from . import rs_sched
from ..utils import locks, numa, trace
from ..utils.stats import (
    EC_DISPATCH_ARENA_INUSE,
    EC_DISPATCH_ARENA_OPS,
    EC_DISPATCH_ARENA_POOLED,
    EC_DISPATCH_BATCHES,
    EC_DISPATCH_SLABS,
    EC_DISPATCH_STACK_BYTES,
    EC_DISPATCH_STACK_SLABS,
    EC_DISPATCH_WINDOW_WAIT,
    EC_RECON_CACHE_COUNTER,
)

DEFAULT_WINDOW_MS = 2.0
# a lane that reaches this many slabs flushes on the submitter
MAX_SLABS = 32
# flusher thread exits after this long with no pending work (a fresh
# submit restarts it): idle schedulers self-clean instead of leaking a
# thread per coder across tests
_IDLE_EXIT_S = 1.0
# lanes of no chip (a single-device coder's) carry this chip label
_NO_CHIP = "-"
# survivor-set -> chip assignments kept per scheduler (LRU): each set's
# fused decode matrix stays cached on its chip (the reference's
# SWFS_EC_DISPATCH_REC_SETS default, a constant here)
REC_SETS = 128


def enabled() -> bool:
    """SWFS_EC_DISPATCH gates the whole plane (default on)."""
    return os.environ.get("SWFS_EC_DISPATCH", "1").lower() not in (
        "0", "false", "off")


def vshard_enabled() -> bool:
    """SWFS_EC_DISPATCH_VSHARD gates the per-chip lanes of multi-device
    coders (default on; single-device coders ignore it)."""
    return os.environ.get("SWFS_EC_DISPATCH_VSHARD", "1").lower() not in (
        "0", "false", "off")


def window_s() -> float:
    return float(os.environ.get("SWFS_EC_DISPATCH_WINDOW_MS",
                                str(DEFAULT_WINDOW_MS))) / 1000.0


def _lane_kind(key: tuple) -> str:
    """The `lane` label of a lane key: "encode" or "reconstruct"."""
    return "encode" if key[0] == "enc" else "reconstruct"


# -- flush completion ----------------------------------------------------------


class FlushDone:
    """Completion handle of one flush: a CUDA event recorded on the
    launching thread's current stream right after the flush's last
    kernel (None for a host coder, whose results exist on return), plus
    one more on each other device the flush read its input from (a
    multi-device coder's split copies the arena buffer to every device
    it lists).

    `is_ready()` is the arena's proof that the flush consumed its input
    buffer: once every event completed, every copy and kernel queued
    before them on those streams has run. `wait()` is the consumer's
    side: it blocks the host until then, so a result is read after it
    was written whatever stream the reading thread uses."""

    __slots__ = ("event", "others")

    def __init__(self, event: "torch.cuda.Event | None", others=()):
        self.event = event
        self.others = tuple(others)

    @classmethod
    def after(cls, out, devices=()) -> "FlushDone":
        """Record the events after the work that produced `out`: on its
        device's current stream and on that of each other CUDA device in
        `devices`."""
        devs = []
        if isinstance(out, torch.Tensor):
            devs.append(out.device)
        devs += [torch.device(d) for d in devices]
        events = []
        seen = set()
        for d in devs:
            if d.type != "cuda":
                continue
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            if d in seen:
                continue
            seen.add(d)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(d))
            events.append(event)
        return cls(events[0] if events else None, events[1:])

    def is_ready(self) -> bool:
        return ((self.event is None or self.event.query())
                and all(e.query() for e in self.others))

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()
        for e in self.others:
            e.synchronize()


# -- stack arena: the host memory plane --------------------------------------

_PAGE = 4096
ARENA_POOL_BYTES = 256 * 1024 * 1024
ARENA_POOL_BUFS = 8


def _aligned_empty(nbytes: int) -> np.ndarray:
    """Page-aligned uint8 buffer of `nbytes` (a view into a slightly
    larger allocation; the view keeps the backing array alive)."""
    raw = np.empty(nbytes + _PAGE, dtype=np.uint8)
    off = (-raw.ctypes.data) % _PAGE
    return raw[off:off + nbytes]


def _consumed(out_ref) -> bool:
    """True iff the flush that read an arena buffer has provably consumed
    its bytes. Host coders return realized numpy arrays or CPU tensors:
    consumed by construction. A `FlushDone` (or anything else with
    is_ready()) is consumed once ready. Anything unprobeable, a CUDA
    tensor without its flush's event included, is treated as never
    consumed (the arena then drops the buffer rather than risk
    recycling live bytes)."""
    if out_ref is None or isinstance(out_ref, np.ndarray):
        return True
    if isinstance(out_ref, torch.Tensor):
        return out_ref.device.type == "cpu"
    fn = getattr(out_ref, "is_ready", None)
    return bool(fn()) if fn is not None else False


class _ArenaBuf:
    __slots__ = ("flat", "cap")

    def __init__(self, cap: int):
        self.flat = _aligned_empty(cap)
        self.cap = cap


class StackArena:
    """Bounded pool of reusable page-aligned host buffers for stacked
    flushes.

    A flush checks a buffer out (`get`), packs its slabs into a view of
    it, dispatches, and hands the buffer back with the flush's completion
    handle (`release`). The buffer returns to the free pool ONLY once
    that handle proves the bytes were consumed (`_consumed`), never while
    a copy to the card could still read them. Buffers whose flush never
    proves consumption are dropped, not recycled.

    Capacities are rounded to power-of-two pages so steady-state lanes
    (same shape flush after flush) hit the same bucket every time; the
    pool is bounded by buffer count and total bytes."""

    def __init__(self, max_bufs: int = ARENA_POOL_BUFS,
                 max_bytes: int = ARENA_POOL_BYTES):
        self.max_bufs = max(1, max_bufs)
        self.max_bytes = max(_PAGE, max_bytes)
        self._pool: dict[int, list[_ArenaBuf]] = {}
        self._pooled_bytes = 0
        self._inuse_bytes = 0
        self._quarantine: list[tuple[_ArenaBuf, object]] = []
        self._largest = 0
        # witnessed leaf lock: held briefly for pool bookkeeping, ranked
        # after every dispatch-plane lock
        self._mu = locks.wlock("dispatch.arena", rank=800)

    @staticmethod
    def _bucket(nbytes: int) -> int:
        cap = _PAGE
        while cap < nbytes:
            cap *= 2
        return cap

    def _sweep_locked(self) -> None:
        """Move quarantined buffers whose flush completed back to the pool
        (opportunistic: called from get/release, never blocks). The
        quarantine itself is bounded: outputs that never prove
        consumption shed their oldest buffers to the GC (counted as
        drops) instead of accumulating forever."""
        still = []
        for buf, out_ref in self._quarantine:
            if _consumed(out_ref):
                self._pool_locked(buf)
            else:
                still.append((buf, out_ref))
        while len(still) > max(8, 2 * self.max_bufs):
            buf, _ = still.pop(0)
            self._inuse_bytes -= buf.cap
            EC_DISPATCH_ARENA_INUSE.set(self._inuse_bytes)
            EC_DISPATCH_ARENA_OPS.inc(result="drop")
        self._quarantine = still

    def _pool_locked(self, buf: _ArenaBuf) -> None:
        self._inuse_bytes -= buf.cap
        bucket = self._pool.setdefault(buf.cap, [])
        n_pooled = sum(len(v) for v in self._pool.values())
        if (n_pooled >= self.max_bufs
                or self._pooled_bytes + buf.cap > self.max_bytes):
            EC_DISPATCH_ARENA_OPS.inc(result="drop")
        else:
            bucket.append(buf)
            self._pooled_bytes += buf.cap
            EC_DISPATCH_ARENA_OPS.inc(result="recycle")
        EC_DISPATCH_ARENA_INUSE.set(self._inuse_bytes)
        EC_DISPATCH_ARENA_POOLED.set(self._pooled_bytes)

    def get(self, nbytes: int) -> _ArenaBuf:
        """Smallest pooled buffer with capacity >= nbytes, else a fresh
        page-aligned allocation (miss; resize when the request outgrew
        every capacity this arena has ever served)."""
        want = self._bucket(max(1, nbytes))
        with self._mu:
            self._sweep_locked()
            for cap in sorted(self._pool):
                if cap >= want and self._pool[cap]:
                    buf = self._pool[cap].pop()
                    self._pooled_bytes -= cap
                    self._inuse_bytes += cap
                    EC_DISPATCH_ARENA_OPS.inc(result="hit")
                    EC_DISPATCH_ARENA_INUSE.set(self._inuse_bytes)
                    EC_DISPATCH_ARENA_POOLED.set(self._pooled_bytes)
                    return buf
            grew = want > self._largest
            self._largest = max(self._largest, want)
            self._inuse_bytes += want
            EC_DISPATCH_ARENA_INUSE.set(self._inuse_bytes)
        EC_DISPATCH_ARENA_OPS.inc(result="resize" if grew else "miss")
        return _ArenaBuf(want)

    def release(self, buf: _ArenaBuf, out_ref) -> None:
        """Hand a checked-out buffer back, tied to the completion handle
        of the flush that consumed it. Recycles now when consumption is
        proven, quarantines otherwise (re-checked on later get/release)."""
        with self._mu:
            if _consumed(out_ref):
                self._pool_locked(buf)
            else:
                self._quarantine.append((buf, out_ref))
            self._sweep_locked()

    def drop(self, buf: _ArenaBuf) -> None:
        """Abandon a checked-out buffer (a flush that raised may have
        queued a copy that still reads it; recycling would risk live
        bytes)."""
        with self._mu:
            self._inuse_bytes -= buf.cap
            EC_DISPATCH_ARENA_INUSE.set(self._inuse_bytes)
        EC_DISPATCH_ARENA_OPS.inc(result="drop")

    def stats(self) -> dict:
        with self._mu:
            return {
                "pooled": sum(len(v) for v in self._pool.values()),
                "pooledBytes": self._pooled_bytes,
                "inUseBytes": self._inuse_bytes,
                "quarantined": len(self._quarantine),
            }

    def close(self) -> None:
        """Drop everything (quarantined buffers are abandoned to the GC:
        their flushes keep them alive exactly as long as needed)."""
        with self._mu:
            dropped = sum(len(v) for v in self._pool.values()) \
                + len(self._quarantine)
            self._pool.clear()
            self._quarantine.clear()
            self._pooled_bytes = 0
            self._inuse_bytes = 0
            EC_DISPATCH_ARENA_INUSE.set(0)
            EC_DISPATCH_ARENA_POOLED.set(0)
        if dropped:
            EC_DISPATCH_ARENA_OPS.inc(dropped, result="drop")


class EcFuture:
    """Result handle for a submitted slab: an encode future resolves to
    parity [m, B], a reconstruct future to (missing_ids, rows), both on
    the coder's device. `np.asarray(fut)` gives an encode result on the
    host (storage/ec_files.to_host).

    `result()` returns only after the flush's completion event (a CUDA
    coder's), so the bytes are written whatever stream the caller reads
    them on. After resolution the future carries the dispatch
    attribution: how long the slab queued in its lane, how many slabs
    shared its stacked launch, and the dispatch wall. Stamped BEFORE the
    result is set, so a woken consumer never reads half-stamped
    attribution."""

    __slots__ = ("_event", "_value", "_error", "_done", "_sched", "_key",
                 "queue_wait_s", "batch_slabs", "chip", "dispatch_wall_s")

    def __init__(self, sched: "EcDispatchScheduler", key: tuple):
        self._event = threading.Event()
        self._value = None
        self._error = None
        self._done: FlushDone | None = None
        self._sched = sched
        self._key = key
        self.queue_wait_s = None
        self.batch_slabs = None
        self.chip = None
        self.dispatch_wall_s = None

    def _set(self, value, done: FlushDone | None = None) -> None:
        self._value = value
        self._done = done
        self._event.set()

    def _set_error(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.is_set():
            if self._key[0] == "rec":
                # serving-side micro-batch: a degraded read already paid
                # a survivor fetch, so give the window a beat to coalesce
                # the other concurrent readers before forcing
                self._event.wait(self._sched.window)
            # demand flush: a STILL-blocked consumer means the window has
            # nothing left to buy; dispatch the lane NOW, on this thread,
            # batching whatever accumulated behind us. Never flush once
            # resolved: that would steal the lane's fresh arrivals
            # mid-window and fragment their batches.
            if not self._event.is_set():
                self._sched._demand_flush(self._key)
            if not self._event.wait(timeout):
                raise TimeoutError("ec dispatch result timed out")
        if self._error is not None:
            raise self._error
        if self._done is not None:
            self._done.wait()
        return self._value

    def __array__(self, dtype=None, copy=None):
        from ..storage.ec_files import to_host

        out = to_host(self.result())
        if dtype is not None and out.dtype != dtype:
            return out.astype(dtype)
        return out


class _Slab:
    __slots__ = ("data", "width", "fut", "t")

    def __init__(self, data: np.ndarray, fut: EcFuture):
        self.data = data
        self.width = data.shape[-1]
        self.fut = fut
        self.t = time.perf_counter()


_schedulers: "weakref.WeakSet[EcDispatchScheduler]" = weakref.WeakSet()
_attach_lock = locks.wlock("dispatch.attach")


def scheduler_for(coder) -> "EcDispatchScheduler":
    """The per-coder shared scheduler (every EC volume and pipeline using
    a coder shares it, which is exactly the cross-volume amortization).
    Lives on the coder object itself so its lifetime tracks the coder's."""
    sched = getattr(coder, "_ec_dispatch_sched", None)
    if sched is None or sched.closed:
        with _attach_lock:
            sched = getattr(coder, "_ec_dispatch_sched", None)
            if sched is None or sched.closed:
                sched = EcDispatchScheduler(coder)
                coder._ec_dispatch_sched = sched
    return sched


def maybe_scheduler(coder):
    """scheduler_for(coder) when the dispatch plane is enabled, else None
    (callers then make direct per-slab coder calls)."""
    return scheduler_for(coder) if enabled() else None


def shutdown_all() -> None:
    """Flush + close every live scheduler (tests; process teardown).
    Idempotent, and registered via atexit so a process that never closes
    its schedulers still drains in-flight lanes instead of abandoning
    their futures."""
    for sched in list(_schedulers):
        try:
            sched.close()
        # lint: allow-broad-except(atexit teardown must visit every
        # scheduler; one failed close must not strand the rest)
        except Exception:  # noqa: BLE001
            pass


atexit.register(shutdown_all)


def reconstruct_now(coder, present_ids, stacked,
                    data_only: bool = False, want=None):
    """Synchronous stacked reconstruct: through the shared scheduler when
    the dispatch plane is on (micro-batches with every concurrent
    caller), the coder's stacked reconstruct otherwise
    -> (missing_ids, rows).

    `want` restricts the solve to those shard ids: the minimal-read
    repair form, where the survivor set may be smaller than k (an LRC
    local group) as long as it spans the wanted rows.

    When the caller is inside a trace span (utils/trace.py), the
    scheduler's per-slab attribution (queue wait, realized batch factor,
    chip, dispatch wall) lands on that span."""
    present_ids = tuple(present_ids)
    want = tuple(want) if want is not None else None
    sched = maybe_scheduler(coder)
    if sched is not None:
        fut = sched.reconstruct_stacked(
            present_ids, stacked, data_only=data_only, want=want)
        out = fut.result()
        sp = trace.current()
        if sp is not None and fut.batch_slabs is not None:
            sp.set_attr(
                dispatchQueueWaitMs=round((fut.queue_wait_s or 0) * 1e3,
                                          3),
                dispatchBatchSlabs=fut.batch_slabs,
                dispatchChip=fut.chip,
                dispatchWallMs=round((fut.dispatch_wall_s or 0) * 1e3, 3))
        return out
    return coder.reconstruct_stacked(present_ids, stacked,
                                     data_only=data_only, want=want)


class EcDispatchScheduler:
    """Window-batched stacked dispatch over one coder.

    Lanes (every key carries the coder's GEOMETRY id: stacked launches
    concatenate slabs along the byte axis and multiply ONE matrix, so
    slabs of different code geometries never share a lane):
      ("enc", geom)                     encode slabs [k, B] (one device)
      ("enc", geom, chip)               per-chip encode lane of a
                                        multi-device coder: slabs
                                        round-robin across chips, each
                                        lane flushes as ONE product
                                        pinned to its chip
      ("rec", geom, present_ids, data_only, want)
                                        reconstruct slabs [P, B] sharing
                                        one survivor set / fused matrix
                                        (want = minimal-read targets); on
                                        a multi-device coder the lane is
                                        pinned to the chip holding that
                                        set's matrix (LRU)

    The per-chip lanes keep the slab axis spread over every device's own
    stream, so the devices fill in parallel; SWFS_EC_DISPATCH_VSHARD=0
    restores one funnel. Single-device coders are untouched either way.
    """

    def __init__(self, coder, window: float | None = None,
                 max_slabs: int = MAX_SLABS):
        self.coder = coder
        # geometry id baked into every lane key: two coders with the same
        # (k, m) but different generator matrices (rs_10_4 and
        # lrc_10_2_2) must never stack into one launch
        self.geom_id = getattr(coder, "geometry_id", None) or \
            f"rs_{coder.data_shards}_{coder.parity_shards}"
        self.window = window_s() if window is None else window
        self.max_slabs = max_slabs
        # lane state condition, witnessed: always acquired AFTER
        # _dispatch_mu on the flush path, never before it
        self._cv = locks.wcondition("dispatch.lane_cv", rank=200)
        self._lanes: "OrderedDict[tuple, list[_Slab]]" = OrderedDict()
        # per-chip lane state; `_chips` resolves on the first submit
        self._chips: list | None = None
        self._enc_rr = itertools.count()
        self._rec_chips: "OrderedDict[tuple, int]" = OrderedDict()
        self._rec_rr = 0
        self._rec_max = REC_SETS
        self._thread: threading.Thread | None = None
        # Serializes SUBMISSION into the coder (not completion: launches
        # stay asynchronous on the card, so batches still pipeline
        # device-side). In-flight dispatch time turns into batching for
        # the next elevator.
        self._dispatch_mu = locks.wlock("dispatch.mu", rank=100)
        # host memory plane: the recycled buffers multi-slab flushes
        # pack into
        self._arena = StackArena()
        self.closed = False
        _schedulers.add(self)

    # -- packing -----------------------------------------------------------

    def _pack_wide(self, slabs: "list[_Slab]"):
        """Pack slabs column-compactly into ONE [rows, sum(widths)] view
        of an arena buffer (never zero-filled). Columns are independent
        under every GF matmul this scheduler dispatches, so packing needs
        no inter-slab padding and therefore no memset at all."""
        with trace.phase("ec.dispatch.pack"):
            rows = slabs[0].data.shape[0]
            total = sum(s.width for s in slabs)
            buf = self._arena.get(rows * total)
            wide = buf.flat[: rows * total].reshape(rows, total)
            off = 0
            for s in slabs:
                wide[:, off: off + s.width] = s.data
                off += s.width
        return wide, buf

    def _pack_vstack(self, slabs: "list[_Slab]"):
        """Pack slabs into ONE [V, rows, bmax] view of an arena buffer
        (the form a multi-device coder splits whole slabs of). Only
        ragged tails (width < bmax) are zeroed; a uniform batch zeroes
        nothing."""
        with trace.phase("ec.dispatch.pack"):
            v = len(slabs)
            rows = slabs[0].data.shape[0]
            bmax = max(s.width for s in slabs)
            region = v * rows * bmax
            buf = self._arena.get(region)
            stack = buf.flat[:region].reshape(v, rows, bmax)
            for i, s in enumerate(slabs):
                stack[i, :, : s.width] = s.data
                if s.width < bmax:
                    stack[i, :, s.width:] = 0
        return stack, buf

    # -- per-chip lane plumbing --------------------------------------------

    def _chip_list(self) -> list:
        """The coder's placement devices when per-chip lanes apply, else
        []. Resolved once; the env gate is re-read every call so a run can
        flip the lanes without rebuilding schedulers."""
        if not vshard_enabled():
            return []
        chips = self._chips
        if chips is None:
            chips = []
            fn = getattr(self.coder, "placement_devices", None)
            if fn is not None and hasattr(self.coder, "encode_parity_on"):
                devs = fn()
                if len(devs) > 1:
                    chips = list(devs)
            self._chips = chips
        return chips

    def _assign_rec_chip(self, key: tuple, n_chips: int) -> int:
        """Stable survivor-set -> chip placement, LRU-evicted: every slab
        sharing this fused decode matrix runs on the chip where the
        matrix is cached (ops/rs_torch.op_on_device)."""
        with self._cv:
            got = self._rec_chips.get(key)
            if got is None:
                got = self._rec_rr % n_chips
                self._rec_rr += 1
                self._rec_chips[key] = got
                while len(self._rec_chips) > self._rec_max:
                    # evict the oldest set WITHOUT queued slabs: dropping
                    # an in-flight lane's pinning mid-window would
                    # dispatch it unpinned and desync the chip counters
                    for old in self._rec_chips:
                        if old not in self._lanes:
                            del self._rec_chips[old]
                            break
                    else:
                        break  # every set in flight; defer eviction
            else:
                self._rec_chips.move_to_end(key)
            return got

    def _lane_chip(self, key: tuple) -> int | None:
        """Chip index a lane is pinned to (None = no chip lane)."""
        if key[0] == "enc":
            return key[2] if len(key) > 2 else None
        with self._cv:
            return self._rec_chips.get(key)

    def _chip_device(self, key: tuple):
        chips = self._chip_list()
        idx = self._lane_chip(key)
        if chips and idx is not None and idx < len(chips):
            return chips[idx]
        return None

    # -- submission --------------------------------------------------------

    def encode_parity(self, data: np.ndarray, copy: bool = True) -> EcFuture:
        """Submit one [k, B] slab; the future resolves to parity [m, B].

        `copy=True` (default) snapshots the slab: the encode pipeline
        recycles its read buffers as soon as the data rows hit disk,
        which can be before the stacked dispatch reads them.

        On a multi-device coder, slabs round-robin over per-chip lanes:
        one pipeline alone fans across every chip, and N pipelines load
        the chips evenly."""
        data = np.asarray(data, dtype=np.uint8)
        if copy:
            data = data.copy()
        chips = self._chip_list()
        if chips:
            key = ("enc", self.geom_id, next(self._enc_rr) % len(chips))
        else:
            key = ("enc", self.geom_id)
        return self._submit(key, data, chip=self._lane_chip(key))

    def reconstruct_stacked(self, present_ids, stacked: np.ndarray,
                            data_only: bool = False,
                            copy: bool = False, want=None) -> EcFuture:
        """Submit survivors [P, B] (caller row order); the future resolves
        to (missing_ids, rows[len(missing), B]). Slabs sharing a survivor
        set (and minimal-read target set `want`) share one
        column-concatenated `reconstruct_stacked` launch, pinned to the
        set's chip on a multi-device coder."""
        stacked = np.asarray(stacked, dtype=np.uint8)
        if copy:
            stacked = stacked.copy()
        key = ("rec", self.geom_id, tuple(present_ids), bool(data_only),
               tuple(want) if want is not None else None)
        chips = self._chip_list()
        chip = self._assign_rec_chip(key, len(chips)) if chips else None
        return self._submit(key, stacked, chip=chip)

    def _submit(self, key: tuple, data: np.ndarray,
                chip: int | None = None) -> EcFuture:
        fut = EcFuture(self, key)
        slab = _Slab(data, fut)
        EC_DISPATCH_SLABS.inc(lane=_lane_kind(key),
                              chip=_NO_CHIP if chip is None else str(chip))
        with self._cv:
            if self.closed:
                raise RuntimeError("ec dispatch scheduler is closed")
            lane = self._lanes.get(key)
            if lane is None:
                lane = self._lanes[key] = []
            lane.append(slab)
            full = len(lane) >= self.max_slabs
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="ec-dispatch-flusher",
                    daemon=True)
                self._thread.start()
            self._cv.notify_all()
        if full:
            # cap reached: dispatch on the submitter rather than queueing
            # unboundedly behind the window
            self._demand_flush(key)
        return fut

    # -- flushing ----------------------------------------------------------

    def _run(self) -> None:
        # NUMA-affine flush path: the flusher packs arenas and feeds the
        # device driver; pinned to one node's CPUs when
        # SWFS_EC_DISPATCH_PIN=1 (utils/numa.py), a no-op otherwise
        numa.pin_thread()
        idle_since: float | None = None
        while True:
            with self._cv:
                now = time.perf_counter()
                if self.closed:
                    return
                if not self._lanes:
                    if idle_since is None:
                        idle_since = now
                    elif now - idle_since > _IDLE_EXIT_S:
                        # self-clean: nothing pending for a while
                        if self._thread is threading.current_thread():
                            self._thread = None
                        return
                    self._cv.wait(_IDLE_EXIT_S / 4)
                    continue
                idle_since = None
                deadline = min(l[0].t for l in self._lanes.values()) \
                    + self.window
                if now < deadline:
                    self._cv.wait(deadline - now)
                    continue
                due = [k for k, l in self._lanes.items()
                       if l[0].t + self.window <= now]
            # elevator batching: take the dispatch lock FIRST, re-pop after
            # acquiring it; every slab that arrived while the previous
            # dispatch was in flight rides this one instead of
            # fragmenting into its own
            for k in due:
                self._flush_lane(k)

    def _demand_flush(self, key: tuple) -> None:
        self._flush_lane(key)

    def _flush_lane(self, key: tuple) -> None:
        # the serial section every flush passes through, timed from the
        # mutex's acquisition to its release on whichever thread flushes
        with self._dispatch_mu, trace.phase("ec.dispatch.section",
                                            lane=_lane_kind(key)):
            with self._cv:
                slabs = self._lanes.pop(key, None)
            if slabs:
                self._dispatch(key, slabs)

    def flush(self) -> None:
        """Dispatch every pending lane now (tests; close)."""
        while True:
            with self._cv:
                keys = list(self._lanes)
            if not keys:
                return
            for k in keys:
                self._flush_lane(k)

    def _dispatch(self, key: tuple, slabs: list[_Slab]) -> None:
        kind = _lane_kind(key)
        chip = self._lane_chip(key)
        label = _NO_CHIP if chip is None else str(chip)
        now = time.perf_counter()
        device = self._chip_device(key)
        EC_DISPATCH_BATCHES.inc(lane=kind, chip=label,
                                reason=self._lane_reason(device))
        EC_DISPATCH_STACK_SLABS.observe(len(slabs), lane=kind)
        EC_DISPATCH_STACK_BYTES.observe(
            sum(s.data.nbytes for s in slabs), lane=kind)
        for s in slabs:
            EC_DISPATCH_WINDOW_WAIT.observe(now - s.t, lane=kind,
                                            chip=label)
            # trace attribution, readable off the future after result()
            s.fut.queue_wait_s = now - s.t
            s.fut.batch_slabs = len(slabs)
            s.fut.chip = label
        # caller holds _dispatch_mu: coder submission is single-threaded,
        # and in-flight dispatch time turns into batching for the next
        # elevator. A chip lane's launches run on that chip's stream, so
        # the chips execute concurrently all the same.
        try:
            if key[0] == "enc":
                self._dispatch_encode(slabs, device)
            else:
                self._dispatch_reconstruct(key, slabs, device)
        except BaseException as e:
            for s in slabs:
                if not s.fut.done():
                    s.fut._set_error(e)

    def _lane_reason(self, device) -> str:
        """WHY this lane dispatched where it did: the `reason` label on
        EC_DISPATCH_BATCHES. chip_affine = pinned to a placement device;
        cpu_env / cpu_explicit = host coder (pinned by
        SEAWEEDFS_TORCH_CODER vs constructed by the call site;
        models/coder.py stamps which); vshard_off = per-chip lanes gated
        off by SWFS_EC_DISPATCH_VSHARD; otherwise single_device."""
        if device is not None:
            return "chip_affine"
        reason = getattr(self.coder, "backend_reason", None)
        if reason:
            return reason
        if not vshard_enabled():
            return "vshard_off"
        return "single_device"

    def _host_encode(self, wide: np.ndarray):
        """Encode of a column-compact [k, W] view on a lane without a
        chip: a host coder's compiled XOR schedule (ops/rs_sched.py) when
        the gate is on and it is predicted cheaper than the dense matmul,
        else the coder's own product. Bytes identical either way."""
        out = rs_sched.maybe_encode(self.coder, wide)
        if out is not None:
            return out
        return self.coder.encode_parity(wide)

    @staticmethod
    def _stamp_wall(slabs: list[_Slab], t0: float) -> None:
        """Dispatch submission wall onto every future BEFORE any _set: a
        consumer wakes on _set and must find the attribution whole. (On
        a CUDA coder this is copy + launch wall, not kernel time.)"""
        wall = time.perf_counter() - t0
        for s in slabs:
            s.fut.dispatch_wall_s = wall

    def _dispatch_encode(self, slabs: list[_Slab], device=None) -> None:
        encode_on = (getattr(self.coder, "encode_parity_on", None)
                     if device is not None else None)
        t0 = time.perf_counter()
        if len(slabs) == 1:
            # lone slab: no stack copy on any lane
            s = slabs[0]
            out0 = (encode_on(s.data, device) if encode_on is not None
                    else self._host_encode(s.data))
            done = FlushDone.after(out0, self._flush_devices(device))
            self._stamp_wall(slabs, t0)
            s.fut._set(out0, done)
            return
        if getattr(self.coder, "prefers_vstack", False) and device is None:
            # multi-device coder, no chip lane: keep the [V, k, B] form so
            # the coder can split WHOLE slabs across its devices; ragged
            # tails ride zero columns, which encode to zero and are
            # sliced away
            stack, buf = self._pack_vstack(slabs)
            try:
                out = self.coder.encode_parity_stacked(stack)
            except BaseException:
                self._arena.drop(buf)
                raise
            done = FlushDone.after(out, self._flush_devices(device))
            self._stamp_wall(slabs, t0)
            for i, s in enumerate(slabs):
                s.fut._set(out[i][:, : s.width], done)
            self._arena.release(buf, done)
            return
        # wide (column-compact) packing: the V slabs lie side by side in
        # ONE [k, sum(widths)] arena view, one product, one launch; each
        # future resolves to its column slice of the one output (the
        # slice keeps the whole output alive until its last reader drops)
        wide, buf = self._pack_wide(slabs)
        try:
            out = (encode_on(wide, device) if encode_on is not None
                   else self._host_encode(wide))
        except BaseException:
            self._arena.drop(buf)
            raise
        done = FlushDone.after(out, self._flush_devices(device))
        self._stamp_wall(slabs, t0)
        off = 0
        for s in slabs:
            s.fut._set(out[:, off: off + s.width], done)
            off += s.width
        self._arena.release(buf, done)

    def _flush_devices(self, device) -> list:
        """The devices a flush's completion must cover besides its
        output's: its chip alone, or every device a multi-device coder's
        split read the input on."""
        if device is not None:
            return [device]
        fn = getattr(self.coder, "placement_devices", None)
        return fn() if fn is not None else []

    def _dispatch_reconstruct(self, key: tuple, slabs: list[_Slab],
                              device=None) -> None:
        _, _geom, present_ids, data_only, want = key
        t0 = time.perf_counter()
        chips = self._chip_list()
        vsharded = getattr(self.coder, "reconstruct_stacked_vsharded", None)
        if (vsharded is not None and chips and len(slabs) >= len(chips)
                and len({s.width for s in slabs}) == 1):
            # a BIG uniform batch (a rebuild pipeline's demand-flushed
            # backlog) outgrows its one assigned chip: split its V axis
            # over every device instead (small serving micro-batches keep
            # the survivor-set chip below). Uniform widths: the pack
            # zeroes nothing.
            vstack, buf = self._pack_vstack(slabs)
            try:
                missing, rows = vsharded(present_ids, vstack,
                                         data_only=data_only, want=want)
            except BaseException:
                self._arena.drop(buf)
                raise
            done = FlushDone.after(rows, self._flush_devices(None))
            self._stamp_wall(slabs, t0)
            for i, s in enumerate(slabs):
                s.fut._set((missing, rows[i]), done)
            self._arena.release(buf, done)
            return
        recon_on = (getattr(self.coder, "reconstruct_stacked_on", None)
                    if device is not None else None)

        def recon(stk):
            if recon_on is not None:
                # the survivor set's fused matrix is cached on this
                # lane's chip; its slabs run there
                return recon_on(present_ids, stk, data_only=data_only,
                                device=device, want=want)
            # host lane: the compiled XOR schedule of the repair matrix
            # when it beats the dense solve (ops/rs_sched.py); same
            # survivor choice, same rows
            got = rs_sched.maybe_reconstruct(
                self.coder, present_ids, stk, data_only=data_only,
                want=want)
            if got is not None:
                return got
            return self.coder.reconstruct_stacked(
                present_ids, stk, data_only=data_only, want=want)

        if len(slabs) == 1:
            out0 = recon(slabs[0].data)
            done = FlushDone.after(out0[1], self._flush_devices(device))
            self._stamp_wall(slabs, t0)
            slabs[0].fut._set(out0, done)
            return
        # column-concatenation into a recycled arena view
        wide, buf = self._pack_wide(slabs)
        try:
            missing, rows = recon(wide)
        except BaseException:
            self._arena.drop(buf)
            raise
        done = FlushDone.after(rows, self._flush_devices(device))
        self._stamp_wall(slabs, t0)
        off = 0
        for s in slabs:
            s.fut._set((missing, rows[:, off: off + s.width]), done)
            off += s.width
        self._arena.release(buf, done)

    # -- lifecycle / introspection ----------------------------------------

    def pending(self) -> int:
        with self._cv:
            return sum(len(l) for l in self._lanes.values())

    def arena_stats(self) -> dict:
        """Live arena snapshot."""
        return self._arena.stats()

    def chip_depths(self) -> dict[str, int]:
        """Queued slabs per chip lane ("-" = lanes of no chip): the
        per-chip depth surfaced in the volume server's /status."""
        with self._cv:
            out: dict[str, int] = {}
            for key, lane in self._lanes.items():
                if key[0] == "enc" and len(key) > 2:
                    c = str(key[2])
                elif key[0] == "rec":
                    idx = self._rec_chips.get(key)
                    c = _NO_CHIP if idx is None else str(idx)
                else:
                    c = _NO_CHIP
                out[c] = out.get(c, 0) + len(lane)
            return out

    def close(self) -> None:
        """Drain pending lanes, then stop + join the flusher thread.

        Idempotent: a second close neither re-drains nor re-joins, and
        never joins the calling thread itself, so a close reached from a
        future callback can't deadlock on a dead flusher."""
        with self._cv:
            already = self.closed
            self.closed = True  # rejects NEW submissions while we drain
            t = self._thread
            self._thread = None
            self._cv.notify_all()
        if not already:
            self.flush()  # resolve every already-queued future
        if t is not None and t is not threading.current_thread() \
                and t.is_alive():
            t.join(timeout=5)
        self._arena.close()


# -- reconstructed-interval cache ---------------------------------------------

DEFAULT_CACHE_BLOCK = 256 * 1024  # the reference's own EC buffer size
DEFAULT_CACHE_MB = 32


class ReconstructIntervalCache:
    """Bounded LRU of reconstructed shard blocks.

    Key: (vid, shard_id, block_index) over fixed-size blocks of the
    shard's byte space — a hot lost shard pays the k-survivor fetch +
    dispatch once per block, and every later degraded read of any needle
    in that block is served from memory. MUST be invalidated whenever a
    shard's backing files can change: mount/unmount/delete
    (server/volume.py wires those)."""

    def __init__(self, max_bytes: int | None = None,
                 block_size: int | None = None):
        if max_bytes is None:
            max_bytes = int(float(os.environ.get(
                "SWFS_EC_RECON_CACHE_MB", str(DEFAULT_CACHE_MB)))
                * 1024 * 1024)
        if block_size is None:
            block_size = int(os.environ.get("SWFS_EC_RECON_CACHE_BLOCK",
                                            str(DEFAULT_CACHE_BLOCK)))
        self.max_bytes = max_bytes
        self.block_size = max(1, block_size)
        self._entries: "OrderedDict[tuple, bytes]" = OrderedDict()
        self._bytes = 0
        # per-vid invalidation generation: a put computed from shard
        # state observed BEFORE an invalidate must not repopulate the
        # cache after it (reconstruct-vs-remount TOCTOU)
        self._gens: dict[int, int] = {}
        self._lock = locks.wlock("dispatch.recon_cache", rank=810)

    def enabled(self) -> bool:
        return self.max_bytes > 0

    def blocks_for(self, offset: int, size: int) -> range:
        """Block indices covering [offset, offset+size)."""
        if size <= 0:
            return range(0)
        return range(offset // self.block_size,
                     (offset + size - 1) // self.block_size + 1)

    def get(self, vid: int, sid: int, block: int) -> bytes | None:
        with self._lock:
            got = self._entries.get((vid, sid, block))
            if got is not None:
                self._entries.move_to_end((vid, sid, block))
        EC_RECON_CACHE_COUNTER.inc(result="hit" if got is not None
                                   else "miss")
        return got

    def generation(self, vid: int) -> int:
        """Snapshot BEFORE gathering survivors; pass to put() so a
        reconstruct that straddles an invalidate can't repopulate the
        cache with pre-invalidation shard bytes."""
        with self._lock:
            return self._gens.get(vid, 0)

    def put(self, vid: int, sid: int, block: int, data: bytes,
            gen: int | None = None) -> None:
        if not self.enabled() or len(data) > self.max_bytes:
            return
        key = (vid, sid, block)
        with self._lock:
            if gen is not None and self._gens.get(vid, 0) != gen:
                return  # invalidated while we were reconstructing
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            self._entries[key] = data
            self._bytes += len(data)
            while self._bytes > self.max_bytes and self._entries:
                _, evicted = self._entries.popitem(last=False)
                self._bytes -= len(evicted)
                EC_RECON_CACHE_COUNTER.inc(result="evict")
        EC_RECON_CACHE_COUNTER.inc(result="put")

    def invalidate(self, vid: int, sid: int | None = None) -> int:
        """Drop every block of `vid` (optionally one shard). Returns the
        number of entries dropped."""
        with self._lock:
            self._gens[vid] = self._gens.get(vid, 0) + 1
            doomed = [k for k in self._entries
                      if k[0] == vid and (sid is None or k[1] == sid)]
            for k in doomed:
                self._bytes -= len(self._entries.pop(k))
        if doomed:
            EC_RECON_CACHE_COUNTER.inc(len(doomed), result="invalidate")
        return len(doomed)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
