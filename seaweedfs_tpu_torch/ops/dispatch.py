"""EC dispatch scheduler: share device launches across the EC plane.

Counterpart of seaweedfs_tpu/ops/dispatch.py on one device. The encode
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

Not carried over yet: the per-chip lanes of a multi-device coder (the
reference's `_chip_list`, `encode_parity_stacked_on`/`encode_parity_on`
and `reconstruct_stacked_vsharded` branches), which wait for the
multi-GPU coder; the compiled XOR-schedule hooks for host coders
(`rs_sched.maybe_encode` / `maybe_reconstruct`), which wait for
ops/rs_sched.py; the `[V, k, B]` stack for a coder that prefers it
(`_pack_vstack`) and the per-slab paths for a coder without stacked
products, since every port coder takes column-packed slabs; and
`ReconstructIntervalCache`, which waits for the volume server that reads
through it. Every lane here is single-device; none of these would change
the bytes.
"""

from __future__ import annotations

import atexit
import os
import threading
import time
import weakref
from collections import OrderedDict

import numpy as np
import torch

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
    EC_DISPATCH_ZEROFILL_ELIDED,
)

DEFAULT_WINDOW_MS = 2.0
# a lane that reaches this many slabs flushes on the submitter
MAX_SLABS = 32
# flusher thread exits after this long with no pending work (a fresh
# submit restarts it): idle schedulers self-clean instead of leaking a
# thread per coder across tests
_IDLE_EXIT_S = 1.0
# lanes of a single-device coder carry this chip label
_NO_CHIP = "-"


def enabled() -> bool:
    """SWFS_EC_DISPATCH gates the whole plane (default on)."""
    return os.environ.get("SWFS_EC_DISPATCH", "1").lower() not in (
        "0", "false", "off")


def window_s() -> float:
    return float(os.environ.get("SWFS_EC_DISPATCH_WINDOW_MS",
                                str(DEFAULT_WINDOW_MS))) / 1000.0


# -- flush completion ----------------------------------------------------------


class FlushDone:
    """Completion handle of one flush: a CUDA event recorded on the
    launching thread's current stream right after the flush's last
    kernel (None for a host coder, whose results exist on return).

    `is_ready()` is the arena's proof that the flush consumed its input
    buffer: once the event completed, every copy and kernel queued
    before it on that stream has run. `wait()` is the consumer's side:
    it blocks the host until then, so a result is read after it was
    written whatever stream the reading thread uses."""

    __slots__ = ("event",)

    def __init__(self, event: "torch.cuda.Event | None"):
        self.event = event

    @classmethod
    def after(cls, out) -> "FlushDone":
        """Record the event after the work that produced `out`."""
        if not isinstance(out, torch.Tensor) or out.device.type != "cuda":
            return cls(None)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(out.device))
        return cls(event)

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


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
    """Window-batched stacked dispatch over one single-device coder.

    Lanes (every key carries the coder's GEOMETRY id: stacked launches
    concatenate slabs along the byte axis and multiply ONE matrix, so
    slabs of different code geometries never share a lane):
      ("enc", geom)                     encode slabs [k, B]
      ("rec", geom, present_ids, data_only, want)
                                        reconstruct slabs [P, B] sharing
                                        one survivor set / fused matrix
                                        (want = minimal-read targets)

    On a multi-device coder the reference splits the encode lane per
    chip and pins each survivor set's lane to one chip; those lanes wait
    for the port's multi-GPU coder, so every lane here runs on the
    coder's one device (chip label "-").
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
        rows = slabs[0].data.shape[0]
        total = sum(s.width for s in slabs)
        buf = self._arena.get(rows * total)
        wide = buf.flat[: rows * total].reshape(rows, total)
        off = 0
        for s in slabs:
            wide[:, off: off + s.width] = s.data
            off += s.width
        EC_DISPATCH_ZEROFILL_ELIDED.inc(rows * total)
        return wide, buf

    # -- submission --------------------------------------------------------

    def encode_parity(self, data: np.ndarray, copy: bool = True) -> EcFuture:
        """Submit one [k, B] slab; the future resolves to parity [m, B].

        `copy=True` (default) snapshots the slab: the encode pipeline
        recycles its read buffers as soon as the data rows hit disk,
        which can be before the stacked dispatch reads them."""
        data = np.asarray(data, dtype=np.uint8)
        if copy:
            data = data.copy()
        # per-chip encode lanes ("enc", geom, chip) wait for the
        # multi-GPU coder
        return self._submit(("enc", self.geom_id), data)

    def reconstruct_stacked(self, present_ids, stacked: np.ndarray,
                            data_only: bool = False,
                            copy: bool = False, want=None) -> EcFuture:
        """Submit survivors [P, B] (caller row order); the future resolves
        to (missing_ids, rows[len(missing), B]). Slabs sharing a survivor
        set (and minimal-read target set `want`) share one
        column-concatenated `reconstruct_stacked` launch."""
        stacked = np.asarray(stacked, dtype=np.uint8)
        if copy:
            stacked = stacked.copy()
        key = ("rec", self.geom_id, tuple(present_ids), bool(data_only),
               tuple(want) if want is not None else None)
        return self._submit(key, stacked)

    def _submit(self, key: tuple, data: np.ndarray) -> EcFuture:
        fut = EcFuture(self, key)
        slab = _Slab(data, fut)
        kind = "encode" if key[0] == "enc" else "reconstruct"
        EC_DISPATCH_SLABS.inc(lane=kind, chip=_NO_CHIP)
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
        with self._dispatch_mu:
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
        kind = "encode" if key[0] == "enc" else "reconstruct"
        now = time.perf_counter()
        EC_DISPATCH_BATCHES.inc(lane=kind, chip=_NO_CHIP,
                                reason=self._lane_reason())
        EC_DISPATCH_STACK_SLABS.observe(len(slabs), lane=kind)
        EC_DISPATCH_STACK_BYTES.observe(
            sum(s.data.nbytes for s in slabs), lane=kind)
        for s in slabs:
            EC_DISPATCH_WINDOW_WAIT.observe(now - s.t, lane=kind,
                                            chip=_NO_CHIP)
            # trace attribution, readable off the future after result()
            s.fut.queue_wait_s = now - s.t
            s.fut.batch_slabs = len(slabs)
            s.fut.chip = _NO_CHIP
        # caller holds _dispatch_mu: coder submission is single-threaded,
        # and in-flight dispatch time turns into batching for the next
        # elevator
        try:
            if key[0] == "enc":
                self._dispatch_encode(slabs)
            else:
                self._dispatch_reconstruct(key, slabs)
        except BaseException as e:
            for s in slabs:
                if not s.fut.done():
                    s.fut._set_error(e)

    def _lane_reason(self) -> str:
        """WHY this lane dispatched where it did: the `reason` label on
        EC_DISPATCH_BATCHES. cpu_env / cpu_explicit = host coder (pinned
        by SEAWEEDFS_TORCH_CODER vs constructed by the call site;
        models/coder.py stamps which); otherwise single_device."""
        return getattr(self.coder, "backend_reason", None) \
            or "single_device"

    @staticmethod
    def _stamp_wall(slabs: list[_Slab], t0: float) -> None:
        """Dispatch submission wall onto every future BEFORE any _set: a
        consumer wakes on _set and must find the attribution whole. (On
        a CUDA coder this is copy + launch wall, not kernel time.)"""
        wall = time.perf_counter() - t0
        for s in slabs:
            s.fut.dispatch_wall_s = wall

    def _dispatch_encode(self, slabs: list[_Slab]) -> None:
        # a host coder's compiled XOR schedule (rs_sched.maybe_encode)
        # would take the product here first; it waits for ops/rs_sched.py
        t0 = time.perf_counter()
        if len(slabs) == 1:
            # lone slab: no stack copy
            s = slabs[0]
            out0 = self.coder.encode_parity(s.data)
            done = FlushDone.after(out0)
            self._stamp_wall(slabs, t0)
            s.fut._set(out0, done)
            return
        # wide (column-compact) packing: the V slabs lie side by side in
        # ONE [k, sum(widths)] arena view, one product, one launch; each
        # future resolves to its column slice of the one output (the
        # slice keeps the whole output alive until its last reader drops)
        wide, buf = self._pack_wide(slabs)
        try:
            out = self.coder.encode_parity(wide)
        except BaseException:
            self._arena.drop(buf)
            raise
        done = FlushDone.after(out)
        self._stamp_wall(slabs, t0)
        off = 0
        for s in slabs:
            s.fut._set(out[:, off: off + s.width], done)
            off += s.width
        self._arena.release(buf, done)

    def _dispatch_reconstruct(self, key: tuple, slabs: list[_Slab]) -> None:
        _, _geom, present_ids, data_only, want = key
        t0 = time.perf_counter()
        # a big uniform batch would shard its V axis over every chip
        # (reconstruct_stacked_vsharded), and a host coder's compiled XOR
        # schedule (rs_sched.maybe_reconstruct) would take the product
        # first; both wait (multi-GPU coder, ops/rs_sched.py)

        def recon(stk):
            return self.coder.reconstruct_stacked(
                present_ids, stk, data_only=data_only, want=want)

        if len(slabs) == 1:
            out0 = recon(slabs[0].data)
            done = FlushDone.after(out0[1])
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
        done = FlushDone.after(rows)
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

