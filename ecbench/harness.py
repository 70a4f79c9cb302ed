"""One run of one cell: set-up, the measured window, the check, the line.

Each volume of the cell is one closed-loop stream: its next round starts
when the last one ends, and no stream starts a new one once the window
has closed. What a round is comes from the op that the cell's traffic
file names (`"op": "encode"` is ecbench/ops/encode.py): it makes the
volumes, drives the port's shard pipeline once for one stream, and checks
the recorded rounds against the plain reference after the window. Rates
count the bytes of the slabs that completed inside the window, which the
op reports through the pipeline's own per-slab hooks.
"""

from __future__ import annotations

import gc
import json
import os
import queue
import shutil
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import device as card
from . import volumes
from . import trace as tr
from .registry import Cell, Registry

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "seaweedfs_tpu")
SETTINGS_PREFIXES = ("SEAWEEDFS_TORCH_", "SWFS_")
FOLD_BYTES = 1024  # width of a row digest


class RunError(RuntimeError):
    """The run cannot give a result."""


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES,
    compared whole (`seaweedfs_tpu_torch` is not `seaweedfs_tpu`)."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN_MODULES)


def program_settings(environ=None) -> list[str]:
    env = os.environ if environ is None else environ
    return sorted(k for k in env if k.startswith(SETTINGS_PREFIXES))


def fold(row: np.ndarray, nbytes: int) -> np.ndarray:
    """XOR of the row's FOLD_BYTES-wide blocks ([FOLD_BYTES / 8] uint64,
    the tail zero-padded): any change confined to FOLD_BYTES bytes, and
    any wrong coefficient, changes it."""
    v = np.asarray(row[:nbytes], np.uint8)
    full = nbytes - nbytes % FOLD_BYTES
    acc = np.zeros(FOLD_BYTES // 8, np.uint64)
    if full:
        acc ^= np.bitwise_xor.reduce(
            np.ascontiguousarray(v[:full]).view(np.uint64)
            .reshape(-1, FOLD_BYTES // 8), axis=0)
    if full < nbytes:
        tail = np.zeros(FOLD_BYTES, np.uint8)
        tail[:nbytes - full] = v[full:]
        acc ^= tail.view(np.uint64)
    return acc


# -- the window ---------------------------------------------------------------


class Window:
    """The measured window and the slabs completed in and around it."""

    def __init__(self):
        self.t0: float | None = None
        self.t1: float | None = None
        self.closed = threading.Event()
        self._slabs: list[tuple[float, int, int]] = []
        self._lock = threading.Lock()

    def open(self) -> float:
        self.t0 = time.perf_counter()
        return self.t0

    def close(self) -> float:
        self.t1 = time.perf_counter()
        self.closed.set()
        return self.t1

    def done(self, nbytes: int, kernel_bytes: int) -> None:
        """A slab completed: `nbytes` toward the rate, `kernel_bytes` the
        least bytes its product reads and writes on the device."""
        t = time.perf_counter()
        with self._lock:
            self._slabs.append((t, nbytes, kernel_bytes))

    def per_second(self) -> list[float]:
        """GB completed in each whole second of the window."""
        out = [0.0] * int(self.t1 - self.t0)
        with self._lock:
            for t, n, _ in self._slabs:
                i = int(t - self.t0)
                if 0 <= t - self.t0 and i < len(out):
                    out[i] += n / 1e9
        return out

    def first(self) -> float | None:
        """When the first slab completed."""
        with self._lock:
            return self._slabs[0][0] if self._slabs else None

    def inside(self) -> list[tuple[float, int, int]]:
        with self._lock:
            return [s for s in self._slabs if self.t0 <= s[0] <= self.t1]


class Verifier:
    """One thread that runs, in order, the check's work handed to it, so
    that the streams' own threads do no more than hand it over."""

    def __init__(self, errors: list):
        self._errors = errors
        self._queue: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._loop,
                                        name="ecbench-verifier", daemon=True)
        self.busy_s = 0.0

    def start(self) -> None:
        self._thread.start()

    def submit(self, fn, *args) -> None:
        self._queue.put((fn, args))

    def _loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            t = time.perf_counter()
            try:
                item[0](*item[1])
            except BaseException as e:  # surfaced by the main thread
                self._errors.append(e)
            self.busy_s += time.perf_counter() - t

    def stop(self) -> None:
        """Run what is queued, then end."""
        if self._thread.is_alive():
            self._queue.put(None)
            self._thread.join()


# -- one run ------------------------------------------------------------------


def default_coder(geo, dev):
    """The program's own coder for the geometry (new_coder's default)."""
    from seaweedfs_tpu_torch.models.coder import new_coder

    return new_coder(geo.data_shards, geo.parity_shards,
                     geometry=geo.code or None)


def counter_snapshot() -> dict[str, dict]:
    """Every counter of the program: name -> {labels: value}."""
    from seaweedfs_tpu_torch.utils import stats

    out = {}
    for metric in list(stats._REGISTRY):
        if isinstance(metric, stats.Gauge) or not isinstance(
                metric, stats.Counter):
            continue
        if hasattr(metric, "_snap"):
            out[metric.name] = dict(metric._snap())
        else:
            with metric._lock:
                out[metric.name] = dict(metric._values)
    return out


@dataclass
class Readings:
    """What a metric's reader reads (registry.py)."""

    op: str  # the cell's op ("encode")
    seconds: float  # the window, host clock
    bytes: int  # .dat bytes of the slabs completed inside it
    setup_s: float
    round_stats: list  # the program's stats of the rounds begun in it
    counters_before: dict
    counters_after: dict
    trace: tr.TraceSummary | None
    kernel_bytes: int  # least device bytes of the slabs inside the window
    memory_rate: float | None  # the card's peak, bytes/s

    def counter(self, name: str, **labels) -> float:
        """Change over the window of the program counter `name`, summed
        over the entries whose labels include `labels`."""
        want = set(labels.items())

        def total(snap):
            return sum(v for k, v in snap.get(name, {}).items()
                       if want <= set(k))

        return total(self.counters_after) - total(self.counters_before)


class Run:
    """What every op shares: the geometry, the coder, the volumes, the
    closed-loop streams, the window and the verifier. The op (a module
    ecbench/ops/<op>.py, named by the traffic file) makes the volumes,
    drives one round of one stream, and checks the rounds."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 workdir: Path, dev: torch.device, coder_factory,
                 registry: Registry):
        from seaweedfs_tpu_torch.storage.ec_locate import Geometry

        conf, traffic = cell.config, cell.traffic
        self.cell, self.seed, self.seconds, self.trace = (cell, seed, seconds,
                                                          trace)
        self.work = workdir
        self.dev = dev
        self.k, self.m = int(conf["data_shards"]), int(conf["parity_shards"])
        self.large = int(conf["large_block_bytes"])
        self.small = int(conf["small_block_bytes"])
        self.geo = Geometry(self.k, self.m, self.large, self.small,
                            conf.get("code", ""))
        self.reference = registry.module(conf.get("reference",
                                                  "ecbench/reference.py"))
        self.n_volumes = int(traffic["volumes"])
        self.dat_bytes = int(traffic["volume_mb"]) << 20
        self.coder_factory = coder_factory
        self.window = Window()
        self.timeline = tr.Timeline()
        self.rounds: list = []
        self._rounds_lock = threading.Lock()
        self._errors: list[BaseException] = []
        self.verifier = Verifier(self._errors)
        self._loops: list[threading.Thread] = []
        self.layout = volumes.rows(self.k, self.large, self.small,
                                   self.dat_bytes)
        self.bases = [str(workdir / f"bench_{v + 1}")
                      for v in range(self.n_volumes)]
        # bytes written to files (not the null device), before the window
        # opened and after
        self.file_bytes = {"set-up": 0, "window": 0}
        self.op = registry.op(traffic["op"]).Traffic(self)

    # -- helpers for the op ----------------------------------------------------

    def wrote(self, *paths: str) -> None:
        n = sum(os.path.getsize(p) for p in paths)
        with self._rounds_lock:
            self.file_bytes["window" if self.window.t0 else "set-up"] += n

    def record(self, rnd) -> None:
        with self._rounds_lock:
            self.rounds.append(rnd)

    def rounds_of(self, v: int) -> int:
        """Rounds of stream v recorded so far."""
        with self._rounds_lock:
            return sum(r.volume == v for r in self.rounds)

    def volume_seed(self, v: int) -> int:
        return volumes.seed_of(self.seed, 0, v)

    def dat_bytes_in(self, shard_off: int, nbytes: int) -> int:
        return volumes.dat_bytes_in(self.k, self.large, self.small,
                                    self.dat_bytes, shard_off, nbytes)

    def kept_rounds(self, v: int) -> set[int]:
        """Rounds of stream v whose output is kept whole for the byte-for-
        byte check: the first and one of the next four, drawn from the
        seed."""
        rng = np.random.default_rng(volumes.seed_of(self.seed, 3, v))
        return {0, int(rng.integers(1, 5))}

    # -- set-up ----------------------------------------------------------------

    def set_up(self) -> None:
        self.op.set_up()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.coder = self.coder_factory(self.geo, self.dev)

    # -- streams ---------------------------------------------------------------

    def _stream(self, v: int) -> None:
        try:
            while not self.window.closed.is_set():
                self.op.round(v, record=True)
        except BaseException as e:  # surfaced by the main thread
            self._errors.append(e)
            self.window.closed.set()

    def warm_up(self) -> None:
        """One round of every stream at once, which builds or loads the
        kernels and meets the window's shapes; then the closed loops
        start, staggered over that round's wall, and run for one more
        round before the window opens, so that the window finds the
        streams spread over their rounds as a long job finds them, not
        starting together. The round's wall is taken from its first
        completed slab on, so that a build of the kernels (a checkout's
        first run) does not stretch what follows."""
        threads = [threading.Thread(target=self._guard, args=(v,))
                   for v in range(self.n_volumes)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        self._raise()
        lead = time.perf_counter() - self.window.first()
        self.verifier.start()
        self._loops = [threading.Thread(target=self._stream, args=(v,),
                                        name=f"ecbench-stream-{v + 1}")
                       for v in range(self.n_volumes)]
        for v, th in enumerate(self._loops):
            if v:
                time.sleep(lead / self.n_volumes)
            th.start()
        self.window.closed.wait(lead)
        self._raise()

    def stop(self) -> None:
        """Let every stream finish its round, then the verifier its queue."""
        self.window.closed.set()
        for th in self._loops:
            th.join()
        self.verifier.stop()

    def _guard(self, v: int) -> None:
        try:
            self.op.round(v, record=False)
        except BaseException as e:
            self._errors.append(e)

    def _raise(self) -> None:
        if self._errors:
            raise RunError(f"a stream failed: {self._errors[0]!r}") \
                from self._errors[0]

    def measure(self) -> tuple[dict, dict, tr.TraceSummary | None]:
        """The window: -> (counters at its open, at its close, trace).

        Every run on a card records the window with the profiler, traced
        or not: the cells' end-to-end rate is taken over the card's busy
        time, which only the device trace holds."""
        prof = None
        mark_host = None
        if self.trace or self.dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile, \
                record_function

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
            with record_function(tr.CLOCK_MARK):
                mark_host = time.perf_counter()
        before = counter_snapshot()
        self.cpu_before = cpu_times()
        t0 = self.window.open()
        self.window.closed.wait(self.seconds)
        t1 = self.window.close()
        self.cpu_after = cpu_times()
        after = counter_snapshot()
        summary = None
        if prof is not None:
            prof.stop()
        self.stop()
        self._raise()
        if prof is not None:
            path = self.work / "trace.json"
            prof.export_chrome_trace(str(path))
            events, mark_us = tr.read_chrome_trace(str(path))
            path.unlink()
            if mark_us is None:
                raise RunError("the trace holds no clock mark")
            summary = tr.summarize(events, mark_us, mark_host, t0, t1)
        return before, after, summary


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        registry: Registry | None = None, coder_factory=default_coder,
        dev: str = "cuda", require_card: bool = True,
        t_start: float | None = None) -> dict:
    """One run of a cell; -> the result (the last line's object, with the
    compared numbers under "checks", and `stderr_lines` to print)."""
    t_start = time.perf_counter() if t_start is None else t_start
    reg = registry or Registry()
    cell = reg.cell(cell_name)
    if require_card:
        card.require(cell.chips)
    found = program_settings()
    if found:
        raise RunError(f"the benchmark measures the program's own settings; "
                       f"unset {', '.join(found)}")
    work = reg.workdir(cell.name)
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    r = Run(cell, seed, seconds, trace, work, torch.device(dev),
            coder_factory, reg)
    try:
        r.set_up()
        r.warm_up()
        before, after, summary = r.measure()
        setup_s = r.window.t0 - t_start
        inside = r.window.inside()
        if not inside:
            raise RunError("no slab completed inside the window")
        info = device_info(r, summary)
        round_stats = [x.stats for x in r.rounds
                       if x.stats is not None and x.started >= r.window.t0]
        # the program's state goes before the reference runs
        from seaweedfs_tpu_torch.ops import dispatch

        del r.coder
        dispatch.shutdown_all()
        gc.collect()
        if r.dev.type == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks, attempted, failed = r.op.check()
        t_check = time.perf_counter() - t_check
        readings = Readings(
            op=r.op.name, seconds=r.window.t1 - r.window.t0,
            bytes=sum(s[1] for s in inside), setup_s=setup_s,
            round_stats=round_stats, counters_before=before,
            counters_after=after, trace=summary,
            kernel_bytes=sum(s[2] for s in inside),
            memory_rate=card.memory_rate(info["kind"]))
        metrics = {}
        for m in reg.metrics_for(cell.name, trace):
            value = reg.reader(m["name"])(readings,
                                          m["name"].partition(".")[2])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result = {
            "correct": all(v <= 0 for v in checks.values()),
            "attempted": attempted,
            "failed": failed,
            "metrics": metrics,
            "device": info,
        }
        if summary is not None and trace:
            result["breakdown"] = {
                "device_ops": summary.top_ops(),
                "idle_gaps": summary.idle_gaps(r.timeline)}
        result["checks"] = {k: {"value": v, "limit": 0}
                            for k, v in checks.items()}
        lines = [f"window {readings.seconds} s, {len(inside)} slabs inside, "
                 f"{len(r.rounds)} rounds, set-up {setup_s} s, the check "
                 f"{t_check} s",
                 f"bytes written to files: set-up {r.file_bytes['set-up']}, "
                 f"window and after {r.file_bytes['window']}",
                 f"encode rate over the window, host clock: "
                 f"{readings.bytes / readings.seconds / 1e9} GB/s",
                 cpu_line(r.cpu_before, r.cpu_after),
                 *r.op.lines(r.window.t0),
                 f"the verifier thread's time, set-up to the window's end: "
                 f"{r.verifier.busy_s} s",
                 "GB completed in each second of the window: " + " ".join(
                     f"{x:.3f}" for x in r.window.per_second()),
                 io_line()]
        lines += [f"check {k}: {v} (limit 0)" for k, v in checks.items()]
        result["stderr_lines"] = lines
        return result
    finally:
        r.stop()
        shutil.rmtree(work, ignore_errors=True)


def device_info(r: Run, summary) -> dict:
    if r.dev.type == "cuda":
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(r.dev),
                "count": r.cell.chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    r.dev)),
                "power_limit": card.power_limit()}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if summary is not None:
        info["busy_s"] = summary.busy_s()
        info["window_s"] = summary.window_s
    return info


def cpu_times() -> tuple[float, float]:
    """This process's (user, system) CPU seconds so far."""
    t = os.times()
    return t.user, t.system


def cpu_line(before, after) -> str:
    return (f"this process over the window: user {after[0] - before[0]:.2f} "
            f"s, system {after[1] - before[1]:.2f} s of CPU")


def io_line() -> str:
    """This process's bytes written to storage, from /proc/self/io."""
    try:
        with open("/proc/self/io") as f:
            fields = dict(line.split(":") for line in f if ":" in line)
    except OSError:
        return "write_bytes unknown"
    return (f"/proc/self/io: wchar {int(fields['wchar'])} write_bytes "
            f"{int(fields['write_bytes'])} cancelled_write_bytes "
            f"{int(fields['cancelled_write_bytes'])}")


def emit(result: dict, out=None, err=None) -> None:
    """The stderr lines, the compared numbers last, then the result line
    as the last line of stdout."""
    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    lines = result.pop("stderr_lines", [])
    for line in lines:
        print(line, file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
