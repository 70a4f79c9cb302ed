"""Host activity marks and the reduction of a device trace to numbers.

The harness marks, per stream, what the stream's thread is doing (a
piecewise-constant `Timeline` on the host's `perf_counter`). A traced run
records the window with `torch.profiler` and exports a Chrome trace; its
device events (kernels, memory copies, memsets) are read here, clipped to
the window and merged. One user annotation, `CLOCK_MARK`, recorded at a
known `perf_counter` reading, ties the two clocks together.
"""

from __future__ import annotations

import bisect
import collections
import json
import threading
import time
from dataclasses import dataclass, field

CLOCK_MARK = "ecbench.clock"
KERNEL, MEMCPY, MEMSET = "kernel", "memcpy", "memset"
_CATEGORY = {"kernel": KERNEL, "gpu_memcpy": MEMCPY, "gpu_memset": MEMSET}


@dataclass(frozen=True)
class DeviceEvent:
    name: str
    kind: str  # KERNEL, MEMCPY or MEMSET
    start: float  # microseconds, profiler clock
    end: float


def device_kind(event: dict) -> str | None:
    """The kind of one Chrome-trace event, or None for a host event."""
    kind = _CATEGORY.get(event.get("cat", ""))
    if kind is not None:
        return kind
    name = event.get("name", "")
    if event.get("cat", "").startswith("gpu") or name.startswith("Memcpy"):
        return MEMCPY if name.startswith("Memcpy") else (
            MEMSET if name.startswith("Memset") else None)
    return None


def read_chrome_trace(path: str) -> tuple[list[DeviceEvent], float | None]:
    """(device events, start of the clock mark in us) of a Chrome trace
    written by torch.profiler."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    out = []
    mark = None
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("name") == CLOCK_MARK and mark is None:
            mark = float(e["ts"])
            continue
        kind = device_kind(e)
        if kind is not None:
            ts = float(e["ts"])
            out.append(DeviceEvent(e["name"], kind, ts, ts + float(e["dur"])))
    return out, mark


def merge(intervals) -> list[tuple[float, float]]:
    """Union of [start, end) intervals, as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(events, lo: float, hi: float) -> list[DeviceEvent]:
    return [DeviceEvent(e.name, e.kind, max(e.start, lo), min(e.end, hi))
            for e in events if e.end > lo and e.start < hi]


def covered(intervals) -> float:
    return sum(e - s for s, e in merge(intervals))


def gaps(merged, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi) that no merged interval covers."""
    out = []
    at = lo
    for s, e in merged:
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


class Timeline:
    """What each stream's thread is doing, as marks (time, activity)."""

    def __init__(self):
        self._marks: dict[str, list[tuple[float, str]]] = \
            collections.defaultdict(list)
        self._lock = threading.Lock()

    def mark(self, stream: str, activity: str) -> None:
        t = time.perf_counter()
        with self._lock:
            self._marks[stream].append((t, activity))

    def activity_at(self, t: float) -> dict[str, str]:
        """stream -> its activity at host time t (streams not yet marked
        are left out)."""
        out = {}
        with self._lock:
            items = [(s, list(m)) for s, m in self._marks.items()]
        for stream, marks in items:
            i = bisect.bisect_right([m[0] for m in marks], t) - 1
            if i >= 0:
                out[stream] = marks[i][1]
        return out

    def label_at(self, t: float) -> str:
        """"activity xN, ..." over the streams at host time t, the most
        common first."""
        counts = collections.Counter(self.activity_at(t).values())
        if not counts:
            return "no stream"
        return ", ".join(f"{a} x{n}" for a, n in
                         sorted(counts.items(), key=lambda x: (-x[1], x[0])))


@dataclass
class TraceSummary:
    """Device events of the traced window, on the host clock's scale."""

    window_s: float
    events: list[DeviceEvent]  # clipped to the window, us
    lo: float  # window bounds, us on the profiler clock
    hi: float
    to_host: float = 0.0  # add to a profiler time (us) / 1e6 for perf_counter
    gap_labels: list[tuple[str, float]] = field(default_factory=list)

    def busy_s(self, kinds=(KERNEL, MEMCPY, MEMSET)) -> float:
        return covered((e.start, e.end) for e in self.events
                       if e.kind in kinds) / 1e6

    def summed_s(self, kind: str) -> float:
        return sum(e.end - e.start for e in self.events if e.kind == kind) / 1e6

    def top_ops(self, n: int = 10) -> list[list]:
        by = collections.Counter()
        for e in self.events:
            by[e.name] += (e.end - e.start) / 1e6
        return [[name, s] for name, s in by.most_common(n)]

    def idle_gaps(self, timeline: Timeline | None, n: int = 10) -> list[list]:
        """The n longest stretches in which no device operation ran, each
        named by what the streams were doing at its middle."""
        merged = merge((e.start, e.end) for e in self.events)
        longest = sorted(gaps(merged, self.lo, self.hi),
                         key=lambda g: g[0] - g[1])[:n]
        out = []
        for s, e in longest:
            mid = (s + e) / 2 / 1e6 + self.to_host
            label = timeline.label_at(mid) if timeline else "idle"
            out.append([label, (e - s) / 1e6])
        return out


def summarize(events, mark_us: float, mark_host: float, t0: float,
              t1: float) -> TraceSummary:
    """Clip `events` to the host window [t0, t1], the profiler's clock
    tied to the host's by the mark (`mark_us` on the profiler clock was
    `mark_host` on perf_counter)."""
    lo = mark_us + (t0 - mark_host) * 1e6
    hi = mark_us + (t1 - mark_host) * 1e6
    return TraceSummary(window_s=t1 - t0, events=clip(events, lo, hi),
                        lo=lo, hi=hi, to_host=mark_host - mark_us / 1e6)
