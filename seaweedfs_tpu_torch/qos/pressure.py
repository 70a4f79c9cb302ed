"""Backpressure scoring: one number per volume server.

Two queues already measured per-request by the tracing plane are
the earliest honest overload signals a volume server has:

  * **group-commit buffer depth** — writes registered for flush but not
    yet covered by one (`Volume._gc_seq - Volume._gc_flushed`, summed
    over volumes). A deep buffer means the leader flush is falling
    behind the ingest rate (the `gcWaitMs` span attribute, aggregated).
  * **EC dispatch queue depth** — slabs queued in the scheduler's
    per-chip lanes (`EcDispatchScheduler.chip_depths()`, summed). Deep
    lanes mean device dispatches are the bottleneck (the
    `dispatchQueueWaitMs` span attribute, aggregated).

`pressure_score` folds them into [0, 1]: 0 = idle, ->1 = both queues at
their caps. The fold is `1 - (1-a)(1-b)` over the clamped per-queue
loads — STRICTLY MONOTONE in each input (pinned by tests/test_qos.py),
so the master can compare servers and a rising queue can never lower a
score. Caps are knobs: `SWFS_QOS_GC_CAP` pending writes (default 256)
and `SWFS_QOS_DISPATCH_CAP` queued slabs (default 64).

The score rides every `QosGrant` lease refresh to the master, which
folds it into `assign` placement (prefer calm replicas) and — above
`SWFS_QOS_SHED_PRESSURE` — sheds assigns outright, so admission fails
fast instead of the data plane timing out late.
"""

from __future__ import annotations

import os
import threading
import time

DEFAULT_GC_CAP = 256
DEFAULT_DISPATCH_CAP = 64


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def pressure_score(gc_depth: float, dispatch_depth: float, *,
                   gc_cap: float | None = None,
                   dispatch_cap: float | None = None) -> float:
    """[0, 1] overload score, monotone in both queue depths."""
    if gc_cap is None:
        gc_cap = _env_int("SWFS_QOS_GC_CAP", DEFAULT_GC_CAP)
    if dispatch_cap is None:
        dispatch_cap = _env_int("SWFS_QOS_DISPATCH_CAP",
                                DEFAULT_DISPATCH_CAP)
    a = min(max(gc_depth, 0.0) / max(gc_cap, 1.0), 1.0)
    b = min(max(dispatch_depth, 0.0) / max(dispatch_cap, 1.0), 1.0)
    return round(1.0 - (1.0 - a) * (1.0 - b), 4)


# -- process-local "the cluster is hot" signal -------------------

DEFAULT_HOT_HOLD_S = 3.0


def _shed_threshold() -> float:
    """The same knob the master sheds assigns on; unset = never hot by
    score alone (matching the plane's observe-only default)."""
    try:
        v = float(os.environ.get("SWFS_QOS_SHED_PRESSURE", "") or 0.0)
    except ValueError:
        v = 0.0
    return v if v > 0 else 2.0  # scores are [0,1]: 2.0 = unreachable


class PressureSignal:
    """Recency-tracked overload signal consumed by the pipelined chunk
    engine (filer/chunk_pipeline.py): when the process has RECENTLY
    observed shedding (a tenant admission rejection, a 429/503 from a
    volume server) or strain (a chunk read forced onto the failover
    ladder), or the last reported pressure score crossed the shed
    threshold, readahead/overlap windows collapse to 1 — prefetch
    fan-out must not multiply load on a cluster that is already
    shedding. The signal decays on its own: `SWFS_QOS_HOT_HOLD_S`
    (default 3s) after the last report, windows re-open.

    Injectable clock for tests (the admission TokenBucket pattern)."""

    def __init__(self, now=time.monotonic):
        self._now = now
        self._lock = threading.Lock()
        self._hot_until = 0.0
        self._score = 0.0
        self.sheds = 0
        self.strains = 0

    def _hold(self) -> float:
        try:
            return float(os.environ.get("SWFS_QOS_HOT_HOLD_S",
                                        str(DEFAULT_HOT_HOLD_S)))
        except ValueError:
            return DEFAULT_HOT_HOLD_S

    def report_shed(self) -> None:
        """A request was rejected/throttled (429/503, admission)."""
        with self._lock:
            self.sheds += 1
            self._hot_until = max(self._hot_until,
                                  self._now() + self._hold())

    def report_strain(self) -> None:
        """The data plane needed its failover machinery (e.g. every
        cached replica of a chunk failed) — not a shed, but fan-out on
        top of a struggling cluster only deepens the hole."""
        with self._lock:
            self.strains += 1
            self._hot_until = max(self._hot_until,
                                  self._now() + self._hold())

    def report_score(self, score: float) -> None:
        """Latest local pressure score (volume servers feed their own)."""
        with self._lock:
            self._score = float(score)

    def is_hot(self) -> bool:
        with self._lock:
            return self._now() < self._hot_until \
                or self._score >= _shed_threshold()

    def reset(self) -> None:
        with self._lock:
            self._hot_until = 0.0
            self._score = 0.0
            self.sheds = 0
            self.strains = 0

    def status(self) -> dict:
        with self._lock:
            return {
                "hot": self._now() < self._hot_until
                or self._score >= _shed_threshold(),
                "sheds": self.sheds,
                "strains": self.strains,
                "score": self._score,
                "holdSeconds": self._hold(),
            }


#: Process-wide signal: admission planes and data-plane clients report,
#: the chunk pipeline consults.
SIGNAL = PressureSignal()
