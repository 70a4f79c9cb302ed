"""Metrics of the EC dispatch plane: counters, gauges and histograms.

The part of seaweedfs_tpu/utils/stats.py that the dispatch scheduler
reports into: the ``Counter``, ``Gauge`` and ``Histogram`` classes, the
``EC_DISPATCH_*`` families and ``ec_dispatch_stats()``. Metric names
match the reference's. The text exposition (``/metrics``), histogram
exemplars and the reconstructed-interval cache's counter wait for the
server slice; here the values are read in process (``value``, ``split_by``,
``Histogram.snapshot``).
"""

from __future__ import annotations

import threading

_BUCKETS = [0.0001, 0.0003, 0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1, 3, 10]


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()


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
        match, Prometheus-aggregation style)."""
        want = set(labels.items())
        with self._lock:
            return sum(v for k, v in self._values.items()
                       if want <= set(k))

    def split_by(self, label: str, **labels) -> dict[str, float]:
        """Per-`label`-value sums among entries matching `labels`, e.g.
        split_by("reason", lane="encode") -> {reason: batches}."""
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


class Gauge(Counter):
    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = v


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_: str, buckets=None):
        super().__init__(name, help_)
        self.buckets = list(buckets or _BUCKETS)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}

    def observe(self, v: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if v <= b:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0) + v
            self._totals[key] = self._totals.get(key, 0) + 1

    def snapshot(self, **labels) -> dict:
        """{"count", "sum"} of the observations whose labels include
        `labels` (subset match, like Counter.value)."""
        want = set(labels.items())
        with self._lock:
            keys = [k for k in self._totals if want <= set(k)]
            return {"count": sum(self._totals[k] for k in keys),
                    "sum": sum(self._sums[k] for k in keys)}


# -- EC dispatch plane: the scheduler that coalesces encode / reconstruct
#    slabs into stacked device dispatches, plus the reconstructed-interval
#    cache serving repeated degraded reads ---------------------------------

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

# -- host memory plane: the stack arena that recycles the scheduler's
#    flush buffers, plus its quarantine (buffers held until a device
#    dispatch has provably consumed the bytes) -----------------------------

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
EC_DISPATCH_ZEROFILL_ELIDED = Counter(
    "SeaweedFS_ec_dispatch_zerofill_elided_bytes",
    "Stack bytes whose zero-fill was elided because every byte of the "
    "packed region is overwritten by slab payload (column-compact wide "
    "packing).")


def ec_dispatch_stats() -> dict:
    """Snapshot of the dispatch plane: per-lane batch factor, batches by
    reason and the stack arena."""
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

    # metric label values stay snake_case (Prometheus idiom); the
    # snapshot is camelCase, so reason keys are re-spelled here
    def _camel(label: str) -> str:
        head, *rest = label.split("_")
        return head + "".join(p.capitalize() for p in rest)

    out["reasons"] = {_camel(r): int(n) for r, n in
                      EC_DISPATCH_BATCHES.split_by("reason").items()}
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
        "zeroFillElidedBytes": int(EC_DISPATCH_ZEROFILL_ELIDED.value()),
    }
    return out
