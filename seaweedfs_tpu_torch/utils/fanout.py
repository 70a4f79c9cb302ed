"""Shared bounded fan-out executor for the data-plane hot paths
(counterpart of seaweedfs_tpu/utils/fanout.py).

`VolumeServer.replicate_write` sends each replicated write to its peers
through ONE process-wide executor whose threads park between calls,
instead of a ThreadPoolExecutor built and torn down per write (thread
spawn on the hottest write path).

Bounds: `SWFS_FANOUT_THREADS` (default 16) caps concurrent tasks PER
POOL. Pools are NAMED TIERS, not one flat budget, because tasks in one
tier may transitively depend on another tier making progress: an upload
blocks on a volume PUT handler whose replication fan-out needs threads of
its own. In a combined-process topology a single shared pool full of
blocked uploads would starve the very replica sends those uploads wait
on: a circular wait. The tiers form a DAG instead:

    "pipeline"  (GET prefetch / PUT upload windows)
        └─ blocks on volume handlers, which fan out on →
    "replicate" (replica sends)
        └─ blocks on replica handlers, which fan out on nothing

so saturation in one tier can never deadlock the tier below it. Tasks
must never submit into their OWN pool (the classic shared-pool
deadlock); every consumer bottoms out in socket IO.
"""

from __future__ import annotations

import atexit
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor

from .locks import wlock

_lock = wlock("fanout.mu", rank=860)
_executors: dict[str, ThreadPoolExecutor] = {}


def _threads() -> int:
    try:
        return max(4, int(os.environ.get("SWFS_FANOUT_THREADS", "16")))
    except ValueError:
        return 16


def _shutdown() -> None:
    with _lock:
        pools = list(_executors.values())
        _executors.clear()
    for ex in pools:
        ex.shutdown(wait=False, cancel_futures=True)


def executor(pool: str = "pipeline") -> ThreadPoolExecutor:
    """The process-wide fan-out executor for `pool` (created on first
    use). Pick the tier that matches what the task BLOCKS ON — see the
    module docstring's dependency DAG."""
    ex = _executors.get(pool)
    if ex is not None:
        return ex
    with _lock:
        ex = _executors.get(pool)
        if ex is None:
            if not _executors:
                atexit.register(_shutdown)
            ex = _executors[pool] = ThreadPoolExecutor(
                max_workers=_threads(),
                thread_name_prefix=f"swfs-fanout-{pool}")
        return ex


def submit(fn, *args, pool: str = "pipeline", **kwargs) -> Future:
    return executor(pool).submit(fn, *args, **kwargs)


def run_all(fn, items, pool: str = "pipeline") -> list:
    """Run `fn(item)` for every item concurrently; wait for ALL to
    settle, then raise the first failure (in item order). Waiting before
    raising matters for replication fan-out: an early raise would leave
    sends still holding the request body and the caller unable to tell
    which replicas actually received it."""
    futs = [submit(fn, it, pool=pool) for it in items]
    first_err: BaseException | None = None
    results = []
    for f in futs:
        try:
            results.append(f.result())
        # lint: allow-broad-except(every send must settle before the
        # first failure is re-raised below)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            results.append(None)
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err
    return results
