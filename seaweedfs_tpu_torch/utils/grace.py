"""Graceful shutdown + profiling hooks.

Rebuild of SeaweedFS weed/util/grace/ (pprof.go:19-50
SetupProfiling, signal handling): `-cpuprofile` runs cProfile for the
process lifetime and dumps pstats at exit; `-memprofile` snapshots
tracemalloc peak at exit. on_interrupt() registers shutdown callbacks
run once on SIGINT/SIGTERM (and atexit).
"""

from __future__ import annotations

import atexit
import signal
import threading

_hooks: list = []
_hooks_lock = threading.Lock()
_installed = False
_profiler = None


def on_interrupt(fn) -> None:
    """Register fn to run once at shutdown (OnInterrupt, grace/signal.go)."""
    global _installed
    with _hooks_lock:
        _hooks.append(fn)
        if not _installed:
            _installed = True
            for sig in (signal.SIGINT, signal.SIGTERM):
                try:
                    signal.signal(sig, _run_hooks_and_exit)
                except ValueError:
                    pass  # not the main thread (tests)
            atexit.register(_run_hooks)


def _run_hooks(*_args) -> None:
    """Run-and-drain, exactly once per registration: the list swap under
    the lock means a SIGTERM handler racing atexit (or two concurrent
    signals) can never run the same hook twice — whoever swaps first
    owns the whole batch, later callers see an empty list. A hook that
    raises (even SystemExit from a sys.exit() inside a callback) must
    not block the remaining hooks."""
    with _hooks_lock:
        hooks, _hooks[:] = list(_hooks), []
    for fn in reversed(hooks):
        try:
            fn()
        # lint: allow-broad-except(shutdown must visit every hook)
        except BaseException:  # noqa: BLE001 - shutdown must proceed
            pass


def _run_hooks_and_exit(signum, frame) -> None:
    _run_hooks()
    raise SystemExit(128 + signum)


def setup_profiling(cpu_profile: str = "", mem_profile: str = "") -> None:
    """SetupProfiling (pprof.go:19): start collectors now, dump at exit."""
    global _profiler
    if cpu_profile:
        import cProfile

        _profiler = cProfile.Profile()
        _profiler.enable()

        def dump_cpu():
            _profiler.disable()
            _profiler.dump_stats(cpu_profile)

        on_interrupt(dump_cpu)
    if mem_profile:
        import tracemalloc

        tracemalloc.start()

        def dump_mem():
            snap = tracemalloc.take_snapshot()
            with open(mem_profile, "w") as f:
                for stat in snap.statistics("lineno")[:100]:
                    f.write(f"{stat}\n")

        on_interrupt(dump_mem)
