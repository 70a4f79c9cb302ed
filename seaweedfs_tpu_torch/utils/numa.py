"""NUMA/host-thread pinning for the EC dispatch hot loop.

The part of seaweedfs_tpu/utils/numa.py that the dispatch flusher uses.
The flusher moves tens of MB per batch between arena buffers and the
device driver. On a multi-socket host the OS is free to migrate it
across NUMA nodes mid-batch, turning every one of those passes into
cross-node traffic. Pinning it to one node's CPU set keeps a flush's
arena and its host-to-device copy on local memory.

Everything here is OPTIONAL and fails soft:

  * gated by ``SWFS_EC_DISPATCH_PIN`` (default off: laptops, CI
    containers and cgroup-restricted pods behave identically with the
    gate closed);
  * topology is read from ``/sys/devices/system/node`` and falls back to
    a single all-CPU node when absent (macOS, restricted /sys);
  * ``os.sched_setaffinity`` failures (EPERM in a locked-down container,
    non-Linux hosts without the call) degrade to a counted no-op.

Threads register through :func:`pin_thread` and round-robin across
nodes. Not carried over yet: ``next_node``, the node one encode
pipeline's reader and shard writers share in the reference; the port's
pipelines pin nothing until a measurement on the card's host asks for
it.
"""

from __future__ import annotations

import glob
import itertools
import os
import threading

_GATE = "SWFS_EC_DISPATCH_PIN"

_lock = threading.Lock()
_rr = itertools.count()
_pinned = 0  # threads successfully pinned
_noops = 0  # pin attempts that degraded to a no-op
_nodes_cache: list[list[int]] | None = None


def enabled() -> bool:
    """True iff the operator opted in (default OFF: pinning a thread in
    a cgroup-limited container can easily hurt)."""
    return os.environ.get(_GATE, "0").lower() in ("1", "true", "on")


def _parse_cpulist(text: str) -> list[int]:
    """Kernel cpulist format: "0-3,8,10-11" -> [0,1,2,3,8,10,11]."""
    cpus: list[int] = []
    for part in text.strip().split(","):
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-", 1)
            cpus.extend(range(int(lo), int(hi) + 1))
        else:
            cpus.append(int(part))
    return cpus


def node_cpus(sys_root: str = "/sys/devices/system/node") -> list[list[int]]:
    """Per-NUMA-node CPU lists from /sys, cached. A host without the
    sysfs tree (or with a single node) yields one all-CPU pseudo-node,
    so callers never special-case topology absence."""
    global _nodes_cache
    with _lock:
        if _nodes_cache is not None and sys_root == "/sys/devices/system/node":
            return _nodes_cache
    nodes: list[list[int]] = []
    try:
        for path in sorted(glob.glob(os.path.join(sys_root, "node[0-9]*"))):
            with open(os.path.join(path, "cpulist")) as f:
                cpus = _parse_cpulist(f.read())
            if cpus:
                nodes.append(cpus)
    except OSError:
        nodes = []
    if not nodes:
        # graceful fallback: one pseudo-node spanning the process's
        # current affinity mask (or every online CPU)
        try:
            cpus = sorted(os.sched_getaffinity(0))
        except (AttributeError, OSError):
            cpus = list(range(os.cpu_count() or 1))
        nodes = [cpus]
    if sys_root == "/sys/devices/system/node":
        with _lock:
            _nodes_cache = nodes
    return nodes


def pin_thread() -> tuple[int, ...] | None:
    """Pin the CALLING thread to one NUMA node's CPUs, the next node in
    round-robin order. Returns the CPU set applied, or None when pinning
    was a no-op (gate closed, or EPERM)."""
    global _pinned, _noops
    if not enabled():
        return None
    nodes = node_cpus()
    cpus = tuple(nodes[next(_rr) % len(nodes)])
    setter = getattr(os, "sched_setaffinity", None)
    if setter is None:
        with _lock:
            _noops += 1
        return None
    try:
        setter(0, cpus)
    except OSError:
        with _lock:
            _noops += 1
        return None
    with _lock:
        _pinned += 1
    return cpus


def pinning_stats() -> dict:
    """Snapshot: gate state, topology, realized pins."""
    with _lock:
        pinned, noops = _pinned, _noops
    return {
        "enabled": enabled(),
        "nodes": len(node_cpus()) if enabled() else 0,
        "threadsPinned": pinned,
        "noops": noops,
    }


def _reset_for_tests() -> None:
    global _pinned, _noops, _nodes_cache, _rr
    with _lock:
        _pinned = _noops = 0
        _nodes_cache = None
        _rr = itertools.count()
