"""Strict priority between foreground I/O and background work via
cluster-wide token grants.

taught ONE background workload (the scrubber) to yield to ONE
signal (its own server's foreground QPS). This module generalizes that
into a cluster plane:

  * the MASTER runs a `GrantLedger` — one shared background byte budget
    (`SWFS_QOS_BG_MBPS`, cluster-wide) leased out over the `QosGrant`
    RPC in short TTL'd grants. Priority is STRICT by reservation:
    `repair` outranks `scrub`/`archival`, so while repair demand exists
    the lower classes' grants shrink to zero before repair loses a
    byte. (Foreground is not a grant class at all — see below.)
  * each VOLUME SERVER runs a `BackgroundGovernor` — background
    workloads call `acquire(work_class, nbytes)` before burning
    disk/CPU. The governor spends its local lease, refreshes over
    `QosGrant` when dry (each refresh also reports the server's
    pressure score), and additionally yields to LOCAL foreground
    traffic while `foreground_qps()` exceeds `SWFS_QOS_FG_QPS` — the
    backoff, now shared by every background class.

Failure semantics (the part chaos tests pin):

  * **foreground fails OPEN** by construction: client reads/writes
    never call into this module, so a dead master cannot deadlock a
    write on the QoS plane.
  * **background fails CLOSED**: a lease refresh that cannot reach the
    master (or is refused past the wait budget) raises
    `QosUnavailable` — the scrubber skips its sweep, archival encodes
    abort before touching bytes. Paused background work is always
    safe; unthrottled background work during a control-plane outage is
    exactly the contention storm this plane exists to prevent.

With `SWFS_QOS_BG_MBPS` unset (the default) the governor is disabled
and every `acquire` is a no-op — the scrubber's local pacing remains the only
throttle, and tier-1 behavior is unchanged.
"""

from __future__ import annotations

import os
import threading
import time

from ..utils import failpoint
from ..utils.stats import (
    QOS_BG_WAIT_SECONDS,
    QOS_GRANT_OPS,
    QOS_GRANTED_BYTES,
)

# strict order: lower rank preempts higher. Foreground is deliberately
# NOT here — it never asks permission.
BACKGROUND_CLASSES = {"repair": 0, "scrub": 1, "archival": 1}

DEFAULT_LEASE_TTL_S = 2.0
DEFAULT_MAX_GRANT_BYTES = 64 << 20
_CFG_TTL_S = 1.0


class QosUnavailable(IOError):
    """Background token acquisition failed closed (master unreachable
    or budget withheld past the wait cap). Callers pause the background
    work; they never surface this to a foreground client."""


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


class GrantLedger:
    """Master-side cluster background budget + strict-priority grants.

    One token bucket holds the shared budget (bytes). Strictness is by
    reservation: a grant for class C only sees tokens left after the
    demand that strictly-higher classes expressed within the current
    demand window has been reserved. Demand is what servers ASKED for
    (not what they got), so a starving repair backlog keeps its
    reservation even while denied scrub askers retry. Demand is kept
    per (class, server) — each server's LATEST ask, not one entry per
    RPC — so a starved governor retrying the same request every ~100ms
    cannot multiply its reservation ~40x across the window and starve
    lower classes far beyond the actual higher-class need."""

    DEMAND_WINDOW_S = 4.0

    def __init__(self, now=time.monotonic):
        self._now = now
        self._lock = threading.Lock()
        self._tokens = 0.0
        self._last = now()
        self._rate = -1.0  # resolved lazily from env (refreshable)
        self._rate_read_at = -1e9
        # class -> {address: (t, requested_bytes)} inside DEMAND_WINDOW_S
        self._demand: dict[str, dict[str, tuple[float, int]]] = {
            k: {} for k in BACKGROUND_CLASSES}
        # address -> {pressure, unix, byClass: {klass: granted_total}}
        self.servers: dict[str, dict] = {}
        self.granted_total: dict[str, int] = {}
        self.denied_total: dict[str, int] = {}

    def rate_bytes(self) -> float:
        """Cluster background budget in bytes/s; <= 0 = unlimited."""
        t = self._now()
        if t - self._rate_read_at > _CFG_TTL_S:
            self._rate = _env_float("SWFS_QOS_BG_MBPS", 0.0) * 1e6
            self._rate_read_at = t
        return self._rate

    def _refill_locked(self, rate: float) -> None:
        t = self._now()
        burst = max(rate, 1.0)  # 1s of budget
        self._tokens = min(burst, self._tokens + (t - self._last) * rate)
        self._last = t

    def _demand_of_higher_locked(self, klass: str) -> float:
        rank = BACKGROUND_CLASSES.get(klass, 99)
        cut = self._now() - self.DEMAND_WINDOW_S
        total = 0.0
        for k, by_addr in self._demand.items():
            if BACKGROUND_CLASSES[k] >= rank:
                continue
            for addr in list(by_addr):
                t, n = by_addr[addr]
                if t < cut:
                    del by_addr[addr]
                else:
                    total += n
        return total

    def grant(self, address: str, klass: str, requested: int,
              pressure: float) -> tuple[int, float]:
        """-> (granted_bytes, lease_ttl_s). Unknown classes get nothing;
        with no cluster budget configured everything is granted (the
        governor then only enforces the local FG-QPS backoff)."""
        ttl = _env_float("SWFS_QOS_LEASE_TTL_S", DEFAULT_LEASE_TTL_S)
        requested = max(int(requested), 0)
        rate = self.rate_bytes()
        with self._lock:
            st = self.servers.setdefault(
                address, {"byClass": {}, "pressure": 0.0, "unix": 0.0})
            st["pressure"] = float(pressure)
            st["unix"] = time.time()
            if klass not in BACKGROUND_CLASSES:
                # pressure-only report (work_class "" rides the same RPC)
                return 0, ttl
            self._demand[klass][address] = (self._now(), requested)
            if rate <= 0:
                granted = min(requested, DEFAULT_MAX_GRANT_BYTES)
            else:
                self._refill_locked(rate)
                reserve = self._demand_of_higher_locked(klass)
                available = self._tokens - reserve
                granted = int(min(requested, max(available, 0.0),
                                  DEFAULT_MAX_GRANT_BYTES))
                self._tokens -= granted
            st["byClass"][klass] = st["byClass"].get(klass, 0) + granted
            if granted > 0:
                self.granted_total[klass] = \
                    self.granted_total.get(klass, 0) + granted
            else:
                self.denied_total[klass] = \
                    self.denied_total.get(klass, 0) + 1
        if granted > 0:
            QOS_GRANTED_BYTES.inc(granted, work_class=klass)
        QOS_GRANT_OPS.inc(work_class=klass,
                          outcome="ok" if granted > 0 else "denied")
        return granted, ttl

    def node_pressure(self, address: str, max_age_s: float = 15.0) -> float:
        """Last reported pressure of one server; stale reports decay to
        0 so a server that stopped refreshing can't repel placement
        forever."""
        with self._lock:
            st = self.servers.get(address)
            if st is None or time.time() - st["unix"] > max_age_s:
                return 0.0
            return st["pressure"]

    def status(self) -> dict:
        rate = self.rate_bytes()
        with self._lock:
            return {
                "clusterBudgetMBps": round(rate / 1e6, 3) if rate > 0
                else 0.0,
                "grantedBytes": dict(self.granted_total),
                "deniedGrants": dict(self.denied_total),
                "servers": {
                    addr: {
                        "pressure": st["pressure"],
                        "ageSeconds": round(time.time() - st["unix"], 1),
                        "grantedBytes": dict(st["byClass"]),
                    } for addr, st in self.servers.items()
                },
            }


class BackgroundGovernor:
    """Volume-server-side gate every background byte passes through."""

    def __init__(self, server):
        # server contract: .address, .master_grpc, .foreground_qps(),
        # .qos_pressure() — VolumeServer provides all four
        self.server = server
        self._lock = threading.Lock()
        self._tokens: dict[str, float] = {}
        self._lease_expiry: dict[str, float] = {}
        self._cluster_rate = 0.0  # bytes/s, learned from grant replies
        self.waits: dict[str, float] = {}
        self.denials = 0

    def enabled(self) -> bool:
        return _env_float("SWFS_QOS_BG_MBPS", 0.0) > 0

    def _fg_backoff(self) -> float:
        """Strict local priority: background yields while foreground QPS
        is above SWFS_QOS_FG_QPS (0 = no gate). -> seconds slept."""
        limit = _env_float("SWFS_QOS_FG_QPS", 0.0)
        if limit <= 0:
            return 0.0
        slept = 0.0
        pause = _env_float("SWFS_QOS_FG_BACKOFF_MS", 100.0) / 1e3
        while self.server.foreground_qps() > limit and slept < 10.0:
            time.sleep(pause)
            slept += pause
        return slept

    def _refresh(self, klass: str, want: int) -> None:
        """One QosGrant round trip; raises QosUnavailable on any
        transport failure (fail closed). The `qos.grant` failpoint sits
        in front of the wire for targeted chaos."""
        import grpc

        from ..pb import qos_pb2, rpc

        master = self.server.master_grpc
        try:
            failpoint.fail("qos.grant", ctx=f"{master},")
            stub = rpc.master_stub(master)
            resp = stub.QosGrant(qos_pb2.QosGrantRequest(
                address=self.server.address, work_class=klass,
                requested_bytes=max(int(want), 1),
                pressure=self.server.qos_pressure()), timeout=5)
        except (grpc.RpcError, failpoint.FailpointError) as e:
            QOS_GRANT_OPS.inc(work_class=klass, outcome="error")
            raise QosUnavailable(
                f"qos lease refresh for {klass!r} failed ({e}); "
                f"background work pauses (fail closed)") from e
        with self._lock:
            self._tokens[klass] = self._tokens.get(klass, 0.0) \
                + resp.granted_bytes
            self._lease_expiry[klass] = time.monotonic() \
                + (resp.lease_ttl_seconds or DEFAULT_LEASE_TTL_S)
            self._cluster_rate = float(resp.cluster_rate_bytes or 0)

    def acquire(self, klass: str, nbytes: int, *,
                max_wait_s: float | None = None) -> float:
        """Gate `nbytes` of background work. No-op when the cluster
        budget is unconfigured (beyond the FG-QPS yield when that gate
        is set). Blocks while the budget is reserved for higher
        classes; raises QosUnavailable past `max_wait_s` (default
        SWFS_QOS_BG_WAIT_MAX_S=30) or on an unreachable master.
        -> seconds spent waiting."""
        waited = self._fg_backoff()
        if not self.enabled():
            if waited:
                QOS_BG_WAIT_SECONDS.inc(waited, work_class=klass)
            return waited
        if max_wait_s is None:
            max_wait_s = _env_float("SWFS_QOS_BG_WAIT_MAX_S", 30.0)
        nbytes = max(int(nbytes), 1)
        t0 = time.monotonic()
        while True:
            with self._lock:
                have = self._tokens.get(klass, 0.0)
                fresh = time.monotonic() < self._lease_expiry.get(klass,
                                                                  0.0)
                if have and not fresh:
                    # expired lease: hoarded tokens are VOID — the
                    # master's bucket was debited for them a TTL ago;
                    # spending them now would burst on top of the
                    # current budget ("short TTL'd grants" contract)
                    self._tokens[klass] = have = 0.0
                if have >= nbytes and fresh:
                    self._tokens[klass] = have - nbytes
                    break
            self._refresh(klass, max(nbytes, 1 << 20))
            with self._lock:
                if self._tokens.get(klass, 0.0) >= nbytes:
                    self._tokens[klass] -= nbytes
                    break
                rate = self._cluster_rate
            waited_now = time.monotonic() - t0
            if waited_now >= max_wait_s:
                self.denials += 1
                raise QosUnavailable(
                    f"{klass} starved of cluster tokens for "
                    f"{waited_now:.1f}s (higher-priority demand holds "
                    f"the budget)")
            # denied: sleep roughly until the budget could cover the
            # ask (bounded 0.1-1s) instead of hammering QosGrant every
            # 100ms — each retry still re-expresses demand, so the
            # reservation against lower classes never lapses
            pause = nbytes / rate if rate > 0 else 0.1
            time.sleep(min(max(pause, 0.1), 1.0, max_wait_s))
        waited += time.monotonic() - t0
        if waited > 0:
            QOS_BG_WAIT_SECONDS.inc(waited, work_class=klass)
            with self._lock:
                self.waits[klass] = self.waits.get(klass, 0.0) + waited
        return waited

    def pacer(self, klass: str, prepaid: int = 0):
        """Per-slab draw for long background jobs (archival encode,
        shard rebuild). The caller admission-probes a BOUNDED first
        chunk up front (fail closed before touching bytes), passes it
        as `prepaid`, and hands the returned callable to the job's slab
        loop: each call draws `nbytes` more from the cluster budget, so
        a volume far larger than one wait-cap's worth of budget still
        encodes — paced against competing demand instead of demanding
        the whole volume in one lump (which could never be granted).
        QosUnavailable propagates mid-job; callers abort and roll back
        exactly as they do for a failed admission probe."""
        credit = prepaid
        lock = threading.Lock()

        def pace(nbytes: int) -> None:
            nonlocal credit
            with lock:
                take = min(credit, nbytes)
                credit -= take
                rest = nbytes - take
            if rest > 0:
                self.acquire(klass, rest)

        return pace

    def status(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled(),
                "tokens": {k: int(v) for k, v in self._tokens.items()},
                "leaseExpiresInS": {
                    k: round(max(e - time.monotonic(), 0.0), 2)
                    for k, e in self._lease_expiry.items()},
                "waitSeconds": {k: round(v, 3)
                                for k, v in self.waits.items()},
                "denials": self.denials,
            }
