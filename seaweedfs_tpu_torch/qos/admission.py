"""Per-tenant admission control at the ingress planes.

The reference gateway has a per-action/bucket concurrency breaker
(s3api/circuit_breaker.go); under "millions of users" the missing half
is per-TENANT rate admission: one tenant's small-file flood must shed
early at the front door — with an honest `Retry-After` — instead of
queueing behind everyone until the whole box times out late
(arXiv:1709.05365's foreground/background contention story, applied to
tenant/tenant contention).

Tenant keys (cheap, no backend calls on the admission path):

  * S3: the access key from the Authorization header when one is
    presented (`ak:<key>` — unverified at admission time; a forged key
    still fails signature checks later, but keys the right bucket of a
    real tenant's budget), else the bucket (`col:<bucket>` — the
    collection analog), else `anonymous`.
  * filer: the `collection` query param, else the bucket segment of a
    `/buckets/<bucket>/...` path, else `anonymous`.

Rates come from env — `SWFS_QOS_TENANT_RPS` / `SWFS_QOS_TENANT_BURST`
defaults, per-tenant overrides via `SWFS_QOS_TENANT_OVERRIDES`
(JSON: {"ak:k1": {"rps": 50, "burst": 100}}). rps <= 0 = unlimited
(the default — admission observes but never rejects).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass

from ..utils.stats import QOS_ADMISSION_OPS

MAX_TENANTS = 4096          # hard cap on tracked buckets (hostile key spray)
REJECTION_LOG = 128         # recent rejections kept for /status + tests
_CFG_TTL_S = 1.0


class TokenBucket:
    """Admission token bucket with an injectable clock (the refill
    arithmetic is tested under fake time — no sleeps, no flakes).

    `try_take(n)` -> 0.0 when admitted (tokens deducted), else the
    seconds until `n` tokens will exist (nothing deducted). rate <= 0
    means unlimited."""

    __slots__ = ("rate", "burst", "_tokens", "_last", "_now", "_lock")

    def __init__(self, rate: float, burst: float | None = None,
                 now=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(rate, 1.0))
        self._tokens = self.burst
        self._now = now
        self._last = now()
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        t = self._now()
        self._tokens = min(self.burst,
                           self._tokens + (t - self._last) * self.rate)
        self._last = t

    def try_take(self, n: float = 1.0) -> float:
        if self.rate <= 0:
            return 0.0
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            return (n - self._tokens) / self.rate

    def available(self) -> float:
        if self.rate <= 0:
            return float("inf")
        with self._lock:
            self._refill_locked()
            return self._tokens


@dataclass
class Decision:
    admitted: bool
    tenant: str
    retry_after_s: float = 0.0
    reason: str = ""


def s3_access_key_hint(headers, query: str = "") -> str:
    """Access key named by the request, WITHOUT verifying the signature
    (admission keys budgets; authentication stays where it was). Covers
    SigV4 Authorization headers and presigned/v2 query forms."""
    auth = headers.get("Authorization") or ""
    marker = "Credential="
    i = auth.find(marker)
    if i >= 0:
        cred = auth[i + len(marker):].split(",")[0].strip()
        return cred.split("/")[0]
    for param in ("X-Amz-Credential=", "AWSAccessKeyId="):
        j = (query or "").find(param)
        if j >= 0:
            val = query[j + len(param):].split("&")[0]
            return val.split("%2F")[0].split("/")[0]
    return ""


def s3_tenant(headers, query: str, bucket: str) -> str:
    ak = s3_access_key_hint(headers, query)
    if ak:
        return f"ak:{ak}"
    if bucket:
        return f"col:{bucket}"
    return "anonymous"


def filer_tenant(path: str, collection: str = "") -> str:
    if collection:
        return f"col:{collection}"
    if path.startswith("/buckets/"):
        seg = path[len("/buckets/"):].split("/", 1)[0]
        if seg and not seg.startswith("."):
            return f"col:{seg}"
    return "anonymous"


class TenantAdmission:
    """One ingress plane's per-tenant admission state: bounded LRU of
    token buckets, a bounded log of recent rejections (each carrying the
    trace id the client saw in X-Trace-Id — the `trace.dump` handle),
    and the /status.Qos snapshot."""

    def __init__(self, plane: str, now=time.monotonic):
        self.plane = plane
        self._now = now
        self._buckets: "OrderedDict[str, TokenBucket]" = OrderedDict()
        self._lock = threading.Lock()
        self._rejections: deque = deque(maxlen=REJECTION_LOG)
        self.admitted = 0
        self.rejected = 0
        self._cfg = {"t": -1.0, "rps": 0.0, "burst": 0.0, "overrides": {}}

    # -- config (env, TTL-cached like utils/trace) --------------------------

    def _config(self) -> dict:
        c = self._cfg
        now = time.monotonic()
        if now - c["t"] > _CFG_TTL_S:
            try:
                c["rps"] = float(os.environ.get("SWFS_QOS_TENANT_RPS", "0"))
            except ValueError:
                c["rps"] = 0.0
            try:
                c["burst"] = float(
                    os.environ.get("SWFS_QOS_TENANT_BURST", "0"))
            except ValueError:
                c["burst"] = 0.0
            try:
                c["overrides"] = json.loads(
                    os.environ.get("SWFS_QOS_TENANT_OVERRIDES", "") or "{}")
            except ValueError:
                c["overrides"] = {}
            c["t"] = now
        return c

    def refresh_config(self) -> None:
        """Drop the cached env config (tests flip the env mid-function)."""
        self._cfg["t"] = -1.0
        with self._lock:
            self._buckets.clear()

    def _bucket_for(self, tenant: str) -> TokenBucket:
        cfg = self._config()
        ov = cfg["overrides"].get(tenant, {})
        rps = float(ov.get("rps", cfg["rps"]))
        burst = float(ov.get("burst", cfg["burst"])) or max(rps, 1.0)
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None or b.rate != rps or b.burst != burst:
                if b is None and len(self._buckets) >= MAX_TENANTS:
                    self._buckets.popitem(last=False)
                b = TokenBucket(rps, burst, now=self._now)
                self._buckets[tenant] = b
            else:
                self._buckets.move_to_end(tenant)
            return b

    # -- the admission verb -------------------------------------------------

    def admit(self, tenant: str, *, cost: float = 1.0,
              trace_id: str = "", detail: str = "") -> Decision:
        wait = self._bucket_for(tenant).try_take(cost)
        if wait <= 0.0:
            self.admitted += 1
            QOS_ADMISSION_OPS.inc(plane=self.plane, result="admit")
            return Decision(True, tenant)
        self.rejected += 1
        QOS_ADMISSION_OPS.inc(plane=self.plane, result="reject")
        # a local shed is the earliest "this process is hot" evidence
        # there is: the pipelined chunk engine collapses its
        # readahead/overlap windows to 1 while the signal holds
        from .pressure import SIGNAL

        SIGNAL.report_shed()
        retry_after = max(wait, 0.05)
        self._rejections.append({
            "tenant": tenant,
            "traceId": trace_id,
            "retryAfterS": round(retry_after, 3),
            "detail": detail,
            "unix": time.time(),
        })
        return Decision(False, tenant, retry_after_s=retry_after,
                        reason=f"tenant {tenant} over rate")

    # -- surfaces ------------------------------------------------------------

    def recent_rejections(self) -> list[dict]:
        return list(self._rejections)

    def status(self) -> dict:
        cfg = self._config()
        with self._lock:
            tenants = {
                t: {"rate": b.rate, "burst": b.burst,
                    "tokens": round(b.available(), 2)
                    if b.rate > 0 else -1}
                for t, b in list(self._buckets.items())[-32:]
            }
        return {
            "plane": self.plane,
            "defaultRps": cfg["rps"],
            "defaultBurst": cfg["burst"],
            "admitted": self.admitted,
            "rejected": self.rejected,
            "tenants": tenants,
            "recentRejections": self.recent_rejections()[-16:],
        }
