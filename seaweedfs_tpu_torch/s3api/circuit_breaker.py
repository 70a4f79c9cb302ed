"""S3 gateway circuit breaker.

Counterpart of seaweedfs_tpu/s3api/circuit_breaker.py (SeaweedFS
weed/s3api/s3api_circuit_breaker.go): per-action
concurrency limits (request count and in-flight bytes), globally and per
bucket, loaded from the filer at /etc/s3/circuit_breaker.json (the
s3_pb.S3CircuitBreakerConfig shape) and hot-reloadable. A request past any
enabled limit is rejected with 503 TooManyRequests before it touches the
filer, exactly like the reference's Limit() wrapper.

Limit keys are "<Action>:Count" and "<Action>:MB" (the reference's
LimitTypeCount / LimitTypeMB).
"""

from __future__ import annotations

import json
import threading

CB_CONFIG_DIR = "/etc/s3"
CB_CONFIG_FILE = "circuit_breaker.json"


class TooManyRequests(Exception):
    pass


def load_filer_config(stub) -> dict | None:
    """Read /etc/s3/circuit_breaker.json from the filer (None if absent)."""
    from ..pb import filer_pb2

    try:
        resp = stub.LookupDirectoryEntry(
            filer_pb2.LookupDirectoryEntryRequest(
                directory=CB_CONFIG_DIR, name=CB_CONFIG_FILE), timeout=5)
    # lint: allow-broad-except(no readable breaker config means no limits;
    # the gateway polls again within its reload interval)
    except Exception:  # noqa: BLE001
        return None
    if not resp.entry.content:
        return None
    try:
        return json.loads(resp.entry.content)
    except json.JSONDecodeError:
        return None


def _limits(options: dict) -> dict[str, int]:
    """{"Read:Count": 10, "Write:MB": 64, ...} -> normalized int map."""
    out = {}
    for k, v in (options or {}).items():
        action, _, kind = k.partition(":")
        kind = kind or "Count"
        mult = (1 << 20) if kind.upper() == "MB" else 1
        out[f"{action}:{'MB' if mult > 1 else 'Count'}"] = int(v) * mult
    return out


class CircuitBreaker:
    def __init__(self, config: dict | None = None):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}  # scope key -> in-flight requests
        self._bytes: dict[str, int] = {}  # scope key -> in-flight bytes
        self.enabled = False
        self.global_limits: dict[str, int] = {}
        self.bucket_limits: dict[str, dict[str, int]] = {}
        if config:
            self.load(config)

    def load(self, config: dict) -> None:
        """Accepts the s3_pb.S3CircuitBreakerConfig JSON shape."""
        glob = config.get("global", {}) or {}
        with self._lock:
            self.enabled = bool(glob.get("enabled", False))
            self.global_limits = _limits(glob.get("actions"))
            self.bucket_limits = {}
            for bucket, opts in (config.get("buckets") or {}).items():
                if opts.get("enabled", True):
                    self.bucket_limits[bucket] = _limits(opts.get("actions"))

    def to_config(self) -> dict:
        def denorm(limits):
            return {k: (v >> 20 if k.endswith(":MB") else v)
                    for k, v in limits.items()}

        return {
            "global": {"enabled": self.enabled,
                       "actions": denorm(self.global_limits)},
            "buckets": {b: {"enabled": True, "actions": denorm(l)}
                        for b, l in self.bucket_limits.items()},
        }

    # -- request gate ------------------------------------------------------

    def acquire(self, action: str, bucket: str, nbytes: int = 0):
        """Admit one request; raises TooManyRequests past any enabled limit.
        Returns a release() callable (use in a finally)."""
        if not self.enabled:
            return lambda: None
        scopes = [("", self.global_limits)]
        if bucket in self.bucket_limits:
            scopes.append((bucket, self.bucket_limits[bucket]))
        taken: list[tuple[str, str, int]] = []  # (count_key, bytes_key, n)
        with self._lock:
            for scope, limits in scopes:
                ck, bk = f"{scope}/{action}:Count", f"{scope}/{action}:MB"
                climit = limits.get(f"{action}:Count")
                blimit = limits.get(f"{action}:MB")
                if climit is not None and self._counts.get(ck, 0) >= climit:
                    self._rollback(taken)
                    raise TooManyRequests(
                        f"too many {action} requests"
                        + (f" for bucket {scope}" if scope else ""))
                if blimit is not None and nbytes and \
                        self._bytes.get(bk, 0) + nbytes > blimit:
                    self._rollback(taken)
                    raise TooManyRequests(
                        f"too many {action} bytes in flight"
                        + (f" for bucket {scope}" if scope else ""))
                self._counts[ck] = self._counts.get(ck, 0) + 1
                self._bytes[bk] = self._bytes.get(bk, 0) + nbytes
                taken.append((ck, bk, nbytes))

        released = False

        def release():
            nonlocal released
            if released:
                return
            released = True
            with self._lock:
                self._rollback(taken)

        return release

    def _rollback(self, taken) -> None:
        """Caller holds self._lock."""
        for ck, bk, nbytes in taken:
            self._counts[ck] = self._counts.get(ck, 0) - 1
            self._bytes[bk] = self._bytes.get(bk, 0) - nbytes
