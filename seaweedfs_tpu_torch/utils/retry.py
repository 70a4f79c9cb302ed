"""Unified retry/failover: exponential backoff + jitter, retryable-error
classification, and MultiRetry over alternative targets.

Rebuild of SeaweedFS weed/util/retry.go — `Retry` (retry.go:14,
waitTime doubling up to a cap) and `MultiRetry`'s semantics folded into
one module, with the Go string-sniffing error classification
(`ErrorIsRetryable` matching "transport"/"connection refused") replaced
by typed checks: gRPC status codes, `requests` transport errors, and OS
connection errors.

A process-wide circuit breaker (reusing s3api.circuit_breaker) caps how
many callers may concurrently hammer one failing target: once
`PER_TARGET_RETRY_LIMIT` retry loops are inside RE-attempts against the
same address, further retriers fail fast instead of piling on — a dead
node sheds load instead of accumulating it. First attempts are never
gated: ordinary concurrent traffic to a healthy target must not trip
the breaker, only the retry storm that follows a failure does.
"""

from __future__ import annotations

import random
import ssl
import time

import grpc

from . import glog
from .failpoint import FailpointError

DEFAULT_ATTEMPTS = 4
WAIT_INIT = 0.1   # retry.go starts at time.Second; scaled for in-process
WAIT_MAX = 2.0    # doubling cap (retry.go:21 waitTime < RetryWaitTime*10)
JITTER = 0.5      # +/- fraction of the wait randomized away

# At most this many retry loops may simultaneously be attempting one
# target; excess callers get the original error back immediately.
PER_TARGET_RETRY_LIMIT = 8

_RETRYABLE_GRPC = frozenset((
    grpc.StatusCode.UNAVAILABLE,
    grpc.StatusCode.DEADLINE_EXCEEDED,
    grpc.StatusCode.RESOURCE_EXHAUSTED,
))


# generic ssl.SSLError reasons that indicate the PEER'S IDENTITY was
# rejected — retrying (or failing over to the "next replica", which is
# the same misconfigured cluster) cannot cure a bad certificate, and
# hammering a node we refuse to trust only hides the config error
_SSL_FATAL_REASON_MARKERS = ("CERTIFICATE", "UNKNOWN_CA", "BAD_CERT",
                             "CERT_", "HOSTNAME_MISMATCH")


def _ssl_error_of(exc: BaseException) -> ssl.SSLError | None:
    """Innermost ssl.SSLError in the cause/context/args chain.
    requests wraps TLS failures as requests.exceptions.SSLError (a
    ConnectionError subclass!) around urllib3 around the real
    ssl.SSLError, so the blanket ConnectionError branch below would
    happily retry certificate rejections without this unwrap."""
    seen: set[int] = set()
    stack: list[BaseException | None] = [exc]
    while stack:
        e = stack.pop()
        if e is None or id(e) in seen:
            continue
        seen.add(id(e))
        if isinstance(e, ssl.SSLError):
            return e
        stack.append(getattr(e, "__cause__", None))
        stack.append(getattr(e, "__context__", None))
        stack.extend(a for a in getattr(e, "args", ())
                     if isinstance(a, BaseException))
    return None


def ssl_error_is_retryable(e: ssl.SSLError) -> bool:
    """Classify ssl.SSLError subtypes: handshake
    timeouts, EOF mid-handshake and protocol flakes look like a node
    going down and are retryable; certificate-verification failures are
    a trust decision and fail fast."""
    if isinstance(e, ssl.SSLCertVerificationError):
        return False
    if isinstance(e, (ssl.SSLEOFError, ssl.SSLZeroReturnError,
                      ssl.SSLWantReadError, ssl.SSLWantWriteError,
                      ssl.SSLSyscallError)):
        return True  # connection torn mid-handshake/read: transient
    reason = (getattr(e, "reason", "") or "").upper()
    if any(m in reason for m in _SSL_FATAL_REASON_MARKERS):
        return False
    # alert strings travel in args too (urllib3 re-raises with a
    # stringified inner error on some paths)
    msg = " ".join(str(a) for a in e.args).upper()
    if "CERTIFICATE_VERIFY_FAILED" in msg or "UNKNOWN CA" in msg:
        return False
    return True  # handshake alerts, version hiccups, truncated records


def is_retryable(exc: BaseException) -> bool:
    """Transient transport/availability failures — the ones a different
    attempt (or a different replica) can cure. Application errors
    (NOT_FOUND, bad request, integrity failures) are final, and so are
    TLS certificate-verification rejections (a cert-invalid replica is
    not merely down; see ssl_error_is_retryable)."""
    if isinstance(exc, grpc.RpcError):
        code = exc.code() if callable(getattr(exc, "code", None)) else None
        return code in _RETRYABLE_GRPC
    if isinstance(exc, FailpointError):
        return True  # injected faults model transient outages
    sslerr = _ssl_error_of(exc)
    if sslerr is not None:
        return ssl_error_is_retryable(sslerr)
    try:
        import requests

        if isinstance(exc, (requests.exceptions.ConnectionError,
                            requests.exceptions.Timeout,
                            requests.exceptions.ChunkedEncodingError)):
            return True
    except ImportError:  # pragma: no cover
        pass
    return isinstance(exc, (ConnectionError, TimeoutError))


class Backoff:
    """Iterator of sleep durations: WAIT_INIT doubling to WAIT_MAX, each
    randomized by +/-JITTER so synchronized clients don't stampede."""

    def __init__(self, wait_init: float = WAIT_INIT,
                 wait_max: float = WAIT_MAX, jitter: float = JITTER,
                 rng: random.Random | None = None):
        self.wait = wait_init
        self.wait_max = wait_max
        self.jitter = jitter
        self.rng = rng or random

    def next_wait(self) -> float:
        w = self.wait * (1 + self.jitter * (2 * self.rng.random() - 1))
        self.wait = min(self.wait * 2, self.wait_max)
        return max(w, 0.0)

    def sleep(self) -> None:
        time.sleep(self.next_wait())


def retry(name: str, fn, *, attempts: int = DEFAULT_ATTEMPTS,
          wait_init: float = WAIT_INIT, wait_max: float = WAIT_MAX,
          retryable=is_retryable, on_retry=None):
    """util.Retry: run fn() up to `attempts` times, backing off between
    retryable failures; final or exhausted errors propagate."""
    bo = Backoff(wait_init, wait_max)
    last: BaseException | None = None
    for attempt in range(attempts):
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 - classified below
            if not retryable(e) or attempt == attempts - 1:
                raise
            last = e
            glog.v(1, f"retry {name}: attempt {attempt + 1} failed: {e}")
            if on_retry is not None:
                on_retry(e, attempt)
        bo.sleep()
    raise last  # pragma: no cover - loop always raises or returns


def multi_retry(name: str, targets, fn, *, cycles: int = 2,
                wait_init: float = WAIT_INIT, wait_max: float = WAIT_MAX,
                retryable=is_retryable):
    """Failover across alternative targets: try fn(target) for each in
    order; a retryable failure moves to the next target immediately
    (the next replica is the backoff), a full failed cycle sleeps, and
    non-retryable errors propagate at once. Each attempt is admitted
    through the per-target circuit breaker so a dead target is not
    hammered by every caller at once."""
    targets = list(targets)
    if not targets:
        raise ValueError(f"{name}: no targets")
    bo = Backoff(wait_init, wait_max)
    last: BaseException | None = None
    for cycle in range(cycles):
        for target in targets:
            try:
                # first-cycle attempts are ordinary traffic and bypass
                # the breaker; only RE-attempts (cycle > 0, the ones
                # that pile onto an already-failing target) are capped
                if cycle:
                    return guarded_attempt(target, lambda: fn(target))
                return fn(target)
            except BaseException as e:  # noqa: BLE001 - classified below
                if not retryable(e):
                    raise
                last = e
                glog.v(1, f"retry {name}: target {target} failed: {e}")
        if cycle < cycles - 1:
            bo.sleep()
    raise last


# -- per-target retry admission (reuses the s3api circuit breaker) ---------

_breaker = None


def _target_breaker():
    global _breaker
    if _breaker is None:
        from ..s3api.circuit_breaker import CircuitBreaker

        _breaker = CircuitBreaker({"global": {"enabled": True, "actions": {
            # process-wide ceiling across all targets; generous — the
            # per-target bucket below is the real anti-hammering cap
            "Retry": PER_TARGET_RETRY_LIMIT * 64,
        }}})
    return _breaker


def guarded_attempt(target: str, fn):
    """Run one attempt against `target` under the per-target concurrency
    cap. When the target's bucket is saturated (PER_TARGET_RETRY_LIMIT
    callers already mid-attempt), fail fast as a retryable error so the
    caller moves on to its next alternative."""
    from ..s3api.circuit_breaker import TooManyRequests

    cb = _target_breaker()
    if target not in cb.bucket_limits:
        cb.bucket_limits[target] = {"Retry:Count": PER_TARGET_RETRY_LIMIT}
    try:
        release = cb.acquire("Retry", target)
    except TooManyRequests as e:
        raise ConnectionError(
            f"target {target} circuit open: {e}") from e
    try:
        return fn()
    finally:
        release()
