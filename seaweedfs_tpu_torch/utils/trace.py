"""Per-request spans: the part of seaweedfs_tpu/utils/trace.py the EC
dispatch plane stamps its attribution on.

``span()`` opens a timed span (child of this thread's active span, or a
new root), ``current()`` returns the active one, and ``Span.set_attr``
records plain JSON-able attributes. ``dispatch.reconstruct_now`` writes
a degraded read's queue wait, realized batch size and dispatch wall onto
the caller's span. The process span store, head sampling, W3C
``traceparent`` propagation and tail retention wait for the server
slice; a finished span here carries its duration and attributes and is
recorded nowhere else.

Timing derives from ``time.perf_counter()`` only (monotonic).
``SWFS_TRACE=0`` turns ``span()`` into a no-op.
"""

from __future__ import annotations

import os
import random
import threading
import time

_tls = threading.local()


def enabled() -> bool:
    """SWFS_TRACE gates the whole plane (default on)."""
    return os.environ.get("SWFS_TRACE", "1").lower() not in (
        "0", "false", "off")


def _rand_hex(nbytes: int) -> str:
    return f"{random.getrandbits(nbytes * 8):0{nbytes * 2}x}"


class Span:
    """One timed operation with plain JSON-able attributes."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "_t0",
                 "attrs", "error", "duration_ms")

    def __init__(self, name: str, trace_id: str, parent_id: str):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _rand_hex(8)
        self.parent_id = parent_id
        self._t0 = time.perf_counter()
        self.attrs: dict = {}
        self.error = ""
        self.duration_ms = -1.0

    def set_attr(self, **attrs) -> None:
        self.attrs.update(attrs)

    def set_error(self, err) -> None:
        self.error = str(err)[:300]

    def finish(self) -> None:
        self.duration_ms = (time.perf_counter() - self._t0) * 1000.0


def current() -> Span | None:
    """The active span on this thread (None outside any span)."""
    sp = getattr(_tls, "span", None)
    return sp if isinstance(sp, Span) else None


class _SpanCtx:
    __slots__ = ("sp", "_prev")

    def __init__(self, sp: Span):
        self.sp = sp
        self._prev = None

    def __enter__(self) -> Span:
        self._prev = getattr(_tls, "span", None)
        _tls.span = self.sp
        return self.sp

    def __exit__(self, et, ev, tb):
        _tls.span = self._prev
        sp = self.sp
        if ev is not None and not sp.error:
            sp.set_error(f"{et.__name__}: {ev}")
        sp.finish()
        return False


class _NoopSpan:
    """What a disabled span() yields: set_attr/set_error are absorbing
    no-ops, so callers never branch."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    duration_ms = -1.0

    def set_attr(self, **attrs) -> None:
        pass

    def set_error(self, err) -> None:
        pass


class _NoopCtx:
    __slots__ = ()

    def __enter__(self):
        return _NoopSpan()

    def __exit__(self, *exc):
        return False


def span(name: str, **attrs):
    """A timed span, installed as this thread's current one while the
    `with` block runs: a child of the active span, else a new root.
    Exceptions propagate; they mark the span as an error first."""
    if not enabled():
        return _NoopCtx()
    parent = current()
    if parent is not None:
        sp = Span(name, parent.trace_id, parent.span_id)
    else:
        sp = Span(name, _rand_hex(16), "")
    sp.attrs.update(attrs)
    return _SpanCtx(sp)
