"""Cluster-wide request tracing: per-plane latency attribution.

Six PRs of perf work were tuned with aggregate counters — this module is
the missing per-request view: take one slow S3 GET and say how much of
its wall was filer cache miss, volume group-commit wait, EC dispatch
queue wait, or device matmul. Span contexts propagate as W3C
`traceparent` over both HTTP headers and gRPC metadata (pb/rpc.py
injects/extracts them centrally), every server keeps a bounded
in-process ring buffer of finished spans, and the interesting traces
are pinned past ring churn by tail-based retention:

  * keep-if-error: a span that exited with an exception (or was marked
    via set_error) always pins its trace;
  * keep-if-slow: any span >= SWFS_TRACE_SLOW_MS (default 250) pins its
    trace — the p99 tail is exactly what aggregate histograms can't
    explain;
  * head sampling (SWFS_TRACE_SAMPLE, default 1.0) caps the recording
    rate at the ROOT so the whole request tree is either recorded or
    not (partial trees attribute nothing).

Surfaces: `/debug/traces` JSON on master/filer/volume/s3, the
`X-Trace-Id` response header, the shell's `trace.dump` (gathers one
trace's spans from every server it touched), and histogram exemplars
in utils/stats.py (a p99 bucket in /metrics links to a retained trace
id).

Cheap enough to leave on: a span is one perf_counter pair, one dict,
and one deque append — no locks on the hot path beyond the store's
(the reference measured <= 2% median overhead on a small-file A/B).
SWFS_TRACE=0 turns the whole plane into no-ops.

Timing discipline (lint rule SWFS002): spans must never read the wall
clock per-event — `time.time()` is not monotonic and a step (NTP slew,
manual set) would corrupt durations. All timing derives from
`time.perf_counter()`; wall-clock timestamps come from a single
monotonic-anchored epoch captured at import.

Phases (`phase()`) time the EC plane's per-slab host work where it
happens, with no request around it: the dispatch scheduler's serial
section and pack, the codec's copy in and launch, the encode pipeline's
copy back. The store keeps per-(phase, lane) seconds, which
`SeaweedFS_ec_phase_seconds` pulls, and a ring of intervals of their own
(`phase_intervals`), apart from the request ring so a busy encode never
evicts the spans `/debug/traces` serves. While a `torch.profiler` records
on the phase's thread, a phase is also a `record_function` range of its
name, so the exported trace shows it beside the copies and kernels it
started; the profiler records the ranges of the thread that started it
alone, so a phase on another thread is placed on the device's clock
through its ring interval instead (a reader maps perf_counter onto the
profiler's clock by a range of known perf_counter time).
"""

from __future__ import annotations

import os
import random
import sys
import threading
from collections import OrderedDict, deque

import time

# Wall-clock anchor: captured ONCE at import; every span timestamp is
# anchor + perf_counter delta, so spans are strictly monotonic within a
# process and never see a clock step mid-trace. This line is the single
# sanctioned wall-clock read (lint rule SWFS002, tools/lint.py).
_EPOCH_ANCHOR = time.time_ns() / 1e9  # lint: allow-wall-clock-anchor
_PC_ANCHOR = time.perf_counter()

TRACEPARENT = "traceparent"
_VERSION = "00"
_HEX = set("0123456789abcdef")

DEFAULT_SLOW_MS = 250.0
DEFAULT_RING_SPANS = 4096
DEFAULT_RETAIN_TRACES = 128
# phase intervals held: a 15 s window of eight volumes encoding through
# one H100 records about 6,000, and a reader asks back over such a window
# and the rounds that finish after it
PHASE_RING = 65536
# hard cap on spans held per RETAINED trace: a client reusing one fixed
# traceparent on every request funnels everything into one trace id —
# without this, the first slow span would pin a list that then grows
# forever (the "all bounds are hard" contract)
RETAINED_TRACE_SPAN_CAP = 512


def now_unix() -> float:
    """Monotonic-anchored wall-clock seconds (the only sanctioned span
    timestamp source — see the module docstring on SWFS002)."""
    return _EPOCH_ANCHOR + (time.perf_counter() - _PC_ANCHOR)


# Config cache: os.environ reads cost ~2us each (str encode + Mapping
# machinery) — three per span would dominate the span itself. The env
# stays the knob (flippable at runtime, e.g. the A/B alternates
# SWFS_TRACE between segments), re-read at most every _CFG_TTL_S;
# refresh_config() forces it (tests that flip the env mid-function).
_CFG_TTL_S = 0.25
_cfg_cache = {"t": -1.0, "enabled": True, "sample": 1.0,
              "slow": DEFAULT_SLOW_MS}


def _cfg() -> dict:
    c = _cfg_cache
    now = time.monotonic()
    if now - c["t"] > _CFG_TTL_S:
        c["enabled"] = os.environ.get("SWFS_TRACE", "1").lower() not in (
            "0", "false", "off")
        try:
            c["sample"] = float(os.environ.get("SWFS_TRACE_SAMPLE", "1"))
        except ValueError:
            c["sample"] = 1.0
        try:
            c["slow"] = float(os.environ.get("SWFS_TRACE_SLOW_MS",
                                             str(DEFAULT_SLOW_MS)))
        except ValueError:
            c["slow"] = DEFAULT_SLOW_MS
        c["t"] = now
    return c


def refresh_config() -> None:
    """Drop the cached env config so the next span sees fresh values."""
    _cfg_cache["t"] = -1.0


def enabled() -> bool:
    """SWFS_TRACE gates the whole plane (default on)."""
    return _cfg()["enabled"]


def sample_rate() -> float:
    """Head-sampling probability applied at trace ROOTS (default 1.0:
    record everything — retention, not sampling, bounds memory)."""
    return _cfg()["sample"]


def slow_ms() -> float:
    """Tail-retention threshold: any span at least this slow pins its
    whole trace past ring churn."""
    return _cfg()["slow"]


# -- process identity ------------------------------------------------------

_identity = {"component": "", "server": ""}


def set_identity(component: str, server: str) -> None:
    """Stamp this process's spans with who it is (called by every
    server's start()). Multiple in-process servers (tests, `weed
    server`) each re-stamp on ingress via the span's component=."""
    _identity["component"] = component
    _identity["server"] = server


# -- context propagation ---------------------------------------------------

_tls = threading.local()


def _rand_hex(nbytes: int) -> str:
    return f"{random.getrandbits(nbytes * 8):0{nbytes * 2}x}"


def parse_traceparent(value) -> tuple[str, str, bool] | None:
    """W3C traceparent `00-<32 hex>-<16 hex>-<2 hex>` ->
    (trace_id, parent_span_id, sampled); anything malformed -> None
    (callers re-root — a hostile header must never 500)."""
    if not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    ver, tid, sid, flags = parts[0], parts[1], parts[2], parts[3]
    if len(ver) != 2 or not set(ver) <= _HEX or ver == "ff":
        return None
    if len(tid) != 32 or not set(tid) <= _HEX or set(tid) == {"0"}:
        return None
    if len(sid) != 16 or not set(sid) <= _HEX or set(sid) == {"0"}:
        return None
    if len(flags) != 2 or not set(flags) <= _HEX:
        return None
    return tid, sid, bool(int(flags, 16) & 0x01)


class Span:
    """One timed operation. Attributes are plain JSON-able values; the
    span records itself into the process trace store on close (when its
    trace is sampled). Kept deliberately thin — a span on the write hot
    path is two perf_counter reads, one 8-byte random id, and one deque
    append; the JSON view is built lazily at READ time (to_dict), never
    per request."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "component",
                 "server", "sampled", "_t0", "attrs", "error",
                 "duration_ms")

    def __init__(self, name: str, trace_id: str, parent_id: str,
                 sampled: bool, component: str = "", server: str = ""):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _rand_hex(8)
        self.parent_id = parent_id
        self.sampled = sampled
        self.component = component or _identity["component"]
        self.server = server or _identity["server"]
        self._t0 = time.perf_counter()
        self.attrs: dict = {}
        self.error = ""
        self.duration_ms = -1.0

    @property
    def start_unix(self) -> float:
        # derived, not stored: the anchor arithmetic runs at read time
        return _EPOCH_ANCHOR + (self._t0 - _PC_ANCHOR)

    def set_attr(self, **attrs) -> None:
        self.attrs.update(attrs)

    def set_error(self, err) -> None:
        self.error = str(err)[:300]

    def traceparent(self) -> str:
        return (f"{_VERSION}-{self.trace_id}-{self.span_id}-"
                f"{'01' if self.sampled else '00'}")

    def context(self) -> tuple[str, str, bool]:
        """Portable parent handle for cross-thread span creation (sink
        threads, thread pools): pass to span(parent=...)."""
        return self.trace_id, self.span_id, self.sampled

    def finish(self) -> None:
        self.duration_ms = (time.perf_counter() - self._t0) * 1000.0
        if self.sampled:
            STORE.record(self)

    def to_dict(self) -> dict:
        return {
            "traceId": self.trace_id, "spanId": self.span_id,
            "parentId": self.parent_id, "name": self.name,
            "component": self.component, "server": self.server,
            "startUnix": round(self.start_unix, 6),
            "durationMs": round(self.duration_ms, 3),
            "error": self.error, "attrs": dict(self.attrs),
        }


class _NoopSpan:
    """Returned when tracing is off or the span is suppressed: callers
    never branch — set_attr/set_error are absorbing no-ops."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    sampled = False
    duration_ms = -1.0

    def set_attr(self, **attrs) -> None:
        pass

    def set_error(self, err) -> None:
        pass

    def traceparent(self) -> str:
        return ""

    def context(self) -> None:
        return None


NOOP = _NoopSpan()


def current() -> Span | None:
    """The active span on this thread (None outside any span)."""
    sp = getattr(_tls, "span", None)
    return sp if isinstance(sp, Span) else None


def current_context() -> tuple[str, str, bool] | None:
    sp = current()
    return sp.context() if sp is not None else None


def traceparent() -> str:
    """Header/metadata value for the active span ("" when none): the
    single injection source pb/rpc.py and the HTTP clients use."""
    sp = current()
    return sp.traceparent() if sp is not None else ""


def inject_headers(headers: dict | None = None) -> dict:
    """Add the active span's traceparent to an outgoing-header dict
    (no-op passthrough when no span is active)."""
    headers = headers if headers is not None else {}
    tp = traceparent()
    if tp:
        headers[TRACEPARENT] = tp
    return headers


def carrier_has_context(carrier) -> bool:
    """True when the carrier (HTTP headers / gRPC metadata) names a
    traceparent at all — servers use this to skip span creation for
    untraced background chatter (heartbeats, lease refills)."""
    return _header_value(carrier) is not None


def _header_value(carrier) -> str | None:
    """traceparent out of an HTTP header mapping or a gRPC invocation-
    metadata iterable of (key, value) pairs."""
    if carrier is None:
        return None
    get = getattr(carrier, "get", None)
    if get is not None:
        # one lookup: HTTP header mappings (email.Message) are case-
        # insensitive already, and W3C mandates the lowercase form
        v = get(TRACEPARENT)
        return v if isinstance(v, str) else None
    try:
        for k, v in carrier:
            if str(k).lower() == TRACEPARENT:
                return v if isinstance(v, str) else None
    except TypeError:
        return None
    return None


class _SpanCtx:
    """Slotted context manager around one Span — a plain class instead
    of @contextmanager because the generator machinery costs more than
    the span itself on the write hot path."""

    __slots__ = ("sp", "activate", "_prev")

    def __init__(self, sp: Span, activate: bool):
        self.sp = sp
        self.activate = activate
        self._prev = None

    def __enter__(self) -> Span:
        if self.activate:
            self._prev = getattr(_tls, "span", None)
            _tls.span = self.sp
        return self.sp

    def __exit__(self, et, ev, tb):
        if self.activate:
            _tls.span = self._prev
        sp = self.sp
        if ev is not None and not sp.error:
            sp.set_error(f"{et.__name__}: {ev}")
        sp.finish()
        return False


class _NoopCtx:
    __slots__ = ()

    def __enter__(self):
        return NOOP

    def __exit__(self, *exc):
        return False


_NOOP_CTX = _NoopCtx()


def span(name: str, *, carrier=None, parent=None, child_only: bool = False,
         component: str = "", server: str = "", activate: bool = True,
         **attrs):
    """The one way spans are made.

      * carrier=: server ingress — parse the request's traceparent; a
        missing/malformed header re-roots (fresh trace id, head-sampled).
      * parent=: explicit cross-thread parent (a span.context() tuple).
      * neither: child of this thread's active span, else a new root.
      * child_only=True: record NOTHING unless a parent is active —
        internal client ops (lookups, leases) must not root noise
        traces of their own.
      * activate=False: time + record the span but don't install it as
        the thread's current context (streaming gRPC handlers, whose
        generator bodies suspend mid-`with` and would leak the TLS).

    Exceptions propagate; they mark the span as an error first
    (keep-if-error retention)."""
    if child_only and parent is None and carrier is None \
            and not isinstance(getattr(_tls, "span", None), Span):
        # fast path: internal client ops outside any trace — the
        # common case on hot client threads; skip even the config read
        return _NOOP_CTX
    if not enabled():
        return _NOOP_CTX
    parent_span = current()
    tid = sid = None
    sampled = True
    if carrier is not None:
        parsed = parse_traceparent(_header_value(carrier))
        if parsed is not None:
            tid, sid, sampled = parsed
        elif parent_span is None:
            # re-root: hostile/absent header, no surrounding span
            tid, sid = _rand_hex(16), ""
            sampled = random.random() < sample_rate()
    if tid is None and parent is not None:
        try:
            tid, sid, sampled = parent
        except (TypeError, ValueError):
            tid = None
    if tid is None:
        if parent_span is not None:
            tid = parent_span.trace_id
            sid = parent_span.span_id
            sampled = parent_span.sampled
        elif child_only:
            return _NOOP_CTX
        else:
            tid, sid = _rand_hex(16), ""
            sampled = random.random() < sample_rate()
    sp = Span(name, tid, sid or "", sampled, component=component,
              server=server)
    if attrs:
        sp.attrs.update(attrs)
    return _SpanCtx(sp, activate)


class _Phase:
    """Slotted context manager around one phase (see `phase`)."""

    __slots__ = ("name", "lane", "_t0", "_prev", "_rf")

    def __init__(self, name: str, lane: str | None):
        self.name = name
        self.lane = lane

    def __enter__(self) -> "_Phase":
        self._prev = getattr(_tls, "lane", None)
        if self.lane is None:
            self.lane = self._prev or "-"
        _tls.lane = self.lane
        self._rf = None
        torch = sys.modules.get("torch")  # not imported: nothing records
        if torch is not None and torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(et, ev, tb)
        _tls.lane = self._prev
        STORE.record_phase(self.name, self.lane, self._t0, t1)
        return False


def phase(name: str, lane: str | None = None):
    """Time one phase of the EC plane's host work on this thread.

    `lane` names the scheduler lane the work serves ("encode",
    "reconstruct"); a phase without one takes the lane of the phase it
    runs inside on this thread, "-" outside any. A no-op when SWFS_TRACE
    turns tracing off."""
    if not enabled():
        return _NOOP_CTX
    return _Phase(name, lane)


def phase_intervals(name: str, lane: str, t0: float, t1: float
                    ) -> tuple[list[tuple[float, float]], bool]:
    """The recorded intervals of phase `name` on `lane` that overlap
    [t0, t1] (perf_counter seconds), oldest first, and whether the ring
    still holds every interval that ended at or after t0 (False once it
    has dropped one of them: the list is then incomplete)."""
    return STORE.phase_intervals(name, lane, t0, t1)


# -- the per-process span store --------------------------------------------


class TraceStore:
    """Bounded two-tier store: a ring of recent spans (every sampled
    span lands here; serves /debug/traces for just-finished requests)
    plus a FIFO-bounded map of RETAINED traces (pinned by error/slow
    spans; the ones histogram exemplars and incident debugging link
    to). All bounds are hard — tracing can be left on forever.

    Hot-path discipline: record() takes ONE lock, appends the Span
    OBJECT (the JSON dict is built lazily at read time), and counts
    into plain ints — the SeaweedFS_trace_* metric families PULL from
    here at scrape time instead of charging every span a metric lock.
    Phases (record_phase) take the same lock, add to plain per-(phase,
    lane) seconds that SeaweedFS_ec_phase_seconds pulls, and go to a
    ring of their own."""

    def __init__(self, ring_spans: int | None = None,
                 retain_traces: int | None = None,
                 phase_ring: int = PHASE_RING):
        if ring_spans is None:
            ring_spans = int(os.environ.get("SWFS_TRACE_BUF",
                                            str(DEFAULT_RING_SPANS)))
        if retain_traces is None:
            retain_traces = int(os.environ.get("SWFS_TRACE_RETAIN",
                                               str(DEFAULT_RETAIN_TRACES)))
        self._ring: deque = deque(maxlen=max(ring_spans, 16))
        self._retained: "OrderedDict[str, list[Span]]" = OrderedDict()
        self._retain_max = max(retain_traces, 4)
        self._lock = threading.Lock()
        self.recorded = 0
        self.retained_total = 0
        self._span_counts: dict[str, int] = {}       # by component
        self._retained_counts: dict[str, int] = {}   # by reason
        self._phases: deque = deque(maxlen=max(phase_ring, 16))
        self._phase_seconds: dict[tuple[str, str], float] = {}
        # the latest end of a phase interval the ring no longer holds
        self._phase_dropped_end = float("-inf")

    def record(self, sp: Span) -> None:
        pin = bool(sp.error) or sp.duration_ms >= slow_ms()
        with self._lock:
            self.recorded += 1
            comp = sp.component or "-"
            self._span_counts[comp] = self._span_counts.get(comp, 0) + 1
            self._ring.append(sp)
            spans = self._retained.get(sp.trace_id)
            if spans is not None:
                # trace already pinned: keep feeding it, but never past
                # the per-trace cap (the ring still holds the overflow
                # briefly, so a fresh dump sees the most recent spans)
                if len(spans) < RETAINED_TRACE_SPAN_CAP:
                    spans.append(sp)
                return
            if not pin:
                return
            # promote: pull the trace's earlier spans out of the ring
            # so the retained view is the whole tree seen so far
            self.retained_total += 1
            reason = "error" if sp.error else "slow"
            self._retained_counts[reason] = \
                self._retained_counts.get(reason, 0) + 1
            self._retained[sp.trace_id] = [
                s for s in self._ring if s.trace_id == sp.trace_id]
            while len(self._retained) > self._retain_max:
                self._retained.popitem(last=False)

    def record_phase(self, name: str, lane: str, t0: float,
                     t1: float) -> None:
        key = (name, lane)
        with self._lock:
            self._phase_seconds[key] = \
                self._phase_seconds.get(key, 0.0) + (t1 - t0)
            ring = self._phases
            if len(ring) == ring.maxlen:
                self._phase_dropped_end = max(self._phase_dropped_end,
                                              ring[0][3])
            ring.append((name, lane, t0, t1))

    def phase_seconds(self) -> dict[tuple[str, str], float]:
        """(phase, lane) -> seconds recorded (the
        SeaweedFS_ec_phase_seconds pull source)."""
        with self._lock:
            return dict(self._phase_seconds)

    def phase_intervals(self, name: str, lane: str, t0: float, t1: float
                        ) -> tuple[list[tuple[float, float]], bool]:
        with self._lock:
            held = list(self._phases)
            whole = self._phase_dropped_end < t0
        return ([(a, b) for n, ln, a, b in held
                 if n == name and ln == lane and b >= t0 and a <= t1],
                whole)

    def span_counts(self) -> dict[str, int]:
        """component -> spans recorded (the SeaweedFS_trace_spans pull
        source)."""
        with self._lock:
            return dict(self._span_counts)

    def retained_counts(self) -> dict[str, int]:
        """reason -> traces pinned (SeaweedFS_trace_retained_traces)."""
        with self._lock:
            return dict(self._retained_counts)

    def trace(self, trace_id: str) -> list[dict]:
        """Every span of one trace this process still holds (retained
        first, then un-pinned ring residents), deduped by span id."""
        with self._lock:
            spans = list(self._retained.get(trace_id, ()))
            seen = {s.span_id for s in spans}
            for s in self._ring:
                if s.trace_id == trace_id and s.span_id not in seen:
                    spans.append(s)
                    seen.add(s.span_id)
        out = [s.to_dict() for s in spans]
        out.sort(key=lambda s: s["startUnix"])
        return out

    def retained_summaries(self, limit: int = 64) -> list[dict]:
        with self._lock:
            items = [(tid, list(spans)) for tid, spans in
                     list(self._retained.items())[-limit:]]
        out = []
        for tid, spans in items:
            if not spans:
                continue
            root = min(spans, key=lambda s: s._t0)
            slowest = max(spans, key=lambda s: s.duration_ms)
            out.append({
                "traceId": tid, "spans": len(spans),
                "root": root.name, "server": root.server,
                "startUnix": round(root.start_unix, 6),
                "maxDurationMs": round(slowest.duration_ms, 3),
                "error": next((s.error for s in spans if s.error), ""),
            })
        out.sort(key=lambda s: s["startUnix"], reverse=True)
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": enabled(),
                "recordedSpans": self.recorded,
                "ringSpans": len(self._ring),
                "retainedTraces": len(self._retained),
                "retainedTotal": self.retained_total,
                "slowMs": slow_ms(),
                "sampleRate": sample_rate(),
            }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._retained.clear()
            for p in self._phases:
                self._phase_dropped_end = max(self._phase_dropped_end, p[3])
            self._phases.clear()


STORE = TraceStore()


def debug_traces_payload(query: dict | None = None) -> dict:
    """The `/debug/traces` JSON every server serves: one trace's spans
    with ?trace=<id>, else the retained summaries + store stats."""
    q = query or {}
    tid = q.get("trace", "")
    if tid:
        return {"traceId": tid, "spans": STORE.trace(tid)}
    return {"retained": STORE.retained_summaries(),
            "store": STORE.stats()}
