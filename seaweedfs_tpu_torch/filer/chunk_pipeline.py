"""Pipelined chunk engine: bounded-window GET readahead +
overlapped PUT upload fan-out.

Counterpart of seaweedfs_tpu/filer/chunk_pipeline.py.

The filer's chunk data path — the leg every S3/HTTP byte actually
crosses — was strictly sequential: `stream_file` issued one volume
round-trip at a time, and `write_stream` fully uploaded chunk N before
reading chunk N+1 from the client. For a multi-chunk object the wall
was Σ(RTT + transfer) when overlap makes it ~max(transfer, RTT) — the
RapidRAID (arXiv:1207.6744) argument applied to archival encode,
now applied to the foreground GET/PUT legs.

Both directions share one engine over the process-wide fan-out
executor (`utils.fanout`):

  * **GET** — `readahead(views, fetch)` yields `fetch(view)` results
    STRICTLY IN ORDER while prefetching up to `READAHEAD_WINDOW` (4)
    upcoming views, bounded by `READAHEAD_CAP_MB` (32) in-flight bytes. Closing the generator (client
    disconnect mid-stream) cancels queued prefetches; already-running
    fetches complete harmlessly and are dropped.
  * **PUT** — `UploadWindow` keeps up to `READAHEAD_WINDOW`
    `save_chunk` uploads in flight while
    the caller keeps reading the client body. md5/offset accounting
    stays strictly ordered because the CALLER still reads
    sequentially; only the uploads overlap. The first failure cancels
    the window and `saved_fids()` hands back every chunk that made it
    to a volume server so the caller can GC them — exactly the
    sequential path's failure contract.

Pressure awareness: both windows consult `qos.pressure.SIGNAL` per
step and collapse to 1 (sequential) while the process has recently
observed shedding (tenant admission rejection, volume-server 429/503)
or strain (a chunk read forced onto the failover ladder) — prefetch
fan-out must not multiply load on a cluster that is already hot.
Pool awareness: windows are clamped to the wdclient keep-alive pool's
per-host size (`SWFS_HTTP_POOL_SIZE`) so a single streaming request
can never sweep every warm connection.

`SWFS_CHUNK_PIPELINE=0` disables both directions (the A/B OFF arm)
without touching any call site. The switch is TTL-cached like
utils.trace; tests flipping the env mid-process call `refresh_config()`.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, wait

from ..qos.pressure import SIGNAL
from ..utils import fanout
from ..utils.stats import (
    CHUNK_PIPELINE_BYTES,
    CHUNK_PIPELINE_INFLIGHT,
    CHUNK_PIPELINE_OPS,
)

_CFG_TTL_S = 1.0
_cfg = {"t": -1.0, "enabled": True}
READAHEAD_WINDOW = 4  # chunk fetches (GET) or uploads (PUT) in flight
READAHEAD_CAP_MB = 32  # in-flight GET bytes
_cfg_lock = threading.Lock()


class ShortBodyError(IOError):
    """A PUT with a known Content-Length whose client body ended short.
    Committing the entry would silently truncate the object; the saved
    chunks are GC'd and the HTTP/S3 handlers map this to a 4xx (the
    client failed, not the cluster)."""

    def __init__(self, got: int, want: int):
        self.got = got
        self.want = want
        super().__init__(
            f"short body: read {got} of {want} declared bytes")


def _config() -> dict:
    c = _cfg
    now = time.monotonic()
    if now - c["t"] > _CFG_TTL_S:
        with _cfg_lock:
            c["enabled"] = (os.environ.get("SWFS_CHUNK_PIPELINE", "1")
                            or "1").lower() not in ("0", "false", "off")
            c["t"] = now
    return c


def refresh_config() -> None:
    """Drop the cached switch (tests flip the env mid-process)."""
    _cfg["t"] = -1.0


def _pool_clamp(w: int) -> int:
    """Never fan wider than the keep-alive pool keeps warm connections
    per host — beyond that every extra in-flight fetch dials cold and
    evicts someone else's warm connection at check-in."""
    from ..wdclient.pool import max_per_host

    return max(1, min(w, max_per_host()))


def _effective_get_window(n_items: int) -> tuple[int, bool]:
    """-> (window, collapsed-by-hot-signal). Pure — no metrics."""
    cfg = _config()
    if not cfg["enabled"] or n_items < 2:
        return 1, False
    if SIGNAL.is_hot():
        return 1, True
    return _pool_clamp(READAHEAD_WINDOW), False


def _effective_put_window() -> tuple[int, bool]:
    cfg = _config()
    if not cfg["enabled"]:
        return 1, False
    if SIGNAL.is_hot():
        return 1, True
    return _pool_clamp(READAHEAD_WINDOW), False


def get_window(n_items: int) -> int:
    """Effective readahead window for a GET of `n_items` chunk views
    (1 = the sequential path). A hot-signal collapse is counted ONCE
    per call — product code calls this once per request (stream_file);
    the per-yield re-evaluation inside `readahead` counts transitions,
    not polls."""
    w, hot = _effective_get_window(n_items)
    if hot:
        CHUNK_PIPELINE_OPS.inc(direction="get", result="collapsed")
    return w


def put_window() -> int:
    """Effective upload-overlap window for a PUT (1 = sequential).
    Pure — UploadWindow does its own transition-counted collapse
    accounting (its wait loop polls this every spin)."""
    return _effective_put_window()[0]


# -- GET: bounded-window in-order readahead ---------------------------------


def readahead(items, fetch, *, direction: str = "get", span=None):
    """Generator yielding `fetch(item)` for every item STRICTLY in
    order, prefetching ahead on the shared fan-out executor.

    * the window is re-evaluated every step: a hot signal mid-stream
      degrades the remaining reads to sequential (and back);
    * in-flight bytes (by each item's `.size`, when present) are capped
      so a wide window of 4MB chunks cannot hold tens of MB hostage;
    * closing the generator cancels queued prefetches — a client
      disconnect must not fetch the rest of a large object;
    * the first fetch failure cancels the window and re-raises in
      order, exactly where the sequential loop would have raised.

    `span` (the request's active span, optional) gets per-yield
    `readaheadHit`/`inflight` attributes plus final totals — the
    answer to "did the prefetcher actually stay ahead?".
    """
    items = list(items)
    n = len(items)
    pending: deque = deque()  # (item, future), submit order == item order
    next_i = 0
    inflight_bytes = 0
    hits = waits = 0
    collapsed = False  # hot-signal transition flag (count events, not polls)
    gauge_dir = direction

    def _size(it) -> int:
        return int(getattr(it, "size", 0) or 0)

    def _run(it):
        CHUNK_PIPELINE_INFLIGHT.inc(direction=gauge_dir)
        try:
            return fetch(it)
        finally:
            CHUNK_PIPELINE_INFLIGHT.dec(direction=gauge_dir)

    def _pump():
        nonlocal next_i, inflight_bytes, collapsed
        target, hot = _effective_get_window(n)
        if hot and not collapsed:
            CHUNK_PIPELINE_OPS.inc(direction=gauge_dir, result="collapsed")
        collapsed = hot
        while next_i < n and len(pending) < target and (
                not pending
                or inflight_bytes + _size(items[next_i])
                <= READAHEAD_CAP_MB << 20):
            it = items[next_i]
            next_i += 1
            inflight_bytes += _size(it)
            CHUNK_PIPELINE_OPS.inc(direction=gauge_dir, result="launched")
            pending.append((it, fanout.submit(_run, it)))

    try:
        _pump()
        while pending:
            it, fut = pending.popleft()
            hit = fut.done()
            if hit:
                hits += 1
                CHUNK_PIPELINE_OPS.inc(direction=gauge_dir,
                                       result="prefetch_hit")
            else:
                waits += 1
                CHUNK_PIPELINE_OPS.inc(direction=gauge_dir,
                                       result="prefetch_wait")
            try:
                data = fut.result()
            except BaseException:
                # in-order failure surface: everything queued behind
                # the failing chunk is moot
                _cancel(pending, gauge_dir)
                raise
            inflight_bytes -= _size(it)
            CHUNK_PIPELINE_BYTES.inc(len(data) if data is not None else 0,
                                     direction=gauge_dir)
            if span is not None:
                span.set_attr(readaheadHit=hit, inflight=len(pending))
            _pump()  # refill BEFORE yielding: the consumer's socket
            #          write happens while the window stays full
            yield data
    except GeneratorExit:
        _cancel(pending, gauge_dir)
        raise
    finally:
        if span is not None and (hits or waits):
            span.set_attr(readaheadHits=hits, readaheadWaits=waits)


def _cancel(pending, direction: str) -> None:
    """Abandon every queued prefetch: futures not yet started are
    cancelled outright; already-running ones complete harmlessly and
    are dropped. Both count as `cancelled` — the consumer walked away
    from that many chunks mid-window."""
    for _it, fut in pending:
        fut.cancel()
        CHUNK_PIPELINE_OPS.inc(direction=direction, result="cancelled")
    pending.clear()


# -- PUT: overlapped upload fan-out -----------------------------------------


class UploadWindow:
    """Up to W concurrent `save_fn(data)` calls while the caller keeps
    reading the client body. Submit order is chunk order; `finish()`
    resolves in that order and stamps offsets, so the entry's chunk
    list is byte-identical to the sequential path's."""

    def __init__(self, save_fn):
        self._save = save_fn
        self._slots: list = []  # (future, offset, nbytes) in submit order
        self._failed: BaseException | None = None
        self._collapsed = False  # hot-signal transition flag

    def _raise_if_failed(self) -> None:
        if self._failed is not None:
            raise self._failed
        for fut, _off, _nb in self._slots:
            if fut.done() and not fut.cancelled():
                exc = fut.exception()
                if exc is not None:
                    self._failed = exc
                    raise exc

    def add(self, data: bytes, offset: int) -> None:
        """Queue one chunk upload; blocks while the window is full.
        Raises the FIRST upload failure as soon as it is visible — the
        caller stops reading the body instead of buffering a doomed
        request to completion."""
        self._raise_if_failed()
        while True:
            target, hot = _effective_put_window()
            if hot and not self._collapsed:
                CHUNK_PIPELINE_OPS.inc(direction="put",
                                       result="collapsed")
            self._collapsed = hot
            live = [f for f, _o, _n in self._slots if not f.done()]
            if len(live) < target:
                break
            wait(live, return_when=FIRST_COMPLETED)
            self._raise_if_failed()

        def _run(payload=data):
            CHUNK_PIPELINE_INFLIGHT.inc(direction="put")
            try:
                return self._save(payload)
            finally:
                CHUNK_PIPELINE_INFLIGHT.dec(direction="put")

        CHUNK_PIPELINE_OPS.inc(direction="put", result="launched")
        self._slots.append((fanout.submit(_run), offset, len(data)))

    def finish(self) -> list:
        """-> the ordered chunk list with offsets stamped. Raises the
        first failure (after letting every in-flight upload settle)."""
        chunks = []
        err: BaseException | None = self._failed
        for fut, off, nbytes in self._slots:
            try:
                c = fut.result()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                if err is None:
                    err = e
                continue
            if err is None:
                c.offset = off
                chunks.append(c)
                CHUNK_PIPELINE_BYTES.inc(nbytes, direction="put")
        if err is not None:
            self._failed = err
            raise err
        return chunks

    def saved_fids(self) -> list[str]:
        """Every chunk that actually landed on a volume server — the GC
        list after a failure. Waits for in-flight uploads to settle
        first: a chunk completing AFTER the failure must not leak."""
        CHUNK_PIPELINE_OPS.inc(direction="put", result="aborted")
        fids = []
        for fut, _off, _nb in self._slots:
            try:
                c = fut.result()
            # lint: allow-broad-except(a failed upload left no chunk to
            # collect; the failure itself is raised by finish())
            except BaseException:  # noqa: BLE001
                continue
            fids.append(c.file_id)
        return fids
