"""Keep-alive pooling HTTP(S) client for the cluster's internal legs
(counterpart of seaweedfs_tpu/wdclient/pool.py).

The replication fan-out and the upload legs would otherwise pay a fresh
TCP (and, under SWFS_HTTPS, a fresh TLS handshake) per request. This pool
replaces those per-request sockets with a process-wide, per-host bounded
pool of `http.client` connections:

  * bounded idle set per (scheme, host, port) — `SWFS_HTTP_POOL_SIZE`
    connections (default 8), excess returns close (evict);
  * idle reaping — a connection idle past `SWFS_HTTP_POOL_IDLE_S`
    (default 15s) is closed at next access instead of reused (volume
    servers are free to reap their side sooner; see stale retry);
  * stale-reuse retry — a POOLED connection failing before the response
    line arrives means the server reaped it while idle; the request is
    retried ONCE on a fresh connection (a fresh connection's failure is
    real and propagates);
  * metrics — `SeaweedFS_http_pool_ops` (hit/miss/expired/evict/
    stale_retry/disabled), `SeaweedFS_http_pool_open_connections`, and
    `SeaweedFS_tls_handshakes{role="client"}`.

`SWFS_HTTP_POOL=0` disables reuse (every request dials fresh) without
changing any call site.

Error surface: everything raised here is an OSError subtype (socket and
ssl errors raw, `http.client` protocol errors wrapped in
ConnectionError), so `utils.retry.is_retryable` classifies pool
failures exactly like the requests-based paths — including the fail-
fast ssl.SSLCertVerificationError when a peer's certificate is wrong.
"""

from __future__ import annotations

import http.client
import os
import ssl
import threading
import time
from collections import deque
from urllib.parse import urlsplit

from ..utils.locks import wlock
from ..utils.stats import HTTP_POOL_OPEN, HTTP_POOL_OPS, TLS_HANDSHAKES


class PoolResponse:
    """Fully-drained response (the internal legs move needle/chunk-sized
    bodies; draining is what makes the connection reusable)."""

    __slots__ = ("status", "headers", "data")

    def __init__(self, status: int, headers, data: bytes):
        self.status = status
        self.headers = headers
        self.data = data

    def getheader(self, name: str, default=None):
        return self.headers.get(name, default)

    @property
    def text(self) -> str:
        return self.data.decode(errors="replace")

    def json(self):
        import json as _json

        return _json.loads(self.data)


def _pool_size() -> int:
    return int(os.environ.get("SWFS_HTTP_POOL_SIZE", "8") or 8)


def _idle_ttl() -> float:
    return float(os.environ.get("SWFS_HTTP_POOL_IDLE_S", "15") or 15)


def pooling_enabled() -> bool:
    return (os.environ.get("SWFS_HTTP_POOL", "1") or "1").lower() \
        not in ("0", "false", "off")


def max_per_host() -> int:
    """Warm connections the pool will keep per (scheme, host, port): the
    bound a pipelined fan-out clamps its windows to, so one streaming
    request can never sweep every warm connection to a volume server."""
    return max(1, _pool_size())


class HttpPool:
    def __init__(self):
        self._idle: dict[tuple, deque] = {}
        self._open = 0  # idle connections currently pooled
        # witnessed leaf lock: guards the idle map only —
        # no request IO ever runs under it
        self._lock = wlock("pool.mu", rank=850)
        self._ctx: ssl.SSLContext | None = None
        self._ctx_key: tuple | None = None

    # -- TLS client context, cached per env fingerprint --------------------

    def _client_ctx(self) -> ssl.SSLContext | None:
        key = (os.environ.get("SWFS_HTTPS", ""),
               os.environ.get("SWFS_HTTPS_CA", ""))
        with self._lock:
            if self._ctx_key == key:
                return self._ctx
        from ..security.tls import load_http_client_context

        ctx = load_http_client_context()
        with self._lock:
            self._ctx, self._ctx_key = ctx, key
        return ctx

    # -- connection lifecycle ----------------------------------------------

    def _new_conn(self, scheme: str, host: str, port: int, timeout: float):
        if scheme == "https":
            ctx = self._client_ctx()
            if ctx is None:  # https:// URL with the gate off: still dial
                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            conn = http.client.HTTPSConnection(host, port, timeout=timeout,
                                               context=ctx)
            # connect eagerly so the counter records COMPLETED
            # handshakes only — a refused dial or a failed handshake
            # (e.g. every attempt during a tls-flap restart window)
            # must not inflate the A/B's amortization numbers
            conn.connect()
            TLS_HANDSHAKES.inc(role="client")
        else:
            conn = http.client.HTTPConnection(host, port, timeout=timeout)
        return conn

    def _checkout(self, key: tuple, timeout: float):
        """-> (conn, from_pool). Reaps expired idle connections."""
        if not pooling_enabled():
            HTTP_POOL_OPS.inc(result="disabled")
            return self._new_conn(*key, timeout), False
        cut = time.monotonic() - _idle_ttl()
        with self._lock:
            dq = self._idle.get(key)
            while dq:
                conn, t = dq.pop()  # LIFO: hottest connection first
                self._open -= 1
                if t < cut:
                    HTTP_POOL_OPS.inc(result="expired")
                    try:
                        conn.close()
                    except OSError:
                        pass
                    continue
                HTTP_POOL_OPS.inc(result="hit")
                HTTP_POOL_OPEN.set(self._open)
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
                return conn, True
        HTTP_POOL_OPS.inc(result="miss")
        HTTP_POOL_OPEN.set(self._open)
        return self._new_conn(*key, timeout), False

    def _checkin(self, key: tuple, conn) -> None:
        if not pooling_enabled():
            conn.close()
            return
        with self._lock:
            dq = self._idle.setdefault(key, deque())
            if len(dq) >= _pool_size():
                HTTP_POOL_OPS.inc(result="evict")
                try:
                    conn.close()
                except OSError:
                    pass
                return
            dq.append((conn, time.monotonic()))
            self._open += 1
            HTTP_POOL_OPEN.set(self._open)

    def clear(self) -> None:
        """Close every idle connection (tests / env flips)."""
        with self._lock:
            for dq in self._idle.values():
                for conn, _ in dq:
                    try:
                        conn.close()
                    except OSError:
                        pass
                dq.clear()
            self._open = 0
            HTTP_POOL_OPEN.set(0)

    # -- the request -------------------------------------------------------

    def request(self, method: str, url: str, body=None, headers=None,
                timeout: float = 30.0) -> PoolResponse:
        # follow same-method redirects, as the requests-based callers do
        for _ in range(4):
            resp = self._request_once(method, url, body, headers, timeout)
            if resp.status in (301, 302, 307, 308):
                loc = resp.getheader("Location")
                if loc:
                    url = loc
                    continue
            return resp
        return resp

    def _request_once(self, method: str, url: str, body, headers,
                      timeout: float) -> PoolResponse:
        u = urlsplit(url)
        scheme = u.scheme or "http"
        host = u.hostname or "localhost"
        port = u.port or (443 if scheme == "https" else 80)
        key = (scheme, host, port)
        target = (u.path or "/") + (f"?{u.query}" if u.query else "")
        hdrs = dict(headers or {})
        # advertise gzip like requests did (the volume plane serves
        # compressed needles verbatim to gzip-capable clients) and
        # transparently decode below
        hdrs.setdefault("Accept-Encoding", "gzip")
        for attempt in (0, 1):
            if attempt:
                # the retry dials FRESH: with several idle connections
                # to a restarted server, a second checkout could hand
                # back another reaped socket and turn benign server-side
                # reaping into a client-visible error
                conn, pooled = self._new_conn(*key, timeout), False
            else:
                conn, pooled = self._checkout(key, timeout)
            try:
                conn.request(method, target, body=body, headers=hdrs)
                resp = conn.getresponse()
            except ssl.SSLCertVerificationError:
                conn.close()
                raise  # a trust decision — never retried, even off-pool
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                # only connection-DEATH shapes BEFORE the response line
                # qualify as "the server reaped this idle connection":
                # a timeout (or any other failure) on a pooled socket
                # may mean the request was already received and
                # processed — replaying it would double the wait and
                # re-apply the operation
                reaped = isinstance(
                    e, (ConnectionResetError, BrokenPipeError,
                        ConnectionAbortedError,
                        http.client.RemoteDisconnected)
                ) and not isinstance(e, TimeoutError)
                if pooled and attempt == 0 and reaped:
                    HTTP_POOL_OPS.inc(result="stale_retry")
                    continue
                if isinstance(e, OSError):
                    raise
                raise ConnectionError(f"{type(e).__name__}: {e}") from e
            try:
                data = resp.read()
            except (OSError, http.client.HTTPException) as e:
                # the status line arrived, so the server definitely
                # processed the request — a mid-body failure must
                # surface, never replay
                conn.close()
                if isinstance(e, OSError):
                    raise
                raise ConnectionError(f"{type(e).__name__}: {e}") from e
            if resp.will_close:
                conn.close()
            else:
                self._checkin(key, conn)
            if (resp.headers.get("Content-Encoding") or "").lower() \
                    == "gzip" and data:
                import gzip as _gz

                data = _gz.decompress(data)  # requests-compatible
            return PoolResponse(resp.status, resp.headers, data)
        raise ConnectionError(f"{method} {url}: retry loop exhausted")

    def get(self, url: str, headers=None, timeout: float = 30.0):
        return self.request("GET", url, headers=headers, timeout=timeout)

    def put(self, url: str, body=b"", headers=None, timeout: float = 30.0):
        return self.request("PUT", url, body=body, headers=headers,
                            timeout=timeout)

    def delete(self, url: str, headers=None, timeout: float = 30.0):
        return self.request("DELETE", url, headers=headers,
                            timeout=timeout)


#: Process-wide pool: every internal data leg shares connection economics
#: (and the metrics tell one coherent story per process).
POOL = HttpPool()

request = POOL.request
get = POOL.get
put = POOL.put
delete = POOL.delete
