"""Shared HTTP server base for every gateway/server in the package.

One tuning matters enormously for the data plane: TCP_NODELAY on accepted
sockets. BaseHTTPRequestHandler writes status line, headers, and body as
separate send()s; with Nagle on, a keepalive connection alternates between
a Nagle-delayed small write and the peer's delayed ACK, stalling ~40ms per
request (measured: 44ms/GET with a requests.Session vs 1.4ms with fresh
connections). The reference's Go net/http sets TCP_NODELAY by default, so
its keepalive path never hits this.

HTTPS: pass an ``ssl.SSLContext`` and every accepted socket is
wrapped — with the handshake running in the per-connection worker thread,
NOT the accept loop, so one client stalling mid-handshake can never stop
the listener from accepting the next connection. Handshake failures
(port scans, protocol probes, a client rejecting our certificate) close
quietly; each completed handshake increments
``SeaweedFS_tls_handshakes{role="server"}``, the counter the harness
reads to measure keep-alive handshake amortization.
"""

from __future__ import annotations

import socket
import ssl
from http.server import ThreadingHTTPServer


class TunedThreadingHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, server_address, RequestHandlerClass,
                 ssl_context: ssl.SSLContext | None = None):
        self.ssl_context = ssl_context
        super().__init__(server_address, RequestHandlerClass)

    @property
    def scheme(self) -> str:
        return "https" if self.ssl_context is not None else "http"

    def process_request(self, request, client_address):
        try:
            request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        super().process_request(request, client_address)

    def process_request_thread(self, request, client_address):
        if self.ssl_context is not None:
            try:
                request = self.ssl_context.wrap_socket(request,
                                                       server_side=True)
            except (OSError, ssl.SSLError):
                # handshake failed: not an HTTP request we can answer
                try:
                    request.close()
                except OSError:
                    pass
                return
            from .stats import TLS_HANDSHAKES

            TLS_HANDSHAKES.inc(role="server")
        super().process_request_thread(request, client_address)
