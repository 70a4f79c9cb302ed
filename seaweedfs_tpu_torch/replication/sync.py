"""Continuous filer->filer sync loop.

Counterpart of seaweedfs_tpu/replication/sync.py (SeaweedFS
weed/command/filer_sync.go): subscribe to the
source filer's metadata stream and replay events into the target cluster.
Events tagged is_from_other_cluster are skipped to break replication
loops, and the resume cursor is persisted in the target filer's KV store
(the reference stores its offset the same way).
"""

from __future__ import annotations

import threading

from ..pb import filer_pb2, rpc
from ..utils import glog
from .replicator import Replicator
from .sink import FilerSink
from .source import FilerSource


def _cursor_key(source: str, prefix: str) -> bytes:
    return f"sync.offset.{source}.{prefix}".encode()


class FilerSyncLoop:
    """One direction of `filer.sync` (run two for -isActiveActive)."""

    def __init__(self, source_filer: str, target_filer: str, *,
                 source_path: str = "/", target_path: str | None = None,
                 client_name: str = "filer.sync"):
        if target_path is None:
            target_path = source_path  # mirror to the same tree by default
        self.source_filer = source_filer
        self.target_filer = target_filer
        self.source_path = source_path
        self.client_name = client_name
        self.replicator = Replicator(
            FilerSource(source_filer),
            FilerSink(target_filer, directory=target_path),
            source_prefix=source_path)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._stream = None  # live gRPC subscription, for cancel-on-stop
        self.replicated = 0

    # -- offset persistence (filer_sync.go getOffset/setOffset) ------------

    @property
    def _target_stub(self):
        return rpc.filer_stub(rpc.grpc_address(self.target_filer))

    def load_cursor(self) -> int:
        resp = self._target_stub.KvGet(filer_pb2.KvGetRequest(
            key=_cursor_key(self.source_filer, self.source_path)),
            timeout=10)
        return int(resp.value.decode()) if resp.value else 0

    def save_cursor(self, ts_ns: int) -> None:
        self._target_stub.KvPut(filer_pb2.KvPutRequest(
            key=_cursor_key(self.source_filer, self.source_path),
            value=str(ts_ns).encode()), timeout=10)

    # -- loop --------------------------------------------------------------

    def run_once(self, since_ns: int | None = None,
                 drain_timeout: float | None = 2.0) -> int:
        """Replay available events once; returns new cursor. A finite
        drain_timeout bounds the tail-wait; None streams forever (the
        continuous loop), persisting the cursor after every replicated
        event so a crash resumes where it left off — with an infinite
        stream there is no "after the loop" to save at."""
        import grpc

        cursor = self.load_cursor() if since_ns is None else since_ns
        stub = rpc.filer_stub(rpc.grpc_address(self.source_filer))
        req = filer_pb2.SubscribeMetadataRequest(
            client_name=self.client_name, path_prefix=self.source_path,
            since_ns=cursor)
        stream = stub.SubscribeMetadata(req, timeout=drain_timeout)
        self._stream = stream  # stop() cancels it mid-wait
        if self._stop.is_set():
            # stop() may have checked _stream before we assigned it —
            # without this re-check an infinite stream would never die
            stream.cancel()
        continuous = drain_timeout is None
        try:
            for resp in stream:
                if self._stop.is_set():
                    break
                ev = resp.event_notification
                if ev.is_from_other_cluster:
                    cursor = resp.ts_ns
                    continue
                try:
                    if self.replicator.replicate(resp):
                        self.replicated += 1
                except Exception as e:
                    glog.error(f"filer.sync replicate @{resp.ts_ns}: {e}")
                    break
                cursor = resp.ts_ns
                if continuous:
                    self.save_cursor(cursor)
        except grpc.RpcError as e:
            # DEADLINE_EXCEEDED is the normal end of an until-idle drain;
            # CANCELLED is stop() tearing down the continuous stream
            if e.code() not in (grpc.StatusCode.DEADLINE_EXCEEDED,
                                grpc.StatusCode.CANCELLED):
                raise
        finally:
            self._stream = None
        self.save_cursor(cursor)
        return cursor

    def start(self) -> None:
        def loop():
            while not self._stop.is_set():
                try:
                    # stream forever: a finite drain would tear down and
                    # re-dial the subscription every couple of seconds even
                    # when fully caught up (the finite drain is for the
                    # one-shot/test path only)
                    self.run_once(drain_timeout=None)
                except Exception as e:
                    glog.v(1, f"filer.sync reconnect: {e}")
                self._stop.wait(0.5)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        stream = self._stream
        if stream is not None:
            stream.cancel()  # grpc's cancel of a finished call is a no-op
        if self._thread:
            self._thread.join(timeout=10)
