"""Filer peer metadata aggregation.

Counterpart of seaweedfs_tpu/filer/meta_aggregator.py (SeaweedFS
weed/filer/meta_aggregator.go). In a multi-filer deployment every filer subscribes to its peers' local metadata streams and
folds those events into its own event log, so any single filer can serve a
cluster-wide SubscribeMetadata. Events are tagged with the originating
filer's signature; a filer skips events carrying its own signature to
avoid loops (MaybeBootstrapFromPeers handles initial catch-up via the
persisted log — here the peer stream replays from since_ns=0 on first
connect, which covers bootstrap for in-memory logs).
"""

from __future__ import annotations

import threading

from ..pb import filer_pb2, rpc
from ..utils import glog
from ..utils.retry import Backoff
from ..utils.stats import META_AGGREGATOR_RECONNECTS


class MetaAggregator:
    def __init__(self, filer, self_signature: int, *,
                 client_name: str = "filer-peer"):
        self.filer = filer
        self.signature = self_signature
        self.client_name = client_name
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.peer_counts: dict[str, int] = {}

    def subscribe_to_peer(self, peer_grpc_address: str,
                          since_ns: int = 0) -> None:
        self.peer_counts[peer_grpc_address] = 0

        def run():
            cursor = since_ns
            # a down peer answers every dial attempt instantly with
            # UNAVAILABLE, so a fixed 0.5s pause was a 2 Hz reconnect
            # hammer per peer; exponential backoff with jitter (the
            # utils/retry discipline every other reconnect loop rides)
            # caps the retry rate while the counted metric keeps the
            # flapping visible
            bo = Backoff()
            while not self._stop.is_set():
                try:
                    stub = rpc.filer_stub(peer_grpc_address)
                    req = filer_pb2.SubscribeMetadataRequest(
                        client_name=self.client_name,
                        path_prefix="/", since_ns=cursor,
                        signature=self.signature)
                    for resp in stub.SubscribeLocalMetadata(req):
                        if self._stop.is_set():
                            return
                        cursor = max(cursor, resp.ts_ns)
                        bo = Backoff()  # events flowing = peer healthy
                        if self.signature in \
                                resp.event_notification.signatures:
                            continue  # our own event echoed back
                        self._fold(resp)
                        self.peer_counts[peer_grpc_address] += 1
                except Exception as e:
                    glog.v(2, f"meta aggregator {peer_grpc_address}: {e}")
                    META_AGGREGATOR_RECONNECTS.inc(peer=peer_grpc_address)
                    if self._stop.wait(bo.next_wait()):
                        return

        t = threading.Thread(target=run, daemon=True)
        t.start()
        self._threads.append(t)

    def _fold(self, resp: filer_pb2.SubscribeMetadataResponse) -> None:
        """Append a peer event to the local log (and only the log — the
        peer owns the store mutation) so local subscribers see it."""
        import time

        copied = filer_pb2.SubscribeMetadataResponse()
        copied.CopyFrom(resp)
        if self.signature not in copied.event_notification.signatures:
            copied.event_notification.signatures.append(self.signature)
        # re-stamp with LOCAL arrival time: subscribers cursor this log by
        # max ts, so keeping the peer's (older) ts would let an event that
        # propagated slowly land behind an already-consumed cursor
        copied.ts_ns = time.time_ns()
        with self.filer._log_cond:
            self.filer._log.append(copied)
            self.filer._log_cond.notify_all()

    def close(self) -> None:
        self._stop.set()
