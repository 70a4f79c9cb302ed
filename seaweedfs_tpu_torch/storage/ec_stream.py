"""Streaming replica->EC conversion: per-destination shard-slab sinks.

Counterpart of seaweedfs_tpu/storage/ec_stream.py, the same names and
the same bytes on the wire. The classic archival flow is three serial
phases (encode every shard locally with `ec_files.generate_ec_files`,
THEN ship completed shard files with `VolumeEcShardsCopy`, THEN mount), so
the network idles during the encode and the encode idles during the
transfer. RapidRAID (arXiv:1207.6744) shows that a pipelined archival
encode cuts insertion time by overlapping coding with transfer.

This module is the overlap point: `generate_ec_files` takes a shard-sink
hook (`sinks=`), and an `EcStreamSinkSet` of `EcStreamDestination`s is
its network implementation. Every slab the encode pipeline has on the
host (data rows before the parity is waited for, parity rows once it is
copied back from the card) is pushed onto a bounded per-destination
queue and streamed to its destination server (`VolumeEcShardsStream`,
pb/ec_stream_pb2.py) by a sender thread while the product of the NEXT
slab runs on the card. Local shard files are still written (the source
keeps its own shards and they are the resume source), so the bytes are
identical to the generate-then-copy path by construction, and
test-pinned anyway.

Digests: every slab's crc32c is recorded at put() time; at commit the
whole-shard digests are folded from those slab CRCs with
`crc32c_combine` (storage/crc.py), with no second read of any shard
file on the happy path. The destination chains its own digest as slabs
land, verifies the commit fold, and persists the `.dig` manifest.

Resume: a destination flap mid-stream marks the sink failed; the encode
pipeline keeps running at full speed (puts become record-only). After
the encode completes, `finish()` asks the destination how many
contiguous bytes of each shard it holds (`VolumeEcShardsStreamStatus`)
and re-streams ONLY the missing ranges, read back from the local shard
files: never re-encoded, never re-sending completed slabs. The chaos
failpoint site `ec.stream.slab` (matchable per shard and per offset)
lives in the destination's handler (server/volume.py).
"""

from __future__ import annotations

import queue
import threading
import time

from ..pb import ec_stream_pb2 as es
from ..utils import glog
from ..utils.stats import (
    EC_STREAM_BYTES,
    EC_STREAM_INFLIGHT_BYTES,
    EC_STREAM_RESUMES,
    EC_STREAM_SECONDS,
    EC_STREAM_SLABS,
    EC_STREAM_STREAMS,
)
from .crc import crc32c, crc32c_combine

# slabs buffered per destination before the encode coordinator blocks
# (backpressure: the pipeline advances at min(encode, slowest live wire))
DEFAULT_QUEUE_SLABS = 8
# resume/catch-up chunk when re-reading missing ranges from local files
DEFAULT_RESUME_CHUNK = 1 << 20
# consecutive same-shard slabs coalesce into wire chunks of this size
# before hitting the queue: the encoder's small-row slabs can be tiny
# (64KB at production geometry), and per-message proto+gRPC overhead on
# hundreds of them costs more than the bytes. 2MB = BUFFER_SIZE_LIMIT,
# the exact chunking of the VolumeEcShardsCopy path it replaces.
DEFAULT_WIRE_CHUNK = 2 * 1024 * 1024
# attempts of the resume (status, then re-send of the missing ranges)
# before the destination falls back to VolumeEcShardsCopy
DEFAULT_RESUME_ATTEMPTS = 4


def fold_slab_crcs(records: list[tuple[int, int, int]]) -> tuple[int, int]:
    """(whole_crc, total_len) from in-offset-order (offset, crc, n)
    slab records via the GF(2) combine — the out-of-order-safe fold the
    scrub plane uses (digest.ec_shard_crcs(slab_crcs=...))."""
    crc = 0
    total = 0
    for _off, c, n in sorted(records):
        crc = crc32c_combine(crc, c, n)
        total += n
    return crc, total


class EcStreamDestination:
    """Streams one destination's shard slabs while the encode runs.

    Thread model: the encode coordinator calls put() (single producer);
    a dedicated sender thread feeds the gRPC client-stream. On any
    transport failure the sink degrades to record-only and the missing
    ranges are re-sent from local shard files in finish()."""

    def __init__(self, address: str, vid: int, collection: str,
                 shard_ids: list[int], base_file_name: str, geo,
                 shard_size: int, source: str = ""):
        self.address = address
        self.vid = vid
        self.collection = collection
        self.shard_ids = sorted(set(shard_ids))
        self.base = base_file_name
        self.geo = geo
        self.shard_size = shard_size
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=DEFAULT_QUEUE_SLABS)
        # per-shard in-offset-order (offset, crc, nbytes) — complete over
        # the WHOLE encode regardless of transport failures, so the
        # commit digests never need a second read
        self._slabs: dict[int, list[tuple[int, int, int]]] = {
            sid: [] for sid in self.shard_ids}
        self._fold_cache: dict[int, tuple[int, int, int]] = {}
        # per-shard wire-chunk coalescing: [start_offset, bytearray]
        self._pending: dict[int, list] = {}
        self._chunk = DEFAULT_WIRE_CHUNK
        self._failed: BaseException | None = None
        self._committed = False
        self._thread: threading.Thread | None = None
        self.bytes_streamed = 0
        self.resumed_bytes = 0
        self.resumes = 0
        self.error = ""
        # trace parent captured at CONSTRUCTION (the generate handler's
        # span): finish() runs in a thread-pool worker with no TLS
        # context, but its sink work still belongs to that trace
        from ..utils import trace as _trace

        self._trace_parent = _trace.current_context()

    # -- producer side (encode coordinator) --------------------------------

    def put(self, shard_id: int, offset: int, data: bytes) -> None:
        """Record + queue one slab for this destination. The slab's crc
        is recorded unconditionally (the commit digests fold from these
        records); the bytes coalesce with neighbouring same-shard slabs
        into wire chunks. Once the sink has failed, puts are record-only
        — finish() re-reads the missing range from the local shard file
        instead."""
        if shard_id not in self._slabs:
            return
        self._slabs[shard_id].append((offset, crc32c(data), len(data)))
        if self._failed is not None:
            return
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run_live, daemon=True,
                name=f"ec-stream-{self.address}")
            self._thread.start()
        pend = self._pending.get(shard_id)
        if pend is None:
            pend = self._pending[shard_id] = [offset, bytearray()]
        pend[1] += data  # slabs per shard arrive in offset order
        if len(pend[1]) >= self._chunk or (
                2 * len(pend[1]) >= self._chunk and self._q.empty()):
            # full chunk — or the wire is idle and at least half of one
            # is pending: keep the sender busy instead of letting tail
            # bytes pool until finish() (post-encode serial time). The
            # half-chunk floor matters on latency-bound wires, where a
            # flurry of small messages pays per-message RTT and backs
            # the queue up into the encode (backpressure).
            self._flush_pending(shard_id)

    def _flush_pending(self, shard_id: int | None = None) -> None:
        sids = [shard_id] if shard_id is not None else list(self._pending)
        for sid in sids:
            pend = self._pending.pop(sid, None)
            if pend is None or not pend[1] or self._failed is not None:
                continue
            start, buf = pend[0], bytes(pend[1])
            EC_STREAM_INFLIGHT_BYTES.inc(len(buf))
            while True:
                try:
                    self._q.put((sid, start, buf, crc32c(buf)),
                                timeout=0.5)
                    break
                except queue.Full:
                    if self._failed is not None:
                        EC_STREAM_INFLIGHT_BYTES.dec(len(buf))
                        break

    # -- live stream --------------------------------------------------------

    def _request_messages(self):
        yield es.VolumeEcShardsStreamRequest(header=es.EcStreamHeader(
            volume_id=self.vid, collection=self.collection,
            shard_ids=self.shard_ids, shard_size=self.shard_size,
            resume=False, source=self.source))
        while True:
            try:
                item = self._q.get(timeout=0.5)
            except queue.Empty:
                if self._failed is not None:
                    return  # the call died; stop feeding its iterator
                continue
            if item is None:
                break
            sid, off, data, crc = item
            # off the queue, so out of flight: counted down before the
            # yield, which never returns when the call dies there (_drain
            # sees only the slabs still queued)
            EC_STREAM_INFLIGHT_BYTES.dec(len(data))
            yield es.VolumeEcShardsStreamRequest(slab=es.EcStreamSlab(
                shard_id=sid, offset=off, data=data, crc=crc))
            self.bytes_streamed += len(data)
            EC_STREAM_BYTES.inc(len(data), role="source", phase="live")
            EC_STREAM_SLABS.inc(role="source", phase="live")
        if self._failed is not None:
            # abort() also enqueues the sentinel — never commit then:
            # the partial digests WOULD match the truncated bytes the
            # destination holds, committing a half-streamed shard set
            # as valid (the encode itself failed; nothing is complete)
            return
        yield es.VolumeEcShardsStreamRequest(commit=self._commit_message())

    def _folded(self, sid: int) -> tuple[int, int]:
        """(crc, size) fold of a shard's slab records, memoized while
        the record list is stable (commit + verify fold the same list)."""
        records = self._slabs[sid]
        hit = self._fold_cache.get(sid)
        if hit is not None and hit[0] == len(records):
            return hit[1], hit[2]
        crc, total = fold_slab_crcs(records)
        self._fold_cache[sid] = (len(records), crc, total)
        return crc, total

    def _commit_message(self):
        commit = es.EcStreamCommit()
        for sid in self.shard_ids:
            crc, total = self._folded(sid)
            commit.digests.add(shard_id=sid, crc=crc, size=total)
        return commit

    def _run_live(self) -> None:
        from ..pb import rpc
        from ..utils import numa

        # feeder thread of the streamed encode: NUMA-pinned (gated by
        # SWFS_EC_DISPATCH_PIN) so wire-chunk assembly reads slab bytes
        # from local memory; a no-op when the gate is closed
        numa.pin_thread()
        t0 = time.perf_counter()
        try:
            stub = rpc.volume_stub(rpc.grpc_address(self.address))
            resp = stub.VolumeEcShardsStream(self._request_messages(),
                                             timeout=24 * 3600)
            self._verify_response(resp)
            self._committed = True
        except BaseException as e:  # noqa: BLE001 — recorded, resumed later
            self._failed = e
            glog.v(1, f"ec stream to {self.address} failed live "
                      f"({type(e).__name__}: {e}); will resume from "
                      f"local shard files")
        finally:
            EC_STREAM_SECONDS.inc(time.perf_counter() - t0,
                                  peer=self.address)
            if self._failed is not None:
                self._drain()

    def _drain(self) -> None:
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                EC_STREAM_INFLIGHT_BYTES.dec(len(item[2]))

    def _verify_response(self, resp) -> None:
        got = {d.shard_id: (d.crc, d.size) for d in resp.shards}
        for sid in self.shard_ids:
            crc, total = self._folded(sid)
            if got.get(sid) != (crc, total):
                raise IOError(
                    f"ec stream to {self.address}: shard {sid} digest "
                    f"mismatch (want crc={crc:#x} size={total}, "
                    f"destination reports {got.get(sid)})")

    # -- completion / resume ------------------------------------------------

    def finish(self) -> None:
        """Close the live stream, then re-send whatever the destination is
        missing (only the missing byte ranges, read back from the local
        shard files). Raises on unrecoverable failure; the caller turns
        that into a per-target fallback."""
        from ..utils import trace as _trace

        with _trace.span("ec.stream.finish", parent=self._trace_parent,
                         child_only=True, peer=self.address,
                         vid=self.vid) as tsp:
            self._finish_traced(tsp)

    def _finish_traced(self, tsp) -> None:
        t = self._thread
        if t is not None:
            self._flush_pending()  # tail chunks below the wire size
            while True:  # a healthy-but-slow wire may hold a full queue
                try:
                    self._q.put(None, timeout=0.5)
                    break
                except queue.Full:
                    if self._failed is not None:
                        break  # sender dead; nothing will drain it
            t.join(timeout=24 * 3600)
        if self._committed:
            EC_STREAM_STREAMS.inc(outcome="ok")
            tsp.set_attr(bytesStreamed=self.bytes_streamed,
                         resumes=self.resumes)
            return
        self._drain()
        try:
            self._catch_up()
            EC_STREAM_STREAMS.inc(outcome="ok")
            tsp.set_attr(bytesStreamed=self.bytes_streamed,
                         resumes=self.resumes,
                         resumedBytes=self.resumed_bytes)
        except BaseException as e:
            self.error = f"{type(e).__name__}: {e}"
            EC_STREAM_STREAMS.inc(outcome="failed")
            raise

    def abort(self) -> None:
        """Tear down without resuming (the encode itself failed — there
        is nothing complete to stream). Setting _failed BEFORE the
        sentinel makes the request generator end without a commit."""
        self._failed = self._failed or RuntimeError("aborted")
        t = self._thread
        if t is not None:
            try:
                self._q.put_nowait(None)
            except queue.Full:
                pass
            t.join(timeout=5)
        self._drain()

    def _catch_up(self) -> None:
        from ..utils import retry as retry_mod

        retry_mod.retry(f"ec.stream.{self.address}", self._catch_up_once,
                        attempts=DEFAULT_RESUME_ATTEMPTS, wait_init=0.05,
                        wait_max=0.5)

    def _catch_up_once(self) -> None:
        from ..pb import rpc

        self._failed = None
        stub = rpc.volume_stub(rpc.grpc_address(self.address))
        st = stub.VolumeEcShardsStreamStatus(
            es.VolumeEcShardsStreamStatusRequest(
                volume_id=self.vid, collection=self.collection,
                shard_ids=self.shard_ids), timeout=30)
        got = {p.shard_id: p.size for p in st.shards}
        self.resumes += 1
        EC_STREAM_RESUMES.inc(peer=self.address)

        def messages():
            yield es.VolumeEcShardsStreamRequest(header=es.EcStreamHeader(
                volume_id=self.vid, collection=self.collection,
                shard_ids=self.shard_ids, shard_size=self.shard_size,
                resume=True, source=self.source))
            for sid in self.shard_ids:
                start = min(got.get(sid, 0), self.shard_size)
                if start >= self.shard_size:
                    continue  # destination already holds this shard whole
                path = self.geo.shard_file_name(self.base, sid)
                with open(path, "rb") as f:
                    f.seek(start)
                    off = start
                    while off < self.shard_size:
                        data = f.read(min(DEFAULT_RESUME_CHUNK,
                                          self.shard_size - off))
                        if not data:
                            raise IOError(
                                f"{path}: short read at {off} during "
                                f"resume (local shard incomplete)")
                        yield es.VolumeEcShardsStreamRequest(
                            slab=es.EcStreamSlab(
                                shard_id=sid, offset=off, data=data,
                                crc=crc32c(data)))
                        self.resumed_bytes += len(data)
                        self.bytes_streamed += len(data)
                        EC_STREAM_BYTES.inc(len(data), role="source",
                                            phase="resume")
                        EC_STREAM_SLABS.inc(role="source", phase="resume")
                        off += len(data)
            yield es.VolumeEcShardsStreamRequest(
                commit=self._commit_message())

        t0 = time.perf_counter()
        try:
            resp = stub.VolumeEcShardsStream(messages(), timeout=3600)
        finally:
            EC_STREAM_SECONDS.inc(time.perf_counter() - t0,
                                  peer=self.address)
        self._verify_response(resp)
        self._committed = True


class EcStreamSinkSet:
    """The shard-sink hook `generate_ec_files` calls: routes each slab to
    the destination (if any) that will host its shard. Slab bytes are
    copied out of the pipeline's recycled buffers here, once, before
    they cross a thread boundary."""

    def __init__(self, destinations: list[EcStreamDestination]):
        self.destinations = list(destinations)
        self._by_shard: dict[int, EcStreamDestination] = {}
        for d in self.destinations:
            for sid in d.shard_ids:
                self._by_shard[sid] = d

    def put(self, shard_id: int, offset: int, row, nbytes: int) -> None:
        """`row` is a uint8 numpy row on the host (generate_ec_files
        hands over nothing else; a device tensor has no buffer and
        raises here)."""
        d = self._by_shard.get(shard_id)
        if d is not None:
            d.put(shard_id, offset, bytes(memoryview(row)[:nbytes]))

    def abort(self) -> None:
        for d in self.destinations:
            d.abort()
