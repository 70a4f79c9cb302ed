"""Cross-server survivor-range gather for syndrome verify.

An EC volume whose shards are split across servers has no single holder
that can re-encode its parity locally — the syndrome sweep had to
report it "skipped" and lean on per-shard CRC cross-checks. This module
is the missing transport: the slab-streaming plane run in
REVERSE. Where `VolumeEcShardsStream` pushed chunked, CRC-verified,
offset-addressed shard slabs source→destination, `VolumeEcShardsRead`
pulls them holder→scrubber, and the `ShardRangeGatherer` here turns N
such streams into an assembled window feed the verify loop consumes:

* one fetch thread per remote shard (concurrent per-peer fetches), each
  riding `utils/retry` classification — a peer flap re-requests ONLY the
  byte range past the last verified slab (slab-granular resume, counted
  in `SeaweedFS_scrub_gather_resumes`), rotating to another holder of
  the same shard when one exists;
* every slab's crc32c is verified in transit (a corrupt wire slab is
  retried, never verified against);
* a bounded prefetch window: fetchers run ahead of the consumer by at
  most `prefetch` slabs per shard, so the network transfer overlaps the
  GF recompute (RapidRAID's overlap, arXiv:1207.6744) without buffering
  whole shards.

The scrubbing side decides WHAT to fetch (a repair-plan's worth, not k
shards — models/geometry.py) and paces the combined byte flow through
the scrub-class QoS budget; this module only moves ranges.
"""

from __future__ import annotations

import threading

from ..storage.crc import crc32c
from ..utils import glog
from ..utils.locks import wcondition
from ..utils.retry import Backoff, is_retryable
from ..utils.stats import SCRUB_GATHER_BYTES, SCRUB_GATHER_RESUMES

DEFAULT_PREFETCH = 4
MAX_FAILURES_PER_SHARD = 6
# the server clamps per-slab payloads to its streaming chunk size
# (BUFFER_SIZE_LIMIT in server/volume.py) — the consumer's window stride
# must never exceed it, or slabs land at a finer stride than window()
# pops and healthy volumes read as corrupt
MAX_SLAB = 2 * 1024 * 1024


class GatherError(IOError):
    """A needed shard range could not be fetched from any holder."""


class _WireCorruption(IOError):
    """Slab crc mismatch in transit — retryable (re-request the range)."""


def _read_stream(addr: str, vid: int, collection: str, sid: int,
                 offset: int, size: int, slab: int):
    """One VolumeEcShardsRead stream: yields (offset, data) slabs with
    the transit CRC verified. Contiguity is enforced — the server sends
    a shard's slabs in offset order from the requested start."""
    import grpc  # noqa: F401  (RpcError classification happens upstream)

    from ..pb import ec_gather_pb2 as eg
    from ..pb import rpc

    stub = rpc.volume_stub(rpc.grpc_address(addr))
    req = eg.VolumeEcShardsReadRequest(
        volume_id=vid, collection=collection, slab=slab)
    req.ranges.add(shard_id=sid, offset=offset, size=size)
    expect = offset
    for resp in stub.VolumeEcShardsRead(req, timeout=3600):
        if resp.shard_id != sid or resp.offset != expect:
            raise _WireCorruption(
                f"shard {sid} from {addr}: non-contiguous slab at "
                f"{resp.offset}, expected {expect}")
        if crc32c(resp.data) != resp.crc:
            raise _WireCorruption(
                f"shard {sid} from {addr}: slab crc mismatch at "
                f"{resp.offset}")
        yield resp.offset, bytes(resp.data)
        expect += len(resp.data)


def fetch_range_once(addrs: list[str], vid: int, collection: str,
                     sid: int, offset: int, size: int,
                     slab: int = 1 << 20) -> bytes | None:
    """One-shot assembled fetch of [offset, offset+size) of a shard from
    the first holder that answers — the culprit-pinning side channel
    (it needs EVERY shard's bytes for one window, not a sweep's worth)."""
    for addr in addrs:
        buf = bytearray()
        try:
            for _off, data in _read_stream(addr, vid, collection, sid,
                                           offset, size, slab):
                buf += data
        except Exception as e:  # noqa: BLE001 — any holder may answer
            glog.v(1, f"gather: shard {sid} range from {addr}: {e}")
            continue
        buf += b"\0" * (size - len(buf))
        return bytes(buf[:size])
    return None


class ShardRangeGatherer:
    """Assembles remote shard ranges into consumer windows.

    `shard_addrs` maps each needed remote shard id to the holders that
    serve it. Every shard is fetched [start, shard_size) in `slab`-sized
    chunks by its own thread; `window(off, n)` blocks until every
    shard's [off, off+n) slab arrived, pops it, and advances the
    prefetch gate. Failures after retries surface as GatherError from
    window() — the verify pass degrades gracefully instead of erroring
    a client-facing path."""

    def __init__(self, vid: int, collection: str,
                 shard_addrs: dict[int, list[str]], shard_size: int,
                 slab: int, start: int = 0,
                 prefetch: int = DEFAULT_PREFETCH):
        self.vid = vid
        self.collection = collection
        self.shard_size = shard_size
        self.slab = min(max(4096, slab), MAX_SLAB)
        self.start = start
        self.prefetch = max(1, prefetch)
        self.bytes_fetched = 0
        self.resumed_bytes = 0
        self.resumes = 0
        self._cond = wcondition("gather.cv", rank=420)
        self._cursor = start
        self._slabs: dict[tuple[int, int], bytes] = {}
        self._failed: dict[int, str] = {}
        self._stop = False
        self._sids = sorted(shard_addrs)
        self._threads = [
            threading.Thread(target=self._shard_loop, args=(sid, addrs),
                             name=f"scrub-gather-{vid}-{sid}", daemon=True)
            for sid, addrs in sorted(shard_addrs.items())
        ]
        for t in self._threads:
            t.start()

    # -- fetch side --------------------------------------------------------

    def _shard_loop(self, sid: int, addrs: list[str]) -> None:
        progress = self.start
        failures = 0
        bo = Backoff()
        while progress < self.shard_size:
            addr = addrs[failures % len(addrs)]
            flap = failures > 0
            if flap:
                # slab-granular resume: re-request ONLY the missing
                # ranges — everything before `progress` is stored or
                # already consumed and is never moved twice
                with self._cond:
                    self.resumes += 1
                SCRUB_GATHER_RESUMES.inc()
            try:
                for off, data in _read_stream(
                        addr, self.vid, self.collection, sid, progress,
                        self.shard_size - progress, self.slab):
                    with self._cond:
                        # bounded prefetch: overlap the wire with the
                        # recompute without buffering whole shards
                        while (not self._stop and off >= self._cursor
                               + self.prefetch * self.slab):
                            self._cond.wait(1.0)
                        if self._stop:
                            return
                        self._slabs[(sid, off)] = data
                        self.bytes_fetched += len(data)
                        if flap:
                            self.resumed_bytes += len(data)
                        self._cond.notify_all()
                    progress = off + len(data)
                    SCRUB_GATHER_BYTES.inc(
                        len(data), phase="resume" if flap else "live")
                if progress >= self.shard_size:
                    return
                raise _WireCorruption(
                    f"shard {sid} from {addr}: stream ended at "
                    f"{progress} < {self.shard_size}")
            except Exception as e:  # noqa: BLE001 — classified below
                if self._stop:
                    return
                failures += 1
                retryable = is_retryable(e) or isinstance(e,
                                                          _WireCorruption)
                if not retryable or failures >= MAX_FAILURES_PER_SHARD:
                    with self._cond:
                        self._failed[sid] = f"{addr}: {e}"
                        self._cond.notify_all()
                    return
                glog.v(1, f"gather: shard {sid} flap at {progress} "
                          f"({addr}): {e}; resuming missing range")
                bo.sleep()

    # -- consume side ------------------------------------------------------

    def window(self, off: int, n: int) -> dict[int, bytes]:
        """The assembled [off, off+n) slab of every gathered shard; pops
        the stored bytes and opens the prefetch gate for off+n."""
        out: dict[int, bytes] = {}
        with self._cond:
            for sid in self._sids:
                while ((sid, off) not in self._slabs
                       and sid not in self._failed and not self._stop):
                    self._cond.wait(1.0)
                if sid in self._failed:
                    raise GatherError(
                        f"ec volume {self.vid}: shard {sid} range "
                        f"[{off}, {off + n}) unfetchable after retries "
                        f"({self._failed[sid]})")
                if self._stop:
                    raise GatherError("gather stopped")
                data = self._slabs.pop((sid, off))
                if len(data) < n and off + len(data) < self.shard_size:
                    # a mid-shard short slab means the wire stride and
                    # the window stride disagree — zero-padding it would
                    # turn a healthy volume into a corruption finding
                    raise GatherError(
                        f"ec volume {self.vid}: shard {sid} slab at "
                        f"{off} is {len(data)} bytes, window wants {n}")
                out[sid] = (data + b"\0" * (n - len(data)))[:n]
            self._cursor = off + n
            self._cond.notify_all()
        return out

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._slabs.clear()
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=5)
