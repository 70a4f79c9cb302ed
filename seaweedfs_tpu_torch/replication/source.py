"""Replication source: read chunk bytes out of the source cluster.

Counterpart of seaweedfs_tpu/replication/source.py (SeaweedFS
weed/replication/source/filer_source.go) —
LookupFileId via the source filer, then HTTP GET from its volume servers.
"""

from __future__ import annotations

from ..pb import filer_pb2, rpc
from ..utils.http import url_for
from ..wdclient import pool


class ChunkNotFound(IOError):
    """Every holder of a chunk answered 404: the needle is gone (its
    entry overwritten or deleted since the event that named it)."""


def _remote_only(entry: filer_pb2.Entry) -> bool:
    from ..remote_storage import REMOTE_ENTRY_KEY

    return not entry.chunks and entry.attributes.file_size > 0 and \
        REMOTE_ENTRY_KEY in entry.extended


class FilerSource:
    def __init__(self, filer: str):
        self.filer = filer

    @property
    def stub(self):
        return rpc.filer_stub(rpc.grpc_address(self.filer))

    def lookup_urls(self, file_id: str) -> list[str]:
        vid = file_id.split(",", 1)[0]
        resp = self.stub.LookupVolume(filer_pb2.LookupVolumeRequest(
            volume_ids=[vid]), timeout=30)
        locs = resp.locations_map.get(vid)
        if locs is None or not locs.locations:
            raise LookupError(f"no locations for volume {vid}")
        return [url_for(l.url, file_id) for l in locs.locations]

    def read_chunk(self, file_id: str) -> bytes:
        last: Exception | None = None
        statuses = []
        urls = self.lookup_urls(file_id)
        for url in urls:
            try:
                # pooled keep-alive leg: a sync run reads many
                # chunks from few volume servers — one warm connection
                # each instead of a dial per chunk
                r = pool.get(url, timeout=60)
                if r.status == 200:
                    return r.data
                statuses.append(r.status)
                last = IOError(f"{url}: {r.status}")
            except OSError as e:
                from ..utils.retry import (
                    _ssl_error_of,
                    ssl_error_is_retryable,
                )

                sslerr = _ssl_error_of(e)
                if sslerr is not None \
                        and not ssl_error_is_retryable(sslerr):
                    # a certificate rejection is a trust decision, not a
                    # down replica — don't walk the rest of the same
                    # misconfigured cluster (the filer read ladder's rule)
                    raise
                last = e
        if statuses == [404] * len(urls):
            raise ChunkNotFound(f"read {file_id}: {last}")
        raise IOError(f"read {file_id}: {last}")

    def superseded(self, path: str, entry: filer_pb2.Entry) -> bool:
        """Whether the entry at `path` on the source is no longer this
        version: deleted, or its chunks replaced."""
        import grpc

        d, name = path.rsplit("/", 1)
        try:
            now = self.stub.LookupDirectoryEntry(
                filer_pb2.LookupDirectoryEntryRequest(directory=d or "/",
                                                      name=name),
                timeout=30).entry
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.NOT_FOUND:
                return True
            raise
        return [c.file_id for c in now.chunks] != \
            [c.file_id for c in entry.chunks]

    def read_remote_only(self, path: str, size: int) -> bytes:
        """The whole of a remote-only entry through the filer's GET, which
        streams it from the remote store; anything but `size` bytes
        raises."""
        r = pool.get(url_for(self.filer, path), timeout=300)
        if r.status != 200 or len(r.data) != size:
            raise IOError(f"read {path} through the filer: {r.status}, "
                          f"{len(r.data)} of {size} bytes")
        return r.data

    def read_entry_content(self, entry: filer_pb2.Entry,
                           path: str | None = None) -> bytes:
        """Materialize a full entry body (content or chunks).

        Chunk fetches ride the pipelined chunk engine: a
        sync run materializing a multi-chunk entry overlaps its volume
        round-trips instead of paying Σ(RTT) — and assembles through
        the filer's visible-interval resolution (filechunks), so an
        entry with overwritten extents replicates exactly the bytes a
        filer GET would serve (offset-order paste-over could not).

        An entry mounted from remote storage and not cached has neither
        content nor chunks: its bytes are read through the source filer
        at `path` (its remote read-through), where the reference returns
        b"" and so mirrors an empty file (ROADMAP.md C)."""
        if entry.content:
            return entry.content
        if _remote_only(entry):
            if path is None:
                raise IOError(f"{entry.name} lives in remote storage only: "
                              f"its bytes are read by path")
            return self.read_remote_only(path, entry.attributes.file_size)
        from ..filer import chunk_pipeline
        from ..filer.filechunks import total_size, view_from_chunks

        views = view_from_chunks(entry.chunks)
        buf = bytearray(total_size(entry.chunks))

        def fetch(v):
            return self.read_chunk(v.file_id)[
                v.chunk_offset:v.chunk_offset + v.size]

        # generator first in the zip: it then runs to completion (clean
        # StopIteration) instead of being left suspended for the GC
        for data, v in zip(chunk_pipeline.readahead(views, fetch),
                           views):
            buf[v.logical_offset:v.logical_offset + len(data)] = data
        return bytes(buf)
