"""Chunk math: visible-interval resolution + manifest chunks.

Counterpart of seaweedfs_tpu/filer/filechunks.py (SeaweedFS
weed/filer/filechunks.go NonOverlappingVisibleIntervals/ViewFromChunks,
interval_list.go, and filechunk_manifest.go, where chunks >IntervalSize
get folded into manifest chunks).

A file is a list of FileChunk extents; later-modified chunks shadow earlier
ones. Reads resolve the chunk list into non-overlapping [start, stop) views.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..pb import filer_pb2

MANIFEST_BATCH = 1000  # fold manifests once a file exceeds this many chunks


@dataclass
class ChunkView:
    file_id: str
    chunk_offset: int  # offset inside the chunk
    size: int
    logical_offset: int  # offset in the file
    is_full_chunk: bool = False
    cipher_key: bytes = b""
    is_gzipped: bool = False


def total_size(chunks) -> int:
    return max((c.offset + c.size for c in chunks), default=0)


def etag(chunks) -> str:
    import hashlib

    if not chunks:
        return ""
    if len(chunks) == 1:
        return chunks[0].e_tag or chunks[0].file_id
    h = hashlib.md5()
    for c in chunks:
        h.update((c.e_tag or c.file_id).encode())
    return f"{h.hexdigest()}-{len(chunks)}"


def non_overlapping_visible_intervals(chunks) -> list[tuple[int, int, object]]:
    """-> [(start, stop, chunk)] sorted, later mtime wins on overlap
    (filechunks.go NonOverlappingVisibleIntervals)."""
    events = sorted(chunks, key=lambda c: (c.modified_ts_ns, c.file_id))
    visible: list[list] = []  # [start, stop, chunk]
    for c in events:
        start, stop = c.offset, c.offset + c.size
        out = []
        for v in visible:
            vs, ve, vc = v
            if ve <= start or vs >= stop:
                out.append(v)
                continue
            if vs < start:
                out.append([vs, start, vc])
            if ve > stop:
                out.append([stop, ve, vc])
        out.append([start, stop, c])
        visible = out
    visible.sort(key=lambda v: v[0])
    return [(s, e, c) for s, e, c in visible if e > s]


def view_from_chunks(chunks, offset: int = 0, size: int | None = None) -> list[ChunkView]:
    """Resolve a read range into per-chunk views (ViewFromChunks).
    size=None means "to end-of-file from `offset`" — callers streaming a
    whole entry (filer GET, replication materialize, the
    pipelined readers) pass None instead of re-deriving total_size."""
    if size is None:
        size = max(total_size(chunks) - offset, 0)
    stop = offset + size
    views = []
    for vs, ve, c in non_overlapping_visible_intervals(chunks):
        s, e = max(vs, offset), min(ve, stop)
        if s >= e:
            continue
        views.append(ChunkView(
            file_id=c.file_id,
            chunk_offset=s - c.offset,
            size=e - s,
            logical_offset=s,
            is_full_chunk=(s == c.offset and e == c.offset + c.size),
            cipher_key=c.cipher_key,
            is_gzipped=c.is_compressed,
        ))
    return views


# -- manifests (filechunk_manifest.go) -------------------------------------

def has_chunk_manifest(chunks) -> bool:
    return any(c.is_chunk_manifest for c in chunks)


def separate_manifest_chunks(chunks):
    manifests, rest = [], []
    for c in chunks:
        (manifests if c.is_chunk_manifest else rest).append(c)
    return manifests, rest


def resolve_chunk_manifest(fetch_fn, chunks) -> list:
    """Expand manifest chunks recursively; fetch_fn(file_id) -> bytes
    (ResolveChunkManifest)."""
    out = []
    for c in chunks:
        if not c.is_chunk_manifest:
            out.append(c)
            continue
        m = filer_pb2.FileChunkManifest.FromString(fetch_fn(c.file_id))
        resolved = resolve_chunk_manifest(fetch_fn, m.chunks)
        for rc in resolved:
            rc.offset += c.offset
        out.extend(resolved)
    return out


def maybe_manifestize(save_fn, chunks) -> list:
    """Fold data chunks into manifest chunks when too many
    (MaybeManifestize): save_fn(bytes) -> FileChunk for the manifest blob."""
    data_chunks = [c for c in chunks if not c.is_chunk_manifest]
    manifest_chunks = [c for c in chunks if c.is_chunk_manifest]
    if len(data_chunks) <= MANIFEST_BATCH:
        return chunks
    folded = []
    for i in range(0, len(data_chunks) - len(data_chunks) % MANIFEST_BATCH,
                   MANIFEST_BATCH):
        batch = data_chunks[i:i + MANIFEST_BATCH]
        base = min(c.offset for c in batch)
        m = filer_pb2.FileChunkManifest()
        for c in batch:
            cc = filer_pb2.FileChunk()
            cc.CopyFrom(c)
            cc.offset -= base
            m.chunks.append(cc)
        mc = save_fn(m.SerializeToString())
        mc.offset = base
        mc.size = max(c.offset + c.size for c in batch) - base
        mc.is_chunk_manifest = True
        folded.append(mc)
    tail = data_chunks[len(data_chunks) - len(data_chunks) % MANIFEST_BATCH:]
    return manifest_chunks + folded + tail
