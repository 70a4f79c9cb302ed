"""Offline volume tools: backup, compact, fix, export.

Counterpart of seaweedfs_tpu/command/tools.py (SeaweedFS
weed/command/backup.go: incremental volume backup from a live server;
compact.go: offline vacuum; fix.go: rebuild .idx from .dat; export.go:
extract needles to files).
"""

from __future__ import annotations

import os
import sys

from ..pb import rpc, volume_server_pb2 as vs
from ..storage import types
from ..storage.needle import Needle
from ..storage.volume import Volume


def run_backup(opts) -> int:
    """`weed-tpu backup -server host:port -volumeId N -dir d`: pull a full
    or incremental copy of a live volume into a local .dat/.idx pair."""
    from ..wdclient import MasterClient

    server = opts.server
    if not server:
        locs = MasterClient(opts.master).lookup_volume(opts.volumeId)
        if not locs:
            print(f"volume {opts.volumeId} not found", file=sys.stderr)
            return 1
        server = locs[0].url
    stub = rpc.volume_stub(rpc.grpc_address(server))
    status = stub.VolumeSyncStatus(
        vs.VolumeSyncStatusRequest(volume_id=opts.volumeId), timeout=30)
    os.makedirs(opts.dir, exist_ok=True)
    prefix = f"{status.collection}_" if status.collection else ""
    base = os.path.join(opts.dir, f"{prefix}{opts.volumeId}")
    have = os.path.getsize(base + ".dat") if os.path.exists(base + ".dat") \
        else 0
    if have == 0 or have > status.tail_offset or \
            _local_revision(base) != status.compact_revision:
        # full copy (the reference falls back the same way)
        for name, ext in ((".dat", ".dat"), (".idx", ".idx")):
            with open(base + ext, "wb") as f:
                for resp in stub.CopyFile(vs.CopyFileRequest(
                        volume_id=opts.volumeId, ext=ext,
                        collection=status.collection,
                        compaction_revision=status.compact_revision,
                        stop_offset=(status.tail_offset if ext == ".dat"
                                     else status.idx_file_size)),
                        timeout=3600):
                    f.write(resp.file_content)
        # backed-up bytes carry the SOURCE's offset width — mirror its
        # marker rather than stamping local mode
        from ..operation import sync_stride_marker

        sync_stride_marker(stub, opts.volumeId, status.collection, base)
        print(f"full backup of volume {opts.volumeId}: "
              f"{os.path.getsize(base + '.dat')} bytes")
        return 0
    # incremental: replay appended records since our tail
    v = Volume(opts.dir, status.collection, opts.volumeId)
    appended = 0
    # the server streams raw 2MiB slices with no record alignment —
    # buffer across responses so records spanning a boundary parse whole
    buf = bytearray()
    stream = stub.VolumeIncrementalCopy(
        vs.VolumeIncrementalCopyRequest(
            volume_id=opts.volumeId, since_ns=v.last_append_at_ns),
        timeout=3600)

    def records():
        nonlocal buf
        for resp in stream:
            buf += resp.file_content
            pos = 0
            while pos + types.NEEDLE_HEADER_SIZE <= len(buf):
                n = Needle.parse_header(
                    bytes(buf[pos:pos + types.NEEDLE_HEADER_SIZE]))
                total = types.actual_size(max(n.size, 0), v.version)
                if pos + total > len(buf):
                    break  # record continues in the next chunk
                yield Needle.from_bytes(bytes(buf[pos:pos + total]),
                                        v.version, check_crc=False)
                pos += total
            del buf[:pos]

    for full in records():
        if full.size > 0:
            v.write_needle(full, check_cookie=False)
        else:
            v.delete_needle(full.id, full.cookie or None)
        appended += 1
    v.close()
    print(f"incremental backup of volume {opts.volumeId}: "
          f"{appended} records")
    return 0


def _local_revision(base: str) -> int:
    try:
        with open(base + ".dat", "rb") as f:
            hdr = f.read(8)
        return int.from_bytes(hdr[4:6], "big")
    except (FileNotFoundError, IndexError):
        return -1


def run_compact(opts) -> int:
    """`weed-tpu compact -dir d -volumeId N`: offline vacuum."""
    v = Volume(opts.dir, opts.collection, opts.volumeId)
    before = v.data_size()
    v.compact()
    v.commit_compact()
    after = v.data_size()
    v.close()
    print(f"compacted volume {opts.volumeId}: {before} -> {after} bytes")
    return 0


def run_fix(opts) -> int:
    """`weed-tpu fix -dir d -volumeId N`: rebuild .idx by scanning .dat
    (fix.go runFix)."""
    prefix = f"{opts.collection}_" if opts.collection else ""
    base = os.path.join(opts.dir, f"{prefix}{opts.volumeId}")
    idx = base + ".idx"
    if os.path.exists(idx):
        os.rename(idx, idx + ".bak")
    try:
        v = Volume(opts.dir, opts.collection, opts.volumeId)
        count = 0
        for n, off in v.scan_needles(strict=False):
            if n.size > 0:
                v.nm.put(n.id, types.offset_to_stored(off), n.size)
            else:  # zero-size record = deletion marker
                v.nm.delete(n.id, types.offset_to_stored(off))
            count += 1
        v.close()
    except BaseException:
        if os.path.exists(idx + ".bak"):
            os.replace(idx + ".bak", idx)
        raise
    if os.path.exists(idx + ".bak"):
        os.remove(idx + ".bak")
    print(f"fixed volume {opts.volumeId}: {count} records indexed")
    return 0


def run_export(opts) -> int:
    """`weed-tpu export -dir d -volumeId N -o outdir`: extract live
    needles to files (export.go, minus the tar format)."""
    v = Volume(opts.dir, opts.collection, opts.volumeId)
    os.makedirs(opts.output, exist_ok=True)
    exported = 0
    for n, off in v.scan_needles(strict=False):
        nv = v.nm.get(n.id)
        if nv is None or types.size_is_deleted(nv.size):
            continue
        if types.stored_to_actual_offset(nv.offset) != off:
            continue
        name = n.name.decode(errors="replace") if n.name else f"{n.id:x}"
        # needle names are caller-controlled: keep the export inside -o
        target = os.path.normpath(os.path.join(opts.output,
                                               name.lstrip("/")))
        root = os.path.abspath(opts.output)
        if not os.path.abspath(target).startswith(root + os.sep):
            target = os.path.join(root, f"{n.id:x}")
        os.makedirs(os.path.dirname(target) or opts.output, exist_ok=True)
        with open(target, "wb") as f:
            f.write(n.data)
        exported += 1
    v.close()
    print(f"exported {exported} files from volume {opts.volumeId} "
          f"to {opts.output}")
    return 0
