"""Crash-safe sidecar writes.

Every small metadata file that gets REWRITTEN in place — `.vif` volume
info, `.dig` digest manifests, `.scb` scrub cursors, the
`.swfs_incarnation` epoch counter — used to go through ad-hoc
`tmp + os.replace` sequences without a single fsync. That pattern is
atomic against a crash of *this process* (rename is all-or-nothing in
the kernel's view) but NOT against power loss or a SIGKILL racing the
page cache: the rename can be durable while the tmp file's bytes are
not, leaving a zero-length or half-written sidecar that poisons the
next mount. The reference hits the same class of bug with
`weed/util/file_util.go`-style helpers; the fix is the classic
four-step dance, centralized here so every sidecar gets it:

    write tmp (same directory)  ->  fsync(tmp)  ->  rename  ->  fsync(dir)

The directory fsync makes the *rename itself* durable. All helpers
take the final path; the tmp name is derived (`<path>.tmp`) so the
recovery ladder (storage/recovery.py) can sweep orphaned tmp files
left by a crash mid-sequence — before the rename they are invisible to
every reader, after it they are the file.
"""

from __future__ import annotations

import json
import os


def fsync_dir(path: str) -> None:
    """fsync the directory containing `path` (or `path` itself if it is
    a directory) so a just-completed rename survives power loss.
    Best-effort: some filesystems refuse O_RDONLY dir fsync."""
    d = path if os.path.isdir(path) else (os.path.dirname(path) or ".")
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_file_atomic(path: str, data: bytes, *,
                      fsync: bool = True) -> None:
    """Replace `path` with `data` atomically and (by default) durably."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    from . import failpoint

    # chaos seam: a crash between tmp-fsync and rename leaves exactly the
    # orphan the recovery ladder's tmp sweep exists for. Arm with a
    # @<suffix>, match (ctx is the final path) to target one sidecar kind.
    failpoint.fail("sidecar.write", ctx=path + ",")
    os.replace(tmp, path)
    if fsync:
        fsync_dir(path)


def write_text_atomic(path: str, text: str, *,
                      fsync: bool = True) -> None:
    write_file_atomic(path, text.encode("utf-8"), fsync=fsync)


def write_json_atomic(path: str, obj, *, fsync: bool = True) -> None:
    write_file_atomic(path, json.dumps(obj).encode("utf-8"), fsync=fsync)
