"""Unclean-shutdown recovery ladder.

The durability story sold by group commit (ack-after-covering-flush),
streamed EC commit and epoch-tagged anti-entropy is only real if a SIGKILL at *any* instruction leaves the
store recoverable. This module is the mount-time half of that
contract — the reference spreads the same work across
`weed/storage/volume_checking.go` (CheckAndFixVolumeDataIntegrity)
and the needle-map loaders; here it is one explicit ladder that
`Store.__init__` runs over every disk location BEFORE any volume is
opened, whenever the previous process died unclean.

Unclean detection: each location carries a `.swfs_dirty` marker,
written (fsync'd) right after the location is opened and removed only
by a clean `Store.close()`. Marker present at startup ⇒ the previous
incarnation never finished shutdown ⇒ run the ladder. (The
`.swfs_incarnation` bump happens regardless, so post-crash epoch tags
can never collide with pre-crash ones — the ladder and the stamper are
the two halves of restart hygiene.)

The ladder, per location — every rung file-level, so a repair can
never be confused by (or race) a half-constructed Volume runtime:

1. sweep orphaned `*.tmp` files (a crash between atomic_write's write
   and rename leaves one; it is invisible to readers, but it would
   shadow the NEXT atomic write's tmp name);
2. resolve interrupted vacuum commits: `.cpd`+`.cpx` both present ⇒
   the two-rename commit never started, roll BACK (delete both, the
   live files are untouched); `.cpx` alone ⇒ the `.dat` rename
   already happened, roll FORWARD (finish the `.idx` rename) — the
   same decision table as the reference's makeupDiff recovery;
3. torn-tail repair for every `.dat`: forward-scan from the
   superblock verifying each record's structure and CRC, truncate the
   file at the last valid record boundary (byte-exact — the reference's golden
   fixtures cut a record at every byte
   offset and pin the result), then drop `.idx` suffix entries whose
   records extend past the new tail (group commit flushes .dat before
   .idx, so idx-never-ahead-of-dat makes this a pure suffix drop);
4. quarantine half-streamed EC shard sets: `.ec??` shard files whose
   base has no `.ecx` never saw their commit — move them (plus any
   `.ecj` journal) into `.swfs_quarantine/` so no later mount or
   partial re-encode can mistake them for committed bytes;
5. validate rewritten sidecars — `.vif` (JSON), `.dig` (manifest
   magic + framing), `.scb` (JSON), `.tier` (JSON),
   `.swfs_incarnation` (int) — and DELETE corrupt ones: every one is
   reconstructible (geometry refuses to serve without .vif — better
   refused loudly at quarantine than poisoned; digests and cursors
   rebuild on the next sweep), while a truncated one poisons the
   mount. All of them are written through utils/atomic_write now, so
   this rung only fires for pre-upgrade files or genuine disk rot.

Every volume the ladder touched is reported as a scrub SUSPECT: the
server queues `Scrubber.report_suspect(vid)` so the anti-entropy fabric
re-verifies the repaired volume against its replicas and re-replicates
any acked-but-locally-lost needle from a peer — local truncation is
allowed to lose un-flushed bytes, the CLUSTER contract (zero acked
loss) is what the reference's crash drill asserts.

SWFS_RECOVERY=0 is the escape hatch (mount proceeds with only the
legacy per-volume check_and_fix_integrity backward repair).
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field

from ..utils import glog, trace
from ..utils.atomic_write import fsync_dir
from ..utils.stats import (
    RECOVERY_EC_QUARANTINED,
    RECOVERY_IDX_DROPPED,
    RECOVERY_RUNS,
    RECOVERY_SIDECARS_DISCARDED,
    RECOVERY_SUSPECTS,
    RECOVERY_TMP_SWEPT,
    RECOVERY_TRUNCATED_BYTES,
    RECOVERY_VACUUM_RESOLVED,
)
from . import types
from .crc import crc32c
from .needle import crc_value_legacy
from .super_block import SUPER_BLOCK_SIZE

DIRTY_MARKER = ".swfs_dirty"
QUARANTINE_DIR = ".swfs_quarantine"

_BASE_RE = re.compile(r"^(?P<base>(?:.+_)?\d+)\.dat$")
_EC_SHARD_RE = re.compile(r"^(?P<base>(?:.+_)?\d+)\.ec(?:\d\d|j)$")
_VID_RE = re.compile(r"^(?:.+_)?(?P<vid>\d+)$")


def enabled() -> bool:
    """SWFS_RECOVERY escape hatch (default on)."""
    return os.environ.get("SWFS_RECOVERY", "1").lower() not in (
        "0", "false", "off")


# -- dirty-marker protocol --------------------------------------------------

def marker_path(directory: str) -> str:
    return os.path.join(directory, DIRTY_MARKER)


def was_unclean(directory: str) -> bool:
    return os.path.exists(marker_path(directory))


def mark_dirty(directory: str) -> None:
    """Write the marker durably — if IT can be lost to a crash, the
    crash it should witness goes undetected."""
    path = marker_path(directory)
    try:
        with open(path, "w") as f:
            f.write(str(os.getpid()))
            f.flush()
            os.fsync(f.fileno())
        fsync_dir(directory)
    except OSError:
        pass  # read-only disk: recovery detection degrades, serving doesn't


def clear_dirty(directory: str) -> None:
    try:
        os.remove(marker_path(directory))
        fsync_dir(directory)
    except OSError:
        pass


# -- rung 3: torn-tail scan (the goldens pin this function) -----------------

def scan_valid_prefix(dat_path: str) -> tuple[int, int]:
    """Forward-scan a `.dat`, structurally and CRC-verifying every
    record; -> (end offset of the last fully-valid record, count of
    valid records). A file without even a whole superblock reports
    (actual size, 0) — nothing to truncate, the volume open will
    refuse it on its own terms."""
    size = os.path.getsize(dat_path)
    if size < SUPER_BLOCK_SIZE:
        return size, 0
    with open(dat_path, "rb") as f:
        fd = f.fileno()
        hdr8 = os.pread(fd, SUPER_BLOCK_SIZE, 0)
        version = hdr8[0]
        extra = int.from_bytes(hdr8[6:8], "big")
        offset = SUPER_BLOCK_SIZE + extra
        good_end, count = min(offset, size), 0
        while offset + types.NEEDLE_HEADER_SIZE <= size:
            head = os.pread(fd, types.NEEDLE_HEADER_SIZE, offset)
            if len(head) < types.NEEDLE_HEADER_SIZE:
                break
            nsize = int.from_bytes(head[12:16], "big")
            # stored Size is uint32; tombstone markers appear in .idx
            # only, so an in-.dat record always has size >= 0
            total = types.actual_size(nsize, version)
            if offset + total > size:
                break  # torn: record extends past EOF
            if not _record_valid(fd, offset, nsize, version):
                break
            offset += total
            good_end = offset
            count += 1
        return good_end, count


def _record_valid(fd: int, offset: int, nsize: int, version: int) -> bool:
    """CRC check mirroring Needle.from_bytes without hydrating: the
    stored checksum covers the DATA section only, which for v2/v3 needs
    the body parsed far enough to find it."""
    try:
        hdr = types.NEEDLE_HEADER_SIZE
        if nsize == 0:
            return True  # deletion marker record: header-only body
        body = os.pread(fd, nsize + types.NEEDLE_CHECKSUM_SIZE,
                        offset + hdr)
        if len(body) < nsize + types.NEEDLE_CHECKSUM_SIZE:
            return False
        if version == types.VERSION1:
            data = body[:nsize]
        else:
            if nsize < 4:
                return False
            dsize = int.from_bytes(body[:4], "big")
            if 4 + dsize > nsize:
                return False
            data = body[4:4 + dsize]
        stored = int.from_bytes(body[nsize:nsize + 4], "big")
        actual = crc32c(data)
        return stored == actual or stored == crc_value_legacy(actual)
    except OSError:
        return False


def repair_dat_tail(dat_path: str) -> tuple[int, int]:
    """Truncate `dat_path` to its last CRC-valid record boundary;
    -> (bytes truncated, new size). Byte-exact: a cut exactly at a
    record end truncates nothing."""
    size = os.path.getsize(dat_path)
    good_end, _count = scan_valid_prefix(dat_path)
    if good_end >= size:
        return 0, size
    with open(dat_path, "r+b") as f:
        f.truncate(good_end)
        f.flush()
        os.fsync(f.fileno())
    return size - good_end, good_end


def reconcile_idx(idx_path: str, dat_end: int) -> int:
    """Drop `.idx` suffix entries whose records extend past `dat_end`
    (idx-never-ahead-of-dat ⇒ the stale entries are a contiguous
    suffix); -> entries dropped. Tombstone entries are trusted — they
    reference the DELETED record's offset, which by definition lies in
    the durable prefix."""
    try:
        raw_size = os.path.getsize(idx_path)
    except OSError:
        return 0
    entry = types.NEEDLE_MAP_ENTRY_SIZE
    n = raw_size // entry
    if n == 0:
        return 0
    from . import idx as idx_mod

    _ids, offs, sizes = idx_mod.read_index_file(idx_path)
    version = _dat_version(idx_path)
    first_bad = n
    for i in range(n - 1, -1, -1):
        size = int(sizes[i])
        if size == types.TOMBSTONE_FILE_SIZE:
            continue
        off = types.stored_to_actual_offset(int(offs[i]))
        end = off + types.actual_size(max(size, 0), version)
        if end > dat_end:
            first_bad = i
        else:
            break  # append order: everything earlier is inside the prefix
    dropped = n - first_bad
    if dropped > 0:
        with open(idx_path, "r+b") as f:
            f.truncate(first_bad * entry)
            f.flush()
            os.fsync(f.fileno())
    return dropped


def _dat_version(idx_path: str) -> int:
    base, _ = os.path.splitext(idx_path)
    try:
        with open(base + ".dat", "rb") as f:
            return f.read(1)[0]
    except (OSError, IndexError):
        return types.CURRENT_VERSION


# -- report -----------------------------------------------------------------

@dataclass
class RecoveryReport:
    unclean: bool = False
    ran: bool = False
    dat_truncated_bytes: int = 0
    idx_entries_dropped: int = 0
    ec_shards_quarantined: int = 0
    vacuum_rolled_back: int = 0
    vacuum_rolled_forward: int = 0
    sidecars_discarded: dict[str, int] = field(default_factory=dict)
    tmp_swept: int = 0
    suspects: list[int] = field(default_factory=list)
    details: list[str] = field(default_factory=list)

    def note(self, msg: str) -> None:
        self.details.append(msg)
        glog.warning(f"recovery: {msg}")

    def status(self) -> dict:
        """/status.Recovery section (camelCase like every other)."""
        return {
            "uncleanShutdown": self.unclean,
            "ran": self.ran,
            "datTruncatedBytes": self.dat_truncated_bytes,
            "idxEntriesDropped": self.idx_entries_dropped,
            "ecShardsQuarantined": self.ec_shards_quarantined,
            "vacuumRolledBack": self.vacuum_rolled_back,
            "vacuumRolledForward": self.vacuum_rolled_forward,
            "sidecarsDiscarded": dict(self.sidecars_discarded),
            "tmpSwept": self.tmp_swept,
            "suspects": list(self.suspects),
            "details": list(self.details[:50]),
        }


# -- the ladder -------------------------------------------------------------

def recover_location(directory: str, report: RecoveryReport) -> None:
    """Run every rung over one disk location (marker already checked by
    the caller). File-level only: no Volume/EcVolume objects exist yet."""
    suspects: set[int] = set()
    names = sorted(os.listdir(directory))

    # rung 1: orphaned atomic-write tmp files
    for name in names:
        if name.endswith(".tmp"):
            try:
                os.remove(os.path.join(directory, name))
                report.tmp_swept += 1
                RECOVERY_TMP_SWEPT.inc()
                report.note(f"swept orphaned tmp {name}")
            except OSError:
                pass

    # rung 2: interrupted vacuum commits (commit_compact's two renames)
    for name in names:
        if not name.endswith(".cpd"):
            continue
        base = os.path.join(directory, name[:-len(".cpd")])
        for ext in (".cpd", ".cpx"):
            try:
                os.remove(base + ext)
            except OSError:
                pass
        report.vacuum_rolled_back += 1
        RECOVERY_VACUUM_RESOLVED.inc(action="rollback")
        report.note(f"rolled back uncommitted vacuum for {name[:-4]}")
        _suspect(base, suspects)
    for name in names:
        if not name.endswith(".cpx"):
            continue
        base = os.path.join(directory, name[:-len(".cpx")])
        if os.path.exists(base + ".cpd"):
            continue  # handled above
        # .dat already swapped, .idx rename lost with the process:
        # finish the commit — the .cpx matches the NEW .dat
        try:
            os.replace(base + ".cpx", base + ".idx")
            fsync_dir(directory)
            report.vacuum_rolled_forward += 1
            RECOVERY_VACUUM_RESOLVED.inc(action="rollforward")
            report.note(
                f"rolled forward vacuum idx swap for {name[:-4]}")
            _suspect(base, suspects)
        except OSError:
            pass

    # rung 3: torn .dat tails + idx suffix reconcile
    for name in sorted(os.listdir(directory)):
        m = _BASE_RE.match(name)
        if m is None:
            continue
        base = os.path.join(directory, m.group("base"))
        try:
            cut, new_end = repair_dat_tail(base + ".dat")
        except OSError as e:
            report.note(f"tail scan failed for {name}: {e}")
            _suspect(base, suspects)
            continue
        if cut:
            report.dat_truncated_bytes += cut
            RECOVERY_TRUNCATED_BYTES.inc(cut)
            report.note(f"truncated {cut} torn bytes off {name}")
            _suspect(base, suspects)
        if os.path.exists(base + ".idx"):
            try:
                dropped = reconcile_idx(base + ".idx", new_end)
            except (OSError, ValueError) as e:
                report.note(f"idx reconcile failed for {name}: {e}")
                dropped = 0
            if dropped:
                report.idx_entries_dropped += dropped
                RECOVERY_IDX_DROPPED.inc(dropped)
                report.note(
                    f"dropped {dropped} idx entries past the durable "
                    f"prefix of {name}")
                _suspect(base, suspects)

    # rung 4: quarantine EC shard sets that never saw their .ecx commit
    orphans: dict[str, list[str]] = {}
    for name in sorted(os.listdir(directory)):
        m = _EC_SHARD_RE.match(name)
        if m is None:
            continue
        base = m.group("base")
        if os.path.exists(os.path.join(directory, base + ".ecx")):
            continue
        orphans.setdefault(base, []).append(name)
    if orphans:
        qdir = os.path.join(directory, QUARANTINE_DIR)
        os.makedirs(qdir, exist_ok=True)
        for base, files in orphans.items():
            moved = 0
            for name in files:
                dst = os.path.join(qdir, name)
                i = 0
                while os.path.exists(dst):
                    i += 1
                    dst = os.path.join(qdir, f"{name}.{i}")
                try:
                    os.replace(os.path.join(directory, name), dst)
                    moved += 1
                except OSError:
                    pass
            if moved:
                report.ec_shards_quarantined += moved
                RECOVERY_EC_QUARANTINED.inc(moved)
                report.note(
                    f"quarantined {moved} uncommitted ec files for "
                    f"{base} (no .ecx)")
                _suspect(os.path.join(directory, base), suspects)
        fsync_dir(directory)

    # rung 5: validate rewritten sidecars, discard corrupt ones
    validators = {
        ".vif": _valid_json, ".scb": _valid_json, ".tier": _valid_json,
        ".dig": _valid_dig,
    }
    for name in sorted(os.listdir(directory)):
        stem, ext = os.path.splitext(name)
        check = validators.get(ext)
        if check is None:
            continue
        path = os.path.join(directory, name)
        if check(path):
            continue
        try:
            os.remove(path)
        except OSError:
            continue
        kind = ext.lstrip(".")
        report.sidecars_discarded[kind] = (
            report.sidecars_discarded.get(kind, 0) + 1)
        RECOVERY_SIDECARS_DISCARDED.inc(kind=kind)
        report.note(f"discarded corrupt sidecar {name}")
        _suspect(os.path.join(directory, stem), suspects)
    inc = os.path.join(directory, ".swfs_incarnation")
    if os.path.exists(inc) and not _valid_int(inc):
        try:
            os.remove(inc)
            report.sidecars_discarded["incarnation"] = (
                report.sidecars_discarded.get("incarnation", 0) + 1)
            RECOVERY_SIDECARS_DISCARDED.inc(kind="incarnation")
            report.note("discarded corrupt .swfs_incarnation")
        except OSError:
            pass

    for vid in sorted(suspects):
        if vid not in report.suspects:
            report.suspects.append(vid)


def recover_store(locations: list[str]) -> RecoveryReport:
    """Entry point used by Store.__init__: detect unclean shutdown per
    location, run the ladder where needed, re-arm the dirty markers."""
    report = RecoveryReport()
    report.unclean = any(was_unclean(d) for d in locations)
    if report.unclean and enabled():
        report.ran = True
        with trace.span("recovery.ladder", component="storage",
                        locations=len(locations)):
            for d in locations:
                if was_unclean(d):
                    recover_location(d, report)
        RECOVERY_RUNS.inc(outcome="unclean")
        RECOVERY_SUSPECTS.inc(len(report.suspects))
        if report.suspects:
            glog.warning(
                f"recovery: queueing scrub suspects {report.suspects}")
    else:
        RECOVERY_RUNS.inc(
            outcome="disabled" if report.unclean else "clean")
    for d in locations:
        mark_dirty(d)
    return report


def _suspect(base: str, suspects: set[int]) -> None:
    m = _VID_RE.match(os.path.basename(base))
    if m:
        suspects.add(int(m.group("vid")))


def _valid_json(path: str) -> bool:
    try:
        with open(path) as f:
            json.load(f)
        return True
    except (OSError, ValueError):
        return False


def _valid_dig(path: str) -> bool:
    from ..scrub import digest

    try:
        with open(path, "rb") as f:
            magic = f.read(8)
        if magic == digest.EC_MAGIC:
            digest.read_ec_manifest(path)
        else:
            digest.read_manifest(path)
        return True
    except (OSError, ValueError):
        return False


def _valid_int(path: str) -> bool:
    try:
        with open(path) as f:
            int(f.read().strip() or "x")
        return True
    except (OSError, ValueError):
        return False
