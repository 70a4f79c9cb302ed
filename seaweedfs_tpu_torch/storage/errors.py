"""Storage error types shared by the Volume and EcVolume paths (a copy of
seaweedfs_tpu/storage/errors.py; SeaweedFS weed/storage/volume_write.go's
sentinel errors)."""


class NotFoundError(KeyError):
    """Needle id absent (ErrorNotFound)."""


class DeletedError(KeyError):
    """Needle exists only as a tombstone (ErrorDeleted)."""


class CookieMismatch(ValueError):
    """Request cookie does not match the stored needle's cookie."""


class QuarantinedError(IOError):
    """The needle is quarantined by the scrub plane: its on-disk bytes
    failed verification and a repair is in flight. Serving layers must
    answer from a healthy replica, never from the local record."""

    def __init__(self, vid: int, needle_id: int):
        self.volume_id = vid
        self.needle_id = needle_id
        super().__init__(
            f"needle {needle_id:x} of volume {vid} is quarantined for repair")


class VacuumCrcError(IOError):
    """The scrub-aware vacuum found a live record whose bytes fail CRC:
    compaction aborted rather than copying rot forward. Distinct from
    plain IOError so callers can scope repair-ladder escalation to
    ACTUAL corruption — an ENOSPC or unloaded-volume IOError during a
    vacuum must not queue the volume as a corruption suspect."""

    def __init__(self, vid: int, needle_id: int, offset: int):
        self.volume_id = vid
        self.needle_id = needle_id
        self.offset = offset
        super().__init__(
            f"volume {vid}: needle {needle_id:x} at offset {offset} "
            f"failed CRC re-verify during vacuum — aborting compaction")
