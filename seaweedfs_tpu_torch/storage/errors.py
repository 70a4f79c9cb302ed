"""Storage error types shared by the Volume and EcVolume paths (a copy of
the part of seaweedfs_tpu/storage/errors.py the port needs; SeaweedFS
weed/storage/volume_write.go's sentinel errors)."""


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
