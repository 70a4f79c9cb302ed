"""Storage error types shared by the EC read path (a copy of the part of
seaweedfs_tpu/storage/errors.py the port needs)."""


class NotFoundError(KeyError):
    """Needle id absent, or present only as a tombstone."""
