"""Continuous integrity plane: background scrubbing, digest-based
anti-entropy, and self-healing repair.

- `scrubber.Scrubber` — the paced per-volume-server daemon: needle CRC
  sweeps with a persistent cursor, EC syndrome verification through the
  shared dispatch scheduler, and the quarantine -> re-replicate /
  EC-rebuild -> re-verify repair ladder.
- `digest` — per-volume digest manifests (sorted per-needle CRCs +
  rolling digest) so cross-replica anti-entropy compares ~16 bytes per
  needle instead of shipping content.
"""

from .digest import (
    DigestEntry,
    diff_entries,
    manifest_bytes,
    read_manifest,
    rolling_digest,
    volume_digest_entries,
    write_manifest,
)
from .scrubber import Finding, ScrubReport, Scrubber, TokenBucket

__all__ = [
    "DigestEntry",
    "Finding",
    "ScrubReport",
    "Scrubber",
    "TokenBucket",
    "diff_entries",
    "manifest_bytes",
    "read_manifest",
    "rolling_digest",
    "volume_digest_entries",
    "write_manifest",
]
