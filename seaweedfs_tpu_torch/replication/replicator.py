"""Replicator: apply filer metadata events to a sink.

Counterpart of seaweedfs_tpu/replication/replicator.py (SeaweedFS
weed/replication/replicator.go) — Replicate()
dispatches EventNotification (old/new entry combinations) to the sink's
create/update/delete, materializing chunk data through the source. A sink
apply that keeps failing is retried with backoff and then raised. An event
whose chunks are gone because a later version replaced its entry is
skipped: the later event carries that version.
"""

from __future__ import annotations

from ..pb import filer_pb2
from ..utils import glog
from ..utils.retry import is_retryable, retry
from .sink import ReplicationSink, SinkUnavailable
from .source import ChunkNotFound, FilerSource


class Replicator:
    def __init__(self, source: FilerSource, sink: ReplicationSink, *,
                 source_prefix: str = "/", sink_attempts: int = 4,
                 sink_wait_init: float = 0.05):
        self.source = source
        self.sink = sink
        self.prefix = source_prefix.rstrip("/") or "/"
        # a flapping sink (target filer restart, S3 endpoint blip) is
        # retried with backoff instead of dropping the event on the floor
        self.sink_attempts = sink_attempts
        self.sink_wait_init = sink_wait_init

    def _apply(self, what: str, fn) -> None:
        # sink applies are idempotent (PUT-or-overwrite / delete-if-there),
        # so target-side 5xx (SinkUnavailable) are retryable too, not just
        # transport-level failures; 4xx rejections and local path errors
        # can never improve on retry and propagate at once
        retry(f"replication.{self.sink.name}.{what}", fn,
              attempts=self.sink_attempts, wait_init=self.sink_wait_init,
              retryable=lambda e: is_retryable(e)
              or isinstance(e, SinkUnavailable))

    def _strip(self, path: str) -> str | None:
        """Path relative to the replicated prefix, or None if outside."""
        if self.prefix == "/":
            return path
        if path == self.prefix:
            return "/"
        if path.startswith(self.prefix + "/"):
            return path[len(self.prefix):]
        return None

    def replicate(self, resp: filer_pb2.SubscribeMetadataResponse) -> bool:
        """-> True if the event was applied (in-prefix)."""
        ev = resp.event_notification
        directory = resp.directory
        has_old = bool(ev.old_entry.name)
        has_new = bool(ev.new_entry.name)
        applied = False
        if has_old:
            old_path = self._strip(
                directory.rstrip("/") + "/" + ev.old_entry.name)
            new_dir = ev.new_parent_path or directory
            new_path = self._strip(
                new_dir.rstrip("/") + "/" + ev.new_entry.name) \
                if has_new else None
            if old_path is not None and old_path != new_path:
                self._apply("delete", lambda: self.sink.delete_entry(
                    old_path, ev.old_entry.is_directory))
                applied = True
        if has_new:
            new_dir = ev.new_parent_path or directory
            source_path = new_dir.rstrip("/") + "/" + ev.new_entry.name
            new_path = self._strip(source_path)
            if new_path is not None:
                data = None
                if not ev.new_entry.is_directory:
                    try:
                        data = self.source.read_entry_content(
                            ev.new_entry, source_path)
                    except ChunkNotFound:
                        # a later event carries the version that replaced
                        # this one (SeaweedFS's filer sink logs and goes
                        # on); the reference raises here and so stalls on
                        # this event (ROADMAP.md C)
                        if not self.source.superseded(source_path,
                                                      ev.new_entry):
                            raise
                        glog.v(1, f"replicate {source_path}: superseded "
                                  f"since this event; skipped")
                        return applied
                self._apply("create", lambda: self.sink.create_entry(
                    new_path, ev.new_entry, data))
                applied = True
        if applied:
            glog.v(1, f"replicated {directory}: "
                      f"old={ev.old_entry.name!r} new={ev.new_entry.name!r}")
        return applied
