"""Persisted filer metadata log under /topics/.system/log.

Counterpart of seaweedfs_tpu/filer/meta_log.py (SeaweedFS
weed/filer/filer_notify.go: logMetaEvent :70 streams every metadata event
into dated segment files stored through the filer's own namespace, and
ReadPersistedLogBuffer :116 replays them for a point-in-time resume, so a
subscriber resumes across a filer restart).

Design differences from the reference (same behavior, simpler machinery):
  * Events are length-framed serialized SubscribeMetadataResponse protos
    (4-byte big-endian length + payload), accumulated in a small buffer and
    flushed to the current segment entry by a daemon thread (interval) or
    inline (size threshold).
  * A segment is a filer entry `/topics/.system/log/<YYYY-MM-DD>/<HH-MM-SS>.<startNs>`
    whose bytes live in the entry's inline `content` — so persistence
    inherits whatever durability the configured FilerStore has (sqlite /
    leveldb survive restart; the memory store mirrors the reference's
    behavior when its log store is wiped).
  * Segment entries are written store-direct (no _notify), the reference's
    SystemLogDir skip.
"""

from __future__ import annotations

import threading
from datetime import datetime, timezone

from ..pb import filer_pb2
from .entry import Entry, new_directory_entry

SYSTEM_LOG_DIR = "/topics/.system/log"


class MetaLog:
    def __init__(self, store, *, segment_max_bytes: int = 4 << 20,
                 flush_interval: float = 2.0, flush_threshold: int = 256 << 10):
        self.store = store
        self.segment_max_bytes = segment_max_bytes
        self.flush_interval = flush_interval
        self.flush_threshold = flush_threshold
        self._lock = threading.Lock()
        self._buf = bytearray()
        self._buf_start_ns = 0
        self._segment_path: str | None = None
        self._segment_size = 0
        self._flusher: threading.Thread | None = None
        self._stop = threading.Event()

    # -- write side --------------------------------------------------------

    def append(self, msg: filer_pb2.SubscribeMetadataResponse) -> None:
        blob = msg.SerializeToString()
        flush_now = False
        with self._lock:
            if not self._buf:
                self._buf_start_ns = msg.ts_ns
            self._buf += len(blob).to_bytes(4, "big") + blob
            flush_now = len(self._buf) >= self.flush_threshold
            if self._flusher is None:
                self._flusher = threading.Thread(
                    target=self._flush_loop, name="meta-log-flush", daemon=True)
                self._flusher.start()
        if flush_now:
            self.flush()

    def _flush_loop(self) -> None:
        while not self._stop.wait(self.flush_interval):
            try:
                self.flush()
            except Exception as e:  # keep the flusher alive across store hiccups
                from ..utils import glog

                glog.warning(f"meta log flush failed: {e}")

    def flush(self) -> None:
        with self._lock:
            if not self._buf:
                return
            payload, start_ns = bytes(self._buf), self._buf_start_ns
            self._buf.clear()
            self._buf_start_ns = 0
            self._write_segment(payload, start_ns)

    def _write_segment(self, payload: bytes, start_ns: int) -> None:
        """Append to the open segment entry, rolling by date or size."""
        day = datetime.fromtimestamp(start_ns / 1e9, tz=timezone.utc)
        date_dir = f"{SYSTEM_LOG_DIR}/{day:%Y-%m-%d}"
        roll = (
            self._segment_path is None
            or not self._segment_path.startswith(date_dir + "/")
            or self._segment_size + len(payload) > self.segment_max_bytes
        )
        if roll:
            self._ensure_dir(date_dir)
            self._segment_path = f"{date_dir}/{day:%H-%M-%S}.{start_ns}"
            self._segment_size = 0
            seg = Entry(full_path=self._segment_path, content=payload)
            seg.attr.mtime = seg.attr.crtime = int(start_ns / 1e9)
            self.store.insert_entry(seg)
        else:
            seg = self.store.find_entry(self._segment_path)
            if seg is None:  # wiped underneath us — restart the segment
                self._segment_path = None
                return self._write_segment(payload, start_ns)
            seg.content += payload
            self.store.update_entry(seg)
        self._segment_size += len(payload)

    def _ensure_dir(self, dir_path: str) -> None:
        parts = dir_path.strip("/").split("/")
        path = ""
        for p in parts:
            path += "/" + p
            if self.store.find_entry(path) is None:
                self.store.insert_entry(new_directory_entry(path))

    # -- read side (ReadPersistedLogBuffer, filer_notify.go:116) -----------

    def read_since(self, since_ns: int):
        """Yield persisted events with ts_ns > since_ns, oldest first.
        Flushes the write buffer first so the persisted view is current."""
        self.flush()
        segments: list[tuple[int, str]] = []  # (start_ns, path)
        days = self.store.list_directory_entries(SYSTEM_LOG_DIR, limit=10000)
        for day in sorted(days or [], key=lambda e: e.full_path):
            kids = self.store.list_directory_entries(day.full_path, limit=100000)
            for seg in kids or []:
                try:
                    start_ns = int(seg.full_path.rsplit(".", 1)[1])
                except (IndexError, ValueError):
                    continue
                segments.append((start_ns, seg.full_path))
        segments.sort()
        for idx, (start_ns, path) in enumerate(segments):
            nxt = segments[idx + 1][0] if idx + 1 < len(segments) else None
            if nxt is not None and nxt <= since_ns:
                continue  # every event in this segment predates the cursor
            seg = self.store.find_entry(path)
            if seg is None:
                continue
            data, off = seg.content, 0
            while off + 4 <= len(data):
                ln = int.from_bytes(data[off:off + 4], "big")
                off += 4
                if off + ln > len(data):
                    break  # torn tail from an interrupted flush
                msg = filer_pb2.SubscribeMetadataResponse()
                try:
                    msg.ParseFromString(bytes(data[off:off + ln]))
                # lint: allow-broad-except(an undecodable record ends the
                # segment's readable prefix, as a torn tail does)
                except Exception:  # noqa: BLE001
                    break
                off += ln
                if msg.ts_ns > since_ns:
                    yield msg

    def close(self) -> None:
        self._stop.set()
        self.flush()
