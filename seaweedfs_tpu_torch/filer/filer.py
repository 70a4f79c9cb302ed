"""Filer core: entry CRUD over a FilerStore + metadata event log.

Counterpart of seaweedfs_tpu/filer/filer.py (SeaweedFS weed/filer/filer.go:
CreateEntry :175, UpdateEntry :284, FindEntry :312; filer_delete_entry.go,
filer_rename.go via filer gRPC AtomicRenameEntry, and filer_notify.go's
metadata event stream, whose LogBuffer becomes a bounded in-memory deque
that subscribers drain with a replay cursor). Each event is also
published to the queue notification.toml configures, if any
(filer_notify.go's Queue.SendMessage).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..pb import filer_pb2
from .entry import Entry, new_directory_entry
from .filerstore import FilerStore
from .meta_log import SYSTEM_LOG_DIR, MetaLog


class FilerError(Exception):
    pass


class NotFound(FilerError):
    pass


class NotEmpty(FilerError):
    pass


class Filer:
    def __init__(self, store: FilerStore, *, log_capacity: int = 16384,
                 persist_meta_log: bool = True):
        self.store = store
        self._log: deque[filer_pb2.SubscribeMetadataResponse] = deque(
            maxlen=log_capacity)
        self._log_cond = threading.Condition()
        self.signature = int(time.time_ns()) & 0x7FFFFFFF
        # filer_notify.go:70 logMetaEvent — events also flush to dated
        # segment entries under /topics/.system/log so subscribers can
        # resume point-in-time across restarts (and a lagging subscriber
        # falls back to the persisted log instead of losing drops from
        # the bounded deque).
        self.meta_log = MetaLog(store) if persist_meta_log else None
        # optional external publisher (notification.toml; filer_notify.go's
        # Queue.SendMessage side of NotifyUpdateEvent) — set by the server
        self.notification_queue = None
        # optional mutation hook (path, recursive) — the native filer hot
        # plane registers one so python-side mutations (S3 gateway,
        # DELETE, rename) invalidate its path cache (see
        # native/dataplane.cpp filer hot plane). Called AFTER the store
        # mutation commits.
        self.on_mutate = None

    def _mutated(self, path: str, recursive: bool = False) -> None:
        if self.on_mutate is not None:
            try:
                self.on_mutate(path, recursive)
            # lint: allow-broad-except(the store mutation has committed; a
            # failed invalidation must not fail it, as in the reference)
            except Exception:  # noqa: BLE001
                pass

    # -- events (filer_notify.go:20 NotifyUpdateEvent) ---------------------

    def _notify(self, directory: str, old: Entry | None, new: Entry | None,
                delete_chunks: bool = False,
                from_other_cluster: bool = False) -> None:
        if directory.startswith(SYSTEM_LOG_DIR):
            return  # the log must not log itself (filer_notify.go SystemLogDir)
        ev = filer_pb2.EventNotification(
            delete_chunks=delete_chunks,
            is_from_other_cluster=from_other_cluster,
            signatures=[self.signature])
        if old is not None:
            ev.old_entry.CopyFrom(old.to_pb())
        if new is not None:
            ev.new_entry.CopyFrom(new.to_pb())
            if old is not None and old.parent != new.parent:
                ev.new_parent_path = new.parent
        msg = filer_pb2.SubscribeMetadataResponse(
            directory=directory, ts_ns=time.time_ns())
        msg.event_notification.CopyFrom(ev)
        with self._log_cond:
            self._log.append(msg)
            self._log_cond.notify_all()
        if self.meta_log is not None:
            self.meta_log.append(msg)
        if self.notification_queue is not None:
            key = (new or old).full_path if (new or old) else directory
            try:
                self.notification_queue.send_message(key, ev)
            except Exception as e:  # publisher failures must not fail writes
                from ..utils import glog

                glog.warning(f"notification publish failed: {e}")

    def read_events(self, since_ns: int, timeout: float = 1.0):
        """-> (events newer than since_ns, new cursor).

        Served from the in-memory tail when the cursor is inside its window;
        a cursor older than the window (subscriber lagged past the deque, or
        the filer restarted) replays the persisted log first
        (ReadPersistedLogBuffer, filer_notify.go:116)."""
        with self._log_cond:
            oldest = self._log[0].ts_ns if self._log else None
        if self.meta_log is not None and (oldest is None or since_ns < oldest):
            persisted = list(self.meta_log.read_since(since_ns))
            if persisted:
                with self._log_cond:
                    mem = {m.ts_ns for m in self._log}
                out = [m for m in persisted if m.ts_ns not in mem]
                with self._log_cond:
                    out += [m for m in self._log if m.ts_ns > since_ns]
                out.sort(key=lambda m: m.ts_ns)
                if out:
                    return out, out[-1].ts_ns
        with self._log_cond:
            out = [m for m in self._log if m.ts_ns > since_ns]
            if not out:
                self._log_cond.wait(timeout)
                out = [m for m in self._log if m.ts_ns > since_ns]
            return out, (out[-1].ts_ns if out else since_ns)

    # -- CRUD --------------------------------------------------------------

    def find_entry(self, path: str) -> Entry:
        path = normalize(path)
        if path == "/":
            return new_directory_entry("/")
        e = self.store.find_entry(path)
        if e is None:
            raise NotFound(path)
        return e

    def exists(self, path: str) -> bool:
        try:
            self.find_entry(path)
            return True
        except NotFound:
            return False

    def create_entry(self, entry: Entry, *, o_excl: bool = False,
                     skip_parents: bool = False,
                     from_other_cluster: bool = False) -> None:
        entry.full_path = normalize(entry.full_path)
        if not skip_parents:
            self._ensure_parents(entry.parent)
        old = self.store.find_entry(entry.full_path)
        if old is not None and o_excl:
            raise FilerError(f"{entry.full_path} already exists")
        if old is not None and old.is_directory and not entry.is_directory:
            raise FilerError(f"{entry.full_path} is a directory")
        self.store.insert_entry(entry)
        self._mutated(entry.full_path)
        self._notify(entry.parent, old, entry,
                     from_other_cluster=from_other_cluster)

    def _ensure_parents(self, dir_path: str) -> None:
        dir_path = normalize(dir_path)
        if dir_path == "/":
            return
        if self.store.find_entry(dir_path) is not None:
            return
        self._ensure_parents(parent_of(dir_path))
        self.store.insert_entry(new_directory_entry(dir_path))

    def update_entry(self, entry: Entry, *,
                     from_other_cluster: bool = False) -> None:
        entry.full_path = normalize(entry.full_path)
        old = self.store.find_entry(entry.full_path)
        if old is None:
            raise NotFound(entry.full_path)
        self.store.update_entry(entry)
        self._mutated(entry.full_path)
        self._notify(entry.parent, old, entry,
                     from_other_cluster=from_other_cluster)

    def delete_entry(self, path: str, *, recursive: bool = False,
                     is_delete_data: bool = True,
                     from_other_cluster: bool = False) -> list[str]:
        """-> chunk fids to garbage-collect (filer_delete_entry.go)."""
        path = normalize(path)
        entry = self.find_entry(path)
        fids: list[str] = []
        if entry.is_directory:
            kids = list(self.store.list_directory_entries(path, limit=2))
            if kids and not recursive:
                raise NotEmpty(f"directory {path} not empty")
            fids.extend(self._collect_fids_recursive(path))
            self.store.delete_folder_children(path)
        if is_delete_data:
            fids.extend(c.file_id for c in entry.chunks)
        self.store.delete_entry(path)
        self._mutated(path, recursive=entry.is_directory)
        self._notify(entry.parent, entry, None, delete_chunks=is_delete_data,
                     from_other_cluster=from_other_cluster)
        return fids

    def _collect_fids_recursive(self, dir_path: str) -> list[str]:
        fids = []
        start = ""
        while True:
            batch = list(self.store.list_directory_entries(
                dir_path, start_file_name=start, limit=1024))
            if not batch:
                break
            for e in batch:
                if e.is_directory:
                    fids.extend(self._collect_fids_recursive(e.full_path))
                else:
                    fids.extend(c.file_id for c in e.chunks)
            start = batch[-1].name
            if len(batch) < 1024:
                break
        return fids

    def rename(self, old_path: str, new_path: str) -> None:
        """AtomicRenameEntry semantics: move the entry (and any subtree) by
        rewriting paths in the store (filer_rename.go moveEntry)."""
        for _ in self.rename_stream(old_path, new_path):
            pass

    def rename_stream(self, old_path: str, new_path: str):
        """rename() that yields each (old_entry, moved_entry) as it lands
        — the engine under both AtomicRenameEntry and StreamRenameEntry
        (filer_grpc_server_rename.go:51 moveEntry): children move first,
        depth-first, then the entry itself."""
        old_path, new_path = normalize(old_path), normalize(new_path)
        entry = self.find_entry(old_path)
        self._ensure_parents(parent_of(new_path))
        if entry.is_directory:
            for child in list(self.store.list_directory_entries(
                    old_path, limit=1_000_000)):
                yield from self.rename_stream(child.full_path,
                                              new_path + "/" + child.name)
        moved = Entry(full_path=new_path, attr=entry.attr, chunks=entry.chunks,
                      extended=entry.extended, content=entry.content,
                      is_directory=entry.is_directory,
                      hard_link_id=entry.hard_link_id,
                      hard_link_counter=entry.hard_link_counter)
        self.store.delete_entry(old_path)
        self.store.insert_entry(moved)
        self._mutated(old_path, recursive=entry.is_directory)
        self._mutated(new_path, recursive=entry.is_directory)
        # the event sits in the directory the entry left, and names the
        # one it entered (filer_notify.go NotifyUpdateEvent); the
        # reference files it under the new directory, so a subscriber
        # deletes a path that never existed (ROADMAP.md C)
        self._notify(entry.parent, entry, moved)
        yield entry, moved

    def list_entries(self, dir_path: str, start: str = "",
                     include_start: bool = False, limit: int = 1024,
                     prefix: str = ""):
        return self.store.list_directory_entries(
            normalize(dir_path), start, include_start, limit, prefix)


def normalize(p: str) -> str:
    if not p.startswith("/"):
        p = "/" + p
    while "//" in p:
        p = p.replace("//", "/")
    return p.rstrip("/") or "/"


def parent_of(p: str) -> str:
    p = normalize(p)
    if p == "/":
        return "/"
    return p.rsplit("/", 1)[0] or "/"
