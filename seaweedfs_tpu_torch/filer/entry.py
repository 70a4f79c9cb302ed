"""Filer entry model: path -> attributes + chunk list.

Counterpart of seaweedfs_tpu/filer/entry.py (SeaweedFS weed/filer/entry.go
and filechunks.go's FileChunk model). An Entry is either a directory or a file whose bytes live as chunks
(fid extents) on volume servers; small files may inline `content`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..pb import filer_pb2


@dataclass
class Attr:
    mtime: int = 0           # unix seconds
    crtime: int = 0
    mode: int = 0o660
    uid: int = 0
    gid: int = 0
    mime: str = ""
    ttl_sec: int = 0
    user_name: str = ""
    symlink_target: str = ""
    md5: bytes = b""
    disk_type: str = ""
    file_size: int = 0       # declared size for chunk-less entries
    #                          (remote-mounted mirrors carry no chunks)

    @property
    def is_directory(self) -> bool:
        return bool(self.mode & 0o40000 == 0o40000) or bool(self.mode & (1 << 31))


@dataclass
class Entry:
    full_path: str = "/"
    attr: Attr = field(default_factory=Attr)
    chunks: list[filer_pb2.FileChunk] = field(default_factory=list)
    extended: dict[str, bytes] = field(default_factory=dict)
    content: bytes = b""
    hard_link_id: bytes = b""
    hard_link_counter: int = 0
    is_directory: bool = False
    quota: int = 0  # bucket dirs only (filer.proto Entry.quota)

    @property
    def name(self) -> str:
        return self.full_path.rstrip("/").rsplit("/", 1)[-1] if self.full_path != "/" else ""

    @property
    def parent(self) -> str:
        if self.full_path == "/":
            return "/"
        p = self.full_path.rstrip("/").rsplit("/", 1)[0]
        return p or "/"

    def size(self) -> int:
        if self.content:
            return len(self.content)
        return max((c.offset + c.size for c in self.chunks),
                   default=self.attr.file_size)

    # -- protobuf conversion ----------------------------------------------

    def to_pb(self) -> filer_pb2.Entry:
        e = filer_pb2.Entry(
            name=self.name, is_directory=self.is_directory,
            content=self.content, hard_link_id=self.hard_link_id,
            hard_link_counter=self.hard_link_counter, quota=self.quota,
        )
        e.chunks.extend(self.chunks)
        a = self.attr
        e.attributes.CopyFrom(filer_pb2.FuseAttributes(
            file_size=self.size(), mtime=a.mtime, file_mode=a.mode,
            uid=a.uid, gid=a.gid, crtime=a.crtime, mime=a.mime,
            ttl_sec=a.ttl_sec, user_name=a.user_name,
            symlink_target=a.symlink_target, md5=a.md5, disk_type=a.disk_type,
        ))
        for k, v in self.extended.items():
            e.extended[k] = v
        return e

    @classmethod
    def from_pb(cls, directory: str, e: filer_pb2.Entry) -> "Entry":
        a = e.attributes
        full = directory.rstrip("/") + "/" + e.name if e.name else directory
        return cls(
            full_path=full or "/",
            attr=Attr(mtime=a.mtime, crtime=a.crtime, mode=a.file_mode,
                      uid=a.uid, gid=a.gid, mime=a.mime, ttl_sec=a.ttl_sec,
                      user_name=a.user_name, symlink_target=a.symlink_target,
                      md5=a.md5, disk_type=a.disk_type,
                      file_size=a.file_size),
            chunks=list(e.chunks),
            extended=dict(e.extended),
            content=e.content,
            hard_link_id=e.hard_link_id,
            hard_link_counter=e.hard_link_counter,
            is_directory=e.is_directory,
            quota=e.quota,
        )


def new_directory_entry(path: str, mode: int = 0o770) -> Entry:
    now = int(time.time())
    return Entry(full_path=path, is_directory=True,
                 attr=Attr(mtime=now, crtime=now, mode=mode | 0o40000))
