"""Volume file backends and the cloud-tier targets.

Counterpart of seaweedfs_tpu/storage/backend.py (SeaweedFS
weed/storage/backend/): BackendStorageFile (backend.go) abstracts where
`.dat` bytes live: a local disk file (disk_file.go), an mmap'd file
(memory_map/), or a remote tier object (s3_backend/, rclone_backend/). A
sealed volume's `.dat` can be moved to a tier backend
(`volume.tier.move`); reads then range-fetch from the remote while `.idx`
stays local, as SeaweedFS's VolumeTierMoveDatToRemote flow does.

Tier backends here: `local` (directory-backed, always available) and `s3`
(any S3 HTTP endpoint, the port's own gateway among them), loaded from a
master.toml-shaped config by `load_tier_backends`. A `.tier` JSON sidecar
next to the `.idx` records where the `.dat` went (SeaweedFS stores the
same in the volume's `.vif` VolumeInfo).
"""

from __future__ import annotations

import json
import mmap
import os

from ..utils import failpoint


class BackendStorageFile:
    """SPI (backend.go BackendStorageFile)."""

    def read_at(self, offset: int, length: int) -> bytes:
        raise NotImplementedError

    def write_at(self, offset: int, data: bytes) -> int:
        raise NotImplementedError

    def append(self, data: bytes) -> int:
        """-> offset the data landed at."""
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def truncate(self, size: int) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def drop_page_cache(self, offset: int = 0, length: int = 0) -> None:
        """Hint the kernel to evict this file's cached pages: a cold CRC sweep reads every byte exactly once
        and must not evict the serving working set. `length` 0 = to EOF.
        Default no-op — remote/tier backends have no local pages."""

    def close(self) -> None:
        pass

    @property
    def writable(self) -> bool:
        return False


class DiskFile(BackendStorageFile):
    """Local file (disk_file.go); pread-based, safe for concurrent reads."""

    def __init__(self, path: str, create: bool = False):
        self.path = path
        self._f = open(path, "w+b" if create and not os.path.exists(path)
                       else "r+b")

    def read_at(self, offset, length):
        return os.pread(self._f.fileno(), length, offset)

    def write_at(self, offset, data):
        return os.pwrite(self._f.fileno(), data, offset)

    def _torn_guard(self, data: bytes) -> None:
        # torn-write site: every sequential write — .dat needle
        # records (via write()), .ec*/log appends (via append()) —
        # funnels through here, so one armed point can tear any of
        # them. The tear is fsync'd FIRST — a prefix still sitting in
        # the page cache would vanish with the process and the "crash"
        # would look clean — then the process dies (or, in in-process
        # test stacks, raises; see failpoint.crash_self).
        cut = failpoint.torn("backend.append", data,
                             ctx=self.path + ",")
        if cut is not None:
            self._f.write(data[:cut])
            self._f.flush()
            os.fsync(self._f.fileno())
            failpoint.crash_self("backend.append")

    def append(self, data):
        self._f.seek(0, 2)
        offset = self._f.tell()
        self._torn_guard(data)
        self._f.write(data)
        return offset

    def seek_end(self) -> int:
        self._f.seek(0, 2)
        return self._f.tell()

    def seek(self, offset: int) -> None:
        self._f.seek(offset)

    def tell(self) -> int:
        return self._f.tell()

    def read(self, n: int = -1) -> bytes:
        return self._f.read(n)

    def write(self, data: bytes) -> int:
        if failpoint.is_armed("backend.append"):
            self._torn_guard(data)
        return self._f.write(data)

    def size(self):
        return os.fstat(self._f.fileno()).st_size

    def truncate(self, size):
        self._f.truncate(size)

    def flush(self):
        self._f.flush()

    def drop_page_cache(self, offset=0, length=0):
        # DONTNEED acts on the inode's page cache, so this also drops
        # pages faulted in through OTHER descriptors on the same file —
        # including the native (C++) data plane's own fd
        fadvise = getattr(os, "posix_fadvise", None)
        if fadvise is None:
            return  # non-POSIX host: graceful no-op
        try:
            fadvise(self._f.fileno(), offset, length,
                    os.POSIX_FADV_DONTNEED)
        except (OSError, ValueError):
            # best-effort hint, never an error — ValueError covers
            # fileno() on a file another thread already closed
            # (vacuum/compaction swap, server shutdown)
            pass

    def close(self):
        self._f.close()

    def fileno(self) -> int:
        return self._f.fileno()

    @property
    def writable(self):
        return True


class MmapFile(BackendStorageFile):
    """Read-mostly mmap'd file (memory_map/): zero-copy reads for hot
    volumes; writes go through the underlying descriptor."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "r+b")
        self._size = os.fstat(self._f.fileno()).st_size
        self._mm = mmap.mmap(self._f.fileno(), 0,
                             access=mmap.ACCESS_READ) \
            if self._size else None

    def read_at(self, offset, length):
        if self._mm is None:
            return b""
        return bytes(self._mm[offset:offset + length])

    def size(self):
        return self._size

    def fileno(self) -> int:
        return self._f.fileno()

    def drop_page_cache(self, offset=0, length=0):
        fadvise = getattr(os, "posix_fadvise", None)
        if fadvise is None:
            return
        try:
            fadvise(self._f.fileno(), offset, length,
                    os.POSIX_FADV_DONTNEED)
        except (OSError, ValueError):
            pass  # see DiskFile.drop_page_cache

    def close(self):
        if self._mm is not None:
            self._mm.close()
        self._f.close()


# -- tier backends ---------------------------------------------------------

class TierBackend:
    """Remote home for sealed `.dat` files (backend.go BackendStorage)."""

    name = "abstract"

    def upload(self, key: str, local_path: str) -> int:
        raise NotImplementedError

    def download(self, key: str, local_path: str) -> int:
        raise NotImplementedError

    def read_range(self, key: str, offset: int, length: int) -> bytes:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError


class LocalTierBackend(TierBackend):
    """Directory-backed tier (stands in for any shared/network mount)."""

    def __init__(self, root: str, name: str = "local"):
        self.root = root
        self.name = name
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "_"))

    def upload(self, key, local_path):
        import shutil

        shutil.copyfile(local_path, self._path(key))
        return os.path.getsize(self._path(key))

    def download(self, key, local_path):
        import shutil

        shutil.copyfile(self._path(key), local_path)
        return os.path.getsize(local_path)

    def read_range(self, key, offset, length):
        with open(self._path(key), "rb") as f:
            return os.pread(f.fileno(), length, offset)

    def delete(self, key):
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass


class S3TierBackend(TierBackend):
    """S3-endpoint tier (s3_backend/s3_backend.go) via HTTP + SigV4."""

    def __init__(self, endpoint: str, bucket: str, *, name: str = "s3",
                 access_key: str = "", secret_key: str = "",
                 region: str = "us-east-1"):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.name = name
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region

    def _url(self, key: str) -> str:
        import urllib.parse

        return (f"{self.endpoint}/{self.bucket}/"
                f"{urllib.parse.quote(key, safe='/')}")

    def _headers(self, method: str, url: str, payload: bytes,
                 extra: dict | None = None) -> dict:
        h = dict(extra or {})
        if self.access_key:
            from ..s3api.sigv4_client import sign_request

            h.update(sign_request(method, url, payload, self.access_key,
                                  self.secret_key, self.region))
        return h

    def upload(self, key, local_path):
        import requests

        with open(local_path, "rb") as f:
            data = f.read()
        url = self._url(key)
        r = requests.put(url, data=data,
                         headers=self._headers("PUT", url, data),
                         timeout=600)
        r.raise_for_status()
        return len(data)

    def download(self, key, local_path):
        import requests

        url = self._url(key)
        r = requests.get(url, headers=self._headers("GET", url, b""),
                         timeout=600)
        r.raise_for_status()
        with open(local_path, "wb") as f:
            f.write(r.content)
        return len(r.content)

    def read_range(self, key, offset, length):
        import requests

        url = self._url(key)
        r = requests.get(url, timeout=60, headers=self._headers(
            "GET", url, b"",
            {"Range": f"bytes={offset}-{offset + length - 1}"}))
        r.raise_for_status()
        return r.content

    def delete(self, key):
        import requests

        url = self._url(key)
        requests.delete(url, headers=self._headers("DELETE", url, b""),
                        timeout=60)


class RemoteDatFile(BackendStorageFile):
    """A tiered volume's `.dat`: ranged reads against a TierBackend."""

    def __init__(self, backend: TierBackend, key: str, size: int):
        self.backend = backend
        self.key = key
        self._size = size

    def read_at(self, offset, length):
        if offset >= self._size:
            return b""
        length = min(length, self._size - offset)
        return self.backend.read_range(self.key, offset, length)

    def size(self):
        return self._size


# -- registry + .tier sidecar ----------------------------------------------

_BACKENDS: dict[str, TierBackend] = {}


def register_tier_backend(backend: TierBackend) -> TierBackend:
    _BACKENDS[backend.name] = backend
    return backend


def get_tier_backend(name: str) -> TierBackend:
    b = _BACKENDS.get(name)
    if b is None:
        raise KeyError(
            f"unknown tier backend {name!r} (configured: {sorted(_BACKENDS)})")
    return b


def load_tier_backends(config: dict) -> None:
    """Config shape mirrors master.toml's [storage.backend] section:
    {"s3": {"default": {"endpoint": ..., "bucket": ...}},
     "local": {"default": {"root": ...}}}"""
    for kind, instances in config.items():
        for name, conf in instances.items():
            full = kind if name == "default" else f"{kind}.{name}"
            if kind == "local":
                register_tier_backend(
                    LocalTierBackend(conf["root"], name=full))
            elif kind == "s3":
                register_tier_backend(S3TierBackend(
                    conf["endpoint"], conf["bucket"], name=full,
                    access_key=conf.get("access_key", ""),
                    secret_key=conf.get("secret_key", ""),
                    region=conf.get("region", "us-east-1")))
            else:
                raise KeyError(f"unknown tier backend kind {kind!r}")


def tier_sidecar_path(volume_base: str) -> str:
    return volume_base + ".tier"


def write_tier_sidecar(volume_base: str, backend_name: str, key: str,
                       size: int) -> None:
    with open(tier_sidecar_path(volume_base), "w") as f:
        json.dump({"backend": backend_name, "key": key, "size": size}, f)


def read_tier_sidecar(volume_base: str) -> dict | None:
    try:
        with open(tier_sidecar_path(volume_base)) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
