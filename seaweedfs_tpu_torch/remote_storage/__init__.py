"""Cloud-tier remote storage mounts.

Counterpart of seaweedfs_tpu/remote_storage/__init__.py (SeaweedFS
weed/remote_storage/): a filer directory can be
mounted onto a remote (cloud) store; entries mirror remote objects with a
`remote entry` marker, bytes are fetched lazily ("cache") and can be
dropped again ("uncache"). The client SPI mirrors remote_storage_client.go
(Traverse, ReadFile, WriteFile, DeleteFile); a directory-backed `local`
client is the built-in working implementation (the reference's tests use
its own cluster similarly), an `s3` client rides any S3 HTTP endpoint,
and gcs/azure/b2 ride the REST wire clients in ..cloud (JSON API,
SharedKey signing, B2 native API). Mount configuration persists in the filer
at /etc/remote.conf as JSON, like the reference's remote.conf protobuf.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass

from ..pb import filer_pb2, rpc

REMOTE_CONF_DIR = "/etc"
REMOTE_CONF_FILE = "remote.conf"
REMOTE_ENTRY_KEY = "remote.entry"  # Entry.extended marker


@dataclass
class RemoteEntry:
    """Mirror of remote object metadata (remote_pb RemoteEntry)."""

    path: str           # path under the remote mount root
    size: int
    mtime: int
    etag: str = ""

    def to_json(self) -> bytes:
        return json.dumps(dataclasses.asdict(self)).encode()

    @classmethod
    def from_json(cls, blob: bytes) -> "RemoteEntry":
        return cls(**json.loads(blob))


class RemoteStorageClient:
    """SPI (remote_storage_client.go RemoteStorageClient)."""

    def traverse(self, prefix: str = ""):
        """yields RemoteEntry for every object under prefix."""
        raise NotImplementedError

    def read_file(self, path: str, offset: int = 0, size: int = -1) -> bytes:
        """Whole object, or the [offset, offset+size) range when size >= 0."""
        raise NotImplementedError

    def write_file(self, path: str, data: bytes) -> RemoteEntry:
        raise NotImplementedError

    def delete_file(self, path: str) -> None:
        raise NotImplementedError


class LocalRemoteStorage(RemoteStorageClient):
    """Directory-backed remote (usable + the test double)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._real = os.path.realpath(root)

    def _abs(self, path: str) -> str:
        """`path` under the root. A path that leaves it, by `..` or a
        link, raises PermissionError: the reference joins without a
        check (ROADMAP.md C)."""
        full = os.path.realpath(os.path.join(self._real, path.lstrip("/")))
        if full != self._real and not full.startswith(
                self._real.rstrip(os.sep) + os.sep):
            raise PermissionError(f"{path!r} leaves the remote root "
                                  f"{self.root!r}")
        return full

    def traverse(self, prefix: str = ""):
        base = self._abs(prefix)
        for dirpath, _dirs, files in os.walk(base if os.path.isdir(base)
                                             else self._real):
            for name in sorted(files):
                full = os.path.join(dirpath, name)
                rel = os.path.relpath(full, self._real)
                if prefix and not rel.startswith(prefix.lstrip("/")):
                    continue
                st = os.stat(full)
                yield RemoteEntry(path="/" + rel, size=st.st_size,
                                  mtime=int(st.st_mtime))

    def read_file(self, path: str, offset: int = 0, size: int = -1) -> bytes:
        with open(self._abs(path), "rb") as f:
            f.seek(offset)
            return f.read() if size < 0 else f.read(size)

    def write_file(self, path: str, data: bytes) -> RemoteEntry:
        target = self._abs(path)
        os.makedirs(os.path.dirname(target), exist_ok=True)
        with open(target, "wb") as f:
            f.write(data)
        return RemoteEntry(path=path, size=len(data),
                           mtime=int(time.time()))

    def delete_file(self, path: str) -> None:
        try:
            os.remove(self._abs(path))
        except FileNotFoundError:
            pass


class S3RemoteStorage(RemoteStorageClient):
    """S3-endpoint remote (remote_storage/s3/); plain HTTP + SigV4."""

    def __init__(self, endpoint: str, bucket: str, *, access_key: str = "",
                 secret_key: str = "", region: str = "us-east-1"):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region

    def _headers(self, method: str, url: str, payload: bytes) -> dict:
        if not self.access_key:
            return {}
        from ..s3api.sigv4_client import sign_request

        return sign_request(method, url, payload, self.access_key,
                            self.secret_key, self.region)

    def _url(self, path: str) -> str:
        import urllib.parse

        return (f"{self.endpoint}/{self.bucket}/"
                f"{urllib.parse.quote(path.lstrip('/'), safe='/')}")

    def traverse(self, prefix: str = ""):
        import urllib.parse
        import xml.etree.ElementTree as ET

        import requests

        token = ""
        while True:
            url = (f"{self.endpoint}/{self.bucket}?list-type=2"
                   f"&prefix={prefix.lstrip('/')}")
            if token:
                url += ("&continuation-token=" +
                        urllib.parse.quote(token, safe=""))
            r = requests.get(url, headers=self._headers("GET", url, b""),
                             timeout=60)
            r.raise_for_status()
            root = ET.fromstring(r.content)
            for item in root.iter():
                if not item.tag.endswith("Contents"):
                    continue
                key = item.findtext("{*}Key") or ""
                size = int(item.findtext("{*}Size") or 0)
                yield RemoteEntry(path="/" + key, size=size, mtime=0,
                                  etag=(item.findtext("{*}ETag") or
                                        "").strip('"'))
            if (root.findtext("{*}IsTruncated") or "").lower() != "true":
                return
            token = root.findtext("{*}NextContinuationToken") or ""
            if not token:
                return

    def read_file(self, path: str, offset: int = 0, size: int = -1) -> bytes:
        import requests

        url = self._url(path)
        headers = self._headers("GET", url, b"")
        if offset or size >= 0:
            # ranged GET so one-needle fetches don't transfer whole objects
            end = "" if size < 0 else str(offset + size - 1)
            headers["Range"] = f"bytes={offset}-{end}"
        r = requests.get(url, headers=headers, timeout=300)
        r.raise_for_status()
        return r.content

    def write_file(self, path: str, data: bytes) -> RemoteEntry:
        import requests

        url = self._url(path)
        r = requests.put(url, data=data,
                         headers=self._headers("PUT", url, data),
                         timeout=300)
        r.raise_for_status()
        return RemoteEntry(path=path, size=len(data),
                           mtime=int(time.time()),
                           etag=r.headers.get("ETag", "").strip('"'))

    def delete_file(self, path: str) -> None:
        import requests

        url = self._url(path)
        requests.delete(url, headers=self._headers("DELETE", url, b""),
                        timeout=60)


class _CloudRemoteStorage(RemoteStorageClient):
    """Shared shell for object-store remotes: the SPI mapped onto the
    uniform put/get/remove/list verbs every ..cloud client exposes.
    Subclasses only construct the client."""

    def __init__(self, client):
        self.client = client

    def traverse(self, prefix: str = ""):
        for obj in self.client.list(prefix.lstrip("/")):
            yield RemoteEntry(path="/" + obj.name, size=obj.size,
                              mtime=obj.mtime, etag=obj.etag)

    def read_file(self, path: str, offset: int = 0, size: int = -1) -> bytes:
        return self.client.get(path.lstrip("/"), offset, size)

    def write_file(self, path: str, data: bytes) -> RemoteEntry:
        obj = self.client.put(path.lstrip("/"), data)
        return RemoteEntry(path=path, size=len(data),
                           mtime=obj.mtime or int(time.time()),
                           etag=obj.etag)

    def delete_file(self, path: str) -> None:
        self.client.remove(path.lstrip("/"))


class GcsRemoteStorage(_CloudRemoteStorage):
    """GCS-backed remote (remote_storage/gcs/gcs_storage_client.go) over
    the JSON API wire client in ..cloud — no vendor SDK."""

    def __init__(self, bucket: str, *, token: str = "", project_id: str = "",
                 endpoint: str = "https://storage.googleapis.com"):
        from ..cloud import GcsClient

        super().__init__(GcsClient(bucket, token=token, endpoint=endpoint,
                                   project_id=project_id))


class AzureRemoteStorage(_CloudRemoteStorage):
    """Azure-container remote (remote_storage/azure/azure_storage_client.go)
    with real SharedKey signing (..cloud.AzureBlobClient)."""

    def __init__(self, container: str, *, account: str, key: str,
                 endpoint: str = ""):
        from ..cloud import AzureBlobClient

        super().__init__(AzureBlobClient(container, account=account,
                                         key=key, endpoint=endpoint))


class B2RemoteStorage(_CloudRemoteStorage):
    """Backblaze-B2 remote over the native API (the reference reaches B2
    through its S3-compatible endpoint; the native API is the richer
    surface and exercises ..cloud.B2Client end to end)."""

    def __init__(self, bucket: str, *, key_id: str, application_key: str,
                 endpoint: str = "https://api.backblazeb2.com"):
        from ..cloud import B2Client

        super().__init__(B2Client(bucket, key_id=key_id,
                                  application_key=application_key,
                                  endpoint=endpoint))


_CLIENTS = {"local": LocalRemoteStorage, "s3": S3RemoteStorage,
            "gcs": GcsRemoteStorage, "azure": AzureRemoteStorage,
            "b2": B2RemoteStorage}


def mapping_to_pb(conf: dict) -> bytes:
    """Serialize the mount table as remote_pb.RemoteStorageMapping bytes."""
    from ..pb import remote_pb2

    m = remote_pb2.RemoteStorageMapping()
    storages = conf.get("storages", {})
    for directory, mnt in conf.get("mounts", {}).items():
        loc = m.mappings[directory]
        loc.name = mnt.get("storage", "")
        path = mnt.get("remote_path", "")
        kind = storages.get(loc.name, {}).get("type", "local")
        # only bucket-addressed backends split the leading segment off;
        # a local root has no bucket and keeps its full path. A
        # bucket-only mount ("bkt", no slash) still means bucket=bkt,
        # path=/ on the wire.
        if kind in ("s3", "gcs", "azure", "b2") and path.lstrip("/"):
            bucket, _, rest = path.lstrip("/").partition("/")
            loc.bucket, loc.path = bucket, "/" + rest
        else:
            loc.path = "/" + path.lstrip("/")
    return m.SerializeToString()


def conf_to_pb(name: str, conf: dict) -> bytes:
    """Serialize one storage config as remote_pb.RemoteConf bytes."""
    from ..pb import remote_pb2

    rc = remote_pb2.RemoteConf(type=conf.get("type", "local"), name=name)
    if rc.type == "local":
        rc.local_root = conf.get("root", "")
    elif rc.type == "s3":
        rc.s3_endpoint = conf.get("endpoint", "")
        rc.s3_access_key = conf.get("access_key", "")
        rc.s3_secret_key = conf.get("secret_key", "")
        rc.s3_region = conf.get("region", "")
    elif rc.type == "gcs":
        rc.gcs_google_application_credentials = conf.get("token", "")
        rc.gcs_project_id = conf.get("project_id", "")
        rc.gcs_endpoint = conf.get("endpoint", "")
    elif rc.type == "azure":
        rc.azure_account_name = conf.get("account", "")
        rc.azure_account_key = conf.get("key", "")
        rc.azure_endpoint = conf.get("endpoint", "")
    elif rc.type == "b2":
        rc.backblaze_key_id = conf.get("key_id", "")
        rc.backblaze_application_key = conf.get("application_key", "")
        rc.backblaze_endpoint = conf.get("endpoint", "")
    return rc.SerializeToString()


def new_client(conf: dict) -> RemoteStorageClient:
    kind = conf.get("type", "local")
    cls = _CLIENTS.get(kind)
    if cls is None:
        raise KeyError(f"unknown remote storage type {kind!r}")
    kwargs = {k: v for k, v in conf.items() if k not in ("type", "name")}
    return cls(**kwargs)


def _lookup(stub, directory: str, name: str) -> filer_pb2.Entry:
    """The entry at directory/name, or an empty Entry where there is
    none; any other failure raises."""
    import grpc

    try:
        return stub.LookupDirectoryEntry(
            filer_pb2.LookupDirectoryEntryRequest(directory=directory,
                                                  name=name),
            timeout=10).entry
    except grpc.RpcError as e:
        if e.code() == grpc.StatusCode.NOT_FOUND:
            return filer_pb2.Entry()
        raise


class RemoteConf:
    """Mount table persisted in the filer (shell `remote.configure` +
    `remote.mount` state; reference stores remote.conf the same way)."""

    def __init__(self, filer: str, *, entry_reader=None):
        # entry_reader: optional (directory, name) -> content|None hook
        # so code running INSIDE the filer process (the gRPC
        # CacheRemoteObjectToLocalCluster handler) reads the conf
        # in-process instead of looping back through its own gRPC pool
        self.filer = filer
        self._entry_reader = entry_reader

    @property
    def _stub(self):
        return rpc.filer_stub(rpc.grpc_address(self.filer))

    def load(self) -> dict:
        """The mount table; empty only where /etc/remote.conf does not
        exist. A filer that does not answer raises: the reference reads
        any failure as an empty table, which the next save() then writes
        over every storage and mount (ROADMAP.md C)."""
        if self._entry_reader is not None:
            content = self._entry_reader(REMOTE_CONF_DIR, REMOTE_CONF_FILE)
        else:
            content = _lookup(self._stub, REMOTE_CONF_DIR,
                              REMOTE_CONF_FILE).content
        if not content:
            return {"storages": {}, "mounts": {}}
        return json.loads(content)

    def save(self, conf: dict) -> None:
        entry = filer_pb2.Entry(name=REMOTE_CONF_FILE,
                                content=json.dumps(conf, indent=2).encode())
        entry.attributes.file_mode = 0o600
        entry.attributes.mtime = int(time.time())
        self._stub.CreateEntry(filer_pb2.CreateEntryRequest(
            directory=REMOTE_CONF_DIR, entry=entry), timeout=10)
        # wire-parity copy: the reference persists the mount table as a
        # serialized remote_pb.RemoteStorageMapping at /etc/remote/mapping
        # (filer_remote_storage.go) — keep that file readable by its tools
        mapping = filer_pb2.Entry(name="mapping",
                                  content=mapping_to_pb(conf))
        mapping.attributes.file_mode = 0o600
        mapping.attributes.mtime = int(time.time())
        self._stub.CreateEntry(filer_pb2.CreateEntryRequest(
            directory=REMOTE_CONF_DIR, entry=mapping), timeout=10)

    def configure_storage(self, name: str, conf: dict) -> None:
        all_ = self.load()
        all_.setdefault("storages", {})[name] = conf
        self.save(all_)

    def mount(self, directory: str, storage: str, remote_path: str) -> None:
        all_ = self.load()
        if storage not in all_.get("storages", {}):
            raise KeyError(f"unknown remote storage {storage!r}")
        all_.setdefault("mounts", {})[directory] = {
            "storage": storage, "remote_path": remote_path}
        self.save(all_)

    def unmount(self, directory: str) -> None:
        all_ = self.load()
        all_.get("mounts", {}).pop(directory, None)
        self.save(all_)

    def client_for(self, directory: str, table: dict | None = None
                   ) -> tuple[RemoteStorageClient, str] | None:
        """The client and remote path of the mount at `directory`, from
        `table` where the caller has loaded it, else from the filer."""
        all_ = self.load() if table is None else table
        m = all_.get("mounts", {}).get(directory)
        if m is None:
            return None
        storage = all_["storages"][m["storage"]]
        return new_client(storage), m["remote_path"]


class RemoteGateway:
    """Mount operations against the filer namespace
    (shell remote.* commands + filer.remote.sync)."""

    def __init__(self, filer: str, *, conf: RemoteConf | None = None):
        self.filer = filer
        self.conf = conf if conf is not None else RemoteConf(filer)

    @property
    def _stub(self):
        return rpc.filer_stub(rpc.grpc_address(self.filer))

    def sync_dir(self, directory: str) -> int:
        """BFS the remote and mirror metadata into the filer
        (traverse_bfs.go + filer_remote_sync); returns entries synced."""
        pair = self.conf.client_for(directory)
        if pair is None:
            raise KeyError(f"{directory} is not a remote mount")
        client, remote_root = pair
        synced = 0
        for rent in client.traverse(remote_root):
            rel = rent.path
            if remote_root.strip("/"):
                rel = rent.path[len("/" + remote_root.strip("/")):] or "/"
            target = directory.rstrip("/") + rel
            d, name = target.rsplit("/", 1)
            marker = rent.to_json()
            # unchanged remote object: keep the existing entry (and any
            # cached chunks); changed: drop it so stale chunks are GC'd
            old = _lookup(self._stub, d or "/", name)
            if old.name:
                if old.extended.get(REMOTE_ENTRY_KEY) == marker:
                    continue
                self._stub.DeleteEntry(filer_pb2.DeleteEntryRequest(
                    directory=d or "/", name=name, is_delete_data=True),
                    timeout=30)
            entry = filer_pb2.Entry(name=name)
            entry.attributes.file_size = rent.size
            entry.attributes.mtime = rent.mtime or int(time.time())
            entry.attributes.file_mode = 0o644
            entry.extended[REMOTE_ENTRY_KEY] = marker
            self._stub.CreateEntry(filer_pb2.CreateEntryRequest(
                directory=d or "/", entry=entry), timeout=30)
            synced += 1
        return synced

    def _remote_location(self, path: str):
        """-> (client, remote-store path) for a filer path under a mount.
        Raises IOError (not KeyError) so HTTP handlers answer a clean 500
        when the mount is gone but marker entries linger."""
        table = self.conf.load()
        try:
            mount_dir = _mount_of(table, path)
        except KeyError as e:
            raise IOError(str(e)) from e
        client, remote_root = self.conf.client_for(mount_dir, table)
        rel = path[len(mount_dir):]
        rpath = ("/" + remote_root.strip("/") + rel
                 if remote_root.strip("/") else rel)
        return client, rpath

    def read_through(self, path: str, offset: int, size: int,
                     piece: int = 2 * 1024 * 1024):
        """Yield a remote entry's bytes straight from the remote store in
        fixed-size ranged reads — no caching, no whole-object buffering
        (the reference filer's IsInRemoteOnly read fallback). Exactly
        `size` bytes are produced so HTTP framing never drifts from the
        declared Content-Length even if the remote object changed.
        """
        client, rpath = self._remote_location(path)
        remaining = size
        pos = offset
        while remaining > 0:
            want = min(piece, remaining)
            data = client.read_file(rpath, pos, want)
            if not data:
                raise IOError(
                    f"remote object truncated: {rpath} short at {pos}")
            yield data[:remaining]
            pos += len(data)
            remaining -= len(data)

    def uncache(self, path: str) -> None:
        """Drop cached chunks, keep the remote pointer (remote.uncache).
        Delete+recreate so the dropped chunks are garbage-collected."""
        d, name = path.rsplit("/", 1)
        resp = self._stub.LookupDirectoryEntry(
            filer_pb2.LookupDirectoryEntryRequest(directory=d or "/",
                                                  name=name), timeout=10)
        entry = resp.entry
        if REMOTE_ENTRY_KEY not in entry.extended:
            raise KeyError(f"{path} is not a remote entry")
        size = max((c.offset + c.size for c in entry.chunks),
                   default=entry.attributes.file_size)
        self._stub.DeleteEntry(filer_pb2.DeleteEntryRequest(
            directory=d or "/", name=name, is_delete_data=True), timeout=30)
        fresh = filer_pb2.Entry(name=name)
        fresh.attributes.CopyFrom(entry.attributes)
        fresh.attributes.file_size = size
        for k, v in entry.extended.items():
            fresh.extended[k] = v
        self._stub.CreateEntry(filer_pb2.CreateEntryRequest(
            directory=d or "/", entry=fresh), timeout=10)


def _mount_of(table: dict, path: str) -> str:
    """The deepest mount of `table` that holds `path`."""
    mounts = table.get("mounts", {})
    best = ""
    for m in mounts:
        if path.startswith(m.rstrip("/") + "/") and len(m) > len(best):
            best = m
    if not best:
        raise KeyError(f"{path} is not under a remote mount")
    return best
