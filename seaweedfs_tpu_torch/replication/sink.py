"""Replication sinks.

Counterpart of seaweedfs_tpu/replication/sink.py (SeaweedFS
weed/replication/sink/) — the ReplicationSink
interface (replication_sink.go: CreateEntry/UpdateEntry/DeleteEntry/
GetSinkToDirectory) with the filer sink (filersink/), local sink
(localsink/), an S3 sink whose wire client is the S3 gateway's own
HTTP surface (works against any S3 endpoint without boto3), and
GCS/Azure/B2 sinks riding the REST wire clients in ..cloud.
"""

from __future__ import annotations

import os
import time

import requests

from ..pb import filer_pb2, rpc
from ..utils import failpoint
from ..utils.http import url_for
from ..wdclient import pool


class SinkUnavailable(IOError):
    """Target-side transient failure (5xx, injected flap): the apply is
    idempotent and worth retrying. Client-side rejections (4xx auth,
    bad request) stay plain IOError — retrying those only adds load."""


class ReplicationSink:
    name = "abstract"

    def _chaos(self, verb: str, path: str) -> None:
        """`replication.sink` failpoint: lets the chaos suite flap the
        sink (fail the first N applies, delay, etc.) uniformly across
        every concrete sink."""
        failpoint.fail("replication.sink", ctx=f"{self.name} {verb} {path}")

    def create_entry(self, path: str, entry: filer_pb2.Entry,
                     data: bytes | None) -> None:
        raise NotImplementedError

    def update_entry(self, path: str, entry: filer_pb2.Entry,
                     data: bytes | None) -> None:
        self.create_entry(path, entry, data)

    def delete_entry(self, path: str, is_directory: bool) -> None:
        raise NotImplementedError


class FilerSink(ReplicationSink):
    """Mirror into another filer cluster (sink/filersink/filer_sink.go).
    Chunk bytes are re-uploaded through the target filer's HTTP data plane
    (which re-chunks and re-assigns volumes in the target cluster)."""

    name = "filer"

    def __init__(self, filer: str, *, directory: str = "/"):
        self.filer = filer
        self.dir = directory.rstrip("/")

    @property
    def stub(self):
        return rpc.filer_stub(rpc.grpc_address(self.filer))

    def _target(self, path: str) -> str:
        return self.dir + path

    def create_entry(self, path, entry, data):
        self._chaos("create", path)
        target = self._target(path)
        if entry.is_directory:
            e = filer_pb2.Entry(name=target.rsplit("/", 1)[-1],
                                is_directory=True)
            e.attributes.CopyFrom(entry.attributes)
            self.stub.CreateEntry(filer_pb2.CreateEntryRequest(
                directory=target.rsplit("/", 1)[0] or "/", entry=e,
                is_from_other_cluster=True), timeout=30)
            return
        try:
            # pooled keep-alive leg: a sync run applies many
            # entries against one target filer
            r = pool.put(
                url_for(self.filer, target), body=data or b"",
                headers={"Content-Type": entry.attributes.mime or
                         "application/octet-stream",
                         # loop-prevention: target filer marks the event
                         # so a reverse sync loop skips it
                         # (filer_sync.go signatures)
                         "X-From-Other-Cluster": "1"}, timeout=300)
        except OSError as e:
            from ..utils.retry import _ssl_error_of, ssl_error_is_retryable

            sslerr = _ssl_error_of(e)
            if sslerr is not None and not ssl_error_is_retryable(sslerr):
                # a certificate rejection is a trust decision — wrapping
                # it as SinkUnavailable would force-retry what the ssl
                # classification fails fast everywhere else
                raise
            raise SinkUnavailable(f"filer sink PUT {target}: {e}") from e
        if r.status >= 300:
            cls = SinkUnavailable if r.status >= 500 else IOError
            raise cls(f"filer sink PUT {target}: {r.status}")

    def delete_entry(self, path, is_directory):
        self._chaos("delete", path)
        target = self._target(path)
        directory, name = target.rsplit("/", 1)
        self.stub.DeleteEntry(filer_pb2.DeleteEntryRequest(
            directory=directory or "/", name=name, is_delete_data=True,
            is_recursive=is_directory, is_from_other_cluster=True),
            timeout=60)


class LocalSink(ReplicationSink):
    """Mirror into a local directory (sink/localsink/local_sink.go)."""

    name = "local"

    def __init__(self, directory: str):
        self.dir = directory

    def _target(self, path: str) -> str:
        return os.path.join(self.dir, path.lstrip("/"))

    def create_entry(self, path, entry, data):
        self._chaos("create", path)
        target = self._target(path)
        if entry.is_directory:
            os.makedirs(target, exist_ok=True)
            return
        os.makedirs(os.path.dirname(target), exist_ok=True)
        tmp = target + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data or b"")
        os.replace(tmp, target)
        if entry.attributes.mtime:
            os.utime(target, (entry.attributes.mtime,
                              entry.attributes.mtime))

    def delete_entry(self, path, is_directory):
        self._chaos("delete", path)
        target = self._target(path)
        try:
            if is_directory:
                import shutil

                shutil.rmtree(target)
            else:
                os.remove(target)
        except FileNotFoundError:
            pass


class S3Sink(ReplicationSink):
    """Mirror into an S3 endpoint (sink/s3sink/) via plain HTTP PUT/DELETE
    with SigV4 when credentials are configured; anonymous otherwise (works
    against this framework's own S3 gateway)."""

    name = "s3"

    def __init__(self, endpoint: str, bucket: str, *,
                 directory: str = "", access_key: str = "",
                 secret_key: str = "", region: str = "us-east-1"):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.dir = directory.strip("/")
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region

    def _url(self, path: str) -> str:
        import urllib.parse

        key = (self.dir + "/" if self.dir else "") + path.lstrip("/")
        return (f"{self.endpoint}/{self.bucket}/"
                f"{urllib.parse.quote(key, safe='/')}")

    def _headers(self, method: str, url: str, payload: bytes) -> dict:
        if not self.access_key:
            return {}
        from ..s3api.sigv4_client import sign_request

        return sign_request(method, url, payload, self.access_key,
                            self.secret_key, self.region)

    def create_entry(self, path, entry, data):
        self._chaos("create", path)
        if entry.is_directory:
            return
        url = self._url(path)
        body = data or b""
        headers = self._headers("PUT", url, body)
        # carry the entry's mime across (s3_sink.go sets ContentType on
        # the upload input) so gateway reads return the original type
        if entry.attributes.mime:
            headers["Content-Type"] = entry.attributes.mime
        r = requests.put(url, data=body, headers=headers, timeout=300)
        if r.status_code >= 300:
            cls = SinkUnavailable if r.status_code >= 500 else IOError
            raise cls(f"s3 sink PUT {url}: {r.status_code}")

    def delete_entry(self, path, is_directory):
        self._chaos("delete", path)
        if is_directory:
            return
        url = self._url(path)
        requests.delete(url, headers=self._headers("DELETE", url, b""),
                        timeout=60)


class _CloudSink(ReplicationSink):
    """Shared shell for object-store sinks: directory-entry skip, key
    prefixing, mime defaulting. Subclasses only construct a ..cloud
    client (uniform put/remove verbs)."""

    default_mime = "application/octet-stream"

    def __init__(self, client, directory: str):
        self.client = client
        self.dir = directory.strip("/")

    def _key(self, path: str) -> str:
        return (self.dir + "/" if self.dir else "") + path.lstrip("/")

    def create_entry(self, path, entry, data):
        self._chaos("create", path)
        if entry.is_directory:
            return
        self.client.put(self._key(path), data or b"",
                        entry.attributes.mime or self.default_mime)

    def delete_entry(self, path, is_directory):
        self._chaos("delete", path)
        if is_directory:
            return
        self.client.remove(self._key(path))


class GcsSink(_CloudSink):
    """Mirror into a GCS bucket (sink/gcssink/gcs_sink.go) over the JSON
    API wire client (..cloud.GcsClient) — no vendor SDK."""

    name = "gcs"

    def __init__(self, bucket: str, *, directory: str = "", token: str = "",
                 endpoint: str = "https://storage.googleapis.com"):
        from ..cloud import GcsClient

        super().__init__(GcsClient(bucket, token=token, endpoint=endpoint),
                         directory)


class AzureSink(_CloudSink):
    """Mirror into an Azure container (sink/azuresink/azure_sink.go) with
    SharedKey-signed REST calls (..cloud.AzureBlobClient)."""

    name = "azure"

    def __init__(self, container: str, *, account: str, key: str,
                 directory: str = "", endpoint: str = ""):
        from ..cloud import AzureBlobClient

        super().__init__(AzureBlobClient(container, account=account,
                                         key=key, endpoint=endpoint),
                         directory)


class B2Sink(_CloudSink):
    """Mirror into a B2 bucket (sink/b2sink/b2_sink.go) over the native
    API (..cloud.B2Client): authorize/upload-url dance, sha1-verified
    uploads, versioned deletes."""

    name = "b2"
    default_mime = "b2/x-auto"

    def __init__(self, bucket: str, *, key_id: str, application_key: str,
                 directory: str = "",
                 endpoint: str = "https://api.backblazeb2.com"):
        from ..cloud import B2Client

        super().__init__(B2Client(bucket, key_id=key_id,
                                  application_key=application_key,
                                  endpoint=endpoint), directory)


def new_sink(kind: str, **kwargs) -> ReplicationSink:
    sinks = {"filer": FilerSink, "local": LocalSink, "s3": S3Sink,
             "gcs": GcsSink, "azure": AzureSink, "b2": B2Sink}
    cls = sinks.get(kind)
    if cls is None:
        raise KeyError(f"unknown sink {kind!r}")
    return cls(**kwargs)
