"""Minimal wire-protocol clients for GCS, Azure Blob, and Backblaze B2.

Counterpart of seaweedfs_tpu/cloud.py. SeaweedFS reaches these providers
through their vendor SDKs (weed/remote_storage/gcs/gcs_storage_client.go:1,
 azure/azure_storage_client.go:1, replication/sink/b2sink/b2_sink.go:1);
the port carries none of those SDKs, so these are direct REST/JSON
implementations of the handful of calls the framework needs:

- GCS JSON API (storage/v1): media upload, alt=media download (ranged),
  object list with pageToken paging, delete. Auth is a static bearer
  token (service-account JWT exchange needs RSA signing, which the
  stdlib cannot do — a `token` is accepted from config or metadata-
  server-style injection; anonymous works against emulators).
- Azure Blob REST with real SharedKey request signing (HMAC-SHA256 over
  the canonicalized headers/resource — pure stdlib): Put Blob,
  Get Blob (ranged), Delete Blob, List Blobs (XML, marker paging).
- B2 native API v2: b2_authorize_account (basic auth),
  b2_get_upload_url / b2_upload_file (sha1-checked), b2_list_file_names,
  b2_delete_file_version, ranged file download; 401-expiry re-auth.

Every client speaks to any endpoint URL, so the test suite runs them
e2e against in-repo fake servers (tests/fake_cloud.py) that verify the
wire format — including the Azure signature — independently.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import urllib.parse
import xml.etree.ElementTree as ET

import requests


class CloudObject:
    """One remote object as the storage layers see it."""

    __slots__ = ("name", "size", "mtime", "etag", "extra")

    def __init__(self, name: str, size: int, mtime: int = 0,
                 etag: str = "", extra: dict | None = None):
        self.name = name
        self.size = size
        self.mtime = mtime
        self.etag = etag
        self.extra = extra or {}

    def __repr__(self):  # pragma: no cover
        return f"CloudObject({self.name!r}, {self.size})"


# ---------------------------------------------------------------------------
# GCS


class GcsClient:
    """GCS JSON API subset (objects: insert/get/list/delete)."""

    def __init__(self, bucket: str, *, token: str = "",
                 endpoint: str = "https://storage.googleapis.com",
                 project_id: str = ""):
        self.bucket = bucket
        self.token = token
        self.endpoint = endpoint.rstrip("/")
        self.project_id = project_id

    def _headers(self, extra: dict | None = None) -> dict:
        h = dict(extra or {})
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    def _obj_url(self, name: str) -> str:
        return (f"{self.endpoint}/storage/v1/b/{self.bucket}/o/"
                f"{urllib.parse.quote(name, safe='')}")

    def put_object(self, name: str, data: bytes,
                   content_type: str = "application/octet-stream"
                   ) -> CloudObject:
        url = (f"{self.endpoint}/upload/storage/v1/b/{self.bucket}/o"
               f"?uploadType=media&name="
               f"{urllib.parse.quote(name, safe='')}")
        r = requests.post(url, data=data, headers=self._headers(
            {"Content-Type": content_type}), timeout=300)
        if r.status_code >= 300:
            raise IOError(f"gcs upload {name}: {r.status_code} {r.text[:200]}")
        meta = r.json()
        return CloudObject(name, int(meta.get("size", len(data))),
                           _rfc3339_to_unix(meta.get("updated", "")),
                           meta.get("etag", ""))

    def get_object(self, name: str, offset: int = 0, size: int = -1) -> bytes:
        headers = self._headers()
        if offset or size >= 0:
            end = "" if size < 0 else str(offset + size - 1)
            headers["Range"] = f"bytes={offset}-{end}"
        r = requests.get(self._obj_url(name) + "?alt=media", headers=headers,
                         timeout=300)
        if r.status_code >= 300:
            raise IOError(f"gcs get {name}: {r.status_code}")
        return r.content

    def list_objects(self, prefix: str = ""):
        token = ""
        while True:
            url = (f"{self.endpoint}/storage/v1/b/{self.bucket}/o"
                   f"?prefix={urllib.parse.quote(prefix, safe='')}")
            if token:
                url += "&pageToken=" + urllib.parse.quote(token, safe="")
            r = requests.get(url, headers=self._headers(), timeout=60)
            if r.status_code >= 300:
                raise IOError(f"gcs list: {r.status_code}")
            body = r.json()
            for item in body.get("items", []):
                yield CloudObject(item["name"], int(item.get("size", 0)),
                                  _rfc3339_to_unix(item.get("updated", "")),
                                  item.get("etag", ""))
            token = body.get("nextPageToken", "")
            if not token:
                return

    def delete_object(self, name: str) -> None:
        r = requests.delete(self._obj_url(name), headers=self._headers(),
                            timeout=60)
        if r.status_code >= 300 and r.status_code != 404:
            raise IOError(f"gcs delete {name}: {r.status_code}")

    # uniform verbs so sinks/remote-storage wrap any client generically
    put, get, remove, list = put_object, get_object, delete_object, \
        list_objects


def _rfc3339_to_unix(s: str) -> int:
    if not s:
        return 0
    try:
        return int(time.mktime(time.strptime(s[:19], "%Y-%m-%dT%H:%M:%S")))
    except ValueError:
        return 0


# ---------------------------------------------------------------------------
# Azure Blob


def azure_shared_key_signature(account: str, key_b64: str, method: str,
                               path: str, query: dict[str, list[str]],
                               headers: dict[str, str]) -> str:
    """Full SharedKey string-to-sign + HMAC (the 2015-02-21+ scheme:
    empty Content-Length when zero). `headers` is the request's header
    map, case-insensitive keys already lowered."""
    def h(name: str) -> str:
        return headers.get(name, "")

    length = h("content-length")
    if length == "0":
        length = ""
    canon_headers = "".join(
        f"{k}:{headers[k]}\n"
        for k in sorted(k for k in headers if k.startswith("x-ms-")))
    canon_res = f"/{account}{path}"
    for name in sorted(query):
        canon_res += f"\n{name}:{','.join(sorted(query[name]))}"
    sts = "\n".join([
        method.upper(), h("content-encoding"), h("content-language"),
        length, h("content-md5"), h("content-type"), h("date"),
        h("if-modified-since"), h("if-match"), h("if-none-match"),
        h("if-unmodified-since"), h("range"),
    ]) + "\n" + canon_headers + canon_res
    mac = hmac.new(base64.b64decode(key_b64), sts.encode("utf-8"),
                   hashlib.sha256).digest()
    return base64.b64encode(mac).decode()


class AzureBlobClient:
    """Azure Blob REST subset with SharedKey auth."""

    API_VERSION = "2020-10-02"

    def __init__(self, container: str, *, account: str, key: str,
                 endpoint: str = ""):
        self.container = container
        self.account = account
        self.key = key
        self.endpoint = (endpoint.rstrip("/") if endpoint else
                         f"https://{account}.blob.core.windows.net")

    def _request(self, method: str, path: str, *, params: dict | None = None,
                 data: bytes = b"", extra: dict | None = None):
        params = params or {}
        headers = {
            "x-ms-date": time.strftime("%a, %d %b %Y %H:%M:%S GMT",
                                       time.gmtime()),
            "x-ms-version": self.API_VERSION,
        }
        if data:
            headers["Content-Length"] = str(len(data))
        headers.update(extra or {})
        lowered = {k.lower(): v for k, v in headers.items()}
        qmap = {k: [str(v)] for k, v in params.items()}
        sig = azure_shared_key_signature(self.account, self.key, method,
                                         path, qmap, lowered)
        headers["Authorization"] = f"SharedKey {self.account}:{sig}"
        url = self.endpoint + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        return requests.request(method, url, data=data or None,
                                headers=headers, timeout=300)

    def _blob_path(self, name: str) -> str:
        return (f"/{self.container}/"
                f"{urllib.parse.quote(name.lstrip('/'), safe='/')}")

    def put_blob(self, name: str, data: bytes,
                 content_type: str = "application/octet-stream"
                 ) -> CloudObject:
        r = self._request("PUT", self._blob_path(name), data=data, extra={
            "x-ms-blob-type": "BlockBlob", "Content-Type": content_type})
        if r.status_code >= 300:
            raise IOError(f"azure put {name}: {r.status_code} {r.text[:200]}")
        return CloudObject(name, len(data), int(time.time()),
                           r.headers.get("ETag", "").strip('"'))

    def get_blob(self, name: str, offset: int = 0, size: int = -1) -> bytes:
        extra = {}
        if offset or size >= 0:
            end = "" if size < 0 else str(offset + size - 1)
            extra["Range"] = f"bytes={offset}-{end}"
        r = self._request("GET", self._blob_path(name), extra=extra)
        if r.status_code >= 300:
            raise IOError(f"azure get {name}: {r.status_code}")
        return r.content

    def delete_blob(self, name: str) -> None:
        r = self._request("DELETE", self._blob_path(name))
        if r.status_code >= 300 and r.status_code != 404:
            raise IOError(f"azure delete {name}: {r.status_code}")

    def list_blobs(self, prefix: str = ""):
        marker = ""
        while True:
            params = {"restype": "container", "comp": "list"}
            if prefix:
                params["prefix"] = prefix
            if marker:
                params["marker"] = marker
            r = self._request("GET", f"/{self.container}", params=params)
            if r.status_code >= 300:
                raise IOError(f"azure list: {r.status_code}")
            root = ET.fromstring(r.content)
            for blob in root.iter("Blob"):
                name = blob.findtext("Name") or ""
                props = blob.find("Properties")
                size = int(props.findtext("Content-Length") or 0) \
                    if props is not None else 0
                etag = (props.findtext("Etag") or "") \
                    if props is not None else ""
                yield CloudObject(name, size, 0, etag)
            marker = root.findtext("NextMarker") or ""
            if not marker:
                return

    put, get, remove, list = put_blob, get_blob, delete_blob, list_blobs


# ---------------------------------------------------------------------------
# Backblaze B2


class B2Client:
    """B2 native API v2 subset. Lazily authorizes; retries once on a 401
    (expired auth token), matching the SDK behavior the reference's
    b2sink relies on."""

    def __init__(self, bucket: str, *, key_id: str, application_key: str,
                 endpoint: str = "https://api.backblazeb2.com"):
        self.bucket = bucket
        self.key_id = key_id
        self.application_key = application_key
        self.endpoint = endpoint.rstrip("/")
        self._auth: dict | None = None
        self._bucket_id = ""

    # -- session plumbing

    def _authorize(self) -> dict:
        basic = base64.b64encode(
            f"{self.key_id}:{self.application_key}".encode()).decode()
        r = requests.get(
            f"{self.endpoint}/b2api/v2/b2_authorize_account",
            headers={"Authorization": f"Basic {basic}"}, timeout=60)
        if r.status_code >= 300:
            raise IOError(f"b2 authorize: {r.status_code} {r.text[:200]}")
        self._auth = r.json()
        return self._auth

    def _session(self) -> dict:
        return self._auth or self._authorize()

    def _api(self, op: str, body: dict) -> dict:
        for attempt in (0, 1):
            auth = self._session()
            r = requests.post(
                f"{auth['apiUrl']}/b2api/v2/{op}",
                headers={"Authorization": auth["authorizationToken"]},
                data=json.dumps(body), timeout=60)
            if r.status_code == 401 and attempt == 0:
                self._auth = None  # token expired — re-authorize once
                continue
            if r.status_code >= 300:
                raise IOError(f"b2 {op}: {r.status_code} {r.text[:200]}")
            return r.json()
        raise IOError(f"b2 {op}: unauthorized after re-auth")

    def _bucket(self) -> str:
        if not self._bucket_id:
            auth = self._session()
            resp = self._api("b2_list_buckets", {
                "accountId": auth.get("accountId", ""),
                "bucketName": self.bucket})
            for b in resp.get("buckets", []):
                if b.get("bucketName") == self.bucket:
                    self._bucket_id = b["bucketId"]
            if not self._bucket_id:
                raise IOError(f"b2: bucket {self.bucket!r} not found")
        return self._bucket_id

    # -- operations

    def upload(self, name: str, data: bytes,
               content_type: str = "b2/x-auto") -> CloudObject:
        up = self._api("b2_get_upload_url", {"bucketId": self._bucket()})
        r = requests.post(up["uploadUrl"], data=data, headers={
            "Authorization": up["authorizationToken"],
            "X-Bz-File-Name": urllib.parse.quote(name.lstrip("/"), safe="/"),
            "Content-Type": content_type,
            "X-Bz-Content-Sha1": hashlib.sha1(data).hexdigest(),
        }, timeout=300)
        if r.status_code >= 300:
            raise IOError(f"b2 upload {name}: {r.status_code} {r.text[:200]}")
        meta = r.json()
        return CloudObject(meta.get("fileName", name),
                           int(meta.get("contentLength", len(data))),
                           int(meta.get("uploadTimestamp", 0)) // 1000,
                           extra={"fileId": meta.get("fileId", "")})

    def download(self, name: str, offset: int = 0, size: int = -1) -> bytes:
        auth = self._session()
        headers = {"Authorization": auth["authorizationToken"]}
        if offset or size >= 0:
            end = "" if size < 0 else str(offset + size - 1)
            headers["Range"] = f"bytes={offset}-{end}"
        url = (f"{auth['downloadUrl']}/file/{self.bucket}/"
               f"{urllib.parse.quote(name.lstrip('/'), safe='/')}")
        r = requests.get(url, headers=headers, timeout=300)
        if r.status_code == 401:
            self._auth = None
            return self.download(name, offset, size)
        if r.status_code >= 300:
            raise IOError(f"b2 download {name}: {r.status_code}")
        return r.content

    def list_files(self, prefix: str = ""):
        start = ""
        while True:
            body = {"bucketId": self._bucket(), "maxFileCount": 1000}
            if prefix:
                body["prefix"] = prefix
            if start:
                body["startFileName"] = start
            resp = self._api("b2_list_file_names", body)
            for f in resp.get("files", []):
                yield CloudObject(
                    f["fileName"], int(f.get("contentLength", 0)),
                    int(f.get("uploadTimestamp", 0)) // 1000,
                    extra={"fileId": f.get("fileId", "")})
            start = resp.get("nextFileName") or ""
            if not start:
                return

    def delete(self, name: str) -> None:
        """Delete every version of `name` (the sink's semantic).
        b2_list_file_names surfaces only the newest version per name, so
        loop: each pass deletes the then-newest version until none hide
        beneath."""
        name = name.lstrip("/")
        while True:
            victims = [o for o in self.list_files(prefix=name)
                       if o.name == name]
            if not victims:
                return
            for o in victims:
                self._api("b2_delete_file_version",
                          {"fileName": o.name, "fileId": o.extra["fileId"]})

    put, get, remove, list = upload, download, delete, list_files
