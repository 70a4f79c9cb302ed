"""S3-compatible gateway over the filer.

Counterpart of seaweedfs_tpu/s3api/server.py (SeaweedFS weed/s3api/:
s3api_server.go router, s3api_bucket_handlers.go,
s3api_object_handlers.go, filer_multipart.go,
s3api_object_tagging_handlers.go). Buckets are filer directories under
/buckets/<name>; object bytes are filer entries. Multipart parts are staged
under /buckets/.uploads/<uploadId> and merged into one chunk list at
complete time — chunk fids are re-based, bytes are never copied (the same
trick filer_multipart.go:COMPLETEMULTIPARTUPLOAD uses).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from http.server import BaseHTTPRequestHandler

from ..operation import thread_session as _session

from ..utils.httpd import TunedThreadingHTTPServer

import grpc

from ..cluster.metaring import (
    EPOCH_HEADER,
    WRONG_SHARD_STATUS,
    wrong_shard_of,
)
from ..pb import filer_pb2, rpc
from ..utils import glog, trace
from ..utils.http import url_for
from ..utils.stats import (
    S3_REQUEST_HISTOGRAM,
    gather,
    metrics_content_type,
    status_base,
)
from .auth import AuthError, Identity, IdentityAccessManagement
from .circuit_breaker import CircuitBreaker, TooManyRequests, load_filer_config
from .policy import BucketPolicy, PolicyError

# extended-attr keys (s3_constants in the reference)
ACL_KEY = "Seaweed-X-Amz-Acl"
POLICY_KEY = "Seaweed-X-Amz-Policy"
READONLY_KEY = "Seaweed-Read-Only"
CANNED_ACLS = ("private", "public-read", "public-read-write",
               "authenticated-read")

BUCKETS_DIR = "/buckets"
UPLOADS_DIR = "/buckets/.uploads"
S3_NS = "http://s3.amazonaws.com/doc/2006-03-01/"


class S3Error(Exception):
    def __init__(self, status: int, code: str, message: str,
                 retry_after_s: float = 0.0):
        super().__init__(message)
        self.status = status
        self.code = code
        # 503s carry an honest Retry-After so SDK clients back off with
        # jitter instead of hammering or failing hard
        self.retry_after_s = retry_after_s


class S3Server:
    def __init__(self, *, port: int = 8333, filer: str = "localhost:8888",
                 identities: list[Identity] | None = None):
        self.port = port
        self.filer = filer
        self.filer_grpc = rpc.grpc_address(filer)
        self.iam = IdentityAccessManagement(identities)
        self.circuit_breaker = CircuitBreaker()
        # QoS plane: per-tenant (access key / bucket /
        # anonymous) token-bucket admission ahead of every other check;
        # unconfigured env = observe-only, never rejects
        from ..qos import TenantAdmission

        self.qos_admission = TenantAdmission("s3")
        # metadata ring: when the filer namespace is sharded,
        # route every metadata op to the shard owning its parent
        # directory; unsharded deployments see a 1-entry ring and the
        # seed filer answers everything (zero behavior change)
        from ..wdclient import MetaRingClient

        self.ring_client = MetaRingClient(filer_grpc=self.filer_grpc)
        self._cb_loaded_at = 0.0
        self._http_server = None
        self._started_at = time.time()

    @property
    def address(self) -> str:
        return f"localhost:{self.port}"

    def start(self) -> None:
        trace.set_identity("s3", self.address)
        # HTTPS public ingress: same gate as the volume/filer
        # planes, so SWFS_HTTPS moves all four harness shapes onto TLS
        from ..security.tls import load_http_server_context

        https_ctx = load_http_server_context("s3")
        self._http_server = TunedThreadingHTTPServer(
            ("", self.port), _make_handler(self), ssl_context=https_ctx)
        threading.Thread(target=self._http_server.serve_forever,
                         daemon=True).start()
        # control plane (s3.proto SeaweedS3.Configure; s3api_server.go
        # registers the same service beside the HTTP handlers). With
        # [grpc.s3] in security.toml the port requires mTLS like the
        # reference's LoadServerTLS gate and binds all interfaces;
        # plaintext deployments stay LOOPBACK-ONLY — Configure replaces
        # the whole identity set and must not be reachable off-host
        # unauthenticated.
        self._grpc_server = rpc.new_server()
        creds = rpc.add_servicer(self._grpc_server, rpc.S3_SERVICE,
                                 _S3Control(self), component="s3",
                                 address=self.address)
        bind_ip = "[::]" if creds is not None else "127.0.0.1"
        rpc.serve_port(self._grpc_server,
                       f"{bind_ip}:{rpc.derived_grpc_port(self.port)}",
                       "s3", creds=creds)
        self._grpc_server.start()
        glog.info(f"s3 gateway on :{self.port} -> filer {self.filer}")

    def stop(self) -> None:
        if self._http_server:
            self._http_server.shutdown()
        if getattr(self, "_grpc_server", None):
            self._grpc_server.stop(grace=0.5)

    def configure_from_bytes(self, content: bytes) -> None:
        """Hot-swap identities from identity.json bytes (the reference's
        ParseS3ConfigurationFromBytes -> onIamConfigUpdate path), validated
        through the iam_pb S3ApiConfiguration schema."""
        from google.protobuf import json_format

        from ..pb import iam_pb2

        conf = json_format.Parse(
            content.decode(), iam_pb2.S3ApiConfiguration(),
            ignore_unknown_fields=True)
        ids = []
        for ident in conf.identities:
            cred = ident.credentials[0] if ident.credentials else None
            # empty actions mean NO permissions (identity.canDo returns
            # false on an empty list in the reference) — never default up
            ids.append(Identity(
                name=ident.name,
                access_key=cred.access_key if cred else "",
                secret_key=cred.secret_key if cred else "",
                actions=list(ident.actions)))
        self.iam = IdentityAccessManagement(ids)

    # -- filer plumbing ----------------------------------------------------

    def stub(self):
        return rpc.filer_stub(self.filer_grpc)

    def meta_call(self, path: str, fn, *, directory: bool = False):
        """Run `fn(stub)` against the filer shard owning `path` (the
        entry's parent dir, or the dir itself when directory=True), with
        the ring client's one stale-ring retry: a shard answering
        FAILED_PRECONDITION "wrong metadata shard" refreshes the cached
        ring exactly once and the call re-routes."""
        def leg(addr):
            stub = (self.stub() if not addr or addr == self.filer
                    else rpc.filer_stub(rpc.grpc_address(addr)))
            try:
                return fn(stub)
            except grpc.RpcError as e:
                ws = wrong_shard_of(e)
                if ws is not None:
                    raise ws from e
                raise

        return self.ring_client.call_routed(
            path, leg, directory=directory, default=self.filer)

    def maybe_reload_circuit_breaker(self) -> None:
        """Refresh limits from /etc/s3/circuit_breaker.json (10s TTL — the
        reference reloads on filer metadata events; a short poll keeps the
        same convergence without a standing subscription)."""
        now = time.time()
        if now - self._cb_loaded_at < 10:
            return
        self._cb_loaded_at = now
        try:
            conf = load_filer_config(self.stub())
        # lint: allow-broad-except(a failed reload keeps the limits in
        # force; the next request past the interval tries again)
        except Exception:  # noqa: BLE001
            return
        if conf is not None:
            self.circuit_breaker.load(conf)

    def bucket_entry(self, bucket: str) -> filer_pb2.Entry | None:
        return self.find_entry(BUCKETS_DIR, bucket)

    def find_entry(self, directory: str, name: str) -> filer_pb2.Entry | None:
        def lookup(stub):
            try:
                return stub.LookupDirectoryEntry(
                    filer_pb2.LookupDirectoryEntryRequest(
                        directory=directory, name=name), timeout=10).entry
            except grpc.RpcError as e:
                if e.code() == grpc.StatusCode.NOT_FOUND:
                    return None
                raise

        return self.meta_call(f"{directory}/{name}", lookup)

    def list_dir(self, directory: str, start: str = "", limit: int = 1000,
                 prefix: str = "", include_start=False):
        def listing(stub):
            # materialized inside the routed leg: a generator escaping
            # meta_call would stream from the wrong shard after a retry
            try:
                return [resp.entry for resp in stub.ListEntries(
                    filer_pb2.ListEntriesRequest(
                        directory=directory, prefix=prefix,
                        start_from_file_name=start,
                        inclusive_start_from=include_start,
                        limit=limit), timeout=30)]
            except grpc.RpcError as e:
                if e.code() != grpc.StatusCode.NOT_FOUND:
                    raise
                return []

        yield from self.meta_call(directory, listing, directory=True)

    def _meta_url(self, full_path: str, refresh: bool = False) -> str:
        """Filer-HTTP URL for `full_path`, aimed at the shard owning its
        parent directory (the seed filer on a 1-entry/unreachable ring)."""
        if refresh:
            self.ring_client.ring(refresh=True, trigger="stale")
        shard = self.ring_client.route_entry(full_path, self.filer)
        dir_, _, name = full_path.rpartition("/")
        return url_for(shard, dir_ + "/") + urllib.parse.quote(name)

    def _note_stale_ring(self, resp) -> None:
        """Absorb the epoch a 410 wrong-shard answer carries so the next
        `_meta_url` re-resolves against a fresh ring."""
        try:
            self.ring_client.note_epoch(int(resp.headers.get(
                EPOCH_HEADER, "0")))
        except (TypeError, ValueError):
            pass

    def put_object(self, bucket: str, key: str, body,
                   content_type: str = "") -> str:
        """-> etag. `body` is bytes or a chunk iterator; either way the
        bytes stream straight through the filer HTTP autochunker."""
        full_path = f"{BUCKETS_DIR}/{bucket}/{key}"
        md5 = hashlib.md5()
        if isinstance(body, (bytes, bytearray)):
            md5.update(body)
            data = body
        else:
            # spooled (mem <= 8MB, disk beyond), never a raw generator:
            # the native filer hot plane 307s md5-wanting PUTs to the
            # python listener and requests can only replay a SEEKABLE
            # body across that redirect
            data = _spool(body, md5)
        headers = trace.inject_headers(
            {"Content-Type":
             content_type or "application/octet-stream",
             # tenant budget already charged at the S3 ingress —
             # the filer must not bill this internal leg twice
             "X-Swfs-Qos-Charged": "1",
             # the S3 ETag contract is the whole-body md5: only
             # the python PUT path records it (the C++ hot plane
             # defers these), so PUT/GET/HEAD/If-None-Match agree
             "X-Swfs-Want-Md5": "1"})
        try:
            r = _session().put(self._meta_url(full_path), data=data,
                               headers=headers, timeout=600)
            if r.status_code == WRONG_SHARD_STATUS:
                # stale ring: absorb the shard's epoch, refresh once,
                # rewind the body and retry against the real owner
                self._note_stale_ring(r)
                if hasattr(data, "seek"):
                    data.seek(0)
                r = _session().put(
                    self._meta_url(full_path, refresh=True), data=data,
                    headers=headers, timeout=600)
        finally:
            if hasattr(data, "close"):
                data.close()  # reclaim a disk-rolled spool promptly
        if r.status_code in (429, 503):
            # the backend throttled anyway (direct-traffic budget,
            # pressure shed): surface it as throttling, not a bug
            raise _backend_throttled(r, "filer PUT")
        if r.status_code == 400:
            # the filer refused a short body (ShortBodyError):
            # the client died mid-upload — S3's IncompleteBody, not an
            # InternalError (nothing was committed; chunks were GC'd)
            raise S3Error(400, "IncompleteBody",
                          "You did not provide the number of bytes "
                          "specified by the Content-Length HTTP header")
        if r.status_code >= 300:
            raise S3Error(500, "InternalError", f"filer PUT: {r.status_code}")
        return md5.hexdigest()

    def get_object(self, bucket: str, key: str, range_header: str = "",
                   stream: bool = False,
                   conditional: dict | None = None):
        """`conditional` forwards the caller's validator headers
        (If-None-Match / If-Modified-Since / If-Range) to the filer,
        whose RFC 7232/7233 evaluation (utils.http) then answers the
        S3 conditional GET — a 304 passes back through untouched."""
        full_path = f"{BUCKETS_DIR}/{bucket}/{key}"
        headers = trace.inject_headers(
            {**({"Range": range_header} if range_header else {}),
             **(conditional or {}),
             "X-Swfs-Qos-Charged": "1"})
        r = _session().get(self._meta_url(full_path), headers=headers,
                           timeout=600, stream=stream)
        if r.status_code == WRONG_SHARD_STATUS:
            self._note_stale_ring(r)
            r.close()
            r = _session().get(self._meta_url(full_path, refresh=True),
                               headers=headers, timeout=600, stream=stream)
        if r.status_code == 304:
            return r
        if r.status_code == 404:
            r.close()
            raise S3Error(404, "NoSuchKey", "The specified key does not exist.")
        if r.status_code == 416:
            r.close()
            raise S3Error(416, "InvalidRange",
                          "The requested range is not satisfiable")
        if r.status_code in (429, 503):
            r.close()
            raise _backend_throttled(r, "filer GET")
        if r.status_code >= 300:
            r.close()
            raise S3Error(500, "InternalError", f"filer GET: {r.status_code}")
        return r

    def delete_object(self, bucket: str, key: str) -> None:
        dir_, _, name = f"{BUCKETS_DIR}/{bucket}/{key}".rpartition("/")
        self.delete_entry(dir_, name, is_delete_data=True,
                          is_recursive=True)

    # routed single-entry mutations: every handler path funnels through
    # these so the whole gateway speaks to the owning shard

    def create_entry(self, directory: str, entry, timeout: int = 10):
        return self.meta_call(
            f"{directory}/{entry.name}",
            lambda stub: stub.CreateEntry(filer_pb2.CreateEntryRequest(
                directory=directory, entry=entry), timeout=timeout))

    def update_entry(self, directory: str, entry, timeout: int = 10):
        return self.meta_call(
            f"{directory}/{entry.name}",
            lambda stub: stub.UpdateEntry(filer_pb2.UpdateEntryRequest(
                directory=directory, entry=entry), timeout=timeout))

    def delete_entry(self, directory: str, name: str, *,
                     is_delete_data: bool, is_recursive: bool,
                     timeout: int = 60):
        return self.meta_call(
            f"{directory}/{name}",
            lambda stub: stub.DeleteEntry(filer_pb2.DeleteEntryRequest(
                directory=directory, name=name,
                is_delete_data=is_delete_data,
                is_recursive=is_recursive), timeout=timeout))


# -- XML helpers -----------------------------------------------------------

def _spool(chunks, md5):
    """Drain a chunk iterator into a rewindable file (memory up to 8MB,
    disk beyond), updating `md5` along the way. The filer PUT legs need
    a SEEKABLE body: the native hot plane 307s md5-wanting (and
    over-max-body) PUTs to the python listener, and requests can only
    replay a body across that redirect if it can seek back to 0."""
    import tempfile

    spool = tempfile.SpooledTemporaryFile(max_size=8 << 20)
    total = 0
    for piece in chunks:
        md5.update(piece)
        spool.write(piece)
        total += len(piece)
    spool.seek(0)
    # requests' super_len() consults this BEFORE fileno() — without it,
    # fileno() forces the spool to roll over to disk for every body,
    # making the in-memory tier dead weight
    spool.len = total
    return spool


def _el(parent, tag, text=None):
    e = ET.SubElement(parent, tag)
    if text is not None:
        e.text = str(text)
    return e


def _xml_bytes(root: ET.Element) -> bytes:
    return (b'<?xml version="1.0" encoding="UTF-8"?>'
            + ET.tostring(root))


def _iso(ts: int) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(ts or 0))


# -- request handler -------------------------------------------------------

class _S3Control:
    """s3_pb.SeaweedS3 servicer — configuration push."""

    def __init__(self, srv: S3Server):
        self.srv = srv

    def Configure(self, request, context):
        from ..pb import s3_pb2

        try:
            self.srv.configure_from_bytes(request.s3_configuration_file_content)
        except Exception as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"bad config: {e}")
        return s3_pb2.S3ConfigureResponse()


def _backend_throttled(r, what: str) -> S3Error:
    """A 429/503 from the backing filer IS throttling (its own ingress
    budget or a pressure shed): pass it through as spec-shaped SlowDown
    with the backend's retry hint — never a 500 InternalError that SDKs
    classify as a server fault and fail hard on."""
    try:
        ra = float(r.headers.get("Retry-After") or 1.0)
    except (TypeError, ValueError):
        ra = 1.0
    return S3Error(503, "SlowDown",
                   f"Please reduce your request rate. ({what} throttled)",
                   retry_after_s=ra)


def _backend_unavailable(e: Exception) -> S3Error | None:
    """Map backend-transport failures to a spec-shaped 503
    ServiceUnavailable; None for everything else
    (those stay 500 InternalError)."""
    import requests as _rq

    if isinstance(e, grpc.RpcError):
        code = e.code() if callable(getattr(e, "code", None)) else None
        if code in (grpc.StatusCode.UNAVAILABLE,
                    grpc.StatusCode.DEADLINE_EXCEEDED):
            return S3Error(503, "ServiceUnavailable",
                           f"backend filer unavailable ({code})",
                           retry_after_s=1.0)
        return None
    if isinstance(e, (_rq.ConnectionError, _rq.Timeout)):
        return S3Error(503, "ServiceUnavailable",
                       "backend filer unreachable", retry_after_s=1.0)
    return None


def _iter_exact(rfile, length: int):
    """Yield exactly `length` bytes from the socket in 1MB pieces; a short
    body is an error (AWS IncompleteBody), never a silent truncation."""
    remaining = length
    while remaining > 0:
        piece = rfile.read(min(1 << 20, remaining))
        if not piece:
            raise S3Error(400, "IncompleteBody",
                          "Request body ended before Content-Length")
        remaining -= len(piece)
        yield piece


def _action_for(verb: str, bucket: str, key: str, q) -> str:
    """HTTP request -> gateway action verb (s3_constants/header.go mapping)."""
    if "acl" in q:
        return "ReadAcp" if verb in ("GET", "HEAD") else "WriteAcp"
    if "policy" in q:
        return "Admin"
    if "tagging" in q:
        return "Read" if verb in ("GET", "HEAD") else "Tagging"
    if not bucket:
        return "List"
    if not key:
        if verb == "PUT":
            return "Admin"  # create bucket
        if verb == "DELETE":
            return "Admin"  # delete bucket
        if verb == "POST":
            return "Write"  # multi-delete
        return "List"
    if verb in ("GET", "HEAD"):
        return "Read"
    return "Write"


def _make_handler(srv: S3Server):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            glog.v(2, f"s3 http: {fmt % args}")

        # ---- plumbing

        def _send(self, status: int, body: bytes = b"",
                  ctype: str = "application/xml", headers=None):
            headers = dict(headers or {})
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            if "Content-Length" not in headers:
                headers["Content-Length"] = str(len(body))
            tid = getattr(self, "_trace_id", "")
            # the request id IS the trace id when one exists — header
            # and error-body RequestId agree, and both resolve through
            # /debug/traces
            self.send_header("x-amz-request-id",
                             tid or uuid.uuid4().hex[:16])
            if tid:
                self.send_header("X-Trace-Id", tid)
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            if body and self.command != "HEAD":
                self.wfile.write(body)

        def _error(self, err: S3Error):
            # spec-shaped error body: Code, Message,
            # Resource, RequestId — the fields AWS SDK error parsers
            # read to classify and back off. RequestId is the TRACE id
            # when the request has one, so an error in a client log is
            # one `trace.dump` away from its per-plane breakdown.
            root = ET.Element("Error")
            _el(root, "Code", err.code)
            _el(root, "Message", str(err))
            _el(root, "Resource",
                urllib.parse.urlparse(self.path).path)
            _el(root, "RequestId",
                getattr(self, "_trace_id", "") or uuid.uuid4().hex[:16])
            headers = {}
            if err.status == 503:
                headers["Retry-After"] = str(
                    max(int(err.retry_after_s + 0.999), 1))
                if int(self.headers.get("Content-Length") or 0):
                    # shed before the body was read (QoS admission /
                    # breaker fire ahead of any body consumption): the
                    # unread bytes would desync keep-alive parsing for
                    # the NEXT request on this connection — same guard
                    # as the filer's 429 path. Costs the throttled
                    # client one reconnect, which is the point.
                    self.close_connection = True
            self._send(err.status, _xml_bytes(root), headers=headers)

        def _route(self):
            u = urllib.parse.urlparse(self.path)
            path = urllib.parse.unquote(u.path)
            q = urllib.parse.parse_qs(u.query, keep_blank_values=True)
            parts = path.lstrip("/").split("/", 1)
            bucket = parts[0]
            key = parts[1] if len(parts) > 1 else ""
            return bucket, key, q, u

        def _raw_body(self) -> bytes:
            if not hasattr(self, "_raw_body_cache"):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                if len(body) < length:
                    # the client died mid-body: committing
                    # the short read would store a silently TRUNCATED
                    # object — the filer-side ShortBodyError's gateway
                    # analogue. The socket is desynced; close it.
                    self.close_connection = True
                    raise S3Error(
                        400, "IncompleteBody",
                        "You did not provide the number of bytes "
                        "specified by the Content-Length HTTP header")
                self._raw_body_cache = body
            return self._raw_body_cache

        def _body(self) -> bytes:
            body = self._raw_body()
            if self.headers.get("x-amz-content-sha256") == \
                    "STREAMING-AWS4-HMAC-SHA256-PAYLOAD":
                body = _decode_chunked_signing(body)
            return body

        def _auth(self, u) -> Identity | None:
            claimed = self.headers.get("x-amz-content-sha256",
                                       "UNSIGNED-PAYLOAD")
            if srv.iam.enabled and claimed not in (
                    "UNSIGNED-PAYLOAD",
                    "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"):
                # the signature covers the client's claimed hash; the claim
                # must match the actual body or a captured signed request
                actual = hashlib.sha256(self._raw_body()).hexdigest()
                if actual != claimed:
                    raise S3Error(400, "XAmzContentSHA256Mismatch",
                                  "payload hash does not match body")
            try:
                return srv.iam.authenticate(self.command, u.path, u.query,
                                            self.headers, claimed)
            except AuthError as e:
                raise S3Error(403, e.code, str(e))

        def _authorize(self, ident: Identity | None, action: str,
                       bucket: str, key: str,
                       entry: filer_pb2.Entry | None) -> None:
            """Identity actions + bucket policy + canned ACL, Deny-wins
            (auth_credentials.go canDo + policy evaluation). `entry` is the
            bucket entry fetched once by the dispatcher."""
            if not srv.iam.enabled:
                return
            policy = None
            if entry is not None and POLICY_KEY in entry.extended:
                try:
                    policy = BucketPolicy.parse(entry.extended[POLICY_KEY])
                except PolicyError:
                    policy = None
            verdict = policy.decide(
                principal=ident.access_key if ident else None,
                action=action, bucket=bucket, key=key) if policy else None
            if verdict == "Deny":
                raise S3Error(403, "AccessDenied", "denied by bucket policy")
            if verdict == "Allow":
                return
            if ident is not None:
                if ident.allows(action, bucket):
                    return
                raise S3Error(403, "AccessDenied",
                              f"no permission for {action} on {bucket}")
            # anonymous: only a public canned ACL (or policy, above) admits
            acl = (entry.extended.get(ACL_KEY, b"") if entry else b"").decode()
            if acl == "public-read-write" and action in ("Read", "List",
                                                         "Write"):
                return
            if acl == "public-read" and action in ("Read", "List"):
                return
            raise S3Error(403, "AccessDenied", "anonymous access denied")

        # ---- verbs

        def do_GET(self):
            self._dispatch("GET")

        def do_HEAD(self):
            self._dispatch("HEAD")

        def do_PUT(self):
            self._dispatch("PUT")

        def do_POST(self):
            self._dispatch("POST")

        def do_DELETE(self):
            self._dispatch("DELETE")

        def _admin_plane_ok(self, u) -> bool:
            # /debug/traces and /status expose request-level data (object
            # keys, internal server addresses, error strings) — unlike the
            # aggregate-only /metrics, they must not be anonymous-readable
            # on the public gateway when IAM is on
            if not srv.iam.enabled:
                return True
            try:
                ident = self._auth(u)
            except S3Error:
                return False
            return ident is not None and ident.allows("Admin")

        def _dispatch(self, verb: str):
            self._trace_id = ""  # never leak across keep-alive requests
            # nor the body an earlier request on this connection read: a
            # signed request would be checked, and stored, with its bytes
            self.__dict__.pop("_raw_body_cache", None)
            # admin endpoints match the exact PATH and admit ONLY their
            # own query params — a bucket literally named "metrics" or
            # "status" keeps its S3 query routes (GET /metrics with no
            # query was always the admin endpoint, ?list-type=2 etc.
            # must still reach bucket listing)
            admin_u = urllib.parse.urlparse(self.path)
            admin_q = {k: v[0] for k, v in
                       urllib.parse.parse_qs(admin_u.query).items()}
            if verb == "GET" and admin_u.path == "/metrics" \
                    and set(admin_q) <= {"exemplars"}:
                exemplars = "exemplars" in admin_q
                body = gather(exemplars=exemplars).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 metrics_content_type(exemplars))
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if verb == "GET" and admin_u.path == "/debug/traces" \
                    and set(admin_q) <= {"trace"}:
                if not self._admin_plane_ok(admin_u):
                    return self._send(403, b'{"error": "AccessDenied"}',
                                      "application/json")
                body = json.dumps(
                    trace.debug_traces_payload(admin_q)).encode()
                return self._send(200, body, "application/json")
            if verb == "GET" and admin_u.path == "/status" \
                    and not admin_q:
                if not self._admin_plane_ok(admin_u):
                    return self._send(403, b'{"error": "AccessDenied"}',
                                      "application/json")
                from ..utils.stats import http_pool_stats, qos_stats

                body = json.dumps({
                    **status_base(srv._started_at),
                    "Filer": srv.filer,
                    # TLS handshakes accepted on the public ingress +
                    # this process's pooled client legs
                    "HttpPool": http_pool_stats(),
                    "Trace": trace.STORE.stats(),
                    # QoS plane: tenant buckets + rejections
                    "Qos": {
                        **qos_stats(),
                        "tenantAdmission": srv.qos_admission.status(),
                    },
                }).encode()
                return self._send(200, body, "application/json")
            bucket, key, q, u = self._route()
            action = _action_for(verb, bucket, key, q)
            release = lambda: None  # noqa: E731
            with trace.span("s3.request", carrier=self.headers,
                            component="s3", server=srv.address,
                            action=f"{verb.lower()}", bucket=bucket,
                            key=key) as tsp:
                self._trace_id = tsp.trace_id
                self._dispatch_traced(verb, bucket, key, q, u, action,
                                      release, tsp)

        def _dispatch_traced(self, verb, bucket, key, q, u, action,
                             release, tsp):
            try:
                with S3_REQUEST_HISTOGRAM.time(action=f"{verb.lower()}"):
                    # admission first: a tenant over budget (or a
                    # tripped breaker) must shed load before any filer
                    # lookups (authz reads bucket state). 503 SlowDown
                    # is the spec code SDKs back off on.
                    from ..qos import s3_tenant

                    d = srv.qos_admission.admit(
                        s3_tenant(self.headers, u.query, bucket),
                        trace_id=tsp.trace_id,
                        detail=f"{verb} {u.path}")
                    if not d.admitted:
                        tsp.set_attr(qosRejected=d.reason,
                                     tenant=d.tenant)
                        raise S3Error(
                            503, "SlowDown",
                            "Please reduce your request rate.",
                            retry_after_s=d.retry_after_s)
                    srv.maybe_reload_circuit_breaker()
                    try:
                        release = srv.circuit_breaker.acquire(
                            action, bucket,
                            int(self.headers.get("Content-Length") or 0))
                    except TooManyRequests as e:
                        # SlowDown, not a bare 500/TooManyRequests: the
                        # spec-shaped code is what SDK retry policies
                        # classify as throttling
                        raise S3Error(503, "SlowDown",
                                      f"Please reduce your request "
                                      f"rate. ({e})", retry_after_s=1.0)
                    bucket_entry = srv.bucket_entry(bucket) if bucket else None
                    ident = self._auth(u)
                    self._authorize(ident, action, bucket, key, bucket_entry)
                    if not bucket:
                        return self._service(verb)
                    if not key:
                        return self._bucket(verb, bucket, q, bucket_entry)
                    return self._object(verb, bucket, key, q, bucket_entry)
            except S3Error as e:
                if e.status >= 500 and e.status != 503:
                    # 5xx pins the trace (keep-if-error); expected 4xx
                    # (404 polls, auth rejections) and 503 shedding
                    # (SlowDown floods at hundreds/s are the QoS plane
                    # WORKING — the filer/master overload policy) must
                    # not churn the retained set
                    tsp.set_error(f"{e.code}: {e}")
                else:
                    tsp.set_attr(s3Error=e.code, status=e.status)
                self._error(e)
            except Exception as e:  # noqa: BLE001
                tsp.set_error(f"{type(e).__name__}: {e}")
                glog.error(f"s3 {verb} {self.path}: {e}")
                # transport failures to the backend filer are OUTAGES,
                # not internal bugs: answer 503 ServiceUnavailable with
                # a retry hint so SDK clients back off instead of
                # failing hard on a generic 500
                self._error(_backend_unavailable(e)
                            or S3Error(500, "InternalError", str(e)))
            finally:
                release()

        # ---- service level

        def _service(self, verb: str):
            if verb != "GET":
                raise S3Error(405, "MethodNotAllowed", "unsupported")
            root = ET.Element("ListAllMyBucketsResult", xmlns=S3_NS)
            owner = _el(root, "Owner")
            _el(owner, "ID", "seaweedfs-tpu")
            buckets = _el(root, "Buckets")
            for e in srv.list_dir(BUCKETS_DIR):
                if not e.is_directory or e.name.startswith("."):
                    continue
                b = _el(buckets, "Bucket")
                _el(b, "Name", e.name)
                _el(b, "CreationDate", _iso(e.attributes.crtime))
            self._send(200, _xml_bytes(root))

        # ---- bucket level

        def _bucket(self, verb: str, bucket: str, q,
                    bucket_entry: filer_pb2.Entry | None = None):
            if "acl" in q:
                return self._acl(verb, bucket, "")
            if "policy" in q:
                return self._policy(verb, bucket)
            if verb == "PUT":
                if bucket_entry is not None:
                    # CreateEntry upserts; recreating would wipe the
                    # existing bucket's ACL/policy/quota attributes
                    return self._send(200,
                                      headers={"Location": f"/{bucket}"})
                entry = _dir_entry(bucket)
                acl = self.headers.get("x-amz-acl", "")
                if acl:
                    if acl not in CANNED_ACLS:
                        raise S3Error(400, "InvalidArgument",
                                      f"unsupported canned acl {acl}")
                    entry.extended[ACL_KEY] = acl.encode()
                srv.create_entry(BUCKETS_DIR, entry)
                return self._send(200, headers={"Location": f"/{bucket}"})
            if verb in ("GET", "HEAD"):
                entry = bucket_entry
                if entry is None:
                    raise S3Error(404, "NoSuchBucket",
                                  "The specified bucket does not exist")
                if verb == "HEAD":
                    return self._send(200)
                if "uploads" in q:
                    return self._list_multipart_uploads(bucket)
                return self._list_objects(bucket, q)
            if verb == "DELETE":
                resp = srv.delete_entry(BUCKETS_DIR, bucket,
                                        is_delete_data=True,
                                        is_recursive=True)
                if resp.error:
                    raise S3Error(409, "BucketNotEmpty", resp.error)
                return self._send(204)
            if verb == "POST" and "delete" in q:
                return self._multi_delete(bucket)
            raise S3Error(405, "MethodNotAllowed", "unsupported bucket op")

        def _list_objects(self, bucket: str, q):
            prefix = q.get("prefix", [""])[0]
            delimiter = q.get("delimiter", [""])[0]
            max_keys = int(q.get("max-keys", ["1000"])[0])
            v2 = q.get("list-type", [""])[0] == "2"
            marker = (q.get("continuation-token", [""])[0] if v2
                      else q.get("marker", [""])[0])
            start_after = q.get("start-after", [""])[0]
            if start_after > marker:
                marker = start_after

            contents, common = [], set()
            truncated, next_marker = _walk(
                srv, f"{BUCKETS_DIR}/{bucket}", "", prefix, delimiter,
                marker, max_keys, contents, common)

            tag = "ListBucketResult"
            root = ET.Element(tag, xmlns=S3_NS)
            _el(root, "Name", bucket)
            _el(root, "Prefix", prefix)
            _el(root, "MaxKeys", max_keys)
            if delimiter:
                _el(root, "Delimiter", delimiter)
            _el(root, "IsTruncated", "true" if truncated else "false")
            if v2:
                _el(root, "KeyCount", len(contents))
                if truncated:
                    _el(root, "NextContinuationToken", next_marker)
            elif truncated:
                _el(root, "NextMarker", next_marker)
            for key, entry in contents:
                c = _el(root, "Contents")
                _el(c, "Key", key)
                _el(c, "LastModified", _iso(entry.attributes.mtime))
                _el(c, "ETag", f'"{_entry_etag(entry)}"')
                _el(c, "Size", entry.attributes.file_size)
                _el(c, "StorageClass", "STANDARD")
            for p in sorted(common):
                cp = _el(root, "CommonPrefixes")
                _el(cp, "Prefix", p)
            self._send(200, _xml_bytes(root))

        def _multi_delete(self, bucket: str):
            body = self._body()
            root = ET.fromstring(body)
            ns = root.tag.partition("}")[0] + "}" if "}" in root.tag else ""
            result = ET.Element("DeleteResult", xmlns=S3_NS)
            for obj in root.findall(f"{ns}Object"):
                key = obj.find(f"{ns}Key").text
                try:
                    srv.delete_object(bucket, key)
                    d = _el(result, "Deleted")
                    _el(d, "Key", key)
                except Exception as e:  # noqa: BLE001
                    er = _el(result, "Error")
                    _el(er, "Key", key)
                    _el(er, "Code", "InternalError")
                    _el(er, "Message", str(e))
            self._send(200, _xml_bytes(result))

        # ---- object level

        # ---- ACL (s3acl/ + s3api_object_handlers_acl.go): canned ACLs
        # stored on the entry, rendered as AccessControlPolicy XML

        def _acl(self, verb: str, bucket: str, key: str):
            if key:
                dir_, _, name = f"{BUCKETS_DIR}/{bucket}/{key}".rpartition("/")
            else:
                dir_, name = BUCKETS_DIR, bucket
            entry = srv.find_entry(dir_, name)
            if entry is None:
                raise S3Error(404, "NoSuchKey" if key else "NoSuchBucket",
                              "not found")
            if verb in ("GET", "HEAD"):
                acl = entry.extended.get(ACL_KEY, b"private").decode()
                root = ET.Element("AccessControlPolicy", xmlns=S3_NS)
                owner = _el(root, "Owner")
                _el(owner, "ID", "seaweedfs-tpu")
                grants = _el(root, "AccessControlList")
                g = _el(grants, "Grant")
                ge = _el(g, "Grantee")
                ge.set("xmlns:xsi", "http://www.w3.org/2001/XMLSchema-instance")
                ge.set("xsi:type", "CanonicalUser")
                _el(ge, "ID", "seaweedfs-tpu")
                _el(g, "Permission", "FULL_CONTROL")
                if acl in ("public-read", "public-read-write"):
                    g2 = _el(grants, "Grant")
                    ge2 = _el(g2, "Grantee")
                    ge2.set("xmlns:xsi",
                            "http://www.w3.org/2001/XMLSchema-instance")
                    ge2.set("xsi:type", "Group")
                    _el(ge2, "URI",
                        "http://acs.amazonaws.com/groups/global/AllUsers")
                    _el(g2, "Permission",
                        "READ" if acl == "public-read" else "FULL_CONTROL")
                return self._send(200, _xml_bytes(root))
            if verb == "PUT":
                acl = self.headers.get("x-amz-acl", "")
                if not acl:  # grant-by-XML-body unsupported, like many S3s
                    raise S3Error(400, "MissingSecurityHeader",
                                  "x-amz-acl canned header required")
                if acl not in CANNED_ACLS:
                    raise S3Error(400, "InvalidArgument",
                                  f"unsupported canned acl {acl}")
                entry.extended[ACL_KEY] = acl.encode()
                srv.update_entry(dir_, entry)
                return self._send(200)
            raise S3Error(405, "MethodNotAllowed", "unsupported acl op")

        # ---- bucket policy (policy/ + s3api_bucket_policy_handlers.go)

        def _policy(self, verb: str, bucket: str):
            entry = srv.find_entry(BUCKETS_DIR, bucket)
            if entry is None:
                raise S3Error(404, "NoSuchBucket", "no such bucket")
            if verb == "GET":
                blob = entry.extended.get(POLICY_KEY)
                if not blob:
                    raise S3Error(404, "NoSuchBucketPolicy",
                                  "the bucket policy does not exist")
                return self._send(200, blob, "application/json")
            if verb == "PUT":
                try:
                    pol = BucketPolicy.parse(self._body())
                except PolicyError as e:
                    raise S3Error(400, "MalformedPolicy", str(e))
                entry.extended[POLICY_KEY] = pol.to_bytes()
                srv.update_entry(BUCKETS_DIR, entry)
                return self._send(204)
            if verb == "DELETE":
                if POLICY_KEY in entry.extended:
                    del entry.extended[POLICY_KEY]
                    srv.update_entry(BUCKETS_DIR, entry)
                return self._send(204)
            raise S3Error(405, "MethodNotAllowed", "unsupported policy op")

        def _object(self, verb: str, bucket: str, key: str, q,
                    bucket_entry: filer_pb2.Entry | None = None):
            if bucket_entry is None:
                bucket_entry = srv.find_entry(BUCKETS_DIR, bucket)
            if bucket_entry is None:
                raise S3Error(404, "NoSuchBucket",
                              "The specified bucket does not exist")
            if verb in ("PUT", "POST") and \
                    bucket_entry.extended.get(READONLY_KEY) == b"true":
                # quota outcome (command_s3_bucket_quota_check): block only
                # data-adding verbs — DELETE stays allowed so an over-quota
                # bucket can be drained back under its limit
                raise S3Error(403, "AccessDenied",
                              f"bucket {bucket} is read-only (quota)")
            if "acl" in q:
                return self._acl(verb, bucket, key)
            if "tagging" in q:
                return self._tagging(verb, bucket, key)
            if "uploads" in q and verb == "POST":
                return self._initiate_multipart(bucket, key)
            if "uploadId" in q:
                upload_id = q["uploadId"][0]
                if verb == "PUT" and "partNumber" in q:
                    src = self.headers.get("x-amz-copy-source")
                    if src:
                        return self._upload_part_copy(
                            bucket, key, upload_id,
                            int(q["partNumber"][0]), src)
                    return self._upload_part(bucket, key, upload_id,
                                             int(q["partNumber"][0]))
                if verb == "POST":
                    return self._complete_multipart(bucket, key, upload_id)
                if verb == "DELETE":
                    return self._abort_multipart(bucket, key, upload_id)
                if verb == "GET":
                    return self._list_parts(bucket, key, upload_id)

            if verb == "PUT":
                src = self.headers.get("x-amz-copy-source")
                if src:
                    return self._copy_object(bucket, key, src)
                # When the signature binds no payload hash (anonymous or
                # UNSIGNED-PAYLOAD), the body can stream straight through —
                # gateway memory stays one piece deep. Signed payload
                # hashes and aws-chunked signing need the whole body (the
                # hash/frame check in _auth/_body already consumed it).
                claimed = self.headers.get("x-amz-content-sha256",
                                           "UNSIGNED-PAYLOAD")
                length = int(self.headers.get("Content-Length") or 0)
                streamed = (claimed == "UNSIGNED-PAYLOAD"
                            and not hasattr(self, "_raw_body_cache"))
                chunked_te = "chunked" in (
                    self.headers.get("Transfer-Encoding") or "").lower()
                if chunked_te:
                    if not streamed:
                        # signed payloads need Content-Length semantics
                        raise S3Error(411, "MissingContentLength",
                                      "chunked transfer requires an "
                                      "unsigned payload here")
                    from ..server.filer import _ChunkedReader

                    reader = _ChunkedReader(self.rfile)
                    body = iter(lambda: reader.read(1 << 20), b"")
                elif streamed:
                    body = _iter_exact(self.rfile, length)
                else:
                    body = self._body()
                try:
                    etag = srv.put_object(
                        bucket, key, body,
                        self.headers.get("Content-Type", ""))
                except Exception:
                    if streamed:
                        # body may be partially unread: keep-alive desync
                        self.close_connection = True
                    raise
                acl = self.headers.get("x-amz-acl", "")
                if acl in CANNED_ACLS:
                    dir_, _, name = \
                        f"{BUCKETS_DIR}/{bucket}/{key}".rpartition("/")
                    entry = srv.find_entry(dir_, name)
                    if entry is not None:
                        entry.extended[ACL_KEY] = acl.encode()
                        srv.update_entry(dir_, entry)
                return self._send(200, headers={"ETag": f'"{etag}"'})
            if verb in ("GET", "HEAD"):
                if verb == "HEAD":
                    dir_, _, name = f"{BUCKETS_DIR}/{bucket}/{key}".rpartition("/")
                    entry = srv.find_entry(dir_, name)
                    if entry is None or entry.is_directory:
                        raise S3Error(404, "NoSuchKey", "not found")
                    return self._send(200, headers={
                        "Content-Length": str(entry.attributes.file_size),
                        "ETag": f'"{_entry_etag(entry)}"',
                        "Last-Modified": time.strftime(
                            "%a, %d %b %Y %H:%M:%S GMT",
                            time.gmtime(entry.attributes.mtime)),
                    })
                conditional = {
                    h: self.headers[h]
                    for h in ("If-None-Match", "If-Modified-Since",
                              "If-Range")
                    if self.headers.get(h) is not None}
                r = srv.get_object(bucket, key,
                                   self.headers.get("Range", ""),
                                   stream=True,
                                   conditional=conditional or None)
                headers = {}
                for h in ("Content-Range", "ETag", "Last-Modified"):
                    if h in r.headers:
                        headers[h] = r.headers[h]
                if r.status_code == 304:
                    r.close()
                    return self._send(304, headers=headers)
                # pass the filer's stream straight through: gateway memory
                # stays one chunk deep for any object size
                try:
                    self.send_response(r.status_code)
                    self.send_header("x-amz-request-id", uuid.uuid4().hex[:16])
                    tid = getattr(self, "_trace_id", "")
                    if tid:
                        self.send_header("X-Trace-Id", tid)
                    self.send_header(
                        "Content-Type",
                        r.headers.get("Content-Type",
                                      "application/octet-stream"))
                    self.send_header("Content-Length",
                                     r.headers.get("Content-Length", "0"))
                    for k, v in headers.items():
                        self.send_header(k, v)
                    self.end_headers()
                    # HEAD never reaches here (fast-path above returns)
                    for piece in r.iter_content(1 << 20):
                        if piece:
                            self.wfile.write(piece)
                except IOError:  # client went away mid-stream
                    self.close_connection = True
                finally:
                    r.close()
                return
            if verb == "DELETE":
                srv.delete_object(bucket, key)
                return self._send(204)
            raise S3Error(405, "MethodNotAllowed", "unsupported object op")

        def _parse_copy_source(self, src: str) -> tuple[str, str]:
            # "?versionId=..." may qualify the source (we keep a single
            # version; the suffix must not leak into the key)
            src = src.partition("?")[0]
            src = urllib.parse.unquote(src.lstrip("/"))
            sbucket, _, skey = src.partition("/")
            if not sbucket or not skey:
                raise S3Error(400, "InvalidArgument", "bad copy source")
            return sbucket, skey

        def _copy_object(self, bucket: str, key: str, src: str):
            sbucket, skey = self._parse_copy_source(src)
            # STREAMED copy: the filer serves the source GET
            # through its pipelined readahead and the PUT leg re-chunks
            # through the overlapped autochunker — the gateway spools
            # (mem <= 8MB, disk beyond) instead of materializing the
            # whole object in RAM as r.content did
            r = srv.get_object(sbucket, skey, stream=True)
            try:
                etag = srv.put_object(bucket, key,
                                      r.iter_content(1 << 20),
                                      r.headers.get("Content-Type", ""))
            finally:
                r.close()
            root = ET.Element("CopyObjectResult", xmlns=S3_NS)
            _el(root, "ETag", f'"{etag}"')
            _el(root, "LastModified", _iso(int(time.time())))
            self._send(200, _xml_bytes(root))

        # ---- tagging (stored as extended attrs, s3api_object_tagging)

        def _tagging(self, verb: str, bucket: str, key: str):
            dir_, _, name = f"{BUCKETS_DIR}/{bucket}/{key}".rpartition("/")
            entry = srv.find_entry(dir_, name)
            if entry is None:
                raise S3Error(404, "NoSuchKey", "not found")
            if verb == "GET":
                root = ET.Element("Tagging", xmlns=S3_NS)
                ts = _el(root, "TagSet")
                for k, v in sorted(entry.extended.items()):
                    if k.startswith("x-amz-tag-"):
                        t = _el(ts, "Tag")
                        _el(t, "Key", k[len("x-amz-tag-"):])
                        _el(t, "Value", v.decode())
                return self._send(200, _xml_bytes(root))
            if verb == "PUT":
                body = self._body()
                root = ET.fromstring(body)
                ns = root.tag.partition("}")[0] + "}" if "}" in root.tag else ""
                for k in [k for k in entry.extended
                          if k.startswith("x-amz-tag-")]:
                    del entry.extended[k]
                for tag in root.iter(f"{ns}Tag"):
                    k = tag.find(f"{ns}Key").text
                    v = tag.find(f"{ns}Value").text or ""
                    entry.extended[f"x-amz-tag-{k}"] = v.encode()
                srv.update_entry(dir_, entry)
                return self._send(200)
            if verb == "DELETE":
                for k in [k for k in entry.extended
                          if k.startswith("x-amz-tag-")]:
                    del entry.extended[k]
                srv.update_entry(dir_, entry)
                return self._send(204)
            raise S3Error(405, "MethodNotAllowed", "unsupported tagging op")

        # ---- multipart (filer_multipart.go)

        def _initiate_multipart(self, bucket: str, key: str):
            upload_id = uuid.uuid4().hex
            meta = json.dumps({"bucket": bucket, "key": key,
                               "content_type":
                               self.headers.get("Content-Type", "")}).encode()
            e = _dir_entry(upload_id)
            e.extended["upload-meta"] = meta
            srv.create_entry(UPLOADS_DIR, e)
            root = ET.Element("InitiateMultipartUploadResult", xmlns=S3_NS)
            _el(root, "Bucket", bucket)
            _el(root, "Key", key)
            _el(root, "UploadId", upload_id)
            self._send(200, _xml_bytes(root))

        def _upload_part(self, bucket: str, key: str, upload_id: str,
                         part_number: int):
            if srv.find_entry(UPLOADS_DIR, upload_id) is None:
                raise S3Error(404, "NoSuchUpload", "upload not found")
            body = self._body()
            part_path = (f"{UPLOADS_DIR}/{upload_id}/"
                         f"{part_number:04d}.part")
            r = _session().put(srv._meta_url(part_path), data=body,
                               timeout=600,
                               headers={"X-Swfs-Want-Md5": "1"})
            if r.status_code == WRONG_SHARD_STATUS:
                srv._note_stale_ring(r)
                r = _session().put(srv._meta_url(part_path, refresh=True),
                                   data=body, timeout=600,
                                   headers={"X-Swfs-Want-Md5": "1"})
            if r.status_code >= 300:
                raise S3Error(500, "InternalError", "part upload failed")
            self._send(200, headers={
                "ETag": f'"{hashlib.md5(body).hexdigest()}"'})

        def _upload_part_copy(self, bucket: str, key: str, upload_id: str,
                              part_number: int, src: str):
            """UploadPartCopy: a part sourced from an existing object,
            optionally a byte range — streamed, never fully buffered
            (CopyObjectPartHandler, s3api_object_copy_handlers.go:135-183;
            bad ranges map to 400 InvalidArgument like the reference)."""
            if srv.find_entry(UPLOADS_DIR, upload_id) is None:
                raise S3Error(404, "NoSuchUpload", "upload not found")
            sbucket, skey = self._parse_copy_source(src)
            sdir, _, sname = f"{BUCKETS_DIR}/{sbucket}/{skey}".rpartition("/")
            sentry = srv.find_entry(sdir, sname)
            if sentry is None:
                raise S3Error(404, "NoSuchKey", "copy source not found")
            src_size = sentry.attributes.file_size
            range_header = ""
            rng = self.headers.get("x-amz-copy-source-range", "")
            if rng:
                bad = S3Error(
                    400, "InvalidArgument",
                    "Range specified is not valid for source object "
                    f"of size: {src_size}")
                if not rng.startswith("bytes="):
                    raise bad
                try:
                    lo, _, hi = rng[6:].partition("-")
                    start = int(lo)
                    stop = int(hi) + 1 if hi else src_size
                except ValueError:
                    raise bad
                if start >= src_size or stop > src_size or start >= stop:
                    raise bad
                range_header = f"bytes={start}-{stop - 1}"
            r = srv.get_object(sbucket, skey, range_header=range_header,
                               stream=True)
            part_path = (f"{UPLOADS_DIR}/{upload_id}/"
                         f"{part_number:04d}.part")
            md5 = hashlib.md5()
            spool = _spool(r.iter_content(1 << 20), md5)
            try:
                pr = _session().put(srv._meta_url(part_path), data=spool,
                                    timeout=600,
                                    headers={"X-Swfs-Want-Md5": "1"})
                if pr.status_code == WRONG_SHARD_STATUS:
                    srv._note_stale_ring(pr)
                    spool.seek(0)
                    pr = _session().put(
                        srv._meta_url(part_path, refresh=True), data=spool,
                        timeout=600, headers={"X-Swfs-Want-Md5": "1"})
            finally:
                spool.close()
            if pr.status_code >= 300:
                raise S3Error(500, "InternalError", "part copy failed")
            root = ET.Element("CopyPartResult", xmlns=S3_NS)
            _el(root, "ETag", f'"{md5.hexdigest()}"')
            _el(root, "LastModified", _iso(int(time.time())))
            self._send(200, _xml_bytes(root))

        def _complete_multipart(self, bucket: str, key: str, upload_id: str):
            updir = f"{UPLOADS_DIR}/{upload_id}"
            meta_entry = srv.find_entry(UPLOADS_DIR, upload_id)
            if meta_entry is None:
                raise S3Error(404, "NoSuchUpload", "upload not found")
            meta = json.loads(meta_entry.extended.get("upload-meta", b"{}"))
            # numeric sort: '10000.part' must follow '9999.part'; S3
            # allows 10000 parts, above list_dir's default 1000 cap
            parts = sorted(
                (e for e in srv.list_dir(updir, limit=10001)
                 if e.name.endswith(".part")),
                key=lambda e: int(e.name.split(".")[0]))
            chunks, offset = [], 0
            for p in parts:
                for c in p.chunks:
                    nc = filer_pb2.FileChunk()
                    nc.CopyFrom(c)
                    nc.offset = offset + c.offset
                    chunks.append(nc)
                offset += p.attributes.file_size
            final = filer_pb2.Entry(name=key.rsplit("/", 1)[-1])
            final.chunks.extend(chunks)
            final.attributes.mtime = int(time.time())
            final.attributes.file_size = offset
            final.attributes.mime = meta.get("content_type", "")
            dir_ = f"{BUCKETS_DIR}/{bucket}/{key}".rpartition("/")[0]
            resp = srv.create_entry(dir_, final, timeout=30)
            if resp.error:
                raise S3Error(500, "InternalError", resp.error)
            # drop the staging dir but keep the chunks (owned by the object now)
            srv.delete_entry(UPLOADS_DIR, upload_id,
                             is_delete_data=False, is_recursive=True)
            root = ET.Element("CompleteMultipartUploadResult", xmlns=S3_NS)
            _el(root, "Location", f"/{bucket}/{key}")
            _el(root, "Bucket", bucket)
            _el(root, "Key", key)
            _el(root, "ETag", f'"{hashlib.md5(str(offset).encode()).hexdigest()}-{len(parts)}"')
            self._send(200, _xml_bytes(root))

        def _abort_multipart(self, bucket: str, key: str, upload_id: str):
            srv.delete_entry(UPLOADS_DIR, upload_id,
                             is_delete_data=True, is_recursive=True)
            self._send(204)

        def _list_parts(self, bucket: str, key: str, upload_id: str):
            updir = f"{UPLOADS_DIR}/{upload_id}"
            root = ET.Element("ListPartsResult", xmlns=S3_NS)
            _el(root, "Bucket", bucket)
            _el(root, "Key", key)
            _el(root, "UploadId", upload_id)
            for e in sorted(
                    (e for e in srv.list_dir(updir, limit=10001)
                     if e.name.endswith(".part")),
                    key=lambda e: int(e.name.split(".")[0])):
                p = _el(root, "Part")
                _el(p, "PartNumber", int(e.name.split(".")[0]))
                _el(p, "Size", e.attributes.file_size)
                _el(p, "LastModified", _iso(e.attributes.mtime))
            self._send(200, _xml_bytes(root))

        def _list_multipart_uploads(self, bucket: str):
            root = ET.Element("ListMultipartUploadsResult", xmlns=S3_NS)
            _el(root, "Bucket", bucket)
            for e in srv.list_dir(UPLOADS_DIR):
                meta = json.loads(e.extended.get("upload-meta", b"{}"))
                if meta.get("bucket") != bucket:
                    continue
                u = _el(root, "Upload")
                _el(u, "Key", meta.get("key", ""))
                _el(u, "UploadId", e.name)
                _el(u, "Initiated", _iso(e.attributes.crtime))
            self._send(200, _xml_bytes(root))

    return Handler


def _dir_entry(name: str) -> filer_pb2.Entry:
    e = filer_pb2.Entry(name=name, is_directory=True)
    now = int(time.time())
    e.attributes.crtime = now
    e.attributes.mtime = now
    e.attributes.file_mode = 0o770 | 0o40000
    return e


def _entry_etag(entry: filer_pb2.Entry) -> str:
    if entry.attributes.md5:
        return entry.attributes.md5.hex()
    if len(entry.chunks) == 1:
        return entry.chunks[0].e_tag or entry.chunks[0].file_id
    return hashlib.md5(
        b"".join((c.e_tag or c.file_id).encode() for c in entry.chunks)
    ).hexdigest()


def _walk(srv: S3Server, base_dir: str, rel: str, prefix: str,
          delimiter: str, marker: str, max_keys: int,
          contents: list, common: set) -> tuple[bool, str]:
    """Depth-first object listing with prefix/delimiter semantics
    (s3api_objects_list_handlers.go doListFilerEntries)."""
    truncated = False
    next_marker = ""
    for entry in srv.list_dir(base_dir, limit=10_000):
        key = f"{rel}{entry.name}"
        if entry.is_directory:
            sub = key + "/"
            if prefix and not (sub.startswith(prefix) or prefix.startswith(sub)):
                continue
            if delimiter == "/" and sub.startswith(prefix):
                # collapse at the first delimiter after the prefix
                tail = sub[len(prefix):]
                if "/" in tail[:-1] or tail:
                    common.add(prefix + tail.split("/")[0] + "/")
                    continue
            t, m = _walk(srv, f"{base_dir}/{entry.name}", sub, prefix,
                         delimiter, marker, max_keys, contents, common)
            if t:
                return True, m
            continue
        if prefix and not key.startswith(prefix):
            continue
        if marker and key <= marker:
            continue
        if delimiter == "/":
            tail = key[len(prefix):]
            if "/" in tail:
                common.add(prefix + tail.split("/")[0] + "/")
                continue
        if len(contents) >= max_keys:
            # the page's last key, wherever it was listed: this walk's own
            # marker is empty when the page filled up in a directory
            # walked before it
            return True, contents[-1][0]
        contents.append((key, entry))
        next_marker = key
    return truncated, next_marker


def _decode_chunked_signing(body: bytes) -> bytes:
    """Strip aws-chunked transfer encoding (sigv4 streaming uploads)."""
    out = bytearray()
    i = 0
    while i < len(body):
        j = body.find(b"\r\n", i)
        if j < 0:
            break
        header = body[i:j].split(b";")[0]
        try:
            n = int(header, 16)
        except ValueError:
            break
        if n == 0:
            break
        out += body[j + 2:j + 2 + n]
        i = j + 2 + n + 2
    return bytes(out)
