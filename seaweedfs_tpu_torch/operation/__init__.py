"""Client-side verbs: assign, upload, delete, submit.

Counterpart of seaweedfs_tpu/operation/__init__.py (SeaweedFS
weed/operation/): `Assign`
(assign_file_id.go:37), `Upload`/`UploadData` with gzip + retry
(upload_content.go:85,134-160), `DeleteFiles` (delete_content.go), and
`SubmitFiles` (submit.go:45).
"""

from __future__ import annotations

import gzip
import threading
from dataclasses import dataclass, field

import grpc
import requests

from ..pb import master_pb2, rpc
from ..utils import glog, trace
from ..utils.retry import Backoff, guarded_attempt
from ..utils.stats import (
    CLIENT_ASSIGN_COUNTER,
    CLIENT_ASSIGN_SECONDS,
    CLIENT_UPLOAD_SECONDS,
)

_tl = threading.local()


def thread_session() -> requests.Session:
    """Default per-thread keepalive session for volume-server uploads.
    requests.Session is not safe for concurrent use, so each worker
    thread gets its own."""
    s = getattr(_tl, "session", None)
    if s is None:
        s = _tl.session = requests.Session()
        s.trust_env = False  # skip per-request proxy-env scans
    # refreshed per call: under SWFS_HTTPS every internal leg verifies
    # the cluster CA (or skips verification on self-signed dev setups)
    from ..utils.http import requests_verify

    s.verify = requests_verify()
    return s

COMPRESS_MIN = 128  # don't bother gzipping tiny payloads


@dataclass
class AssignResult:
    fid: str = ""
    url: str = ""
    public_url: str = ""
    count: int = 0
    error: str = ""
    auth: str = ""  # write JWT minted by the master (jwt.go:30)
    replicas: list = field(default_factory=list)


# Master replies that describe topology churn or a momentarily-full
# cluster, not a bad request: a node mid-(re)registration after a
# heartbeat-stream break empties the writable set for a second or two,
# so these are worth re-asking after backoff (the reference's
# assign_file_id retries its whole lookup the same way). Placement
# SHAPE errors ("not enough racks", "not enough other data centers")
# are deliberately absent: retrying cannot conjure a rack, and the
# caller should see the config error immediately.
_TRANSIENT_ASSIGN = ("no writable volumes", "no free volume slot",
                     "not enough servers",
                     "no data center with enough free slots",
                     "volume growth rpc failed",
                     # QoS pressure shed: an explicit
                     # early rejection with a retry hint — pressure
                     # drains in seconds, exactly what backoff is for
                     "overloaded")


def assign(master: str, *, count: int = 1, collection: str = "",
           replication: str = "", ttl: str = "",
           data_center: str = "") -> AssignResult:
    """Instrumented wrapper over the failover assign loop: latency and
    outcome counters make the bench's per-PUT master cost attributable
    (fid-lease batching shows up as fewer assign ops per 1k writes);
    inside a trace the whole master round-trip is a `client.assign`
    child span."""
    with trace.span("client.assign", child_only=True, count=count) as tsp:
        with CLIENT_ASSIGN_SECONDS.time():
            result = _assign(master, count=count, collection=collection,
                             replication=replication, ttl=ttl,
                             data_center=data_center)
        if result.error:
            CLIENT_ASSIGN_COUNTER.inc(outcome="error")
            # attr, not set_error: a cluster-full burst hits every traced
            # write's lease refill, and keep-if-error retention on each
            # would flush the bounded retained set (the master's
            # /dir/assign handler makes the same call)
            tsp.set_attr(assignError=str(result.error)[:120])
        else:
            CLIENT_ASSIGN_COUNTER.inc(outcome="ok")
            CLIENT_ASSIGN_COUNTER.inc(max(1, int(result.count or 1)),
                                      outcome="fids")
            tsp.set_attr(fid=result.fid, leased=int(result.count or 1))
    return result


def _assign(master: str, *, count: int = 1, collection: str = "",
            replication: str = "", ttl: str = "",
            data_center: str = "") -> AssignResult:
    """Assign a file id, surviving master faults (assign_file_id.go's
    retried LookupJwt path + masterclient failover): `master` may be a
    comma-separated list; transient gRPC failures rotate to the next
    master, a follower's "not the leader; ask <addr>" reply redirects
    to (and remembers) the named leader, and capacity errors during
    topology churn are re-asked after backoff."""
    masters = [m.strip() for m in str(master).split(",") if m.strip()]
    if not masters:
        # pure configuration error — don't sleep through retry cycles
        return AssignResult(error="assign: no masters configured")
    req = master_pb2.AssignRequest(
        count=count, collection=collection, replication=replication,
        ttl=ttl, data_center=data_center)
    cycles = 4
    bo = Backoff(wait_init=0.3)
    # None until some master answers or fails; a bare "not the leader"
    # redirect is recorded only when nothing more informative is held
    last_err: Exception | str | None = None
    queue = list(masters)
    for cycle in range(cycles):
        # `seen` only bounds redirects within one cycle: a leader that
        # failed transiently this cycle is worth re-asking next cycle
        seen: set[str] = set()
        while queue:
            m = queue.pop(0)
            seen.add(m)
            try:
                call = lambda: rpc.master_stub(  # noqa: E731
                    rpc.grpc_address(m)).Assign(req, timeout=30)
                # ordinary first-cycle traffic bypasses the breaker;
                # re-asks against a failing master are admission-capped
                resp = guarded_attempt(m, call) if cycle else call()
            except (grpc.RpcError, ConnectionError, TimeoutError) as e:
                # rotate on EVERY RpcError (masterclient tryAllMasters
                # does not classify): a master mid-shutdown or
                # mid-election can surface UNKNOWN/CANCELLED, not just
                # UNAVAILABLE, and the cycle bound already caps retries —
                # exhaustion returns an AssignResult error, never raises
                glog.v(1, f"assign via {m} failed: {e}")
                last_err = e
                continue
            if resp.error:
                # follower redirect: "not the leader; ask host:port"
                leader = resp.error.rsplit("ask ", 1)[-1].strip() \
                    if "not the leader" in resp.error else ""
                if leader:
                    if leader not in seen:
                        queue.insert(0, leader)
                    elif not (isinstance(last_err, str)
                              and "not the leader" not in last_err):
                        # redirect back at a master that just failed
                        # this cycle — transient leader outage; record
                        # it ONLY if no more informative reply (a
                        # capacity/config error from the real leader)
                        # is already held, and let the next cycle
                        # re-ask after backoff
                        last_err = resp.error
                    continue
                if any(t in resp.error for t in _TRANSIENT_ASSIGN):
                    glog.v(1, f"assign via {m}: transient capacity "
                              f"error: {resp.error}")
                    last_err = resp.error
                    continue
                return AssignResult(error=resp.error)
            return AssignResult(
                fid=resp.fid, url=resp.location.url,
                public_url=resp.location.public_url, count=resp.count,
                auth=resp.auth,
                replicas=[l.url for l in resp.replicas],
            )
        queue = [m for m in masters]
        if cycle < cycles - 1:
            bo.sleep()
    if isinstance(last_err, str):
        # a master DID answer, definitively; don't misreport a capacity
        # condition as a connectivity problem
        return AssignResult(error=f"assign: {last_err} "
                                  f"(after {cycles} cycles)")
    return AssignResult(error=f"assign: no master reachable "
                              f"({masters}): {last_err}")


@dataclass
class UploadResult:
    name: str = ""
    size: int = 0
    etag: str = ""
    error: str = ""


def upload_data(url: str, data: bytes, *, filename: str = "",
                mime: str = "application/octet-stream", ttl: str = "",
                compress: bool = True, retries: int = 3,
                auth: str = "", session=None) -> UploadResult:
    """PUT needle bytes to a volume server (UploadData w/ retry,
    upload_content.go:85,134). Rides the wdclient keep-alive pool so
    upload legs reuse connections — and, under SWFS_HTTPS, amortize TLS
    handshakes — instead of dialing per upload. Pass a requests.Session to
    pin a specific keepalive session instead."""
    headers = trace.inject_headers(
        {"Content-Type": mime or "application/octet-stream"})
    if auth:
        headers["Authorization"] = f"Bearer {auth}"
    body = data
    if (compress and len(data) >= COMPRESS_MIN and _compressible(mime)):
        gz = gzip.compress(data, 3)
        if len(gz) < len(data) * 0.9:
            body = gz
            headers["Content-Encoding"] = "gzip"
    if ttl:
        url += ("&" if "?" in url else "?") + f"ttl={ttl}"
    last: Exception | None = None
    bo = Backoff(wait_init=0.1)
    for attempt in range(retries):
        try:
            with trace.span("client.upload", child_only=True,
                            bytes=len(body)), \
                    CLIENT_UPLOAD_SECONDS.time():
                if session is not None:
                    rr = session.put(url, data=body, headers=headers,
                                     timeout=60)
                    status, text, jload = rr.status_code, rr.text, rr.json
                else:
                    from ..wdclient import pool

                    rr = pool.put(url, body=body, headers=headers,
                                  timeout=60)
                    status, text, jload = rr.status, rr.text, rr.json
            # ordinary write replies stamp the volume server's live
            # backpressure score: feed it into the hot
            # signal so upload windows collapse BEFORE the first 429
            try:
                _p = (rr.headers or {}).get("X-Swfs-Pressure")
                if _p:
                    from ..qos.pressure import SIGNAL

                    SIGNAL.report_score(float(_p))
            except (TypeError, ValueError, AttributeError):
                pass
            if status < 300:
                j = jload()
                return UploadResult(name=j.get("name", filename),
                                    size=j.get("size", len(data)),
                                    etag=j.get("eTag", ""))
            last = IOError(f"{status}: {text[:200]}")
            if status in (429, 503):
                # a throttled upload leg marks the process hot: a
                # pipelined PUT window collapses to sequential instead
                # of fanning more load out
                from ..qos.pressure import SIGNAL

                SIGNAL.report_shed()
            if status < 500:
                break  # 4xx (bad request, auth) won't improve on retry
        except (OSError, requests.RequestException) as e:
            last = e
            from ..utils.retry import is_retryable

            if not is_retryable(e):
                break  # e.g. a certificate rejection: fail fast
        if attempt < retries - 1:
            bo.sleep()
    return UploadResult(error=str(last))


def _compressible(mime: str) -> bool:
    if mime.startswith("text/") or mime.endswith(("json", "xml", "javascript")):
        return True
    return mime in ("", "application/octet-stream")


def sync_stride_marker(stub, volume_id: int, collection: str, base: str,
                       ext: str = ".lrg", is_ec: bool = False) -> None:
    """Mirror the SOURCE's stride-marker file next to freshly copied
    volume/EC index bytes (volume copy, backup, EC shard copy).

    Raw-byte copies carry the source's offset width, so the local marker
    must reflect the source, not this process's mode — stamping local
    mode at a copy site would make the open-time stride guards
    (storage/volume.py, storage/ec_files.py check_ecx_stride) a
    tautology and let a cross-mode copy misparse silently."""
    import os

    import grpc

    from ..pb import volume_server_pb2 as vs

    try:
        for _ in stub.CopyFile(vs.CopyFileRequest(
                volume_id=volume_id, ext=ext, collection=collection,
                is_ec_volume=is_ec), timeout=60):
            pass
        with open(base + ext, "wb"):
            pass
    except grpc.RpcError as e:
        if e.code() != grpc.StatusCode.NOT_FOUND:
            raise
        try:
            os.remove(base + ext)
        except FileNotFoundError:
            pass


def delete_files(master: str, fids: list[str]) -> list[dict]:
    """Group fids by volume location and fan out BatchDelete RPCs
    (delete_content.go DeleteFilesAtOneVolumeServer)."""
    from ..pb import volume_server_pb2 as vs
    from ..wdclient import MasterClient

    mc = MasterClient(master)
    by_server: dict[str, list[str]] = {}
    results = []
    for fid in fids:
        try:
            urls = mc.lookup_file_id(fid)
        except LookupError as e:
            results.append({"fid": fid, "error": str(e)})
            continue
        server = urls[0].split("//", 1)[1].split("/", 1)[0]
        by_server.setdefault(server, []).append(fid)
    for server, server_fids in by_server.items():
        stub = rpc.volume_stub(rpc.grpc_address(server))
        resp = stub.BatchDelete(
            vs.BatchDeleteRequest(file_ids=server_fids), timeout=60)
        for res in resp.results:
            results.append({"fid": res.file_id, "size": res.size,
                            "error": res.error or None})
    return results


def submit(master: str, data: bytes, *, filename: str = "",
           collection: str = "", replication: str = "", ttl: str = "",
           mime: str = "") -> dict:
    """assign + upload in one call (SubmitFiles, submit.go:45)."""
    a = assign(master, collection=collection, replication=replication, ttl=ttl)
    if a.error:
        return {"error": a.error}
    from ..utils.http import url_for

    r = upload_data(url_for(a.url, a.fid), data, filename=filename,
                    mime=mime, ttl=ttl, auth=a.auth)
    if r.error:
        return {"error": r.error}
    return {"fid": a.fid, "url": a.url, "size": r.size, "eTag": r.etag}
