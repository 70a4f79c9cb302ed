"""The port's S3 gateway against the JAX package's, on the CPU.

The building blocks first, on seeded inputs: the SigV4 signer's headers
and presigned URLs, the verifier's canonical requests, signatures and
verdicts (V4 header, V4 presigned, V2 header and V2 presigned, tampered
and foreign-key requests among them), the bucket policy's decisions and
the circuit breaker's parse and admissions must be the reference's.

Then the running gateway. One script runs four times on the same
addresses, one run after the other: the reference's S3Server over the
reference's filer and cluster (a master and four volume servers in two
racks, numpy coder), the port's over the port's (RSCodecTorch on the
CPU), the port's gateway over the reference's filer and cluster, and the
reference's gateway over the port's. The script: identities set by the
shell's `s3.configure` and pushed through `SeaweedS3.Configure` (a bad
document refused), an unsigned request and a non-Admin identity refused;
bucket and object CRUD (SigV4 header auth); conditional, range and HEAD
reads; ListObjects v1 and v2 with prefix, delimiter and paging; a
multipart upload with an `UploadPartCopy` part, listed and completed;
`CopyObject` of a small object and of one above the gateway's 8 MiB
spool; multi-delete; tagging; presigned V4 and V2 reads, a V2 header
write and an `aws-chunked` body; a bucket policy that opens a bucket to
anonymous reads; the circuit breaker set and cleared by
`s3.circuitbreaker`; `s3.bucket.quota` and `.check`; `s3.clean.uploads`;
the `s3.bucket.*` commands; then `ec.encode` of the filer's collection,
the server holding the most shards stopped, and every object read back
through the gateway. Statuses, bodies, ETags, listed keys and the shell's
output must be equal in all four runs (tolerance 0). Every run pins the
needle, entry, filer, gateway and shell clocks of both packages to one
fake clock, the cookie source, the placement generator and the
gateways' uuid4 (upload ids) to fixed seeds, and turns the chunk pipeline
and the filer's chunk cache off; request ids and upload ids (uuid4, and
trace ids where a request is sampled) are compared after they are
replaced by their order of appearance, and nothing else is normalised.

Then: one S3 PUT billed once (at the gateway, not again at the filer);
`python -m seaweedfs_tpu_torch s3` and `server -filer -s3` as processes
without JAX; the CLI's `benchmark` against a port cluster, with the
reference's result keys and nothing failed."""

import argparse
import contextlib
import hashlib
import hmac
import io
import json
import os
import random
import re
import secrets
import signal
import socket
import subprocess
import sys
import time
import urllib.parse
import uuid

import grpc
import numpy as np
import pytest
import requests
import torch

from seaweedfs_tpu.command import benchmark as ref_benchmark
from seaweedfs_tpu.filer import chunk_pipeline as ref_chunk_pipeline
from seaweedfs_tpu.filer import entry as ref_entry
from seaweedfs_tpu.filer import filer as ref_filer_core
from seaweedfs_tpu.filer import meta_log as ref_meta_log
from seaweedfs_tpu.models.coder import new_coder as ref_new_coder
from seaweedfs_tpu.pb import rpc as ref_rpc
from seaweedfs_tpu.s3api import auth as ref_auth
from seaweedfs_tpu.s3api import circuit_breaker as ref_cb
from seaweedfs_tpu.s3api import policy as ref_policy
from seaweedfs_tpu.s3api import server as ref_s3_server
from seaweedfs_tpu.s3api import sigv4_client as ref_sigv4
from seaweedfs_tpu.server import filer as ref_filer_server
from seaweedfs_tpu.server.master import MasterServer as RefMaster
from seaweedfs_tpu.server.volume import VolumeServer as RefVolume
from seaweedfs_tpu.shell.commands import s3_mq as ref_shell_s3
from seaweedfs_tpu.shell.env import CommandEnv as RefEnv
from seaweedfs_tpu.shell.registry import run_command as ref_run_command
from seaweedfs_tpu.storage import needle as ref_needle
from seaweedfs_tpu.storage.ec_locate import Geometry as RefGeometry
from seaweedfs_tpu.utils import trace as ref_trace
from seaweedfs_tpu.wdclient import pool as ref_pool
from seaweedfs_tpu_torch import command
from seaweedfs_tpu_torch.command import benchmark
from seaweedfs_tpu_torch.filer import chunk_pipeline
from seaweedfs_tpu_torch.filer import entry as port_entry
from seaweedfs_tpu_torch.filer import filer as filer_core
from seaweedfs_tpu_torch.filer import meta_log
from seaweedfs_tpu_torch.iamapi import IAM_CONFIG_DIR, IAM_CONFIG_FILE
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
from seaweedfs_tpu_torch.pb import filer_pb2, rpc, s3_pb2
from seaweedfs_tpu_torch.s3api import auth, circuit_breaker, policy
from seaweedfs_tpu_torch.s3api import server as s3_server
from seaweedfs_tpu_torch.s3api import sigv4_client
from seaweedfs_tpu_torch.server import filer as filer_server
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell.commands import s3 as shell_s3
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.shell.registry import run_command
from seaweedfs_tpu_torch.storage import needle
from seaweedfs_tpu_torch.storage.ec_locate import Geometry
from seaweedfs_tpu_torch.utils import trace
from seaweedfs_tpu_torch.wdclient import pool
from tests import torch_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# EC blocks as in the filer tests: a 1 MiB chunk spans two small blocks
LARGE, SMALL = 64 * (1 << 20), 1 << 19
MIB = 1 << 20
PLACEMENT_SEED = 31
COOKIE_SEED = 32
UPLOAD_SEED = 33
RACKS = ("r0", "r0", "r1", "r1")
COLLECTION = "s3"
ADMIN = ("admin", "AKADMIN0000000000001", "SKADMIN-secret-0001")
READER = ("reader", "AKREADER000000000002", "SKREADER-secret-0002")
NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


# -- ports ---------------------------------------------------------------------

_PORTS = random.Random(os.getpid() + 41)
# the reference's default ports and their gRPC (+10000) and admin (+11000)
# twins
_RESERVED = {p + d for p in (8888, 9333, 8080, 8333)
             for d in (0, 10000, 11000)}


def _free_port_pair(taken=()) -> int:
    """A free HTTP port whose +10000 and +11000 twins are free too, all
    below the kernel's ephemeral range."""
    for _ in range(400):
        port = torch_ports.draw(_PORTS, 12000, 21000)
        if port in taken or {port, port + 10000, port + 11000} & _RESERVED:
            continue
        try:
            for p in (port, port + 10000):
                with socket.socket() as s:
                    s.bind(("", p))
        except OSError:
            continue
        return port
    raise RuntimeError("no free port pair")


def _ports() -> list[int]:
    out: list[int] = []
    for _ in range(7):  # the master, four volume servers, filer, gateway
        out.append(_free_port_pair(out))
    return out


PORTS = _ports()
FILER_PORT, S3_PORT = PORTS[5], PORTS[6]


# -- the building blocks -------------------------------------------------------


def _seeded_request(rng: random.Random, base: str) -> tuple:
    method = rng.choice(["GET", "PUT", "HEAD", "DELETE", "POST"])
    key = "/".join(rng.choice(["a", "b c", "d+e", "ü", "x%2Fy", "k.txt"])
                   for _ in range(rng.randrange(0, 4)))
    path = f"/bkt{rng.randrange(3)}" + (f"/{key}" if key else "")
    query = "&".join(rng.sample(["uploads", "partNumber=3", "uploadId=ab",
                                 "prefix=p/q", "list-type=2", "acl",
                                 "max-keys=7", "tagging"],
                                rng.randrange(0, 3)))
    body = rng.randbytes(rng.randrange(0, 200))
    url = base + urllib.parse.quote(path) + (f"?{query}" if query else "")
    return method, url, body


def _verdict(iam, method: str, url: str, headers: dict, payload_hash: str):
    u = urllib.parse.urlparse(url)
    try:
        ident = iam.authenticate(method, u.path, u.query, headers,
                                 payload_hash)
    except Exception as e:  # noqa: BLE001 - the verdict is the exception
        return (type(e).__name__, getattr(e, "code", ""))
    return None if ident is None else ident.name


@pytest.mark.parametrize("seed", range(6))
def test_signer_and_verifier_agree_with_the_reference(seed):
    """On seeded requests: the signer's V4 headers and presigned URLs are
    the reference signer's; the verifier's canonical request, signature
    and verdict are the reference verifier's, for good, tampered and
    foreign-key requests, by header, presigned and V2."""
    rng = random.Random(seed)
    base = "http://127.0.0.1:8333"
    ids = [("u0", "AK0", "SK0", ["Read"]), ("u1", "AK1", "SK1", [])]
    ref_iam = ref_auth.IdentityAccessManagement(
        [ref_auth.Identity(*i) for i in ids])
    port_iam = auth.IdentityAccessManagement([auth.Identity(*i) for i in ids])
    now = time.gmtime()
    for _ in range(12):
        method, url, body = _seeded_request(rng, base)
        ak, sk = rng.choice([("AK0", "SK0"), ("AK1", "SK1"),
                             ("AK1", "wrong"), ("AKX", "SKX")])
        h = sigv4_client.sign_request(method, url, body, ak, sk,
                                      amz_now=now)
        assert h == ref_sigv4.sign_request(method, url, body, ak, sk,
                                           amz_now=now)
        if rng.random() < 0.3:
            h["Authorization"] = h["Authorization"][:-1] + "0"
        phash = h["X-Amz-Content-Sha256"]
        assert _verdict(port_iam, method, url, h, phash) == \
            _verdict(ref_iam, method, url, h, phash)
        u = urllib.parse.urlparse(url)
        signed = ["host", "x-amz-content-sha256", "x-amz-date"]
        lower = {k.lower(): v for k, v in h.items()}
        assert auth._canonical_request(method, u.path, u.query, lower,
                                       signed, phash) == \
            ref_auth._canonical_request(method, u.path, u.query, lower,
                                        signed, phash)
        assert auth._signature(sk, h["X-Amz-Date"], h["X-Amz-Date"][:8],
                               "us-east-1", "s3", "creq") == \
            ref_auth._signature(sk, h["X-Amz-Date"], h["X-Amz-Date"][:8],
                                "us-east-1", "s3", "creq")
        expires = rng.choice([60, 3600, 700000])
        pre = sigv4_client.presign_url(method, url, ak, sk, amz_now=now,
                                       expires=expires)
        assert pre == ref_sigv4.presign_url(method, url, ak, sk,
                                            amz_now=now, expires=expires)
        assert _verdict(port_iam, method, pre, {}, "UNSIGNED-PAYLOAD") == \
            _verdict(ref_iam, method, pre, {}, "UNSIGNED-PAYLOAD")
        date = time.strftime("%a, %d %b %Y %H:%M:%S GMT", now)
        assert sigv4_client._v2_string_to_sign(
            method, u.path, u.query, date, "text/plain") == \
            ref_sigv4._v2_string_to_sign(method, u.path, u.query, date,
                                         "text/plain")
        v2 = {"Date": date, "Authorization": f"AWS {ak}:" +
              sigv4_client._v2_sign(sk, sigv4_client._v2_string_to_sign(
                  method, u.path, u.query, date))}
        assert _verdict(port_iam, method, url, v2, "UNSIGNED-PAYLOAD") == \
            _verdict(ref_iam, method, url, v2, "UNSIGNED-PAYLOAD")
        pre2 = sigv4_client.presign_url_v2(method, url, ak, sk,
                                           expires=rng.choice([-5, 600]))
        assert _verdict(port_iam, method, pre2, {}, "UNSIGNED-PAYLOAD") == \
            _verdict(ref_iam, method, pre2, {}, "UNSIGNED-PAYLOAD")


def _seeded_policy(rng: random.Random) -> dict:
    def principal():
        return rng.choice(["*", {"AWS": "*"}, {"AWS": ["AK0"]},
                           {"AWS": ["arn:aws:iam::1:user/AK1", "AK2"]}])

    stmts = []
    for _ in range(rng.randrange(1, 4)):
        stmts.append({
            "Effect": rng.choice(["Allow", "Deny"]),
            "Principal": principal(),
            "Action": rng.choice(["s3:*", "s3:GetObject", ["s3:PutObject",
                                  "s3:DeleteObject"], "s3:ListBucket",
                                  "s3:GetObjectTagging"]),
            "Resource": rng.choice(["arn:aws:s3:::b", "arn:aws:s3:::b/*",
                                    "arn:aws:s3:::b/p/*",
                                    ["arn:aws:s3:::b", "arn:aws:s3:::c/*"]]),
        })
    return {"Version": "2012-10-17", "Statement": stmts}


@pytest.mark.parametrize("seed", range(6))
def test_bucket_policies_decide_like_the_reference(seed):
    rng = random.Random(100 + seed)
    for _ in range(8):
        doc = json.dumps(_seeded_policy(rng)).encode()
        if rng.random() < 0.1:
            doc = doc[:-3]  # malformed
        try:
            want = ref_policy.BucketPolicy.parse(doc)
        except ref_policy.PolicyError:
            with pytest.raises(policy.PolicyError):
                policy.BucketPolicy.parse(doc)
            continue
        got = policy.BucketPolicy.parse(doc)
        assert got.to_bytes() == want.to_bytes()
        for _ in range(20):
            kw = dict(principal=rng.choice([None, "AK0", "AK1", "AK9"]),
                      action=rng.choice(["Read", "Write", "List", "Tagging",
                                         "Admin", "ReadAcp"]),
                      bucket=rng.choice(["b", "c"]),
                      key=rng.choice(["", "k", "p/k", "q/r"]))
            assert got.decide(**kw) == want.decide(**kw), kw


def _seeded_breaker(rng: random.Random) -> dict:
    def actions():
        return {f"{a}:{t}": rng.randrange(0, 4)
                for a in rng.sample(["Read", "Write", "List", "Admin"],
                                    rng.randrange(0, 3))
                for t in rng.sample(["Count", "MB"], rng.randrange(1, 3))}

    return {"global": {"enabled": rng.random() < 0.7, "actions": actions()},
            "buckets": {b: {"enabled": rng.random() < 0.7,
                            "actions": actions()}
                        for b in rng.sample(["b", "c", "d"],
                                            rng.randrange(0, 3))}}


def _admissions(mod, conf: dict, rng: random.Random) -> list:
    cb = mod.CircuitBreaker(conf)
    held, out = [], []
    for _ in range(30):
        if held and rng.random() < 0.3:
            held.pop(rng.randrange(len(held)))()
            out.append("release")
            continue
        args = (rng.choice(["Read", "Write", "List"]), rng.choice("bcd"),
                rng.choice([0, 1000, 3 * MIB]))
        try:
            held.append(cb.acquire(*args))
            out.append((args, "ok"))
        except mod.TooManyRequests as e:
            out.append((args, str(e)))
    return [cb.to_config(), cb.enabled] + out


@pytest.mark.parametrize("seed", range(6))
def test_circuit_breakers_parse_and_admit_like_the_reference(seed):
    rng = random.Random(200 + seed)
    for _ in range(6):
        conf = _seeded_breaker(rng)
        s = rng.randrange(1 << 30)
        assert _admissions(circuit_breaker, conf, random.Random(s)) == \
            _admissions(ref_cb, conf, random.Random(s))


# -- the running gateway -------------------------------------------------------


class Clock:
    """A stand-in for the `time` module the needle, entry, filer, gateway
    and shell modules read: every call moves it on by one microsecond,
    and `advance` jumps it (the gateway reloads its breaker config every
    10 s of this clock; s3.clean.uploads compares ages on it)."""

    def __init__(self):
        self.ns = 1_700_000_000_000_000_000

    def advance(self, seconds: float) -> None:
        self.ns += int(seconds * 1e9)

    def time_ns(self) -> int:
        self.ns += 1000
        return self.ns

    def time(self) -> float:
        return self.time_ns() / 1e9

    def perf_counter(self) -> float:
        return time.perf_counter()

    def monotonic(self) -> float:
        return time.monotonic()

    def strftime(self, *a):
        return time.strftime(*a)

    def gmtime(self, *a):
        return time.gmtime(*a)

    def sleep(self, s):
        time.sleep(s)


REF = dict(Master=RefMaster, master_kw={}, Volume=RefVolume,
           Filer=ref_filer_server.FilerServer, S3=ref_s3_server.S3Server,
           Env=RefEnv, run_command=ref_run_command, Geometry=RefGeometry,
           coder=lambda: ref_new_coder(10, 4, "cpu"))
PORT = dict(Master=MasterServer,
            master_kw=dict(placement_seed=PLACEMENT_SEED),
            Volume=VolumeServer, Filer=filer_server.FilerServer,
            S3=s3_server.S3Server, Env=CommandEnv, run_command=run_command,
            Geometry=Geometry,
            coder=lambda: RSCodecTorch(10, 4, device="cpu"))
PKGS = {"ref": REF, "port": PORT}
# (cluster and filer package, gateway and shell package) of each run
RUNS = {"ref": ("ref", "ref"), "port": ("port", "port"),
        "port-s3-on-ref": ("ref", "port"),
        "ref-s3-on-port": ("port", "ref")}
OTHERS = ("port", "port-s3-on-ref", "ref-s3-on-port")


def _objects() -> dict:
    """key -> bytes: small objects under three prefixes, a 2.5 MiB one
    (three filer chunks) and one above the gateway's 8 MiB spool."""
    rng = np.random.default_rng(51)

    def blob(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    out = {}
    for i in range(14):
        prefix = ("logs/2024/", "logs/2025/", "img/")[i % 3]
        out[f"{prefix}o{i:02d}.bin"] = blob(int(rng.integers(10, 5000)))
    out["top.txt"] = b"top level object\n"
    out["big/b.bin"] = blob(int(2.5 * MIB) + 11)
    out["big/spool.bin"] = blob(8 * MIB + 4099)
    return out


OBJECTS = _objects()
PART_A = np.random.default_rng(52).integers(
    0, 256, 700_001, dtype=np.uint8).tobytes()
# incompressible: a part's chunk ETag (what a multipart object's ETag is
# made of) is the CRC of the stored needle, and the client gzips a
# compressible chunk with the wall clock in its header
PART_C = np.random.default_rng(53).integers(
    0, 256, 1400, dtype=np.uint8).tobytes()


def _reset_clients() -> None:
    for mod in (rpc, ref_rpc):
        mod.reset_channels()
    for mod in (pool, ref_pool):
        mod.POOL.clear()


class _Cluster:
    """One package's master and four volume servers on PORTS."""

    def __init__(self, mods, root: str):
        self.mods = mods
        self.root = root
        self.master = mods["Master"](ip="127.0.0.1", port=PORTS[0],
                                     volume_size_limit_mb=64,
                                     **mods["master_kw"])
        self.master.start(vacuum_interval=3600)
        self.servers = {}
        for i, rack in enumerate(RACKS):
            d = os.path.join(root, f"v{i}")
            os.mkdir(d)
            srv = mods["Volume"](
                directories=[d], master=self.master.address, ip="127.0.0.1",
                port=PORTS[1 + i], rack=rack, pulse_seconds=1,
                coder=mods["coder"](),
                ec_geometry=mods["Geometry"](large_block=LARGE,
                                             small_block=SMALL))
            srv.start()
            self.servers[srv.address] = srv
            self.settle()

    def stop(self, address: str) -> None:
        srv = self.servers.pop(address)
        srv.stop()
        srv._http_server.server_close()
        srv._grpc_server.stop(None).wait(10)
        self.settle()

    def close(self) -> None:
        for address in list(self.servers):
            self.stop(address)
        self.master.stop()
        self.master._http_server.server_close()
        self.master._grpc_server.stop(None).wait(10)

    def settle(self, timeout: float = 30.0) -> None:
        deadline = time.time() + timeout
        while True:
            for srv in self.servers.values():
                srv.trigger_heartbeat()
            want = {}
            for addr, srv in self.servers.items():
                hb = srv.store.collect_heartbeat()
                want[addr] = (
                    sorted((v.id, v.size, v.file_count, v.read_only)
                           for v in hb.volumes),
                    sorted((e.id, e.ec_index_bits) for e in hb.ec_shards))
            topo = self.master.topo
            with topo._lock:
                got = {url: (
                    sorted((v.id, v.size, v.file_count, v.read_only)
                           for v in dn.volumes.values()),
                    sorted((e.volume_id, e.bits)
                           for e in dn.ec_shards.values()))
                    for url, dn in topo.nodes.items()}
            if got == want:
                return
            assert time.time() < deadline, (got, want)
            time.sleep(0.05)

    def shard_counts(self) -> dict:
        return {a: sum(len(ev.shard_files) for loc in s.store.locations
                       for ev in loc.ec_volumes.values())
                for a, s in self.servers.items()}


class _SeededUuid:
    """A stand-in for the `uuid` module the gateways read."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed)

    def uuid4(self) -> uuid.UUID:
        return uuid.UUID(int=self._rng.getrandbits(128), version=4)


class _Ids:
    """Replaces each request id and upload id by its order of appearance
    in one run (uuid4 hex ids, and trace ids where a request is
    sampled); nothing else."""

    ID = re.compile(rb"(?<![0-9a-f])([0-9a-f]{32}|[0-9a-f]{16})(?![0-9a-f])")

    def __init__(self):
        self.seen: dict[bytes, bytes] = {}

    def __call__(self, text: bytes) -> bytes:
        def sub(m):
            k = m.group(1)
            if k not in self.seen:
                self.seen[k] = b"<id%d>" % len(self.seen)
            return self.seen[k]

        return self.ID.sub(sub, text)


_HEADERS = ("ETag", "Content-Range", "Content-Length", "Last-Modified",
            "Content-Type", "Location", "Retry-After")


class _Client:
    """The script's S3 client: SigV4 by header (the port's signer) unless
    told otherwise, one connection per request (the reference's gateway
    checks a keep-alive connection's later requests against the first
    body it read: test_a_keep_alive_connection_carries_each_body);
    -> every answer normalised by one run's _Ids."""

    def __init__(self, base: str, ids: _Ids):
        self.base = base
        self.ids = ids

    def request(self, method: str, url: str, **kw):
        with requests.Session() as http:
            http.trust_env = False
            return http.request(method, url, timeout=120, **kw)

    def upload_id(self) -> str:
        """The UploadId of the last answer, as the gateway sent it."""
        return re.search(rb"<UploadId>([^<]*)<",
                         self.last.content).group(1).decode()

    def answer(self, r) -> tuple:
        self.last = r
        body = r.content
        if len(body) > 512 and not body.startswith(b"<?xml"):
            body = hashlib.sha256(body).hexdigest().encode()
        else:
            body = self.ids(body)
        headers = {h: r.headers[h] for h in _HEADERS if h in r.headers}
        return r.status_code, body, headers

    def call(self, method: str, path: str, body: bytes = b"", *,
             ident=ADMIN, headers=None, signed: bool = True) -> tuple:
        url = self.base + path
        h = dict(headers or {})
        if signed and ident is not None:
            h.update(sigv4_client.sign_request(method, url, body, ident[1],
                                               ident[2]))
        return self.answer(self.request(method, url, data=body, headers=h))

    def url(self, url: str, method: str = "GET") -> tuple:
        return self.answer(self.request(method, url))


def _sign_streaming(method: str, url: str, access: str, secret: str,
                    length: int) -> dict:
    """SigV4 headers of an aws-chunked upload: the claimed payload hash
    is STREAMING-AWS4-HMAC-SHA256-PAYLOAD, signed as such."""
    u = urllib.parse.urlparse(url)
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    date = amz_date[:8]
    phash = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
    headers = {"host": u.netloc, "x-amz-date": amz_date,
               "x-amz-content-sha256": phash,
               "x-amz-decoded-content-length": str(length)}
    signed = sorted(headers)
    creq = "\n".join([
        method, urllib.parse.quote(urllib.parse.unquote(u.path),
                                   safe="/-_.~"), "",
        "".join(f"{k}:{headers[k]}\n" for k in signed),
        ";".join(signed), phash])
    scope = f"{date}/us-east-1/s3/aws4_request"
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     hashlib.sha256(creq.encode()).hexdigest()])
    k = hmac.new(("AWS4" + secret).encode(), date.encode(),
                 hashlib.sha256).digest()
    for part in ("us-east-1", "s3", "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    sig = hmac.new(k, sts.encode(), hashlib.sha256).hexdigest()
    headers["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return headers


def _aws_chunked(data: bytes, piece: int) -> bytes:
    out = b""
    for off in range(0, len(data), piece):
        p = data[off:off + piece]
        out += b"%x;chunk-signature=%s\r\n" % (len(p), b"0" * 64) + p + b"\r\n"
    return out + b"0;chunk-signature=" + b"0" * 64 + b"\r\n\r\n"


def _sh(mods, env, line: str, ids: _Ids) -> bytes:
    out = io.StringIO()
    code = mods["run_command"](env, line, out)
    text = "\n".join(x for x in out.getvalue().splitlines()
                     if not x.startswith("trace "))
    assert code == 0, f"{line!r} failed:\n{text}"
    return ids(re.sub(r"overlap ratio \d+\.\d+", "overlap ratio <measured>",
                      text).encode())


def _keys(answer: tuple) -> list:
    return [k.decode() for k in re.findall(rb"<Key>([^<]*)</Key>",
                                           answer[1])]


def _script(stack_pkg: str, gw_pkg: str, root: str) -> dict:
    """The S3 traffic through a gateway of one package over a filer and
    cluster of one package; -> every observable, for comparison."""
    sm, gm = PKGS[stack_pkg], PKGS[gw_pkg]
    out: dict = {}
    ids = _Ids()
    with pytest.MonkeyPatch.context() as mp:
        clock = Clock()
        for mod in (ref_needle, needle, ref_entry, port_entry,
                    ref_filer_core, filer_core, ref_filer_server,
                    filer_server, ref_s3_server, s3_server, ref_shell_s3,
                    shell_s3):
            mp.setattr(mod, "time", clock)
        mp.setattr(secrets, "randbits", random.Random(COOKIE_SEED).getrandbits)
        for mod in (ref_trace, trace):
            mp.setattr(mod, "random", random.Random(0))
        # upload ids name the staging directories, so they set the order
        # of ListMultipartUploads: both gateways draw them from one seed
        uuids = _SeededUuid(UPLOAD_SEED)
        for mod in (ref_s3_server, s3_server):
            mp.setattr(mod, "uuid", uuids)
        for mod in (ref_meta_log, meta_log):
            mp.setattr(mod.MetaLog, "_flush_loop",
                       lambda self: self._stop.wait())
        mp.setenv("SWFS_CHUNK_PIPELINE", "0")
        mp.setenv("SWFS_FILER_CACHE_MB", "0")
        for mod in (chunk_pipeline, ref_chunk_pipeline):
            mod.refresh_config()
        random.seed(PLACEMENT_SEED)
        c = _Cluster(sm, root)
        fs = gw = None
        cl = _Client(f"http://127.0.0.1:{S3_PORT}", ids)
        try:
            fs = sm["Filer"](ip="127.0.0.1", port=FILER_PORT,
                             master=c.master.address, collection=COLLECTION,
                             store_dir=os.path.join(root, "filer"),
                             chunk_size=MIB)
            fs.start()
            filer = f"127.0.0.1:{FILER_PORT}"
            gw = gm["S3"](port=S3_PORT, filer=filer)
            gw.start()
            env = gm["Env"](c.master.address, filer=filer)

            def sh(line):
                return _sh(gm, env, line, ids)

            # identities: s3.configure writes them to the filer, the
            # gateway takes them through SeaweedS3.Configure
            out["configure"] = [sh(
                f"s3.configure -user={name} -access_key={ak} "
                f"-secret_key={sk} -actions={acts} -apply") for
                (name, ak, sk), acts in ((ADMIN, "Admin,Read,Write,List,"
                                                 "Tagging"),
                                         (READER, "Read,List"))]
            out["configure_list"] = sh("s3.configure")
            doc = rpc.filer_stub(rpc.grpc_address(filer)).LookupDirectoryEntry(
                filer_pb2.LookupDirectoryEntryRequest(
                    directory=IAM_CONFIG_DIR, name=IAM_CONFIG_FILE),
                timeout=10).entry.content
            stub = rpc.s3_stub(rpc.grpc_address(f"127.0.0.1:{S3_PORT}"))
            try:
                stub.Configure(s3_pb2.S3ConfigureRequest(
                    s3_configuration_file_content=b"{not json"), timeout=10)
                out["configure_bad"] = "accepted"
            except grpc.RpcError as e:
                out["configure_bad"] = e.code().name
            stub.Configure(s3_pb2.S3ConfigureRequest(
                s3_configuration_file_content=doc), timeout=10)

            out["refused"] = [
                cl.call("PUT", "/b1", signed=False),
                cl.call("PUT", "/b1", ident=READER),
                cl.call("GET", "/status", ident=READER),
                cl.call("GET", "/status", signed=False),
                cl.call("GET", "/", ident=("x", "AKNOBODY", "SK"))]
            out["admin_status"] = cl.call("GET", "/status")[0]

            out["buckets"] = [
                cl.call("PUT", "/b1"), cl.call("PUT", "/b1"),
                cl.call("HEAD", "/b1"), cl.call("HEAD", "/nope"),
                cl.call("PUT", "/pub"), cl.call("PUT", "/cb"),
                cl.call("PUT", "/q"), cl.call("GET", "/")]
            out["put"] = [cl.call("PUT", f"/b1/{k}", v,
                                  headers={"Content-Type": "text/plain"}
                                  if k.endswith(".txt") else None)
                          for k, v in OBJECTS.items()]
            out["get"] = [cl.call("GET", f"/b1/{k}") for k in OBJECTS]
            big = "/b1/big/b.bin"
            etag = cl.call("HEAD", big)[2]["ETag"]
            out["reads"] = [
                cl.call("HEAD", big),
                cl.call("GET", big, headers={"If-None-Match": etag}),
                cl.call("GET", big, headers={
                    "Range": f"bytes={MIB - 100}-{2 * MIB + 99}"}),
                cl.call("GET", big, headers={"Range": "bytes=-4097"}),
                cl.call("GET", big, headers={"Range": f"bytes={9 * MIB}-"}),
                cl.call("GET", "/b1/missing"),
                cl.call("GET", "/nope/x")]

            lists = []
            for q in ("", "prefix=logs/", "prefix=logs/&delimiter=/",
                      "delimiter=/", "prefix=logs/2024/&max-keys=2",
                      "marker=logs/2024/o03.bin&max-keys=4",
                      "list-type=2&prefix=logs/2025/&max-keys=2",
                      "list-type=2&start-after=img/o05.bin&max-keys=4",
                      "list-type=2&delimiter=/&prefix=img/"):
                lists.append(cl.call("GET", f"/b1?{q}"))
            # pages of 5 keys: a page that ends on a directory's last key
            # is where the reference loses its place (the fault that
            # test_a_page_ending_a_directory_keeps_its_place pins)
            pages, token = [], ""
            while True:
                q = "list-type=2&max-keys=5" + (
                    f"&continuation-token={urllib.parse.quote(token)}"
                    if token else "")
                a = cl.call("GET", f"/b1?{q}")
                pages.append(a)
                m = re.search(rb"<NextContinuationToken>([^<]*)<", a[1])
                if not m:
                    break
                token = m.group(1).decode()
            out["lists"] = lists
            out["pages"] = pages
            out["paged_keys"] = [k for p in pages for k in _keys(p)]

            # multipart: a part, an UploadPartCopy part, a last part
            init = cl.call("POST", "/b1/mp/assembled.bin?uploads")
            up = cl.upload_id()
            second = cl.call("POST", "/b1/mp/second.bin?uploads")
            uid = cl.upload_id()
            mp_path = "/b1/mp/assembled.bin"
            out["multipart"] = [
                init,
                cl.call("PUT", f"{mp_path}?partNumber=1&uploadId={up}",
                        PART_A),
                cl.call("PUT", f"{mp_path}?partNumber=2&uploadId={up}",
                        headers={"x-amz-copy-source": "/b1/big/spool.bin",
                                 "x-amz-copy-source-range":
                                     f"bytes=100-{100 + 8 * MIB + 17}"}),
                cl.call("PUT", f"{mp_path}?partNumber=3&uploadId={up}",
                        headers={"x-amz-copy-source": "/b1/big/spool.bin",
                                 "x-amz-copy-source-range":
                                     "bytes=99999999-100000000"}),
                cl.call("PUT", f"{mp_path}?partNumber=3&uploadId={up}",
                        PART_C),
                cl.call("GET", f"{mp_path}?uploadId={up}"),
                cl.call("GET", "/b1?uploads"),
                cl.call("POST", f"{mp_path}?uploadId={up}"),
                second,
                cl.call("DELETE", f"/b1/mp/second.bin?uploadId={uid}"),
                cl.call("GET", "/b1?uploads"),
                cl.call("HEAD", mp_path),
                cl.call("GET", mp_path),
                cl.call("GET", mp_path, headers={
                    "Range": f"bytes={len(PART_A) - 10}-{len(PART_A) + 9}"}),
                cl.call("PUT", "/b1/mp/x?partNumber=1&uploadId=nope",
                        b"x")]

            out["copy"] = [
                cl.call("PUT", "/b1/copies/top.txt",
                        headers={"x-amz-copy-source": "/b1/top.txt"}),
                cl.call("PUT", "/b1/copies/spool.bin",
                        headers={"x-amz-copy-source":
                                 "/b1/big/spool.bin?versionId=1"}),
                cl.call("GET", "/b1/copies/top.txt"),
                cl.call("GET", "/b1/copies/spool.bin"),
                cl.call("PUT", "/b1/copies/none",
                        headers={"x-amz-copy-source": "/b1/absent"})]

            delete = (b'<?xml version="1.0" encoding="UTF-8"?><Delete '
                      b'xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
                      + b"".join(b"<Object><Key>%s</Key></Object>" % k
                                 for k in (b"img/o02.bin", b"img/o05.bin",
                                           b"never/was.bin"))
                      + b"</Delete>")
            out["multi_delete"] = [cl.call("POST", "/b1?delete", delete),
                                   cl.call("GET", "/b1?prefix=img/")]

            tags = (b'<Tagging><TagSet><Tag><Key>team</Key><Value>ec'
                    b'</Value></Tag><Tag><Key>tier</Key><Value>hot</Value>'
                    b'</Tag></TagSet></Tagging>')
            out["tagging"] = [
                cl.call("PUT", "/b1/top.txt?tagging", tags),
                cl.call("GET", "/b1/top.txt?tagging"),
                cl.call("GET", "/b1/top.txt?tagging", ident=READER),
                cl.call("PUT", "/b1/top.txt?tagging", tags, ident=READER),
                cl.call("DELETE", "/b1/top.txt?tagging"),
                cl.call("GET", "/b1/top.txt?tagging"),
                cl.call("GET", "/b1/nope?tagging")]

            small = "/b1/logs/2024/o00.bin"
            pre = sigv4_client.presign_url("GET", cl.base + small,
                                           ADMIN[1], ADMIN[2])
            pre2 = sigv4_client.presign_url_v2("GET", cl.base + small,
                                               READER[1], READER[2])
            v2 = sigv4_client.sign_request_v2("PUT", cl.base + "/b1/v2.txt",
                                              ADMIN[1], ADMIN[2])
            chunked_body = OBJECTS["img/o08.bin"] * 9
            wire = _aws_chunked(chunked_body, 8192)
            ch = _sign_streaming("PUT", cl.base + "/b1/chunked.bin",
                                 ADMIN[1], ADMIN[2], len(chunked_body))
            ch["Content-Length"] = str(len(wire))
            out["auth_forms"] = [
                cl.url(pre),
                cl.url(pre.replace("X-Amz-Signature=",
                                   "X-Amz-Signature=0")),
                cl.url(pre2),
                cl.answer(cl.request("PUT", cl.base + "/b1/v2.txt",
                                     data=b"signed by v2", headers=v2)),
                cl.call("GET", "/b1/v2.txt"),
                cl.answer(cl.request("PUT", cl.base + "/b1/chunked.bin",
                                     data=wire, headers=ch)),
                cl.call("GET", "/b1/chunked.bin")]

            pol = json.dumps({"Version": "2012-10-17", "Statement": [
                {"Effect": "Allow", "Principal": "*",
                 "Action": ["s3:GetObject"],
                 "Resource": "arn:aws:s3:::pub/*"},
                {"Effect": "Deny", "Principal": {"AWS": [READER[1]]},
                 "Action": "s3:GetObject",
                 "Resource": "arn:aws:s3:::pub/*"}]}).encode()
            out["policy"] = [
                cl.call("PUT", "/pub/doc.txt", b"public document\n"),
                cl.call("GET", "/pub/doc.txt", signed=False),
                cl.call("GET", "/pub?policy"),
                cl.call("PUT", "/pub?policy", pol),
                cl.call("PUT", "/pub?policy", b"{bad"),
                cl.call("GET", "/pub?policy"),
                cl.call("GET", "/pub/doc.txt", signed=False),
                cl.call("PUT", "/pub/anon.txt", b"x", signed=False),
                cl.call("GET", "/pub/doc.txt", ident=READER),
                cl.call("DELETE", "/pub?policy"),
                cl.call("GET", "/pub/doc.txt", signed=False)]

            out["breaker"] = [
                sh("s3.circuitbreaker -global -enable -apply"),
                sh("s3.circuitbreaker -buckets=cb -enable "
                   "-actions=Write:Count=0 -apply")]
            clock.advance(11)  # the gateway's reload interval
            out["breaker"] += [
                cl.call("PUT", "/cb/x.txt", b"blocked"),
                cl.call("PUT", "/b1/through.txt", b"other bucket"),
                sh("s3.circuitbreaker -delete -apply")]
            clock.advance(11)
            out["breaker"] += [cl.call("PUT", "/cb/x.txt", b"open again")]

            out["quota"] = [
                sh("s3.bucket.quota -name=q -sizeMB=1"),
                cl.call("PUT", "/q/fill.bin", OBJECTS["big/b.bin"][:MIB + 5]),
                sh("s3.bucket.quota.check"),
                sh("s3.bucket.quota.check -apply"),
                cl.call("PUT", "/q/more.bin", b"no room"),
                cl.call("GET", "/q/fill.bin"),
                sh("s3.bucket.quota -name=q -disable"),
                sh("s3.bucket.quota.check -apply"),
                cl.call("PUT", "/q/more.bin", b"room again")]

            stale = cl.call("POST", "/q/stale.bin?uploads")
            clock.advance(7200)
            out["clean"] = [stale, cl.call("GET", "/q?uploads"),
                            sh("s3.clean.uploads -timeAgo=1h"),
                            cl.call("GET", "/q?uploads"),
                            sh("s3.clean.uploads")]

            out["bucket_cmds"] = [sh("s3.bucket.create -name=made"),
                                  sh("s3.bucket.list"),
                                  cl.call("HEAD", "/made"),
                                  sh("s3.bucket.delete -name=made"),
                                  sh("s3.bucket.list"),
                                  cl.call("HEAD", "/made")]
            out["deletes"] = [cl.call("DELETE", "/b1/logs/2025/o01.bin"),
                              cl.call("GET", "/b1/logs/2025/o01.bin"),
                              cl.call("DELETE", "/q/more.bin"),
                              cl.call("GET", "/b1?list-type=2")]

            # every object, once its volumes are erasure-coded and the
            # server holding the most shards is gone
            c.settle()
            fsh = PKGS[stack_pkg]
            fenv = fsh["Env"](c.master.address, filer=filer)
            out["encode"] = [_sh(fsh, fenv, line, ids) for line in (
                "lock", f"ec.encode -collection {COLLECTION} -fullPercent 1 "
                "-parallelEncode 1", "unlock")]
            c.settle()
            counts = c.shard_counts()
            victim = max(sorted(counts), key=lambda a: counts[a])
            out["victim"] = (victim, counts[victim])
            c.stop(victim)
            live = [k for k in OBJECTS if k not in (
                "img/o02.bin", "img/o05.bin", "logs/2025/o01.bin")]
            out["degraded"] = [cl.call("GET", f"/b1/{k}") for k in live] + [
                cl.call("GET", "/b1/mp/assembled.bin"),
                cl.call("GET", "/b1/copies/spool.bin"),
                cl.call("GET", "/b1/mp/assembled.bin", headers={
                    "Range": f"bytes={len(PART_A) - 10}-"
                             f"{len(PART_A) + 9}"})]
        finally:
            for srv in (gw, fs):
                if srv is not None:
                    srv.stop()
                    srv._http_server.server_close()
                    srv._grpc_server.stop(None).wait(10)
            c.close()
            _reset_clients()
    return out


_DONE: dict = {}


def _run(name: str, tmp_path_factory) -> dict:
    if name not in _DONE:
        stack_pkg, gw_pkg = RUNS[name]
        root = str(tmp_path_factory.mktemp(f"s3-{name}"))
        _DONE[name] = _script(stack_pkg, gw_pkg, root)
    return _DONE[name]


@pytest.fixture(autouse=True)
def _global_random_restored():
    state = random.getstate()
    yield
    random.setstate(state)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return _run("ref", tmp_path_factory)


@pytest.fixture(scope="module", params=OTHERS)
def other(request, tmp_path_factory):
    return request.param, _run(request.param, tmp_path_factory)


def _want(data: bytes) -> bytes:
    return (hashlib.sha256(data).hexdigest().encode() if len(data) > 512
            else data)


def test_the_reference_run_takes_the_gateways_path(ref):
    """The script does what it says on the reference: these are the
    answers every other run is then held to."""
    assert ref["configure_bad"] == "INVALID_ARGUMENT"
    assert [a[0] for a in ref["refused"]] == [403, 403, 403, 403, 403]
    assert ref["admin_status"] == 200
    assert [a[0] for a in ref["buckets"]] == [200, 200, 200, 404, 200, 200,
                                              200, 200]
    for (status, _b, headers), data in zip(ref["put"], OBJECTS.values()):
        assert status == 200
        assert headers["ETag"] == f'"{hashlib.md5(data).hexdigest()}"'
    for (status, body, headers), data in zip(ref["get"], OBJECTS.values()):
        assert status == 200 and body == _want(data)
        assert headers["ETag"] == f'"{hashlib.md5(data).hexdigest()}"'
    assert [a[0] for a in ref["reads"]] == [200, 304, 206, 206, 416, 404, 404]
    assert ref["paged_keys"] == sorted(OBJECTS)
    assert [a[0] for a in ref["multipart"]] == [
        200, 200, 200, 400, 200, 200, 200, 200, 200, 204, 200, 200, 200,
        206, 404]
    assembled = PART_A + OBJECTS["big/spool.bin"][100:100 + 8 * MIB + 18] \
        + PART_C
    assert ref["multipart"][12][1] == _want(assembled)
    n = len(PART_A)
    assert ref["multipart"][13][1] == assembled[n - 10:n + 10]
    assert [a[0] for a in ref["copy"]] == [200, 200, 200, 200, 404]
    assert ref["copy"][3][1] == _want(OBJECTS["big/spool.bin"])
    assert b"<Deleted><Key>img/o02.bin" in ref["multi_delete"][0][1]
    assert [a[0] for a in ref["tagging"]] == [200, 200, 200, 403, 204, 200,
                                              404]
    assert [a[0] for a in ref["auth_forms"]] == [200, 403, 200, 200, 200,
                                                 200, 200]
    assert ref["auth_forms"][6][1] == _want(OBJECTS["img/o08.bin"] * 9)
    assert [a[0] for a in ref["policy"]] == [200, 403, 404, 204, 400, 200,
                                             200, 403, 403, 204, 403]
    assert [a[0] for a in ref["breaker"][2:4]] == [503, 200]
    assert b"SlowDown" in ref["breaker"][2][1]
    assert ref["breaker"][5][0] == 200
    assert [a[0] for a in ref["quota"][1::1] if isinstance(a, tuple)] == \
        [200, 403, 200, 200]
    assert b"read-only" in ref["quota"][3]
    assert b"aborted upload" in ref["clean"][2]
    assert [a[0] for a in ref["bucket_cmds"] if isinstance(a, tuple)] == \
        [200, 404]
    assert ref["victim"][1] == 4
    assert all(a[0] in (200, 206) for a in ref["degraded"])


KEYS = ("configure", "configure_list", "configure_bad", "refused",
        "admin_status", "buckets", "put", "get", "reads", "lists", "pages",
        "paged_keys", "multipart", "copy", "multi_delete", "tagging",
        "auth_forms", "policy", "breaker", "quota", "clean", "bucket_cmds",
        "deletes", "encode", "victim", "degraded")


@pytest.mark.parametrize("key", KEYS)
def test_runs_are_byte_identical_to_the_reference(ref, other, key):
    name, run = other
    assert run[key] == ref[key], f"{name}: {key}"


def test_the_ports_gateway_serves_every_object_with_a_server_lost(
        tmp_path_factory):
    """On the port's own stack, after ec.encode and the loss of four
    shards, every object comes back byte-identical (the lost chunks
    reconstructed by the volume servers' CPU coder)."""
    run = _run("port", tmp_path_factory)
    assert run["victim"][1] == 4
    live = [k for k in OBJECTS if k not in (
        "img/o02.bin", "img/o05.bin", "logs/2025/o01.bin")]
    for (status, body, headers), k in zip(run["degraded"], live):
        assert status == 200 and body == _want(OBJECTS[k]), k
        assert headers["ETag"] == \
            f'"{hashlib.md5(OBJECTS[k]).hexdigest()}"', k


# -- two faults the port fixed -------------------------------------------------


@contextlib.contextmanager
def _one_server_stack(mods, root: str, identities=None):
    """A master, one volume server, a filer and a gateway of one
    package -> the gateway's base URL."""
    master = mods["Master"](ip="127.0.0.1", port=PORTS[0],
                            volume_size_limit_mb=64, **mods["master_kw"])
    master.start(vacuum_interval=3600)
    vol = mods["Volume"](directories=[root], master=master.address,
                         ip="127.0.0.1", port=PORTS[1], pulse_seconds=1,
                         coder=mods["coder"]())
    vol.start()
    fs = mods["Filer"](ip="127.0.0.1", port=FILER_PORT,
                       master=master.address,
                       store_dir=os.path.join(root, "filer"))
    fs.start()
    gw = mods["S3"](port=S3_PORT, filer=f"127.0.0.1:{FILER_PORT}",
                    identities=identities)
    gw.start()
    try:
        deadline = time.time() + 30
        while not master.topo.nodes:
            assert time.time() < deadline
            time.sleep(0.05)
        yield f"http://127.0.0.1:{S3_PORT}"
    finally:
        for srv in (gw, fs, vol, master):
            srv.stop()
            srv._http_server.server_close()
            srv._grpc_server.stop(None).wait(10)
        _reset_clients()


def _keep_alive_puts(mods, root: str) -> list:
    ident = (mods is REF and ref_auth or auth).Identity(*ADMIN)
    with _one_server_stack(mods, root, [ident]) as base:
        http = requests.Session()  # one keep-alive connection
        http.trust_env = False
        out = []
        for path, body in (("/ka", b""), ("/ka/one.bin", b"first body"),
                           ("/ka/two.bin", b"the second body")):
            h = sigv4_client.sign_request("PUT", base + path, body, ADMIN[1],
                                          ADMIN[2])
            r = http.put(base + path, data=body, headers=h, timeout=60)
            out.append((r.status_code, re.sub(rb"<RequestId>.*</RequestId>",
                                              b"", r.content)))
        h = sigv4_client.sign_request("GET", base + "/ka/two.bin", b"",
                                      ADMIN[1], ADMIN[2])
        out.append(http.get(base + "/ka/two.bin", headers=h,
                            timeout=60).content)
        http.close()
    return out


def test_a_keep_alive_connection_carries_each_body(tmp_path):
    """Signed PUTs one after another on one keep-alive connection, as
    every SDK sends them: each is checked against, and stores, its own
    body. The reference's gateway kept the first body it read on a
    connection (`_raw_body_cache` lives on the connection's handler), so
    the second signed PUT fails its payload hash and desyncs the stream;
    the port's drops it with every request."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    port = _keep_alive_puts(PORT, str(tmp_path / "port"))
    assert [a[0] for a in port[:3]] == [200, 200, 200]
    assert port[3] == b"the second body"
    ref = _keep_alive_puts(REF, str(tmp_path / "ref"))
    assert ref[1][0] == 400 and b"XAmzContentSHA256Mismatch" in ref[1][1]


def _paged_keys(mods, root: str, max_keys: int) -> tuple[list, list]:
    with _one_server_stack(mods, root) as base:
        http = requests.Session()
        http.trust_env = False
        http.put(base + "/pg", timeout=60)
        for k in OBJECTS:
            assert http.put(f"{base}/pg/{k}", data=b"x",
                            timeout=60).status_code == 200
        keys, tokens, token = [], [], ""
        while len(tokens) < 20:
            q = f"list-type=2&max-keys={max_keys}" + (
                f"&continuation-token={urllib.parse.quote(token)}"
                if token else "")
            body = http.get(f"{base}/pg?{q}", timeout=60).content
            keys += [k.decode() for k in re.findall(rb"<Key>([^<]*)<", body)]
            if b"<IsTruncated>true" not in body:
                break
            m = re.search(rb"<NextContinuationToken>([^<]*)<", body)
            token = m.group(1).decode() if m else ""
            tokens.append(token)
            if not token:
                break  # truncated, and nowhere to go on from
        http.close()
    return keys, tokens


def test_a_page_ending_a_directory_keeps_its_place(tmp_path):
    """ListObjectsV2 in pages of 4 over keys in nested directories: the
    fourth page ends on the last key of logs/2025/. The port's next
    continuation token is that key, and the next page lists top.txt; the
    reference's is empty (the walk of the root kept its own, empty,
    marker), so a client stops with top.txt never listed."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    keys, tokens = _paged_keys(PORT, str(tmp_path / "port"), 4)
    assert keys == sorted(OBJECTS)
    assert tokens[3] == "logs/2025/o13.bin"
    ref_keys, ref_tokens = _paged_keys(REF, str(tmp_path / "ref"), 4)
    assert ref_keys == sorted(OBJECTS)[:16] and ref_tokens[3] == ""


# -- one PUT, one charge ---------------------------------------------------------


def test_an_s3_put_is_billed_once(tmp_path):
    """The gateway charges the tenant at its ingress; its leg to the filer
    carries X-Swfs-Qos-Charged and the filer charges nothing more. A
    direct filer PUT is charged by the filer."""
    random.seed(PLACEMENT_SEED)
    c = _Cluster(PORT, str(tmp_path))
    fs = gw = None
    http = requests.Session()
    http.trust_env = False
    try:
        fs = filer_server.FilerServer(ip="127.0.0.1", port=FILER_PORT,
                                      master=c.master.address,
                                      store_dir=str(tmp_path / "filer"))
        fs.start()
        gw = s3_server.S3Server(port=S3_PORT, filer=f"127.0.0.1:{FILER_PORT}")
        gw.start()
        base = f"http://127.0.0.1:{S3_PORT}"
        assert http.put(f"{base}/bill", timeout=60).status_code == 200
        s0, f0 = gw.qos_admission.admitted, fs.qos_admission.admitted
        r = http.put(f"{base}/bill/one.bin", data=b"x" * 5000, timeout=60)
        assert r.status_code == 200
        assert gw.qos_admission.admitted - s0 == 1
        assert fs.qos_admission.admitted - f0 == 0
        r = http.put(f"http://127.0.0.1:{FILER_PORT}/buckets/bill/two.bin",
                     data=b"y", timeout=60)
        assert r.status_code == 201
        assert fs.qos_admission.admitted - f0 == 1
        assert http.get(f"{base}/bill/one.bin",
                        timeout=60).content == b"x" * 5000
    finally:
        http.close()
        for srv in (gw, fs):
            if srv is not None:
                srv.stop()
                srv._http_server.server_close()
                srv._grpc_server.stop(None).wait(10)
        c.close()
        _reset_clients()


# -- the CLI as processes ------------------------------------------------------

_WRAPPER = """
import atexit, runpy, sys
out = sys.argv[1]


def dump():
    with open(out, "w") as f:
        f.write("\\n".join(sorted(sys.modules)))


atexit.register(dump)
sys.argv = ["seaweedfs_tpu_torch"] + sys.argv[2:]
runpy.run_module("seaweedfs_tpu_torch", run_name="__main__", alter_sys=True)
"""


class _Procs:
    """Processes of `python -m seaweedfs_tpu_torch`, each recording the
    modules it imported."""

    def __init__(self, tmp_path):
        self.tmp = tmp_path
        self.env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        self.procs = []
        self.module_files = []
        self.http = requests.Session()
        self.http.trust_env = False

    def spawn(self, name: str, args):
        mods = self.tmp / f"{name}.modules"
        self.module_files.append(mods)
        f = open(self.tmp / f"{name}.log", "wb")
        proc = subprocess.Popen(
            [sys.executable, "-c", _WRAPPER, str(mods)] + args, cwd=REPO,
            env=self.env, stdout=f, stderr=subprocess.STDOUT)
        self.procs.append((name, proc, f))

    def wait_for(self, url: str, name: str, ok=(200,)) -> None:
        deadline = time.time() + 90
        while True:
            proc = next(p for n, p, _ in self.procs if n == name)
            assert proc.poll() is None, \
                (self.tmp / f"{name}.log").read_text()
            try:
                if self.http.get(url, timeout=5).status_code in ok:
                    return
            except requests.RequestException:
                pass
            assert time.time() < deadline, f"{name}: no {url}"
            time.sleep(0.2)

    def wait_registered(self, mport: int, vport: int) -> None:
        deadline = time.time() + 60
        while str(vport) not in self.http.get(
                f"http://127.0.0.1:{mport}/cluster/status", timeout=5).text:
            assert time.time() < deadline, "the volume never registered"
            time.sleep(0.2)

    def stop_all(self) -> list:
        for _name, proc, _f in self.procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        rcs = []
        for _name, proc, f in self.procs:
            try:
                rcs.append(proc.wait(timeout=60))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                rcs.append("killed")
            f.close()
        self.procs = []
        self.http.close()
        return rcs

    def assert_no_jax(self) -> None:
        for path in self.module_files:
            mods = path.read_text().split("\n")
            assert "seaweedfs_tpu_torch.s3api.server" in mods, path
            assert not [m for m in mods if m in ("jax", "seaweedfs_tpu")
                        or m.startswith(("jax.", "seaweedfs_tpu."))], path


def _put_get(http, base: str) -> None:
    data = OBJECTS["big/b.bin"]
    assert http.put(f"{base}/cli", timeout=60).status_code == 200
    r = http.put(f"{base}/cli/b.bin", data=data, timeout=60)
    assert r.status_code == 200
    assert r.headers["ETag"] == f'"{hashlib.md5(data).hexdigest()}"'
    assert http.get(f"{base}/cli/b.bin", timeout=60).content == data
    assert b"<Key>b.bin</Key>" in http.get(f"{base}/cli", timeout=60).content


def test_the_s3_process_runs_without_jax(tmp_path):
    """`master`, `volume -coder cpu`, `filer` and `s3` as processes: a PUT
    and a GET through the gateway; the `s3` process exits 0 on SIGTERM and
    never imported jax or seaweedfs_tpu."""
    mport, vport, fport, sport = PORTS[0], PORTS[1], PORTS[5], PORTS[6]
    p = _Procs(tmp_path)
    master = f"127.0.0.1:{mport}"
    (tmp_path / "data").mkdir()
    try:
        p.spawn("master", ["master", "-ip", "127.0.0.1", "-port", str(mport),
                           "-volumeSizeLimitMB", "64"])
        p.spawn("volume", ["volume", "-dir", str(tmp_path / "data"), "-ip",
                           "127.0.0.1", "-port", str(vport), "-mserver",
                           master, "-coder", "cpu"])
        p.spawn("filer", ["filer", "-ip", "127.0.0.1", "-port", str(fport),
                          "-master", master, "-dir", str(tmp_path / "filer")])
        p.spawn("s3", ["s3", "-port", str(sport), "-filer",
                       f"127.0.0.1:{fport}"])
        p.wait_for(f"http://127.0.0.1:{mport}/cluster/status", "master")
        p.wait_for(f"http://127.0.0.1:{vport}/status", "volume")
        p.wait_registered(mport, vport)
        p.wait_for(f"http://127.0.0.1:{fport}/healthz", "filer")
        p.wait_for(f"http://127.0.0.1:{sport}/status", "s3")
        _put_get(p.http, f"http://127.0.0.1:{sport}")
        proc = next(pr for n, pr, _ in p.procs if n == "s3")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        rcs = p.stop_all()
        rpc.reset_channels()
    assert rcs == [0, 0, 0, 0]
    p.module_files = [tmp_path / "s3.modules"]
    p.assert_no_jax()


def test_server_filer_s3_serves_a_put_and_a_get(tmp_path):
    """`server -filer -s3 -coder cpu`: master, volume server, filer and
    gateway in one process; SIGTERM stops all four with exit 0."""
    mport, vport, fport, sport = PORTS[0], PORTS[1], PORTS[5], PORTS[6]
    p = _Procs(tmp_path)
    try:
        p.spawn("server", ["server", "-dir", str(tmp_path), "-ip",
                           "127.0.0.1", "-master.port", str(mport),
                           "-volume.port", str(vport), "-filer",
                           "-filer.port", str(fport), "-s3", "-s3.port",
                           str(sport), "-coder", "cpu"])
        p.wait_for(f"http://127.0.0.1:{mport}/cluster/status", "server")
        p.wait_registered(mport, vport)
        p.wait_for(f"http://127.0.0.1:{sport}/status", "server")
        _put_get(p.http, f"http://127.0.0.1:{sport}")
    finally:
        rcs = p.stop_all()
        rpc.reset_channels()
    assert rcs == [0]
    p.assert_no_jax()


# -- the CLI's benchmark -------------------------------------------------------


def _bench_opts(master: str, **kw) -> argparse.Namespace:
    o = dict(master=master, n=48, size=2048, c=4, collection="bench",
             skipRead=False, assignBatch=0, nativeClient=False, filer="")
    o.update(kw)
    return argparse.Namespace(**o)


def test_benchmark_returns_the_references_keys_with_nothing_failed(tmp_path):
    """`benchmark` against a port cluster (the CLI, then both packages'
    run_benchmark on the same cluster): writes and reads with 0 failed,
    and the port's result has the reference's keys."""
    random.seed(PLACEMENT_SEED)
    c = _Cluster(PORT, str(tmp_path))
    try:
        master = c.master.address
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert command.main(["benchmark", "-master", master, "-n", "40",
                                 "-size", "1024", "-c", "4", "-collection",
                                 "bench"]) == 0
        said = buf.getvalue()
        assert re.search(r"write: [\d.]+ req/s, [\d.]+ MB/s, [\d.]+ s total,"
                         r" 0 failed", said), said
        assert re.search(r"read: [\d.]+ req/s, [\d.]+ s total, 0 failed",
                         said), said
        with contextlib.redirect_stdout(io.StringIO()):
            got = benchmark.run_benchmark(_bench_opts(master, assignBatch=8))
            want = ref_benchmark.run_benchmark(_bench_opts(master,
                                                           assignBatch=8))
        assert got.keys() == want.keys() == {"write", "read"}
        for k in got:
            assert got[k].keys() == want[k].keys()
            assert got[k]["failed"] == want[k]["failed"] == 0
    finally:
        c.close()
        _reset_clients()


@pytest.mark.parametrize("flags", [["-nativeClient"], ["-filer", "FILER"]],
                         ids=["nativeClient", "filer"])
def test_benchmark_native_client_paths_return_the_references_keys(
        flags, tmp_path):
    """`benchmark -nativeClient` and `-filer` over a port stack whose
    volume server and filer run their C++ planes: the compiled loop loses
    no request, and the port's result has the reference's keys."""
    from tests.test_torch_native_filer import _stack, _teardown

    stack = _stack("seaweedfs_tpu_torch", tmp_path, "bench")
    master, _, fs = stack
    try:
        kw = dict(collection="",
                  nativeClient=flags[0] == "-nativeClient",
                  filer=f"127.0.0.1:{fs.port}" if flags[0] == "-filer"
                  else "")
        with contextlib.redirect_stdout(io.StringIO()):
            got = benchmark.run_benchmark(_bench_opts(master.address, **kw))
            want = ref_benchmark.run_benchmark(_bench_opts(master.address,
                                                           **kw))
        assert got.keys() == want.keys() == {"write", "read"}
        for k in got:
            assert got[k].keys() == want[k].keys()
            assert got[k]["failed"] == want[k]["failed"] == 0
    finally:
        _teardown("seaweedfs_tpu_torch", *stack)
