"""s3.* shell commands (counterpart of the s3.* half of
seaweedfs_tpu/shell/commands/s3_mq.py; SeaweedFS
weed/shell/command_s3_bucket_*.go, command_s3_configure.go,
command_s3_circuitbreaker.go and command_s3_clean_uploads.go). Buckets are
filer directories under /buckets (s3api/server.py BUCKETS_DIR);
identities live at /etc/iam/identity.json, where the gateway's
SeaweedS3.Configure takes them from. `mq.topic.list` stays in deferred.py
until the MQ broker is ported.
"""

from __future__ import annotations

import json
import time

from ...pb import filer_pb2, rpc
from ..registry import command, kv_flags as _kv

BUCKETS_DIR = "/buckets"


def _stub(env):
    return rpc.filer_stub(rpc.grpc_address(env.require_filer()))


@command("s3.bucket.list", "list S3 buckets")
def s3_bucket_list(env, args, out):
    for resp in _stub(env).ListEntries(filer_pb2.ListEntriesRequest(
            directory=BUCKETS_DIR, limit=10000)):
        e = resp.entry
        if e.is_directory and not e.name.startswith("."):
            print(e.name, file=out)


@command("s3.bucket.create", "s3.bucket.create -name=<bucket>")
def s3_bucket_create(env, args, out):
    opts = _kv(args)
    name = opts["name"]
    entry = filer_pb2.Entry(name=name, is_directory=True)
    entry.attributes.file_mode = 0o40777
    entry.attributes.mtime = int(time.time())
    resp = _stub(env).CreateEntry(filer_pb2.CreateEntryRequest(
        directory=BUCKETS_DIR, entry=entry), timeout=10)
    if resp.error:
        raise RuntimeError(resp.error)
    print(f"created bucket {name}", file=out)


@command("s3.bucket.delete", "s3.bucket.delete -name=<bucket>")
def s3_bucket_delete(env, args, out):
    opts = _kv(args)
    name = opts["name"]
    resp = _stub(env).DeleteEntry(filer_pb2.DeleteEntryRequest(
        directory=BUCKETS_DIR, name=name, is_delete_data=True,
        is_recursive=True), timeout=60)
    if resp.error:
        raise RuntimeError(resp.error)
    print(f"deleted bucket {name}", file=out)


@command("s3.configure",
         "s3.configure [-user=x -access_key=k -secret_key=s "
         "-actions=Read:bucket,Write] [-delete]")
def s3_configure(env, args, out):
    """Manage the S3 identity list (command_s3_configure.go), stored in
    the filer where the IAM API and S3 gateway read it."""
    from ...iamapi import IamConfigStore
    from ...s3api.auth import Identity

    store = IamConfigStore(env.require_filer())
    identities = store.load()
    opts = _kv(args)
    if not opts:
        print(json.dumps(
            [{"name": i.name, "access_key": i.access_key,
              "actions": i.actions} for i in identities], indent=2),
            file=out)
        return
    user = opts.get("user", "")
    existing = next((i for i in identities if i.name == user), None)
    if "delete" in opts:
        if existing:
            identities.remove(existing)
    else:
        if existing is None:
            existing = Identity(name=user, access_key="", secret_key="",
                                actions=[])
            identities.append(existing)
        if opts.get("access_key"):
            existing.access_key = opts["access_key"]
        if opts.get("secret_key"):
            existing.secret_key = opts["secret_key"]
        if opts.get("actions"):
            existing.actions = opts["actions"].split(",")
    store.save(identities)
    print(f"configured {len(identities)} identities", file=out)


@command("s3.bucket.quota",
         "s3.bucket.quota -name=<bucket> [-sizeMB=N | -disable]")
def s3_bucket_quota(env, args, out):
    """Set/clear a bucket quota (command_s3_bucket_quota.go): stored as the
    bucket entry's quota field; s3.bucket.quota.check enforces it."""
    opts = _kv(args)
    name = opts["name"]
    stub = _stub(env)
    resp = stub.LookupDirectoryEntry(filer_pb2.LookupDirectoryEntryRequest(
        directory=BUCKETS_DIR, name=name), timeout=10)
    entry = resp.entry
    if not entry.name:
        raise RuntimeError(f"no such bucket {name}")
    if "disable" in opts:
        entry.quota = -abs(entry.quota) if entry.quota else 0
    else:
        entry.quota = int(opts.get("sizeMB", "0")) << 20
    stub.UpdateEntry(filer_pb2.UpdateEntryRequest(
        directory=BUCKETS_DIR, entry=entry), timeout=10)
    print(f"bucket {name} quota = {entry.quota} bytes", file=out)


@command("s3.bucket.quota.check",
         "s3.bucket.quota.check [-apply]  (toggle read-only on over-quota)")
def s3_bucket_quota_check(env, args, out):
    """Enforce quotas (command_s3_bucket_quota_check.go): walk each bucket,
    compare usage to quota, and with -apply flip the bucket's read-only
    marker that the S3 gateway checks on writes."""
    from ...s3api.server import READONLY_KEY

    opts = _kv(args)
    apply = "apply" in opts
    stub = _stub(env)

    def tree_size(d: str) -> int:
        total = 0
        for r in stub.ListEntries(filer_pb2.ListEntriesRequest(
                directory=d, limit=100000)):
            e = r.entry
            if e.is_directory:
                total += tree_size(f"{d}/{e.name}")
            else:
                total += max(e.attributes.file_size,
                             sum(c.size for c in e.chunks), len(e.content))
        return total

    for r in stub.ListEntries(filer_pb2.ListEntriesRequest(
            directory=BUCKETS_DIR, limit=10000)):
        entry = r.entry
        if not entry.is_directory or entry.name.startswith("."):
            continue
        readonly = entry.extended.get(READONLY_KEY) == b"true"
        if entry.quota <= 0:
            want_ro = False
        else:
            used = tree_size(f"{BUCKETS_DIR}/{entry.name}")
            want_ro = used > entry.quota
            pct = 100.0 * used / entry.quota
            print(f"  {entry.name}\tused={used}\tquota={entry.quota}"
                  f"\t{pct:.1f}%", file=out)
        if want_ro != readonly:
            state = "read-only" if want_ro else "writable"
            if apply:
                if want_ro:
                    entry.extended[READONLY_KEY] = b"true"
                else:
                    entry.extended.pop(READONLY_KEY, None)
                stub.UpdateEntry(filer_pb2.UpdateEntryRequest(
                    directory=BUCKETS_DIR, entry=entry), timeout=10)
                print(f"    bucket {entry.name} -> {state}", file=out)
            else:
                print(f"    would set bucket {entry.name} -> {state} "
                      f"(rerun with -apply)", file=out)


@command("s3.circuitbreaker",
         "s3.circuitbreaker [-global|-buckets=b1,b2] [-enable|-disable] "
         "[-actions=Read:Count=100,Write:MB=64] [-delete] [-apply]")
def s3_circuitbreaker(env, args, out):
    """Edit /etc/s3/circuit_breaker.json (command_s3_circuitbreaker.go);
    the gateway hot-reloads it within its poll interval."""
    from ...s3api.circuit_breaker import CB_CONFIG_DIR, CB_CONFIG_FILE

    opts = _kv(args)
    stub = _stub(env)
    conf = {"global": {"enabled": False, "actions": {}}, "buckets": {}}
    try:
        resp = stub.LookupDirectoryEntry(filer_pb2.LookupDirectoryEntryRequest(
            directory=CB_CONFIG_DIR, name=CB_CONFIG_FILE), timeout=10)
        if resp.entry.content:
            conf = json.loads(resp.entry.content)
    # lint: allow-broad-except(an absent or unreadable config starts from
    # the empty one, as in the reference; -apply writes it anew)
    except Exception:  # noqa: BLE001
        pass

    if "delete" in opts:
        conf = {"global": {"enabled": False, "actions": {}}, "buckets": {}}
    else:
        actions = {}
        for pair in filter(None, opts.get("actions", "").split(",")):
            k, _, v = pair.partition("=")
            actions[k] = int(v)
        targets = []
        if "buckets" in opts:
            for b in filter(None, opts["buckets"].split(",")):
                node = conf.setdefault("buckets", {}).setdefault(
                    b, {"enabled": True, "actions": {}})
                targets.append(node)
        else:
            targets.append(conf.setdefault("global",
                                           {"enabled": False, "actions": {}}))
        for node in targets:
            if "enable" in opts:
                node["enabled"] = True
            if "disable" in opts:
                node["enabled"] = False
            if actions:
                node.setdefault("actions", {}).update(actions)

    if "apply" in opts:
        entry = filer_pb2.Entry(name=CB_CONFIG_FILE,
                                content=json.dumps(conf, indent=2).encode())
        entry.attributes.file_mode = 0o600
        entry.attributes.mtime = int(time.time())
        stub.CreateEntry(filer_pb2.CreateEntryRequest(
            directory=CB_CONFIG_DIR, entry=entry), timeout=10)
        print("applied:", file=out)
    print(json.dumps(conf, indent=2), file=out)


@command("s3.clean.uploads",
         "s3.clean.uploads [-timeAgo=24h]  (abort stale multipart uploads)")
def s3_clean_uploads(env, args, out):
    """Drop multipart upload scratch dirs older than the cutoff
    (command_s3_clean_uploads.go)."""
    from ..registry import parse_duration

    opts = _kv(args)
    cutoff = time.time() - parse_duration(opts.get("timeAgo", "24h") or "24h",
                                          flag="-timeAgo")
    stub = _stub(env)
    uploads_dir = f"{BUCKETS_DIR}/.uploads"
    import grpc

    removed = 0
    try:
        entries = list(stub.ListEntries(filer_pb2.ListEntriesRequest(
            directory=uploads_dir, limit=10000)))
    except grpc.RpcError as e:
        if e.code() == grpc.StatusCode.NOT_FOUND:
            entries = []
        else:
            raise
    for r in entries:
        e = r.entry
        ts = e.attributes.crtime or e.attributes.mtime
        if ts and ts < cutoff:
            stub.DeleteEntry(filer_pb2.DeleteEntryRequest(
                directory=uploads_dir, name=e.name, is_delete_data=True,
                is_recursive=True), timeout=30)
            print(f"aborted upload {e.name}", file=out)
            removed += 1
    print(f"removed {removed} stale uploads", file=out)
