"""remote.* shell commands: cloud-tier mounts.

Counterpart of seaweedfs_tpu/shell/commands/remote.py (SeaweedFS
weed/shell/command_remote_*.go: remote.configure, remote.mount,
remote.unmount, remote.meta.sync, remote.cache, remote.uncache and
remote.mount.buckets).
"""

from __future__ import annotations

import json

from ...remote_storage import RemoteConf, RemoteGateway
from ..registry import command, kv_flags as _kv


@command("remote.configure",
         "remote.configure -name=x -type=local|s3|gcs|azure|b2 "
         "[-root=... | -endpoint=... -bucket=... -access_key=... "
         "-secret_key=... | -bucket=... -token=... | -container=... "
         "-account=... -key=... | -bucket=... -key_id=... "
         "-application_key=...]")
def remote_configure(env, args, out):
    opts = _kv(args)
    conf = RemoteConf(env.require_filer())
    if not opts:
        print(json.dumps(conf.load().get("storages", {}), indent=2),
              file=out)
        return
    name = opts.pop("name")
    storage = {"type": opts.pop("type", "local"), **opts}
    conf.configure_storage(name, storage)
    print(f"configured remote storage {name}", file=out)


@command("remote.mount",
         "remote.mount -dir=/buckets/x -remote=name/path")
def remote_mount(env, args, out):
    opts = _kv(args)
    conf = RemoteConf(env.require_filer())
    if not opts:
        print(json.dumps(conf.load().get("mounts", {}), indent=2), file=out)
        return
    directory = opts["dir"]
    storage, _, remote_path = opts["remote"].partition("/")
    conf.mount(directory, storage, remote_path or "/")
    synced = RemoteGateway(env.require_filer()).sync_dir(directory)
    print(f"mounted {directory} -> {opts['remote']} ({synced} entries)",
          file=out)


@command("remote.unmount", "remote.unmount -dir=/buckets/x")
def remote_unmount(env, args, out):
    opts = _kv(args)
    RemoteConf(env.require_filer()).unmount(opts["dir"])
    print(f"unmounted {opts['dir']}", file=out)


@command("remote.meta.sync", "remote.meta.sync -dir=/buckets/x")
def remote_meta_sync(env, args, out):
    opts = _kv(args)
    n = RemoteGateway(env.require_filer()).sync_dir(opts["dir"])
    print(f"synced {n} entries", file=out)


@command("remote.cache", "remote.cache -dir=/buckets/x/file")
def remote_cache(env, args, out):
    """command_remote_cache.go: the filer does the remote fetch; the
    shell speaks the same CacheRemoteObjectToLocalCluster gRPC a stock
    client would."""
    from ...pb import filer_pb2, rpc

    opts = _kv(args)
    d, _, name = opts["dir"].rpartition("/")
    stub = rpc.filer_stub(rpc.grpc_address(env.require_filer()))
    resp = stub.CacheRemoteObjectToLocalCluster(
        filer_pb2.CacheRemoteObjectToLocalClusterRequest(
            directory=d or "/", name=name), timeout=300)
    size = max((c.offset + c.size for c in resp.entry.chunks),
               default=resp.entry.attributes.file_size)
    print(f"cached {size} bytes", file=out)


@command("remote.uncache", "remote.uncache -dir=/buckets/x/file")
def remote_uncache(env, args, out):
    opts = _kv(args)
    RemoteGateway(env.require_filer()).uncache(opts["dir"])
    print(f"uncached {opts['dir']}", file=out)





@command("remote.mount.buckets",
         "remote.mount.buckets -remote=<storage> [-apply]")
def remote_mount_buckets(env, args, out):
    """command_remote_mount_buckets.go: discover the remote storage's
    top-level buckets and mount each under /buckets/<bucket>."""
    opts = _kv(args)
    storage = opts.get("remote", "")
    if not storage:
        raise RuntimeError("usage: remote.mount.buckets -remote=<storage>")
    apply = "apply" in opts
    conf = RemoteConf(env.require_filer())
    all_conf = conf.load()
    if storage not in all_conf.get("storages", {}):
        raise RuntimeError(f"unknown remote storage {storage!r}")
    from ...remote_storage import new_client

    client = new_client(all_conf["storages"][storage])
    buckets = sorted({e.path.lstrip("/").split("/", 1)[0]
                      for e in client.traverse("")})
    mounted = 0
    for b in buckets:
        directory = f"/buckets/{b}"
        if directory in all_conf.get("mounts", {}):
            continue
        if apply:
            conf.mount(directory, storage, b)
            synced = RemoteGateway(env.require_filer()).sync_dir(directory)
            print(f"mounted {directory} -> {storage}/{b} "
                  f"({synced} entries)", file=out)
        else:
            print(f"would mount {directory} -> {storage}/{b} "
                  f"(rerun with -apply)", file=out)
        mounted += 1
    if not mounted:
        print("no unmounted buckets found", file=out)
