"""fs.* shell commands: filer namespace browsing and metadata tools.

Counterpart of seaweedfs_tpu/shell/commands/fs.py (SeaweedFS
weed/shell/command_fs_*.go: fs.ls, fs.cd, fs.pwd, fs.cat, fs.du, fs.mkdir,
fs.rm, fs.mv, fs.tree, fs.verify, fs.configure and the fs.meta.* tools).
`fs.meta.notify` publishes to the queue notification.toml configures.
"""

from __future__ import annotations

import struct

import grpc

from ...pb import filer_pb2, rpc
from ..registry import command


def _stub(env):
    return rpc.filer_stub(rpc.grpc_address(env.require_filer()))


def _resolve(env, arg: str | None) -> str:
    p = arg if arg else env.cwd
    if not p.startswith("/"):
        p = env.cwd.rstrip("/") + "/" + p
    while "//" in p:
        p = p.replace("//", "/")
    return p.rstrip("/") or "/"


def _list(env, directory: str):
    for resp in _stub(env).ListEntries(filer_pb2.ListEntriesRequest(
            directory=directory, limit=1 << 20)):
        yield resp.entry


def _find(env, path: str) -> filer_pb2.Entry | None:
    if path == "/":
        return filer_pb2.Entry(name="", is_directory=True)
    d, name = path.rsplit("/", 1)
    try:
        e = _stub(env).LookupDirectoryEntry(
            filer_pb2.LookupDirectoryEntryRequest(
                directory=d or "/", name=name), timeout=10).entry
    except grpc.RpcError:
        return None
    return e if (e.name or e.is_directory) else None


@command("fs.pwd", "print current filer directory")
def fs_pwd(env, args, out):
    print(env.cwd, file=out)


@command("fs.cd", "fs.cd <dir>")
def fs_cd(env, args, out):
    path = _resolve(env, args[0] if args else "/")
    e = _find(env, path)
    if e is None or not e.is_directory:
        raise RuntimeError(f"{path}: not a directory")
    env.cwd = path


@command("fs.ls", "fs.ls [-l] [dir]")
def fs_ls(env, args, out):
    long_ = "-l" in args
    args = [a for a in args if not a.startswith("-")]
    path = _resolve(env, args[0] if args else None)
    for e in _list(env, path):
        if long_:
            kind = "d" if e.is_directory else "-"
            size = e.attributes.file_size or \
                max((c.offset + c.size for c in e.chunks), default=0)
            print(f"{kind} {e.attributes.file_mode & 0o7777:04o} "
                  f"{size:>12d} {e.name}", file=out)
        else:
            print(e.name + ("/" if e.is_directory else ""), file=out)


@command("fs.du", "fs.du [dir] — directory usage (bytes, files)")
def fs_du(env, args, out):
    path = _resolve(env, args[0] if args else None)

    def walk(d):
        files = size = 0
        for e in _list(env, d):
            if e.is_directory:
                f2, s2 = walk(d.rstrip("/") + "/" + e.name)
                files += f2
                size += s2
            else:
                files += 1
                size += e.attributes.file_size or \
                    max((c.offset + c.size for c in e.chunks), default=0)
        return files, size

    files, size = walk(path)
    print(f"{size:>14d} bytes  {files:>8d} files  {path}", file=out)


@command("fs.cat", "fs.cat <file>")
def fs_cat(env, args, out):
    import requests

    path = _resolve(env, args[0])
    from ...utils.http import requests_verify, url_for

    r = requests.get(url_for(env.require_filer(), path), timeout=60,
                     verify=requests_verify())
    if r.status_code != 200:
        raise RuntimeError(f"{path}: {r.status_code}")
    out.write(r.content.decode(errors="replace"))


@command("fs.mkdir", "fs.mkdir <dir>")
def fs_mkdir(env, args, out):
    path = _resolve(env, args[0])
    d, name = path.rsplit("/", 1)
    entry = filer_pb2.Entry(name=name, is_directory=True)
    entry.attributes.file_mode = 0o40775
    _stub(env).CreateEntry(filer_pb2.CreateEntryRequest(
        directory=d or "/", entry=entry), timeout=10)
    print(f"created {path}", file=out)


@command("fs.rm", "fs.rm [-r] <path>")
def fs_rm(env, args, out):
    recursive = "-r" in args or "-rf" in args
    args = [a for a in args if not a.startswith("-")]
    path = _resolve(env, args[0])
    d, name = path.rsplit("/", 1)
    resp = _stub(env).DeleteEntry(filer_pb2.DeleteEntryRequest(
        directory=d or "/", name=name, is_delete_data=True,
        is_recursive=recursive), timeout=60)
    if resp.error:
        raise RuntimeError(resp.error)
    print(f"removed {path}", file=out)


@command("fs.mv", "fs.mv <src> <dst>")
def fs_mv(env, args, out):
    src = _resolve(env, args[0])
    dst = _resolve(env, args[1])
    if _find(env, dst) is not None and _find(env, dst).is_directory:
        dst = dst.rstrip("/") + "/" + src.rsplit("/", 1)[-1]
    od, on = src.rsplit("/", 1)
    nd, nn = dst.rsplit("/", 1)
    _stub(env).AtomicRenameEntry(filer_pb2.AtomicRenameEntryRequest(
        old_directory=od or "/", old_name=on,
        new_directory=nd or "/", new_name=nn), timeout=60)
    print(f"moved {src} -> {dst}", file=out)


# -- metadata save/load (command_fs_meta_save.go) --------------------------
# File format: repeated [4-byte big-endian length][FullEntry proto] records,
# the same framing the reference writes.

@command("fs.meta.save", "fs.meta.save -o=meta.bin [dir]")
def fs_meta_save(env, args, out):
    output = "meta.bin"
    rest = []
    for a in args:
        if a.startswith("-o="):
            output = a[3:]
        else:
            rest.append(a)
    path = _resolve(env, rest[0] if rest else None)
    count = 0
    with open(output, "wb") as f:
        def walk(d):
            nonlocal count
            for e in _list(env, d):
                blob = filer_pb2.FullEntry(dir=d, entry=e) \
                    .SerializeToString()
                f.write(struct.pack(">I", len(blob)) + blob)
                count += 1
                if e.is_directory:
                    walk(d.rstrip("/") + "/" + e.name)

        walk(path)
    print(f"saved {count} entries from {path} to {output}", file=out)


@command("fs.meta.load", "fs.meta.load meta.bin")
def fs_meta_load(env, args, out):
    stub = _stub(env)
    count = 0
    with open(args[0], "rb") as f:
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                break
            (n,) = struct.unpack(">I", hdr)
            fe = filer_pb2.FullEntry.FromString(f.read(n))
            stub.CreateEntry(filer_pb2.CreateEntryRequest(
                directory=fe.dir, entry=fe.entry), timeout=30)
            count += 1
    print(f"loaded {count} entries", file=out)


@command("fs.meta.cat", "fs.meta.cat <path> — print entry metadata")
def fs_meta_cat(env, args, out):
    path = _resolve(env, args[0])
    e = _find(env, path)
    if e is None:
        raise RuntimeError(f"{path}: not found")
    print(e, file=out)


@command("fs.meta.tail", "fs.meta.tail [-timeAgo=10s] [-pathPrefix=/]")
def fs_meta_tail(env, args, out):
    """Stream filer metadata events (command_fs_meta_tail.go); drains
    until the stream goes idle for 2s (non-interactive shells)."""
    import time as _time

    prefix = "/"
    ago_ns = 0
    for a in args:
        if a.startswith("-pathPrefix="):
            prefix = a.split("=", 1)[1]
        elif a.startswith("-timeAgo="):
            spec = a.split("=", 1)[1]
            mult = {"s": 1, "m": 60, "h": 3600}.get(spec[-1], 1)
            ago_ns = int(float(spec.rstrip("smh")) * mult * 1e9)
    stub = _stub(env)
    cursor = _time.time_ns() - ago_ns
    # timeout=2 is a per-stream deadline, not an idle timer: resume from
    # the cursor until a whole window passes with no new events
    while True:
        got_any = False
        try:
            for resp in stub.SubscribeMetadata(
                    filer_pb2.SubscribeMetadataRequest(
                        client_name="fs.meta.tail", path_prefix=prefix,
                        since_ns=cursor), timeout=2):
                got_any = True
                cursor = max(cursor, resp.ts_ns)
                ev = resp.event_notification
                kind = ("update" if ev.old_entry.name and ev.new_entry.name
                        else "create" if ev.new_entry.name else "delete")
                name = ev.new_entry.name or ev.old_entry.name
                # a rename is filed under the directory it left; the
                # entry now lives in new_parent_path
                directory = ((ev.new_parent_path or resp.directory)
                             if ev.new_entry.name else resp.directory)
                print(f"{resp.ts_ns} {kind} {directory}/{name}", file=out)
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.DEADLINE_EXCEEDED:
                raise
        if not got_any:
            return


@command("fs.configure",
         "fs.configure [-locationPrefix=/p -collection=c -replication=XYZ] "
         "[-apply]")
def fs_configure(env, args, out):
    """Per-path storage rules stored at /etc/seaweedfs/filer.conf
    (command_fs_configure.go + filer_conf.go)."""
    import json as _json
    import time as _time

    stub = _stub(env)
    conf = {"locations": []}
    try:
        resp = stub.LookupDirectoryEntry(
            filer_pb2.LookupDirectoryEntryRequest(
                directory="/etc/seaweedfs", name="filer.conf"), timeout=10)
        if resp.entry.content:
            conf = _json.loads(resp.entry.content)
    except (grpc.RpcError, ValueError):
        pass  # no (readable) filer.conf yet: start from an empty one
    opts = {}
    apply_ = "-apply" in args
    for a in args:
        if a.startswith("-") and "=" in a:
            k, _, v = a[1:].partition("=")
            opts[k] = v
    if "locationPrefix" in opts:
        loc = {"location_prefix": opts["locationPrefix"]}
        for k in ("collection", "replication", "ttl", "disk_type"):
            if opts.get(k):
                loc[k] = opts[k]
        conf["locations"] = [l for l in conf["locations"]
                             if l["location_prefix"] != loc["location_prefix"]]
        conf["locations"].append(loc)
        if apply_:
            entry = filer_pb2.Entry(
                name="filer.conf",
                content=_json.dumps(conf, indent=2).encode())
            entry.attributes.file_mode = 0o644
            entry.attributes.mtime = int(_time.time())
            stub.CreateEntry(filer_pb2.CreateEntryRequest(
                directory="/etc/seaweedfs", entry=entry), timeout=10)
        else:
            # reference semantics: dry run unless -apply
            print("(dry run; add -apply to persist)", file=out)
    print(_json.dumps(conf, indent=2), file=out)


@command("mount.configure", "mount.configure -dir=/p -quotaMB=n")
def mount_configure(env, args, out):
    """Mount quota config persisted in the filer
    (command_mount_configure.go), and set on the live mount at -dir
    through its control socket, as SeaweedFS's command does; the
    reference only writes the file, which no mount reads (ROADMAP.md
    C). -quotaMB=0 lifts the quota."""
    import json as _json
    import os as _os
    import time as _time

    from ...mount import control

    stub = _stub(env)
    opts = {}
    for a in args:
        if a.startswith("-") and "=" in a:
            k, _, v = a[1:].partition("=")
            opts[k] = v
    conf = {}
    try:
        resp = stub.LookupDirectoryEntry(
            filer_pb2.LookupDirectoryEntryRequest(
                directory="/etc/seaweedfs", name="mount.conf"), timeout=10)
        if resp.entry.content:
            conf = _json.loads(resp.entry.content)
    except grpc.RpcError as e:
        if e.code() != grpc.StatusCode.NOT_FOUND:
            raise
    if "dir" in opts:
        quota_mb = int(opts.get("quotaMB", 0))
        conf[opts["dir"]] = {"quotaMB": quota_mb}
        entry = filer_pb2.Entry(name="mount.conf",
                                content=_json.dumps(conf, indent=2).encode())
        entry.attributes.file_mode = 0o644
        entry.attributes.mtime = int(_time.time())
        stub.CreateEntry(filer_pb2.CreateEntryRequest(
            directory="/etc/seaweedfs", entry=entry), timeout=10)
    print(_json.dumps(conf, indent=2), file=out)
    if "dir" in opts and _os.path.exists(
            control.control_socket(opts["dir"])):
        control.configure(opts["dir"], quota_mb << 20)
        print(f"quota {quota_mb} MB set on the mount at {opts['dir']}",
              file=out)


@command("fs.tree", "fs.tree [dir] — recursively print the directory tree")
def fs_tree(env, args, out):
    """command_fs_tree.go."""
    root = _resolve(env, args[0] if args else None)
    dirs = files = 0

    def walk(d: str, indent: str) -> None:
        nonlocal dirs, files
        entries = sorted(_list(env, d), key=lambda e: e.name)
        for i, e in enumerate(entries):
            last = i == len(entries) - 1
            branch = "└──" if last else "├──"
            print(f"{indent}{branch} {e.name}"
                  + ("/" if e.is_directory else ""), file=out)
            if e.is_directory:
                dirs += 1
                walk(f"{d.rstrip('/')}/{e.name}",
                     indent + ("    " if last else "│   "))
            else:
                files += 1

    print(root, file=out)
    walk(root, "")
    print(f"{dirs} directories, {files} files", file=out)


@command("fs.verify",
         "fs.verify [-v] [dir] — check every chunk of every file is readable")
def fs_verify(env, args, out):
    """command_fs_verify.go: walk the tree and probe each referenced chunk
    on its volume server."""
    import requests

    flags = [a for a in args if a.startswith("-")]
    rest = [a for a in args if not a.startswith("-")]
    verbose = "-v" in flags
    root = _resolve(env, rest[0] if rest else None)
    total = bad = 0

    def check_file(path: str, entry) -> None:
        nonlocal total, bad
        for c in entry.chunks:
            fid = c.file_id or (
                f"{c.fid.volume_id},{c.fid.file_key:x}{c.fid.cookie:08x}")
            total += 1
            # a chunk is missing only if NO replica serves it — one down
            # replica of a healthy volume is not data loss
            ok = False
            try:
                urls = env.master_client.lookup_file_id(fid)
            # lint: allow-broad-except(a chunk whose volume cannot be
            # located is reported MISSING below)
            except Exception:  # noqa: BLE001
                urls = []
            for url in urls:
                try:
                    # a volume server's C++ plane answers the HEAD of an
                    # EC volume's needle with a 307 to its Python listener
                    if requests.head(url, timeout=10,
                                     allow_redirects=True).status_code == 200:
                        ok = True
                        break
                except requests.RequestException:
                    continue
            if not ok:
                bad += 1
                print(f"  MISSING {path} chunk {fid}", file=out)
            elif verbose:
                print(f"  ok {path} chunk {fid}", file=out)

    def walk(d: str) -> None:
        for e in _list(env, d):
            full = f"{d.rstrip('/')}/{e.name}"
            if e.is_directory:
                walk(full)
            else:
                check_file(full, e)

    walk(root)
    print(f"verified {total} chunks, {bad} missing/corrupt", file=out)
    if bad:
        raise RuntimeError(f"{bad} of {total} chunks failed verification")


@command("fs.meta.changeVolumeId",
         "fs.meta.changeVolumeId -mapping=old1:new1,old2:new2 [dir] [-apply]")
def fs_meta_change_volume_id(env, args, out):
    """command_fs_meta_change_volume_id.go: rewrite chunk volume ids in
    file metadata after volumes were renumbered/migrated."""
    from ..registry import kv_flags

    opts = kv_flags(args)
    apply = "apply" in opts
    rest = [a for a in args if not a.startswith("-")]
    mapping = {}
    for pair in filter(None, opts.get("mapping", "").split(",")):
        old, _, new = pair.partition(":")
        mapping[int(old)] = int(new)
    if not mapping:
        raise RuntimeError("need -mapping=old:new[,old2:new2]")
    root = _resolve(env, rest[0] if rest else None)
    stub = _stub(env)
    changed = 0

    def rewrite(e) -> bool:
        touched = False
        for c in e.chunks:
            vid = c.fid.volume_id if c.fid.volume_id else (
                int(c.file_id.split(",")[0]) if c.file_id else 0)
            if vid in mapping:
                new = mapping[vid]
                if c.file_id:
                    c.file_id = f"{new},{c.file_id.split(',', 1)[1]}"
                if c.fid.volume_id:
                    c.fid.volume_id = new
                touched = True
        return touched

    def walk(d: str) -> None:
        nonlocal changed
        for e in _list(env, d):
            full = f"{d.rstrip('/')}/{e.name}"
            if e.is_directory:
                walk(full)
            elif rewrite(e):
                changed += 1
                print(f"  {'updated' if apply else 'would update'} {full}",
                      file=out)
                if apply:
                    stub.UpdateEntry(filer_pb2.UpdateEntryRequest(
                        directory=d, entry=e), timeout=10)

    walk(root)
    print(f"{changed} entries {'updated' if apply else 'to update'}"
          + ("" if apply else " (rerun with -apply)"), file=out)


@command("fs.meta.notify",
         "fs.meta.notify [dir] — re-publish create events for a tree")
def fs_meta_notify(env, args, out):
    """command_fs_meta_notify.go: resend metadata as notification events
    (e.g. to prime a freshly configured notification backend). The shell
    loads notification.toml itself, exactly like the reference command."""
    from ...notification import current_queue, load_configuration
    from ...utils.config import load_config

    q = load_configuration(load_config("notification")) or current_queue()
    if q is None:
        raise RuntimeError("no notification queue configured "
                           "(see notification.toml)")
    root = _resolve(env, args[0] if args else None)
    sent = 0

    def walk(d: str) -> None:
        nonlocal sent
        for e in _list(env, d):
            full = f"{d.rstrip('/')}/{e.name}"
            ev = filer_pb2.EventNotification()
            ev.new_entry.CopyFrom(e)
            q.send_message(full, ev)
            sent += 1
            if e.is_directory:
                walk(full)

    walk(root)
    print(f"notified {sent} entries under {root}", file=out)