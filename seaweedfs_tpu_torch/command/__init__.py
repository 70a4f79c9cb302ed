"""CLI: the `weed` binary (counterpart of seaweedfs_tpu/command/__init__.py;
SeaweedFS weed/weed.go:47, weed/command/command.go:11-45). Run as
`python -m seaweedfs_tpu_torch <cmd>`.

Subcommands: master (a Raft group with -peers and -mdir),
master.follower, volume (tier backends with -tierConfig), filer, s3,
server (master + volume, and a filer with -filer, a filer and an S3
gateway with -s3, in one process),
the gateways over a filer (webdav, ftp, iam, mq.broker, and mount or
fuse, a FUSE mount), the filer's tools (filer.sync, filer.replicate,
filer.backup, filer.cat, filer.copy, filer.meta.tail, filer.meta.backup,
filer.remote.sync, filer.remote.gateway), shell, upload, download,
benchmark, the offline volume tools (backup, compact, fix, export),
scaffold, autocomplete, unautocomplete, update, version. The volume servers' erasure coder is the CUDA card by
default (`-coder cuda`): without one they fail at start, and nothing
falls back to the CPU unless `-coder cpu` (numpy) or `-coder native`
(g++) asks for it. `volume` and `server` serve needles from the C++
data plane (native/dataplane.cpp, built with g++ at first use) wherever
it builds and no JWT key or whitelist guard is set, as the reference's
`-nativeDataPlane auto` does; `on` fails at start with g++'s error where
it cannot build, `off` keeps the Python plane. `server -filer` runs the
filer's C++ hot plane over that volume plane.
The tools that follow a filer's metadata stream run until SIGINT or
SIGTERM, and then exit 0; a stream the filer drops is followed again from
the last event.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(prog="weed-tpu-torch", description=__doc__)
    # global flags (weed.go -v/-vmodule + grace.SetupProfiling)
    p.add_argument("-v", type=int, default=0, help="glog verbosity level")
    p.add_argument("-vmodule", default="",
                   help="per-module verbosity, e.g. volume=2,filer=1")
    p.add_argument("-cpuprofile", default="",
                   help="write a cProfile dump at exit")
    p.add_argument("-memprofile", default="",
                   help="write a tracemalloc summary at exit")
    sub = p.add_subparsers(dest="cmd")

    mp = sub.add_parser("master", help="run a master server")
    mp.add_argument("-ip", default="localhost")
    mp.add_argument("-port", type=int, default=9333)
    mp.add_argument("-volumeSizeLimitMB", type=int, default=30_000)
    mp.add_argument("-defaultReplication", default="000")
    mp.add_argument("-garbageThreshold", type=float, default=0.3)
    mp.add_argument("-peers", default="",
                    help="comma-separated master peers for Raft HA")
    mp.add_argument("-mdir", default="",
                    help="directory for Raft state persistence")
    mp.add_argument("-metricsAddress", default="",
                    help="Prometheus push-gateway, broadcast to the fleet")
    mp.add_argument("-metricsIntervalSec", type=int, default=15)

    vp = sub.add_parser("volume", help="run a volume server")
    vp.add_argument("-dir", default="./data", help="comma-separated data dirs")
    vp.add_argument("-max", default="8", help="comma-separated max volume counts")
    vp.add_argument("-ip", default="localhost")
    vp.add_argument("-port", type=int, default=8080)
    vp.add_argument("-mserver", default="localhost:9333")
    vp.add_argument("-dataCenter", default="")
    vp.add_argument("-rack", default="")
    vp.add_argument("-coder", default="cuda",
                    choices=["cuda", "cpu", "native"],
                    help="erasure coder: cuda = the hand-written kernels on "
                         "the CUDA device (fails at start without one), "
                         "cpu = the numpy table codec, native = the "
                         "g++-built host codec")
    vp.add_argument("-index", default="memory",
                    choices=["memory", "sqlite", "leveldb"],
                    help="needle-map index kind (leveldb = sqlite-backed "
                         "low-memory on-disk map)")
    vp.add_argument("-tierConfig", default="",
                    help="JSON file of tier backends, e.g. "
                         '{"s3": {"default": {"endpoint": '
                         '"http://localhost:8333", "bucket": "tier"}}}')
    vp.add_argument("-nativeDataPlane", dest="native", default="auto",
                    nargs="?", const="on", choices=["auto", "on", "off"],
                    help="serve needle GET/PUT/DELETE from the C++ data "
                         "plane on the public port. auto = on when the "
                         "toolchain builds it and no JWT/guard is "
                         "configured (those paths stay Python); on = "
                         "fail at start where it cannot build; bare flag "
                         "= on")
    vp.add_argument("-largeDisk", action="store_true",
                    help="5-byte needle offsets: 8TB volume cap instead of "
                         "32GB (the reference's 5BytesOffset build tag as a "
                         "runtime switch; .idx stride becomes 17 bytes and "
                         "is not interchangeable with 4-byte index files)")

    fp = sub.add_parser("filer", help="run a filer server")
    fp.add_argument("-ip", default="localhost")
    fp.add_argument("-port", type=int, default=8888)
    fp.add_argument("-master", default="localhost:9333")
    fp.add_argument("-dir", default="./filer", help="metadata store directory")
    fp.add_argument("-collection", default="")
    fp.add_argument("-store", default="sqlite",
                    help="metadata store kind (memory|sqlite|leveldb|"
                         "postgres2|mysql2|redis2|...); a filer.toml "
                         "section configures a network store, and one whose "
                         "server does not answer fails at start")
    fp.add_argument("-peers", default="",
                    help="comma-separated peer filers for HA aggregation")
    fp.add_argument("-maxMB", type=int, default=4,
                    help="split files into chunks of this many MB")

    s3p = sub.add_parser("s3", help="run an S3 gateway")
    s3p.add_argument("-port", type=int, default=8333)
    s3p.add_argument("-filer", default="localhost:8888")

    sp = sub.add_parser("server",
                        help="master + volume (+filer +s3) in one process")
    sp.add_argument("-dir", default="./data")
    sp.add_argument("-ip", default="localhost")
    sp.add_argument("-master.port", dest="master_port", type=int,
                    default=9333)
    sp.add_argument("-volume.port", dest="volume_port", type=int,
                    default=8080)
    sp.add_argument("-coder", default="cuda",
                    choices=["cuda", "cpu", "native"],
                    help="the volume server's erasure coder, as for volume")
    sp.add_argument("-filer", action="store_true",
                    help="also run a filer")
    sp.add_argument("-filer.port", dest="filer_port", type=int, default=8888)
    sp.add_argument("-s3", action="store_true",
                    help="also run a filer and an S3 gateway over it")
    sp.add_argument("-s3.port", dest="s3_port", type=int, default=8333)
    sp.add_argument("-volume.nativeDataPlane", dest="volume_native",
                    default="auto", nargs="?", const="on",
                    choices=["auto", "on", "off"],
                    help="C++ needle data plane on the volume public port "
                         "(as volume -nativeDataPlane)")
    sp.add_argument("-volume.tierConfig", dest="volume_tier_config",
                    default="", help="JSON file of tier backends "
                                     "(as volume -tierConfig)")

    shp = sub.add_parser("shell", help="admin shell (commands on stdin)")
    shp.add_argument("-master", default="localhost:9333")
    shp.add_argument("-filer", default="",
                     help="filer address for fs.*/remote.* commands")

    fsy = sub.add_parser("filer.sync",
                         help="continuously sync between two filers")
    fsy.add_argument("-a", required=True, help="source filer")
    fsy.add_argument("-b", required=True, help="target filer")
    fsy.add_argument("-a.path", dest="a_path", default="/")
    fsy.add_argument("-b.path", dest="b_path", default=None,
                     help="target path (defaults to -a.path)")
    fsy.add_argument("-isActiveActive", action="store_true")

    frp = sub.add_parser("filer.replicate",
                         help="replicate filer events to a sink")
    frp.add_argument("-filer", default="localhost:8888")
    frp.add_argument("-path", default="/")
    frp.add_argument("-sink", default="local",
                     choices=["local", "filer", "s3", "gcs", "azure", "b2"])
    frp.add_argument("-sink.dir", dest="sink_dir", default=None,
                     help="local sink directory (default ./replica), or "
                          "key prefix for the cloud sinks")
    frp.add_argument("-sink.filer", dest="sink_filer", default="")
    frp.add_argument("-sink.endpoint", dest="sink_endpoint", default="")
    frp.add_argument("-sink.bucket", dest="sink_bucket", default="")
    frp.add_argument("-sink.container", dest="sink_container", default="")
    frp.add_argument("-sink.account", dest="sink_account", default="")
    frp.add_argument("-sink.key", dest="sink_key", default="",
                     help="azure shared key / gcs bearer token")
    frp.add_argument("-sink.keyId", dest="sink_key_id", default="")
    frp.add_argument("-sink.applicationKey", dest="sink_app_key",
                     default="")

    fbk = sub.add_parser("filer.backup",
                         help="one-shot backup of a filer path to a "
                              "local directory")
    fbk.add_argument("-filer", default="localhost:8888")
    fbk.add_argument("-path", default="/")
    fbk.add_argument("-target", required=True)

    frs = sub.add_parser("filer.remote.sync",
                         help="sync remote-mounted directories")
    frs.add_argument("-filer", default="localhost:8888")
    frs.add_argument("-dir", required=True)

    frg = sub.add_parser("filer.remote.gateway",
                         help="continuously sync all remote mounts")
    frg.add_argument("-filer", default="localhost:8888")
    frg.add_argument("-interval", type=float, default=60.0)

    fct = sub.add_parser("filer.cat", help="print a filer file to stdout")
    fct.add_argument("-filer", default="localhost:8888")
    fct.add_argument("path")

    fcp = sub.add_parser("filer.copy", help="copy local files to the filer")
    fcp.add_argument("-filer", default="localhost:8888")
    fcp.add_argument("files", nargs="+",
                     help="local files/dirs, last arg is the filer dest dir")

    fmt_ = sub.add_parser("filer.meta.tail",
                          help="stream filer metadata events as JSON lines")
    fmt_.add_argument("-filer", default="localhost:8888")
    fmt_.add_argument("-pathPrefix", default="/")

    fmb = sub.add_parser("filer.meta.backup",
                         help="continuously back up filer metadata to a "
                              "local file")
    fmb.add_argument("-filer", default="localhost:8888")
    fmb.add_argument("-o", dest="output", default="meta.backup")

    up = sub.add_parser("upload", help="upload files")
    up.add_argument("-master", default="localhost:9333")
    up.add_argument("-collection", default="")
    up.add_argument("-replication", default="")
    up.add_argument("-ttl", default="")
    up.add_argument("files", nargs="+")

    dp = sub.add_parser("download", help="download a fid")
    dp.add_argument("-master", default="localhost:9333")
    dp.add_argument("-output", default="-")
    dp.add_argument("fid")

    bp = sub.add_parser("benchmark", help="small-file write/read benchmark")
    bp.add_argument("-master", default="localhost:9333")
    bp.add_argument("-n", type=int, default=10_000)
    bp.add_argument("-size", type=int, default=1024)
    bp.add_argument("-c", type=int, default=16)
    bp.add_argument("-collection", default="")
    bp.add_argument("-write", dest="do_write", action="store_true",
                    default=True)
    bp.add_argument("-skipRead", action="store_true")
    bp.add_argument("-assignBatch", type=int, default=0,
                    help="files per master assign (fid _delta suffixes); "
                         "0 = 1")
    bp.add_argument("-nativeClient", action="store_true",
                    help="drive PUT/GET with the compiled C++ client loop "
                         "(batched assigns, keepalive)")
    bp.add_argument("-filer", default="",
                    help="whole-object PUT/GET through this filer with the "
                         "compiled client (the filer's C++ hot plane under "
                         "server -filer)")

    wd = sub.add_parser("webdav", help="run a WebDAV gateway")
    wd.add_argument("-port", type=int, default=7333)
    wd.add_argument("-filer", default="localhost:8888")
    wd.add_argument("-filer.path", dest="filer_path", default="/")

    ftp = sub.add_parser("ftp", help="run an FTP gateway")
    ftp.add_argument("-port", type=int, default=8021)
    ftp.add_argument("-filer", default="localhost:8888")
    ftp.add_argument("-ip", default="", help="passive-mode address "
                     "(default: derived from each control connection)")
    ftp.add_argument("-portRangeStart", type=int, default=30000)
    ftp.add_argument("-portRangeStop", type=int, default=30100)
    ftp.add_argument("-user", default="", help="require this login "
                     "(with -pass); default accepts any credentials")
    ftp.add_argument("-pass", dest="password", default="")

    ip_ = sub.add_parser("iam", help="run an IAM API server")
    ip_.add_argument("-port", type=int, default=8111)
    ip_.add_argument("-filer", default="localhost:8888")

    mqp = sub.add_parser("mq.broker", help="run a message-queue broker")
    mqp.add_argument("-filer", default="localhost:8888")
    mqp.add_argument("-port", type=int, default=17777)

    mnt = sub.add_parser("mount", help="FUSE-mount a filer path")
    mnt.add_argument("-filer", default="localhost:8888")
    mnt.add_argument("-dir", required=True, help="mount point")
    mnt.add_argument("-chunkSizeLimitMB", type=int, default=2)
    mnt.add_argument("-collection", default="")
    mnt.add_argument("-replication", default="")
    mnt.add_argument("-cacheDir", default="")
    mnt.add_argument("-memoryLimitMB", type=int, default=64,
                     help="dirty-page memory budget; excess spills to a "
                          "swap file under -cacheDir")
    mnt.add_argument("-localPort", type=int, default=0,
                     help="localhost gRPC control port (mount.configure)")

    # `weed fuse` — /etc/fstab-style mount entry point (command/fuse.go):
    # same mount machinery, options packed into a single -o string
    fu = sub.add_parser("fuse", help="mount via fstab-style options")
    fu.add_argument("dir", help="mount point")
    fu.add_argument("-o", default="", help="comma-separated options "
                    "(filer=host:port,collection=c,replication=xyz,"
                    "chunkSizeLimitMB=n,cacheDir=d)")

    mfp = sub.add_parser("master.follower",
                         help="run a follower master (requires -peers)")
    mfp.add_argument("-ip", default="localhost")
    mfp.add_argument("-port", type=int, default=9334)
    mfp.add_argument("-peers", required=True)
    mfp.add_argument("-mdir", default="")

    sub.add_parser("autocomplete", help="print bash completion script")
    sub.add_parser("unautocomplete",
                   help="print command to remove bash completion")
    sub.add_parser("update", help="self-update (not applicable here)")

    bk = sub.add_parser("backup", help="backup a live volume locally")
    bk.add_argument("-master", default="localhost:9333")
    bk.add_argument("-server", default="", help="volume server (else lookup)")
    bk.add_argument("-volumeId", type=int, required=True)
    bk.add_argument("-dir", default=".")

    cpt = sub.add_parser("compact", help="offline-compact a local volume")
    cpt.add_argument("-dir", default=".")
    cpt.add_argument("-volumeId", type=int, required=True)
    cpt.add_argument("-collection", default="")

    fxp = sub.add_parser("fix", help="rebuild .idx from .dat")
    fxp.add_argument("-dir", default=".")
    fxp.add_argument("-volumeId", type=int, required=True)
    fxp.add_argument("-collection", default="")

    exp = sub.add_parser("export", help="extract files from a local volume")
    exp.add_argument("-dir", default=".")
    exp.add_argument("-volumeId", type=int, required=True)
    exp.add_argument("-collection", default="")
    exp.add_argument("-o", dest="output", default="./export")

    # the 5-byte-offset mode is process-wide (reference: 5BytesOffset build
    # tag): every tool that opens .idx/.dat takes the flag
    for sc in (bk, cpt, fxp, exp):
        sc.add_argument("-largeDisk", action="store_true",
                        help="5-byte needle offsets (8TB volumes); must "
                             "match the mode the volume files were "
                             "written with")

    sub.add_parser("version", help="print version")
    scp = sub.add_parser("scaffold", help="print a sample config")
    scp.add_argument("-config", default="filer",
                     choices=["filer", "master", "security", "shell"])

    opts = p.parse_args(argv)
    if opts.cmd is None:
        p.print_help()
        return 1
    from ..utils import glog
    from ..utils.grace import setup_profiling

    if opts.v:
        glog.set_verbosity(opts.v)
    if opts.vmodule:
        glog.set_vmodule(opts.vmodule)
    if opts.cpuprofile or opts.memprofile:
        setup_profiling(opts.cpuprofile, opts.memprofile)
    if getattr(opts, "largeDisk", False):
        # like the reference's 5BytesOffset build tag, the mode applies
        # to the whole process
        from ..storage import types as _types

        _types.set_large_disk(True)
    return _run(opts)


def _use_native_plane(cmd: str, mode: str) -> bool:
    """The -nativeDataPlane rule: auto = the C++ plane wherever g++ builds
    it (the reference's default), off = the Python plane, on = the C++
    plane or a failed start that carries g++'s own message."""
    if mode == "off":
        return False
    from ..native import NativeBuildError
    from ..native.dataplane import load_library

    try:
        load_library()
    except NativeBuildError as e:
        if mode == "on":
            raise SystemExit(f"{cmd}: -nativeDataPlane on: {e}")
        from ..utils import glog

        glog.warning(f"{cmd}: the C++ data plane does not build here, "
                     f"the Python plane serves: {e}")
        return False
    return True


def _tier_config(path: str) -> dict | None:
    """The JSON file of -tierConfig (master.toml's [storage.backend]
    shape), or None without one."""
    if not path:
        return None
    import json

    with open(path) as f:
        return json.load(f)


def _wait_forever():
    ev = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: ev.set())
    ev.wait()


def _follow(stub, req, on_event) -> None:
    """Feed each response of SubscribeMetadata(req) to `on_event` until
    SIGINT or SIGTERM cancels the call (between two events, so that no
    event is half handled). A stream the filer drops (a restart, or the
    GOAWAY that ends a stream idle past the keepalive policy) is opened
    again from the last event handled; the reference's tools exit there
    (ROADMAP.md C)."""
    import grpc

    stopped = threading.Event()
    current = [None]

    def stop(*_):
        stopped.set()
        if current[0] is not None:
            current[0].cancel()

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, stop)
    while not stopped.is_set():
        stream = current[0] = stub.SubscribeMetadata(req)
        if stopped.is_set():
            stream.cancel()
        try:
            for resp in stream:
                on_event(resp)
                req.since_ns = resp.ts_ns
        except grpc.RpcError as e:
            if stopped.is_set() or e.code() == grpc.StatusCode.CANCELLED:
                return
            if e.code() != grpc.StatusCode.UNAVAILABLE:
                raise
            print(f"{req.client_name}: {e.details()}; following again from "
                  f"{req.since_ns}", file=sys.stderr, flush=True)
        stopped.wait(1.0)


def _read_meta_backup(path: str) -> int:
    """-> the newest ts_ns recorded in a filer.meta.backup file (0 if
    none), truncating a torn last record so that appends stay
    parseable."""
    import os
    import struct

    from ..pb import filer_pb2

    since_ns = 0
    if not os.path.exists(path):
        return since_ns
    good_end = 0
    with open(path, "rb") as f:
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                break
            (n,) = struct.unpack(">I", hdr)
            blob = f.read(n)
            if len(blob) < n:
                break
            msg = filer_pb2.SubscribeMetadataResponse.FromString(blob)
            since_ns = max(since_ns, msg.ts_ns)
            good_end = f.tell()
    if good_end < os.path.getsize(path):
        with open(path, "r+b") as f:
            f.truncate(good_end)
    return since_ns


def _filer_tool(opts) -> int:
    """The filer's tools: filer.sync, filer.replicate, filer.backup,
    filer.cat, filer.copy, filer.meta.tail, filer.meta.backup,
    filer.remote.sync and filer.remote.gateway."""
    import time

    import requests

    from ..pb import filer_pb2, rpc
    from ..utils.http import requests_verify, url_for

    if opts.cmd == "filer.sync":
        from ..replication import FilerSyncLoop

        b_path = opts.b_path or opts.a_path
        loops = [FilerSyncLoop(opts.a, opts.b, source_path=opts.a_path,
                               target_path=b_path)]
        if opts.isActiveActive:
            loops.append(FilerSyncLoop(opts.b, opts.a,
                                       source_path=b_path,
                                       target_path=opts.a_path))
        for lp in loops:
            lp.start()
        _wait_forever()
        for lp in loops:
            lp.stop()
        return 0

    if opts.cmd == "filer.replicate":
        from ..replication import FilerSource, Replicator, new_sink

        prefix = opts.sink_dir or ""
        if opts.sink == "local":
            sink = new_sink("local", directory=opts.sink_dir or "./replica")
        elif opts.sink == "filer":
            sink = new_sink("filer", filer=opts.sink_filer)
        elif opts.sink == "gcs":
            sink = new_sink("gcs", bucket=opts.sink_bucket,
                            token=opts.sink_key, directory=prefix,
                            **({"endpoint": opts.sink_endpoint}
                               if opts.sink_endpoint else {}))
        elif opts.sink == "azure":
            sink = new_sink("azure", container=opts.sink_container,
                            account=opts.sink_account, key=opts.sink_key,
                            directory=prefix, endpoint=opts.sink_endpoint)
        elif opts.sink == "b2":
            sink = new_sink("b2", bucket=opts.sink_bucket,
                            key_id=opts.sink_key_id,
                            application_key=opts.sink_app_key,
                            directory=prefix,
                            **({"endpoint": opts.sink_endpoint}
                               if opts.sink_endpoint else {}))
        else:
            # anonymous, as in the reference: the CLI takes no S3 keys
            sink = new_sink("s3", endpoint=opts.sink_endpoint,
                            bucket=opts.sink_bucket, directory=prefix)
        repl_ = Replicator(FilerSource(opts.filer), sink,
                           source_prefix=opts.path)
        stub = rpc.filer_stub(rpc.grpc_address(opts.filer))

        def apply(resp):
            try:
                repl_.replicate(resp)
            except Exception as e:
                # the sink's retries are spent: the event is reported and
                # the stream goes on, as filer_replicate.go logs and goes on
                print(f"replicate error: {e}", file=sys.stderr, flush=True)

        _follow(stub, filer_pb2.SubscribeMetadataRequest(
            client_name="filer.replicate", path_prefix=opts.path,
            since_ns=time.time_ns()), apply)
        return 0

    if opts.cmd == "filer.backup":
        from ..replication import FilerSource, new_sink

        source = FilerSource(opts.filer)
        sink = new_sink("local", directory=opts.target)
        stub = rpc.filer_stub(rpc.grpc_address(opts.filer))
        copied = 0
        root = opts.path.rstrip("/") or "/"

        def walk(directory):
            nonlocal copied
            for resp in stub.ListEntries(filer_pb2.ListEntriesRequest(
                    directory=directory, limit=1 << 20)):
                e = resp.entry
                path = directory.rstrip("/") + "/" + e.name
                rel = path[len(root):] if root != "/" else path
                if e.is_directory:
                    sink.create_entry(rel, e, None)
                    walk(path)
                else:
                    sink.create_entry(rel, e,
                                      source.read_entry_content(e, path))
                    copied += 1

        walk(root)
        print(f"backed up {copied} files to {opts.target}")
        return 0

    if opts.cmd == "filer.remote.sync":
        from ..remote_storage import RemoteGateway

        n = RemoteGateway(opts.filer).sync_dir(opts.dir)
        print(f"synced {n} entries")
        return 0

    if opts.cmd == "filer.remote.gateway":
        import threading

        from ..remote_storage import RemoteGateway

        gw = RemoteGateway(opts.filer)
        stop = threading.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
        while not stop.is_set():
            for directory in list(gw.conf.load().get("mounts", {})):
                try:
                    n = gw.sync_dir(directory)
                    if n:
                        print(f"synced {n} entries in {directory}",
                              flush=True)
                except Exception as e:
                    # one mount's failure is reported; the others still
                    # sync, and it is tried again next interval
                    print(f"sync {directory}: {e}", file=sys.stderr,
                          flush=True)
            stop.wait(opts.interval)
        return 0

    if opts.cmd == "filer.cat":
        path = opts.path if opts.path.startswith("/") else "/" + opts.path
        r = requests.get(url_for(opts.filer, path), timeout=300,
                         stream=True, verify=requests_verify())
        if r.status_code != 200:
            print(f"{path}: HTTP {r.status_code}", file=sys.stderr)
            return 1
        for piece in r.iter_content(chunk_size=256 * 1024):
            sys.stdout.buffer.write(piece)
        sys.stdout.buffer.flush()
        return 0

    if opts.cmd == "filer.copy":
        import os

        if len(opts.files) < 2:
            print("usage: filer.copy <src>... <dest-dir>", file=sys.stderr)
            return 1
        *sources, dest = opts.files
        dest = dest if dest.startswith("/") else "/" + dest
        copied = 0
        for src in sources:
            paths = []
            if os.path.isdir(src):
                for dirpath, _dirs, files in os.walk(src):
                    for name in files:
                        full = os.path.join(dirpath, name)
                        paths.append((full, os.path.relpath(full, src)))
            else:
                paths.append((src, os.path.basename(src)))
            for full, rel in paths:
                target = dest.rstrip("/") + "/" + rel
                with open(full, "rb") as f:  # streamed, not slurped
                    r = requests.put(url_for(opts.filer, target), data=f,
                                     timeout=300, verify=requests_verify())
                if r.status_code >= 300:
                    print(f"{target}: HTTP {r.status_code}",
                          file=sys.stderr)
                    return 1
                copied += 1
        print(f"copied {copied} files to {dest}")
        return 0

    if opts.cmd == "filer.meta.tail":
        import json

        from google.protobuf.json_format import MessageToDict

        stub = rpc.filer_stub(rpc.grpc_address(opts.filer))
        _follow(stub, filer_pb2.SubscribeMetadataRequest(
            client_name="filer.meta.tail", path_prefix=opts.pathPrefix,
            since_ns=time.time_ns()),
            lambda resp: print(json.dumps(MessageToDict(resp)), flush=True))
        return 0

    if opts.cmd == "filer.meta.backup":
        import struct

        # resume from the last backed-up event so restarts don't duplicate
        since_ns = _read_meta_backup(opts.output)
        stub = rpc.filer_stub(rpc.grpc_address(opts.filer))
        with open(opts.output, "ab") as f:
            def record(resp):
                blob = resp.SerializeToString()
                f.write(struct.pack(">I", len(blob)) + blob)
                f.flush()

            _follow(stub, filer_pb2.SubscribeMetadataRequest(
                client_name="filer.meta.backup", path_prefix="/",
                since_ns=since_ns), record)
        return 0

    raise SystemExit(f"unknown command {opts.cmd}")


def _run(opts) -> int:
    if opts.cmd.startswith("filer."):
        return _filer_tool(opts)
    if opts.cmd == "version":
        from .. import __version__

        print(f"seaweedfs-tpu-torch {__version__}")
        return 0

    if opts.cmd == "master":
        from ..server.master import MasterServer
        from ..utils.config import load_security_config

        sec = load_security_config()
        ms = MasterServer(ip=opts.ip, port=opts.port,
                          volume_size_limit_mb=opts.volumeSizeLimitMB,
                          default_replication=opts.defaultReplication,
                          garbage_threshold=opts.garbageThreshold,
                          peers=[p.strip() for p in opts.peers.split(",")
                                 if p.strip()] or None,
                          raft_dir=opts.mdir or None,
                          metrics_address=opts.metricsAddress,
                          metrics_interval_sec=opts.metricsIntervalSec,
                          write_jwt_key=sec["write_key"],
                          jwt_expires_sec=sec["expires_sec"])
        ms.start()
        _wait_forever()
        ms.stop()
        return 0

    if opts.cmd == "server":
        from ..models.coder import new_coder
        from ..server.master import MasterServer
        from ..server.volume import VolumeServer

        coder = (None if opts.coder == "cuda"
                 else new_coder(backend=opts.coder))
        use_native = _use_native_plane("server", opts.volume_native)
        try:
            # the volume server first: without a card it fails before the
            # master binds anything
            vsrv = VolumeServer(directories=opts.dir.split(","),
                                master=f"{opts.ip}:{opts.master_port}",
                                ip=opts.ip, port=opts.volume_port,
                                coder=coder, native=use_native,
                                tier_backends=_tier_config(
                                    opts.volume_tier_config))
        except (RuntimeError, NotImplementedError) as e:
            raise SystemExit(f"server: {e}")
        fs = None
        if opts.filer or opts.s3:
            from ..server.filer import FilerServer

            try:
                fs = FilerServer(ip=opts.ip, port=opts.filer_port,
                                 master=f"{opts.ip}:{opts.master_port}",
                                 store_dir=opts.dir.split(",")[0] + "/filer")
            except (ValueError, NotImplementedError, RuntimeError) as e:
                vsrv.stop()  # nothing bound yet; the store lifts its marker
                raise SystemExit(f"server: {e}")
        ms = MasterServer(ip=opts.ip, port=opts.master_port)
        ms.start()
        vsrv.start()
        stoppers = [vsrv.stop, ms.stop]
        if fs is not None:
            # co-located volume plane (it exists once the volume server
            # started): the filer's C++ hot path for whole-object PUT/GET
            # under /buckets/
            fs.native_volume_plane = vsrv.native_plane
            fs.start()
            stoppers.insert(0, fs.stop)
        if opts.s3:
            from ..s3api.server import S3Server

            s3 = S3Server(port=opts.s3_port,
                          filer=f"{opts.ip}:{opts.filer_port}")
            s3.start()
            stoppers.insert(0, s3.stop)
        _wait_forever()
        for stop in stoppers:
            stop()
        return 0

    if opts.cmd == "shell":
        from ..shell.env import CommandEnv
        from ..shell.registry import repl

        repl(CommandEnv(opts.master, filer=opts.filer))
        return 0

    if opts.cmd == "filer":
        from ..server.filer import FilerServer

        try:
            fs = FilerServer(ip=opts.ip, port=opts.port, master=opts.master,
                             store_dir=opts.dir, collection=opts.collection,
                             store=opts.store,
                             chunk_size=max(1, opts.maxMB) * 1024 * 1024,
                             peers=[p.strip() for p in opts.peers.split(",")
                                    if p.strip()])
        except (ValueError, NotImplementedError, RuntimeError) as e:
            # an unknown store, one whose server does not answer, or a
            # notification queue that cannot initialize: fail at start,
            # never fall back
            raise SystemExit(f"filer: {e}")
        fs.start()
        _wait_forever()
        fs.stop()
        return 0

    if opts.cmd == "s3":
        from ..s3api.server import S3Server

        s3 = S3Server(port=opts.port, filer=opts.filer)
        s3.start()
        _wait_forever()
        s3.stop()
        return 0

    if opts.cmd == "webdav":
        from ..server.webdav import WebDavServer

        wd = WebDavServer(port=opts.port, filer=opts.filer,
                          base_dir=opts.filer_path)
        wd.start()
        _wait_forever()
        wd.stop()
        return 0

    if opts.cmd == "ftp":
        from ..ftpd import FtpServer, FtpServerOptions

        if bool(opts.user) != bool(opts.password):
            print("ftp: -user and -pass must be given together",
                  file=sys.stderr)
            return 2
        fsrv = FtpServer(FtpServerOptions(
            port=opts.port, filer=opts.filer, ip=opts.ip,
            passive_port_start=opts.portRangeStart,
            passive_port_stop=opts.portRangeStop,
            users={opts.user: opts.password} if opts.user else None))
        fsrv.start()
        _wait_forever()
        fsrv.stop()
        return 0

    if opts.cmd == "iam":
        from ..iamapi import IamServer

        iam = IamServer(port=opts.port, filer=opts.filer)
        iam.start()
        _wait_forever()
        iam.stop()
        return 0

    if opts.cmd == "mq.broker":
        from ..mq import Broker, MqHttpServer
        from ..mq.grpc_server import MqGrpcServer
        from ..pb import rpc as _rpc

        import time

        import grpc

        broker = Broker(filer=opts.filer)
        # the filer may still be starting: wait for it rather than start
        # empty, which would write over its segments at the next flush
        deadline = time.monotonic() + 60
        while True:
            try:
                broker.load_from_filer()
                break
            except grpc.RpcError as e:
                if e.code() != grpc.StatusCode.UNAVAILABLE or \
                        time.monotonic() > deadline:
                    raise SystemExit(f"mq.broker: the filer {opts.filer} "
                                     f"answered {e.code()}")
                time.sleep(0.5)
        http = MqHttpServer(broker, port=opts.port)
        http.start()
        grpc_srv = MqGrpcServer(broker,
                                port=_rpc.derived_grpc_port(opts.port),
                                address=f"localhost:{opts.port}")
        grpc_srv.start()
        _wait_forever()
        grpc_srv.stop()
        http.stop()
        broker.flush_to_filer()
        return 0

    if opts.cmd in ("mount", "fuse"):
        from ..mount import WFS, mount
        from ..mount.control import MountControlServer
        from ..pb import rpc

        if opts.cmd == "fuse":
            o = dict(kv.partition("=")[::2] for kv in opts.o.split(",")
                     if kv)
            wfs = WFS(rpc.grpc_address(o.get("filer", "localhost:8888")),
                      chunk_size=int(o.get("chunkSizeLimitMB", 2)) << 20,
                      collection=o.get("collection", ""),
                      replication=o.get("replication", ""),
                      cache_dir=o.get("cacheDir") or None)
            local_port = 0
        else:
            wfs = WFS(rpc.grpc_address(opts.filer),
                      chunk_size=opts.chunkSizeLimitMB << 20,
                      collection=opts.collection,
                      replication=opts.replication,
                      cache_dir=opts.cacheDir or None,
                      memory_limit_mb=opts.memoryLimitMB)
            local_port = opts.localPort
        # the control socket of the mount point (and -localPort): the
        # shell's mount.configure sets the quota through it
        control = MountControlServer(wfs, mount_dir=opts.dir,
                                     port=local_port)
        control.start()
        try:
            # serves until unmounted or SIGINT/SIGTERM; a shim that does
            # not build or a mount libfuse refuses fails the command
            mount(wfs, opts.dir)
        finally:
            control.stop()
            wfs.close()
        return 0

    if opts.cmd == "benchmark":
        from .benchmark import run_benchmark

        run_benchmark(opts)
        return 0

    if opts.cmd == "upload":
        import json

        from ..operation import submit

        for path in opts.files:
            with open(path, "rb") as f:
                data = f.read()
            res = submit(opts.master, data, filename=path,
                         collection=opts.collection,
                         replication=opts.replication, ttl=opts.ttl)
            print(json.dumps({"file": path, **res}))
        return 0

    if opts.cmd == "download":
        import requests

        from ..wdclient import MasterClient

        urls = MasterClient(opts.master).lookup_file_id(opts.fid)
        r = requests.get(urls[0], timeout=60)
        r.raise_for_status()
        if opts.output == "-":
            sys.stdout.buffer.write(r.content)
        else:
            with open(opts.output, "wb") as f:
                f.write(r.content)
        return 0

    if opts.cmd == "volume":
        from ..models.coder import new_coder
        from ..server.volume import VolumeServer

        dirs = opts.dir.split(",")
        maxes = [int(x) for x in opts.max.split(",")]
        if len(maxes) == 1:
            maxes = maxes * len(dirs)
        # cuda: the Store builds new_coder() itself, on the card
        coder = (None if opts.coder == "cuda"
                 else new_coder(backend=opts.coder))
        tier_conf = _tier_config(opts.tierConfig)
        from ..security import Guard
        from ..utils.config import load_security_config

        sec = load_security_config()
        guard = Guard(whitelist=sec["whitelist"]) if sec["whitelist"] \
            else None
        if opts.native == "auto" and (sec["write_key"] or guard is not None):
            use_native = False  # python handlers own auth: skip the probe
        else:
            use_native = _use_native_plane("volume", opts.native)
        try:
            vsrv = VolumeServer(directories=dirs, master=opts.mserver,
                                ip=opts.ip, port=opts.port,
                                data_center=opts.dataCenter, rack=opts.rack,
                                max_volume_counts=maxes, coder=coder,
                                tier_backends=tier_conf,
                                needle_map_kind=("sqlite"
                                                 if opts.index != "memory"
                                                 else "memory"),
                                write_jwt_key=sec["write_key"],
                                guard=guard, native=use_native)
        except (RuntimeError, NotImplementedError) as e:
            # no CUDA device for -coder cuda, or an option the port does
            # not carry: fail at start, never fall back
            raise SystemExit(f"volume: {e}")
        vsrv.start()
        _wait_forever()
        vsrv.stop()
        return 0

    if opts.cmd == "master.follower":
        from ..server.master import MasterServer

        ms = MasterServer(ip=opts.ip, port=opts.port,
                          peers=[p.strip() for p in opts.peers.split(",")
                                 if p.strip()],
                          raft_dir=opts.mdir or None)
        ms.start()
        _wait_forever()
        ms.stop()
        return 0

    if opts.cmd == "unautocomplete":
        print("complete -r weed-tpu 2>/dev/null  # remove bash completion")
        return 0

    if opts.cmd == "autocomplete":
        cmds = " ".join(sorted(
            c for c in ("master volume filer s3 webdav iam mq.broker "
                        "server shell mount upload download benchmark "
                        "backup compact fix export filer.sync "
                        "filer.replicate filer.backup filer.cat filer.copy "
                        "filer.meta.tail filer.meta.backup "
                        "filer.remote.sync filer.remote.gateway "
                        "master.follower version scaffold fuse "
                        "unautocomplete update").split()))
        print(f"""# bash completion for weed-tpu
_weed_tpu() {{
  local cur=${{COMP_WORDS[COMP_CWORD]}}
  COMPREPLY=( $(compgen -W "{cmds}" -- "$cur") )
}}
complete -F _weed_tpu weed-tpu""")
        return 0

    if opts.cmd == "update":
        print("this build installs from source; update with "
              "`git pull` in the repository checkout")
        return 0

    if opts.cmd in ("backup", "compact", "fix", "export"):
        from . import tools

        return {"backup": tools.run_backup, "compact": tools.run_compact,
                "fix": tools.run_fix, "export": tools.run_export}[opts.cmd](
                    opts)

    if opts.cmd == "scaffold":
        from .scaffold import print_scaffold

        print_scaffold(opts.config)
        return 0

    raise SystemExit(f"unknown command {opts.cmd}")
