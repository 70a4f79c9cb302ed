"""CLI: the `weed` binary (counterpart of seaweedfs_tpu/command/__init__.py;
SeaweedFS weed/weed.go:47, weed/command/command.go:11-45). Run as
`python -m seaweedfs_tpu_torch <cmd>`.

Subcommands: master, volume, filer, s3, server (master + volume, and a
filer with -filer, a filer and an S3 gateway with -s3, in one process),
shell, upload, download, benchmark, version. The volume servers' erasure
coder is the CUDA card by default (`-coder cuda`): without one they fail
at start, and nothing falls back to the CPU unless `-coder cpu` (numpy)
or `-coder native` (g++) asks for it. The other gateways, the filer's
sync, replicate, backup and remote tools, the master's Raft group
(`-peers`), the compiled benchmark client (`benchmark -filer`,
`-nativeClient`) and the offline tools are not part of the port yet:
their commands and flags fail at start, naming the ROADMAP.md item that
will port them (`DEFERRED`).
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

ROADMAP_RAFT = "ROADMAP.md A2d (master Raft: -peers)"
ROADMAP_GATEWAYS = "ROADMAP.md A2d (other gateways)"
ROADMAP_FILER_TOOLS = "ROADMAP.md A2d (filer tools)"
ROADMAP_REMOTE = "ROADMAP.md A2d (remote_storage)"
ROADMAP_OFFLINE = "ROADMAP.md A2d (offline tools)"

#: the reference's subcommands the port does not carry yet, each with
#: the ROADMAP.md item that will port it
DEFERRED = {
    **{c: ROADMAP_GATEWAYS for c in ("webdav", "ftp", "iam", "mq.broker",
                                     "mount", "fuse")},
    **{c: ROADMAP_FILER_TOOLS for c in (
        "filer.sync", "filer.replicate", "filer.backup", "filer.cat",
        "filer.copy", "filer.meta.tail", "filer.meta.backup")},
    **{c: ROADMAP_REMOTE for c in ("filer.remote.sync",
                                   "filer.remote.gateway")},
    "master.follower": ROADMAP_RAFT,
    **{c: ROADMAP_OFFLINE for c in ("backup", "compact", "fix", "export",
                                    "scaffold", "autocomplete",
                                    "unautocomplete", "update")},
}


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
                    help="comma-separated master peers for Raft HA (not "
                         "part of the port yet: a non-empty value fails "
                         "at start)")
    mp.add_argument("-mdir", default="",
                    help="directory for Raft state persistence (used only "
                         "with -peers)")
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
                    help="JSON file of tier backends (tiered storage is "
                         "not part of the port yet: a non-empty value "
                         "fails at start)")
    vp.add_argument("-nativeDataPlane", dest="native", default="auto",
                    nargs="?", const="on", choices=["auto", "on", "off"],
                    help="the C++ needle data plane is not part of the "
                         "port: auto = off, on fails at start")
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
                    help="metadata store kind (memory|sqlite|leveldb); the "
                         "reference's network stores are not part of the "
                         "port yet and fail at start")
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
                    help="the C++ needle data plane is not part of the "
                         "port: auto = off, on fails at start")

    shp = sub.add_parser("shell", help="admin shell (commands on stdin)")
    shp.add_argument("-master", default="localhost:9333")
    shp.add_argument("-filer", default="",
                     help="filer address for the fs.* commands")

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
                    help="the compiled C++ client loop (not part of the "
                         "port yet: fails at start)")
    bp.add_argument("-filer", default="",
                    help="whole-object PUT/GET through this filer with the "
                         "compiled client (not part of the port yet: a "
                         "non-empty value fails at start)")

    sub.add_parser("version", help="print version")
    # registered so that global flags before them parse; they refuse below
    for name, item in DEFERRED.items():
        sub.add_parser(name, add_help=False, help=f"refuses: {item}")

    opts, _ = p.parse_known_args(argv)
    if opts.cmd in DEFERRED:
        raise SystemExit(f"{opts.cmd} is not part of the PyTorch port yet: "
                         f"{DEFERRED[opts.cmd]}")
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


def _wait_forever():
    ev = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: ev.set())
    ev.wait()


def _run(opts) -> int:
    if opts.cmd == "version":
        from .. import __version__

        print(f"seaweedfs-tpu-torch {__version__}")
        return 0

    if opts.cmd == "master":
        from ..server.master import MasterServer
        from ..utils.config import load_security_config

        sec = load_security_config()
        try:
            ms = MasterServer(ip=opts.ip, port=opts.port,
                              volume_size_limit_mb=opts.volumeSizeLimitMB,
                              default_replication=opts.defaultReplication,
                              garbage_threshold=opts.garbageThreshold,
                              peers=[p.strip() for p in opts.peers.split(",")
                                     if p.strip()] or None,
                              metrics_address=opts.metricsAddress,
                              metrics_interval_sec=opts.metricsIntervalSec,
                              write_jwt_key=sec["write_key"],
                              jwt_expires_sec=sec["expires_sec"])
        except NotImplementedError as e:
            raise SystemExit(f"master: {e}")
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
        try:
            # the volume server first: without a card it fails before the
            # master binds anything
            vsrv = VolumeServer(directories=opts.dir.split(","),
                                master=f"{opts.ip}:{opts.master_port}",
                                ip=opts.ip, port=opts.volume_port,
                                coder=coder,
                                native=opts.volume_native == "on")
        except (RuntimeError, NotImplementedError) as e:
            raise SystemExit(f"server: {e}")
        fs = None
        if opts.filer or opts.s3:
            from ..server.filer import FilerServer

            try:
                fs = FilerServer(ip=opts.ip, port=opts.filer_port,
                                 master=f"{opts.ip}:{opts.master_port}",
                                 store_dir=opts.dir.split(",")[0] + "/filer")
            except (ValueError, NotImplementedError) as e:
                vsrv.stop()  # nothing bound yet; the store lifts its marker
                raise SystemExit(f"server: {e}")
        ms = MasterServer(ip=opts.ip, port=opts.master_port)
        ms.start()
        vsrv.start()
        stoppers = [vsrv.stop, ms.stop]
        if fs is not None:
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
        except (ValueError, NotImplementedError) as e:
            # a store, or a notification queue, the port does not carry:
            # fail at start, never fall back
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

    if opts.cmd == "benchmark":
        from .benchmark import run_benchmark

        try:
            run_benchmark(opts)
        except NotImplementedError as e:
            raise SystemExit(f"benchmark: {e}")
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
        tier_conf = None
        if opts.tierConfig:
            import json as _json

            with open(opts.tierConfig) as f:
                tier_conf = _json.load(f)
        from ..security import Guard
        from ..utils.config import load_security_config

        sec = load_security_config()
        guard = Guard(whitelist=sec["whitelist"]) if sec["whitelist"] \
            else None
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
                                guard=guard, native=opts.native == "on")
        except (RuntimeError, NotImplementedError) as e:
            # no CUDA device for -coder cuda, or an option the port does
            # not carry: fail at start, never fall back
            raise SystemExit(f"volume: {e}")
        vsrv.start()
        _wait_forever()
        vsrv.stop()
        return 0

    raise SystemExit(f"unknown command {opts.cmd}")
