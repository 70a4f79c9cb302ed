"""CLI: the `weed` binary's volume subcommand (counterpart of
seaweedfs_tpu/command/__init__.py; SeaweedFS weed/weed.go:47,
weed/command/command.go:11-45). Run as
`python -m seaweedfs_tpu_torch volume -dir <dirs> -mserver <master>`.

Subcommands: volume, version. The master, filer, S3, shell and the
offline tools of the reference's CLI are not part of the port yet.
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

    vp = sub.add_parser("volume", help="run a volume server")
    vp.add_argument("-dir", default="./data", help="comma-separated data dirs")
    vp.add_argument("-max", default="8", help="comma-separated max volume counts")
    vp.add_argument("-ip", default="localhost")
    vp.add_argument("-port", type=int, default=8080)
    vp.add_argument("-mserver", default="localhost:9333")
    vp.add_argument("-dataCenter", default="")
    vp.add_argument("-rack", default="")
    vp.add_argument("-coder", default="cuda", choices=["cuda", "cpu"],
                    help="erasure coder: cuda = the hand-written kernels on "
                         "the CUDA device (fails at start without one), "
                         "cpu = the numpy table codec")
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

    sub.add_parser("version", help="print version")

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

    if opts.cmd == "volume":
        from ..models.coder import new_coder
        from ..server.volume import VolumeServer

        dirs = opts.dir.split(",")
        maxes = [int(x) for x in opts.max.split(",")]
        if len(maxes) == 1:
            maxes = maxes * len(dirs)
        # cuda: the Store builds new_coder() itself, on the card
        coder = None if opts.coder == "cuda" else new_coder(backend="cpu")
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
