"""Leveled logging in the style of the reference's vendored glog
(SeaweedFS weed/glog/glog.go:985-1052): `v(n, ...)` verbosity gates,
severity helpers, and per-module verbosity overrides (-vmodule).

Implemented over the stdlib logging machinery rather than a glog port — one
process-wide logger with a glog-format formatter.
"""

from __future__ import annotations

import fnmatch
import inspect
import logging
import os
import sys
import threading

_LOG = logging.getLogger("seaweedfs_tpu")
_handler = logging.StreamHandler(sys.stderr)
_handler.setFormatter(logging.Formatter(
    "%(levelname).1s%(asctime)s.%(msecs)03d %(process)d %(module)s] %(message)s",
    datefmt="%m%d %H:%M:%S",
))
_LOG.addHandler(_handler)
_LOG.setLevel(logging.INFO)
_LOG.propagate = False

_verbosity = int(os.environ.get("WEED_V", "0"))
_vmodule: dict[str, int] = {}
_mu = threading.Lock()


def set_verbosity(level: int) -> None:
    global _verbosity
    _verbosity = level


def set_vmodule(spec: str) -> None:
    """"pattern=N,pattern2=M" per-module verbosity (glog -vmodule)."""
    with _mu:
        _vmodule.clear()
        for part in spec.split(","):
            if "=" in part:
                pat, n = part.rsplit("=", 1)
                _vmodule[pat.strip()] = int(n)


def _module_verbosity() -> int:
    if not _vmodule:
        return _verbosity
    frame = inspect.currentframe()
    try:
        caller = frame.f_back.f_back
        mod = os.path.splitext(os.path.basename(caller.f_code.co_filename))[0]
        with _mu:
            for pat, n in _vmodule.items():
                if fnmatch.fnmatch(mod, pat):
                    return n
    finally:
        del frame
    return _verbosity


def v(level: int, msg: str, *args) -> None:
    if level <= _module_verbosity():
        _LOG.info(msg, *args, stacklevel=2)


def info(msg: str, *args) -> None:
    _LOG.info(msg, *args, stacklevel=2)


def warning(msg: str, *args) -> None:
    _LOG.warning(msg, *args, stacklevel=2)


def error(msg: str, *args) -> None:
    _LOG.error(msg, *args, stacklevel=2)


def fatal(msg: str, *args) -> None:
    _LOG.critical(msg, *args, stacklevel=2)
    raise SystemExit(1)
