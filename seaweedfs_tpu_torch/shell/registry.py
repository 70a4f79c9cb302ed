"""Shell command registry + REPL runner (counterpart of
seaweedfs_tpu/shell/registry.py; SeaweedFS weed/shell/commands.go)."""

from __future__ import annotations

import shlex
import sys

COMMANDS: dict[str, tuple] = {}  # name -> (fn, help)


def command(name: str, help_: str = ""):
    def deco(fn):
        COMMANDS[name] = (fn, help_)
        return fn
    return deco


def run_command(env, line: str, out=None) -> int:
    out = out or sys.stdout
    parts = shlex.split(line.strip())
    if not parts:
        return 0
    name, args = parts[0], parts[1:]
    if name in ("help", "?"):
        for n in sorted(COMMANDS):
            print(f"  {n:32s} {COMMANDS[n][1]}", file=out)
        return 0
    entry = COMMANDS.get(name)
    if entry is None:
        print(f"unknown command: {name} (try `help`)", file=out)
        return 1
    try:
        entry[0](env, args, out)
        return 0
    except Exception as e:  # noqa: BLE001 - REPL surfaces, doesn't crash
        print(f"error: {e}", file=out)
        return 1


def repl(env) -> None:
    """Interactive admin shell (`weed shell`)."""
    from . import commands  # noqa: F401 - ensure registration

    print("seaweedfs-tpu-torch shell; `help` lists commands, `exit` quits")
    while True:
        try:
            line = input("> ")
        except (EOFError, KeyboardInterrupt):
            print()
            break
        if line.strip() in ("exit", "quit"):
            break
        run_command(env, line)


def kv_flags(args) -> dict:
    """Shared '-k=v' / bare '-flag' parser for simple commands (richer
    commands use argparse)."""
    out = {}
    for a in args:
        if a.startswith("-"):
            k, _, v = a[1:].partition("=")
            out[k] = v
    return out


_DURATION_UNITS = {"s": 1, "m": 60, "h": 3600, "d": 86400}


def parse_duration(spec: str, *, flag: str = "duration") -> float:
    """'90s' / '15m' / '24h' / '7d' -> seconds; a bare number or anything
    unparsable is an error (silent unit guessing misreads operator intent)."""
    spec = (spec or "").strip()
    if len(spec) >= 2 and spec[-1] in _DURATION_UNITS:
        try:
            return float(spec[:-1]) * _DURATION_UNITS[spec[-1]]
        except ValueError:
            pass
    raise RuntimeError(
        f"bad {flag} {spec!r}: use <number><unit> with unit one of s/m/h/d")


# importing the command modules registers them
from . import commands  # noqa: E402,F401

