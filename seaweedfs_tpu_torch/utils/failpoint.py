"""Failpoint registry: named fault-injection points for chaos testing.

The reference has no first-class failpoints (its docker-compose chaos
relies on killing containers); this build threads explicit injection
points through every cluster plane — volume-server HTTP read/write,
the gRPC stub layer (pb/rpc.py), filer-store mutations, the
replication sink, and the EC shard-read path — so the chaos suite
can exercise degraded modes inside one process
deterministically.

A failpoint is evaluated by name at its injection site:

    failpoint.fail("volume.http.read", ctx=srv.address)      # may raise
    failpoint.delay("filer.store.mutate")                    # may sleep
    data = failpoint.corrupt("ec.shard.read", data)          # may flip bits

All three verbs are no-ops (nanoseconds: one dict probe on an empty
registry) unless the name was armed, either programmatically:

    with failpoint.active("volume.http.read", p=0.2, match="8081"):
        ...

or via the environment for subprocess stacks (parsed once at import):

    SWFS_FAILPOINTS="volume.http.read=error(0.2);pb.Assign=error(1.0x2)"

Spec grammar: `<name>=<mode>(<p>[x<count>])[@<match>]` joined by `;`.
Modes: `error` (raise FailpointError), `delay` (sleep p seconds),
`corrupt` (XOR 0xFF into the payload's first byte), `crash` (die at
the site: SIGKILL-self, subprocess-only — see below), `torn` (write a
random prefix of the buffer durably, then crash; honored only by the
`storage/backend.py` append site). `x<count>` bounds
how many times the point triggers (default unlimited); `@<match>`
requires the substring to appear in the site-supplied ctx, so one
replica out of many can be targeted inside a shared process. A match
may be an `|`-joined list of alternatives (`@shard=0,|shard=1,`), any
one of which arms the point — how the chaos suite "loses" a specific
set of EC shards with a single spec. Because `;` separates spec items
and `|` separates alternatives, ctx strings at injection sites must
never rely on either character: sites comma-terminate both addresses
(`localhost:1234,`) and shard ids (`shard=7,`) precisely so a match
for port 1234 or shard 1 cannot substring-hit port 12345 or shard 10,
while staying expressible through the env.

Crash semantics (kill-anywhere injection): a `crash`-mode
point turns ANY armed site — volume.dat.write, ec.stream.slab,
filer.store.mutate, every pb.<Method> — into a process-death site.
Because SIGKILL-ing the pytest process would take the whole suite
down, actual self-kill is gated on SWFS_CRASH_OK=1 (set only by
harness-spawned server subprocesses); everywhere else the point
degrades to raising FailpointError, which emulates "the process never
got past this instruction" for in-process unit tests while keeping
the anti-vacuous-pass convention. `torn` is crash's evil twin for the
append path: the site writes a random strict prefix of the buffer,
fsyncs it (a tear that isn't durable isn't observable), then crashes.
"""

from __future__ import annotations

import os
import random
import signal
import sys
import threading
import time


class FailpointError(IOError):
    """Raised by an armed `error` failpoint; sites translate it to their
    plane's native failure (HTTP 500, gRPC UNAVAILABLE, store IOError)."""

    def __init__(self, name: str):
        self.failpoint = name
        super().__init__(f"failpoint {name!r} injected failure")


class _Failpoint:
    __slots__ = ("name", "mode", "p", "count", "match", "hits", "rng")

    def __init__(self, name: str, mode: str, p: float, count: int,
                 match: str, seed: int | None):
        if mode not in ("error", "delay", "corrupt", "crash", "torn"):
            raise ValueError(f"unknown failpoint mode {mode!r}")
        self.name = name
        self.mode = mode
        self.p = p
        self.count = count  # remaining triggers; -1 = unlimited
        self.match = match
        self.hits = 0  # times the fault actually fired
        # dedicated RNG so an armed point is reproducible under -p no:randomly
        self.rng = random.Random(seed)

    def should_trigger(self, ctx: str) -> bool:
        if self.match and not any(m in ctx
                                  for m in self.match.split("|")):
            return False
        if self.count == 0:
            return False
        if self.mode != "delay" and self.p < 1.0 \
                and self.rng.random() >= self.p:
            return False
        if self.count > 0:
            self.count -= 1
        self.hits += 1
        return True


_registry: dict[str, _Failpoint] = {}
_lock = threading.Lock()


def configure(name: str, *, mode: str = "error", p: float = 1.0,
              count: int = -1, match: str = "",
              seed: int | None = None) -> None:
    """Arm `name`. For mode='delay', `p` is the sleep in seconds."""
    with _lock:
        _registry[name] = _Failpoint(name, mode, p, count, match, seed)


def clear(name: str | None = None) -> None:
    with _lock:
        if name is None:
            _registry.clear()
        else:
            _registry.pop(name, None)


def is_armed(name: str) -> bool:
    return name in _registry


def hits(name: str) -> int:
    fp = _registry.get(name)
    return fp.hits if fp is not None else 0


class active:
    """Context manager arming a failpoint for a test block."""

    def __init__(self, name: str, **kwargs):
        self.name = name
        self.kwargs = kwargs

    def __enter__(self):
        configure(self.name, **self.kwargs)
        return self

    @property
    def hits(self) -> int:
        return hits(self.name)

    def __exit__(self, *exc):
        clear(self.name)
        return False


def crash_allowed() -> bool:
    """True only when this process has opted into actual self-kill
    (harness-spawned server subprocesses export SWFS_CRASH_OK=1)."""
    return os.environ.get("SWFS_CRASH_OK", "").lower() in (
        "1", "true", "on")


def crash_self(name: str) -> None:
    """Die at an armed crash site — SIGKILL-self so no atexit handler,
    finally block, or flush runs (the whole point: model the kernel
    yanking the process at this exact instruction). In-process test
    stacks (no SWFS_CRASH_OK) degrade to FailpointError: "the process
    never executed past here" without killing the test runner."""
    if not crash_allowed():
        raise FailpointError(name)
    try:
        sys.stderr.write(f"swfs.failpoint.crash: {name}\n")
        sys.stderr.flush()
    except (OSError, ValueError, AttributeError):
        pass  # closed or absent stderr: the process dies all the same
    try:
        os.kill(os.getpid(), signal.SIGKILL)
    except OSError:
        pass
    os._exit(137)  # unreachable after SIGKILL; belt-and-braces


# -- injection-site verbs --------------------------------------------------

def fail(name: str, *, ctx: str = "") -> None:
    """Raise FailpointError when an `error`-mode point triggers; also
    honors delay-mode sleeps and crash-mode death so a single site
    serves error, delay and crash arms."""
    fp = _registry.get(name)
    if fp is None:
        return
    with _lock:
        triggered = fp.should_trigger(ctx)
    if not triggered:
        return
    if fp.mode == "delay":
        time.sleep(fp.p)
        return
    if fp.mode == "crash":
        crash_self(name)
    if fp.mode == "error":
        raise FailpointError(name)
    # corrupt/torn-mode points armed on a fail-only site degrade to
    # errors: silently ignoring the arm would make a typo'd test
    # vacuously pass
    raise FailpointError(name)


def delay(name: str, *, ctx: str = "") -> None:
    fp = _registry.get(name)
    if fp is None or fp.mode not in ("delay", "crash"):
        return
    with _lock:
        triggered = fp.should_trigger(ctx)
    if not triggered:
        return
    if fp.mode == "crash":
        crash_self(name)
    time.sleep(fp.p)


def corrupt(name: str, data: bytes, *, ctx: str = "") -> bytes:
    """Flip the first byte when a `corrupt`-mode point triggers (enough
    to break any CRC/tag without hiding length bugs). Crash-mode arms
    die here instead — every corrupt site is also a kill site."""
    fp = _registry.get(name)
    if fp is None or not data \
            or fp.mode not in ("corrupt", "crash"):
        return data
    with _lock:
        triggered = fp.should_trigger(ctx)
    if not triggered:
        return data
    if fp.mode == "crash":
        crash_self(name)
    return bytes([data[0] ^ 0xFF]) + data[1:]


def torn(name: str, data: bytes, *, ctx: str = "") -> int | None:
    """Torn-write probe for append sites: when a `torn`-mode point
    triggers, return the number of prefix bytes the site should write
    before crashing (0 <= cut < len(data) — possibly nothing at all);
    None means proceed normally. The SITE owns the mechanics (write
    prefix, fsync, then call crash_self) because only it holds the
    file descriptor; see DiskFile.append."""
    fp = _registry.get(name)
    if fp is None or fp.mode != "torn" or not data:
        return None
    with _lock:
        triggered = fp.should_trigger(ctx)
    if not triggered:
        return None
    return fp.rng.randrange(0, len(data))


# -- SWFS_FAILPOINTS env bootstrap (subprocess server stacks) --------------

def load_env(spec: str | None = None) -> None:
    """Parse `name=mode(p[xcount])[@match];...` and arm each point."""
    spec = spec if spec is not None else os.environ.get("SWFS_FAILPOINTS", "")
    for item in filter(None, (s.strip() for s in spec.split(";"))):
        name, _, rhs = item.partition("=")
        rhs, _, match = rhs.partition("@")
        mode, _, args = rhs.rstrip(")").partition("(")
        p, count = 1.0, -1
        if args:
            ps, _, cs = args.partition("x")
            p = float(ps or 1.0)
            count = int(cs) if cs else -1
        configure(name.strip(), mode=mode.strip() or "error", p=p,
                  count=count, match=match.strip())


load_env()
