"""Named, rank-registered lock witness: FreeBSD `witness(4)` style
runtime lock-order checking.

A copy of seaweedfs_tpu/utils/locks.py, so the port's concurrency code
is held to the same discipline (same lock names, same ranks). A static
lock-graph pass proves what it can see lexically; this module catches
what only execution order shows: two threads acquiring the same two
locks in opposite orders through paths no single function exhibits.

Usage: the hot modules construct locks through the factories:

    from .locks import wlock, wrlock, wcondition
    self._mu = wlock("dispatch.mu", rank=100)
    self._cv = wcondition("dispatch.lane_cv", rank=200)
    self._arena_mu = wlock("dispatch.arena", rank=800)

Gate: `SWFS_LOCK_WITNESS=1` **at construction time** (the test suite
arms it in tests/conftest.py before any package import). When the gate
is off the factories return PLAIN `threading.Lock/RLock/Condition`
objects: the disabled path is a no-op, not a cheap wrapper.

When armed, each acquisition is checked against:

* **ranks**: a lock with a rank may only be acquired while every held
  RANKED lock has a strictly smaller rank (unranked locks don't
  constrain ranked ones and vice versa);
* **observed order**: the first `A -> B` nesting seen anywhere records
  the edge; a later acquisition implying `B -> A` (any path back
  through the observed-edge graph, from ANY thread) is an inversion.

Violations are RECORDED (`violations()`), never raised: raising inside
a daemon thread would be swallowed by a broad except. The port's tests
assert zero recorded violations after their concurrent scenarios.

Re-entry: `wrlock` re-entry by the owning thread is invisible to the
witness (only the outermost acquire/release is tracked). Two DISTINCT
locks sharing a name (per-instance locks of one class) never form
same-name edges.

`threading.Condition` support: a witness condition wraps a witness
lock, so `with cv:` and the release/re-acquire inside `cv.wait()` are
tracked through the same acquire/release notes.
"""

from __future__ import annotations

import os
import sys
import threading

__all__ = [
    "wlock", "wrlock", "wcondition", "witness_enabled", "violations",
    "clear_violations", "reset", "observed_edges", "register_rank",
    "WitnessLock", "WitnessRLock",
]


def witness_enabled() -> bool:
    return (os.environ.get("SWFS_LOCK_WITNESS", "") or "").lower() \
        in ("1", "true", "on")


# ---------------------------------------------------------------------------
# global witness state (armed builds only)

_tls = threading.local()

_state_mu = threading.Lock()        # guards the structures below
_edges: dict[str, set[str]] = {}    # observed outer -> {inner}
_edge_sites: dict[tuple[str, str], str] = {}  # first witness description
_ranks: dict[str, int | None] = {}  # registered name -> rank
_violations: list[dict] = []


def register_rank(name: str, rank: int | None) -> None:
    """Names are global; re-registering with a DIFFERENT rank is itself
    a violation (two modules disagreeing about an order is the bug)."""
    with _state_mu:
        old = _ranks.get(name, rank)
        if old != rank:
            _record({
                "kind": "rank-conflict", "name": name,
                "detail": f"rank {rank!r} re-registers {name} "
                          f"(was {old!r})"})
        _ranks.setdefault(name, rank)


def violations() -> list[dict]:
    with _state_mu:
        return list(_violations)


def clear_violations() -> None:
    """Tests that MANUFACTURE violations clear only the ledger,
    leaving the observed-edge graph and rank registry intact, so the
    rest of the suite keeps its accumulated cross-test order evidence."""
    with _state_mu:
        _violations.clear()


def observed_edges() -> dict[str, set[str]]:
    with _state_mu:
        return {k: set(v) for k, v in _edges.items()}


def reset() -> None:
    """Tests only: drop recorded violations, the observed-order graph
    (edges from one scenario must not convict the next) AND the rank
    registry — a stale name->rank binding from a prior scenario would
    manufacture phantom rank-conflicts (product locks always
    re-register with identical ranks, so clearing is safe)."""
    with _state_mu:
        _violations.clear()
        _edges.clear()
        _edge_sites.clear()
        _ranks.clear()


def _held() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _reachable(src: str, dst: str) -> list[str] | None:
    """Path src -> ... -> dst through observed edges (caller holds
    _state_mu); None when unreachable."""
    seen = {src}
    frontier = [(src, [src])]
    while frontier:
        node, path = frontier.pop()
        for nxt in _edges.get(node, ()):
            if nxt == dst:
                return path + [dst]
            if nxt not in seen:
                seen.add(nxt)
                frontier.append((nxt, path + [nxt]))
    return None


def _record(v: dict) -> None:
    """Caller holds _state_mu. Also printed immediately: a first-
    occurrence ABBA DEADLOCKS right after this check, so no test guard
    runs; the stderr line is then the only name-bearing diagnostic."""
    _violations.append(v)
    print(f"[lock-witness] {v}", file=sys.stderr, flush=True)


def _check_acquire(name: str, rank: int | None) -> None:
    """Order/rank check, run BEFORE the (possibly blocking) underlying
    acquire — FreeBSD witness style: the one inversion that actually
    deadlocks must be recorded and printed before both threads hang.
    The edge records the acquisition ATTEMPT in this order; a failed
    non-blocking acquire still expressed that intent."""
    stack = _held()
    if not stack:
        return
    tname = threading.current_thread().name
    with _state_mu:
        for _hobj, hname, hrank in stack:
            if hname == name:
                continue  # distinct instances of one named family
            if hrank is not None and rank is not None \
                    and rank <= hrank:
                _record({
                    "kind": "rank", "thread": tname,
                    "held": hname, "acquiring": name,
                    "detail": f"rank {rank} acquired under "
                              f"{hname} (rank {hrank}) — ranked "
                              f"order must strictly increase"})
            if name not in _edges.get(hname, ()):
                back = _reachable(name, hname)
                if back is not None:
                    _record({
                        "kind": "inversion", "thread": tname,
                        "held": hname, "acquiring": name,
                        "detail": (f"{hname} -> {name} inverts "
                                   f"observed order "
                                   f"{' -> '.join(back)} (first "
                                   f"seen: "
                                   f"{_edge_sites.get((back[0], back[1]), '?')})"),
                    })
                _edges.setdefault(hname, set()).add(name)
                _edge_sites.setdefault(
                    (hname, name), f"thread {tname}")


def _note_acquire(obj: object, name: str, rank: int | None) -> None:
    """Push AFTER a successful acquire (the order check already ran)."""
    _held().append((id(obj), name, rank))


def _note_release(obj: object) -> None:
    stack = _held()
    oid = id(obj)
    for i in range(len(stack) - 1, -1, -1):
        if stack[i][0] == oid:
            del stack[i]
            return


# ---------------------------------------------------------------------------
# wrappers (armed builds only — the factories below return plain
# threading primitives when the witness is off)

class WitnessLock:
    __slots__ = ("_lk", "name", "rank")

    def __init__(self, name: str, rank: int | None = None,
                 _factory=threading.Lock):
        self._lk = _factory()
        self.name = name
        self.rank = rank
        register_rank(name, rank)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _check_acquire(self.name, self.rank)  # BEFORE a blocking wait
        got = self._lk.acquire(blocking, timeout)
        if got:
            _note_acquire(self, self.name, self.rank)
        return got

    def release(self) -> None:
        self._lk.release()
        _note_release(self)

    def locked(self) -> bool:
        return self._lk.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def _is_owned(self) -> bool:
        """threading.Condition ownership probe. Without this, Condition
        falls back to probing via acquire(False) on the WRAPPER — and
        that probe would run the witness order check against whatever
        else the thread holds, recording phantom rank/inversion
        violations on correctly-ordered code (notify/wait both probe).
        Probe the raw lock directly; the witness never sees it."""
        if self._lk.acquire(False):
            self._lk.release()
            return False
        return True

    def __repr__(self) -> str:
        return f"<WitnessLock {self.name} rank={self.rank}>"


class WitnessRLock:
    """Re-entrant witness lock: only the OUTERMOST acquire/release per
    thread is witnessed (re-entry is legal and order-neutral)."""

    __slots__ = ("_lk", "name", "rank", "_depth")

    def __init__(self, name: str, rank: int | None = None):
        self._lk = threading.RLock()
        self.name = name
        self.rank = rank
        self._depth = threading.local()
        register_rank(name, rank)

    def _d(self) -> int:
        return getattr(self._depth, "n", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._d() == 0:
            _check_acquire(self.name, self.rank)
        got = self._lk.acquire(blocking, timeout)
        if got:
            n = self._d()
            self._depth.n = n + 1
            if n == 0:
                _note_acquire(self, self.name, self.rank)
        return got

    def release(self) -> None:
        self._lk.release()
        n = self._d() - 1
        self._depth.n = n
        if n == 0:
            _note_release(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # threading.Condition(lock=...) integration: Condition leans on
    # these when the wrapped lock provides them
    def _is_owned(self) -> bool:
        return self._d() > 0

    def _release_save(self):
        """Fully release (drop re-entrant depth), witness included."""
        n = self._d()
        self._depth.n = 0
        _note_release(self)
        state = self._lk._release_save()  # noqa: SLF001
        return (state, n)

    def _acquire_restore(self, saved) -> None:
        state, n = saved
        _check_acquire(self.name, self.rank)
        self._lk._acquire_restore(state)  # noqa: SLF001
        self._depth.n = n
        _note_acquire(self, self.name, self.rank)

    def __repr__(self) -> str:
        return f"<WitnessRLock {self.name} rank={self.rank}>"


# ---------------------------------------------------------------------------
# factories

def wlock(name: str, rank: int | None = None):
    """A named mutex: witness-tracked when SWFS_LOCK_WITNESS is armed,
    a plain `threading.Lock()` (zero overhead) otherwise."""
    if not witness_enabled():
        return threading.Lock()
    return WitnessLock(name, rank)


def wrlock(name: str, rank: int | None = None):
    if not witness_enabled():
        return threading.RLock()
    return WitnessRLock(name, rank)


def wcondition(name: str, rank: int | None = None, lock=None):
    """A named condition. When armed, the underlying lock is witnessed
    (enter/exit AND the release/re-acquire inside wait()). Pass `lock`
    to share an existing lock, Condition-style: a witness lock keeps
    its own name/rank (re-registering it under the condition's rank
    would manufacture a rank-conflict); a plain threading lock is
    wrapped so acquisitions THROUGH the condition are witnessed under
    `name` (direct raw-lock users stay invisible — partial coverage,
    never a false positive)."""
    if not witness_enabled():
        return threading.Condition(lock)
    if lock is None:
        lock = WitnessRLock(name, rank)
    elif not isinstance(lock, (WitnessLock, WitnessRLock)):
        raw = lock
        lock = WitnessLock(name, rank, _factory=lambda: raw)
    return threading.Condition(lock)
