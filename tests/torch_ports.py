"""Ports for the port's tests that serve over loopback.

Every server of these tests listens on a port P below the kernel's
ephemeral range and on its twins P + 10000 (gRPC) and P + 11000 (the
Python listener behind the C++ plane). A picker checks that its ports
are free and releases them before the server binds, so two pytest-xdist
workers that check at the same moment could be handed the same port;
the gRPC twin binds with SO_REUSEPORT, so the second server would then
share it silently. `draw` gives each worker its own residues modulo
1000: two ports drawn by different workers never differ by a multiple
of 1000, so neither a port nor any of its twins can meet another
worker's.
"""

import os


def worker_share() -> tuple[int, int]:
    """(this worker's index, the number of workers); (0, 1) without
    xdist."""
    n = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)
    name = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    i = int(name[2:]) if name[2:].isdigit() else 0
    return i % max(n, 1), max(n, 1)


def draw(rng, lo: int, hi: int, width: int = 1) -> int:
    """A port p with lo <= p and p + width <= hi, whose run of `width`
    ports lies inside this worker's residues modulo 1000."""
    i, n = worker_share()
    r_lo, r_hi = i * 1000 // n, (i + 1) * 1000 // n
    if r_hi - r_lo < width:  # more workers than the run fits: any residue
        r_lo, r_hi = 0, 1000
    while True:
        port = rng.randrange(lo // 1000, hi // 1000 + 1) * 1000 \
            + rng.randrange(r_lo, r_hi - width + 1)
        if lo <= port and port + width <= hi:
            return port
