"""Share of the traced window in which a memory copy (host to device or
device to host) ran on the card: the union of the trace's memcpy
intervals over the window, in %."""

from ecbench import trace as tr


def read(r, variant):
    if r.trace is None or r.op != variant:
        return None
    busy = r.trace.busy_s(kinds=(tr.MEMCPY,))
    if busy <= 0:
        return None
    return 100.0 * busy / r.trace.window_s
