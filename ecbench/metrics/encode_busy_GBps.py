"""`.dat` bytes of the slabs that completed inside the window, over the
seconds in which the card was busy in it (the union of every kernel, copy
and memset interval of the device trace), all volumes together: what the
card spends on each GB encoded, whatever the host's pace."""


def read(r, variant):
    if r.op != "encode" or r.trace is None:
        return None
    busy = r.trace.busy_s()
    if busy <= 0:
        return None
    return r.bytes / busy / 1e9
