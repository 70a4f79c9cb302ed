"""`.dat` bytes of the slabs that completed inside the window, over the
window's seconds (host clock), all volumes together: the pace that the
host sets (`encode_GBps.wall`)."""


def read(r, variant):
    if r.op != "encode":
        return None
    return r.bytes / r.seconds / 1e9
