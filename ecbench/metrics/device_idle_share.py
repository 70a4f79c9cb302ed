"""Share of the traced window in which nothing ran on the card: one less
the union of every kernel, copy and memset interval over the window,
in %."""


def read(r, variant):
    if r.trace is None or r.op != variant:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
