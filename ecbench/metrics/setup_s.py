"""Seconds from the process's start to the window's open: imports, the
card's context, the seeded volumes, the kernels' load (or build) and one
warm round of every stream."""


def read(r, variant):
    return r.setup_s
