"""Of the traced window's device-idle time (the gaps between the merged
kernel, memcpy and memset intervals), the share that falls inside an
`ec.dispatch.section` interval of the encode lane, in %: the card idle
while the scheduler's serial section packed, copied or launched. The rest
is idle time with no flush under way.

The section's intervals come from the program's phase ring
(seaweedfs_tpu_torch.utils.trace.phase_intervals, perf_counter seconds)
and are mapped onto the profiler's clock through the trace's clock mark.
Nothing is read without the ring, or when the ring no longer reaches
back to the window's open."""

from ecbench import trace as tr

SECTION = "ec.dispatch.section"


def overlap(a, b) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def read(r, variant):
    if r.trace is None or r.op != "encode" or variant != "encode":
        return None
    from seaweedfs_tpu_torch.utils import trace as program_trace

    intervals = getattr(program_trace, "phase_intervals", None)
    if intervals is None:
        return None
    s = r.trace
    sections, whole = intervals(SECTION, variant, s.lo / 1e6 + s.to_host,
                                s.hi / 1e6 + s.to_host)
    if not whole:
        return None
    idle = tr.gaps(tr.merge((e.start, e.end) for e in s.events), s.lo, s.hi)
    idle_us = sum(e - a for a, e in idle)
    if idle_us <= 0:
        return None
    held = tr.merge(((a - s.to_host) * 1e6, (b - s.to_host) * 1e6)
                    for a, b in sections)
    return 100.0 * overlap(idle, held) / idle_us
