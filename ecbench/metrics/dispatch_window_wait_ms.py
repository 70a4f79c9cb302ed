"""Mean time a slab of the scheduler's encode lane waited from its submit
to the start of its flush, over the window, in ms: the flush window and
the queue behind the one dispatch mutex together. The change of the
running sum of SeaweedFS_ec_dispatch_window_wait_seconds over that of its
count, lane "encode", read as the counters
SeaweedFS_ec_dispatch_window_wait_seconds_sum and _count (a program
without them reads nothing)."""

SUM = "SeaweedFS_ec_dispatch_window_wait_seconds_sum"
COUNT = "SeaweedFS_ec_dispatch_window_wait_seconds_count"


def read(r, variant):
    if (r.trace is None or r.op != "encode" or variant != "encode"
            or COUNT not in r.counters_after):
        return None
    n = r.counter(COUNT, lane=variant)
    if n <= 0:
        return None
    return 1e3 * r.counter(SUM, lane=variant) / n
