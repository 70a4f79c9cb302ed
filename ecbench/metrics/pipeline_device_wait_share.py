"""Share of the window's encodes' wall that their coordinators spent
blocked on parity (EncodeStats.device_wait_s / EncodeStats.wall_s, summed
over the encodes; a host wait that covers the scheduler's window, the
copies and the kernel), in %."""


def read(r, variant):
    if r.op != "encode" or variant != "encode" or not r.round_stats:
        return None
    wall = sum(s.wall_s for s in r.round_stats)
    if wall <= 0:
        return None
    return 100.0 * sum(s.device_wait_s for s in r.round_stats) / wall
