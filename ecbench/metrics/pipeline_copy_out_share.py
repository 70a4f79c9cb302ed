"""Share of the window's encodes' wall that their coordinators spent
copying parity back to the host (EncodeStats.copy_out_s / EncodeStats.
wall_s, summed over the same encodes as pipeline_device_wait_share; a
part of its device wait), in %. A program whose stats lack copy_out_s
reads nothing."""


def read(r, variant):
    if (r.trace is None or r.op != "encode" or variant != "encode"
            or not r.round_stats
            or not all(hasattr(s, "copy_out_s") for s in r.round_stats)):
        return None
    wall = sum(s.wall_s for s in r.round_stats)
    if wall <= 0:
        return None
    return 100.0 * sum(s.copy_out_s for s in r.round_stats) / wall
