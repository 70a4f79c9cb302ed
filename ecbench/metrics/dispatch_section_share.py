"""Share of the window that the scheduler's one serial dispatch section
(the hold of its dispatch mutex: a lane's pop, the arena pack, the copy
to the card and the launch) was held for the encode lane, in %: the
change of SeaweedFS_ec_phase_seconds{phase="ec.dispatch.section",
lane="encode"} over the window's seconds (a program without the counter
reads nothing)."""

NAME = "SeaweedFS_ec_phase_seconds"


def read(r, variant):
    if (r.trace is None or r.op != "encode" or variant != "encode"
            or NAME not in r.counters_after):
        return None
    return 100.0 * r.counter(NAME, phase="ec.dispatch.section",
                             lane=variant) / r.seconds
