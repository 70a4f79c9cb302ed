"""Slabs per stacked launch on the scheduler's encode lane over the
window: the change of SeaweedFS_ec_dispatch_slabs over that of
SeaweedFS_ec_dispatch_batches, lane "encode"."""


def read(r, variant):
    if r.op != "encode" or variant != "encode":
        return None
    batches = r.counter("SeaweedFS_ec_dispatch_batches", lane="encode")
    if batches <= 0:
        return None
    return r.counter("SeaweedFS_ec_dispatch_slabs", lane="encode") / batches
