"""Share of the GF(2^8) kernels' roofline over the traced window, in %:
the least time the work needs, the bytes the window's slabs read and
write at the card's peak memory rate ((k + m) * B per encoded slab of
width B, (survivors read + shards rebuilt) * B per rebuilt slab), over
the summed device time of every kernel in the trace, whatever kernel
implements the product and however many there are."""

from ecbench import trace as tr


def read(r, variant):
    if r.trace is None or r.op != variant or not r.memory_rate:
        return None
    kernel_s = r.trace.summed_s(tr.KERNEL)
    if kernel_s <= 0 or r.kernel_bytes <= 0:
        return None
    return 100.0 * (r.kernel_bytes / r.memory_rate) / kernel_s
