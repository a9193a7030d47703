"""estimate_roofline: the least time of ``push_batch``'s device work
(planes read once, statistics written once, blur, activity, pooling,
binned moments and the float64 Gram over the reference's masked pixels)
over the kernel time the calls launched, in %."""

from yardstick import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "estimate.batch")
