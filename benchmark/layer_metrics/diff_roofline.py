"""diff_roofline: the least time of ``diff_batch``'s device work (planes
read once, statistics written once, activity, pooling, Gram and binned
moments over the reference's flat pixels) over the kernel time the calls
launched, in %."""

from yardstick import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "diff.batch")
