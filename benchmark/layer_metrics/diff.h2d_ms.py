"""diff.h2d_ms: device ms of host-to-device copies that one
``diff_batch`` launched, mean over the traced batches."""

from yardstick import copy_ms


def read(ctx):
    return copy_ms(ctx, "diff.batch", "HtoD")
