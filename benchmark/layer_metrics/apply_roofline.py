"""apply_roofline: the least time of the apply's device work (planes read
and written once, parameter rows, patterns and grain operations) over the
kernel time that ``pack_params`` and ``apply_grain`` launched, in %."""

from yardstick import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "apply.issue")
