"""apply.issue_ms: host ms of ``pack_params`` and ``apply_grain`` a batch,
which only enqueue work on the card, host clock, mean over the
window's untraced part."""

from yardstick import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "apply.issue")
