"""apply.upload_ms: host ms of ``pipelines._upload`` a batch (its three
planes stacked, cast to int16, pinned and copied), host clock, mean over
the window's untraced part."""

from yardstick import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "apply.upload")
