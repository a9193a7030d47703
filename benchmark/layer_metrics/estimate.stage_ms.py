"""estimate.stage_ms: host ms of the program's span ``stage.planes``
(``stage_planes``: each plane's frames stacked into a pinned buffer and
sent) inside one ``estimate.batch`` call, mean over the calls, from the
traced window (profiler on)."""

from program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "stage.planes", "estimate.batch")
