"""estimate.launch_ms: host ms of the program's span ``estimate.launch``
(``push_batch``'s launches: blur, flat blocks, pooling and statistics)
inside one ``estimate.batch`` call, mean over the calls, from the traced
window (profiler on)."""

from program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "estimate.launch", "estimate.batch")
