"""estimate.ingest_ms: host ms of the program's span ``estimate.ingest``
(``push_batch``'s per-frame ``_ingest`` of the downloaded statistics)
inside one ``estimate.batch`` call, mean over the calls, from the traced
window (profiler on)."""

from program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "estimate.ingest", "estimate.batch")
