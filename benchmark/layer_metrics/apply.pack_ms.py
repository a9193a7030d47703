"""apply.pack_ms: host ms of the program's span ``grain.pack``
(``ops.grain.pack_params``: the tables as one buffer, pinned and sent)
inside one ``apply.issue`` call, mean over the calls, from the traced
window (profiler on)."""

from program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "grain.pack", "apply.issue")
