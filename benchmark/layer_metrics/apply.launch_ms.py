"""apply.launch_ms: host ms of the program's span ``grain.launch``
(``apply_with_tables``: the pattern views and the K1 and K2 launches)
inside one ``apply.issue`` call, mean over the calls, from the traced
window (profiler on)."""

from program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "grain.launch", "apply.issue")
