"""apply.pin_ms: host ms of the program's span ``upload.pin``
(``pin_memory`` of the stacked planes in ``pipelines._upload``) inside
one ``apply.upload`` call, mean over the calls, from the traced window
(profiler on)."""

from program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "upload.pin", "apply.upload")
