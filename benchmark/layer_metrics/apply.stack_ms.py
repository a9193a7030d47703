"""apply.stack_ms: host ms of the program's span ``upload.stack``
(``np.stack`` of a plane's frames and the cast to int16 in
``pipelines._upload``) inside one ``apply.upload`` call, mean over the
calls, from the traced window (profiler on)."""

from program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "upload.stack", "apply.upload")
