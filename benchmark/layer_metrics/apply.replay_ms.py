"""apply.replay_ms: host ms of the program's span ``program.replay`` (the
parameter program's lookup and graph replay: ``program_for``,
``GrainProgram.run``) inside one ``apply.issue`` call, mean over the
calls, from the traced window (profiler on). At B = 16 it mostly reads
the profiler's own cost of tracing the graph's ~263 nodes: about 0.8 ms
traced against 0.09 ms summed with the profiler off."""

from program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "program.replay", "apply.issue")
