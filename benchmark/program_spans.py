"""Readings of the port's own spans in a traced window.

The port marks the steps of its layers with spans
(``grav1synth_tpu_torch.utils.spans``); while a torch profiler records,
each is a profiler range, so the window's trace holds them beside the
benchmark's own ranges, on one clock. Their host time includes the cost
of the profiler's ranges. A port without a span leaves nothing to read.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple


def within(trace, names: Iterable[str], call: str) -> List[List[Tuple[float, float, str]]]:
    """For each instance of the benchmark's range ``call``, the instances
    of the ranges ``names`` that lie inside it, as (start, end, name)."""
    calls = trace.instances(call)
    starts = [a for a, _ in calls]
    out: List[List[Tuple[float, float, str]]] = [[] for _ in calls]
    for name in names:
        for a, b in trace.instances(name):
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and b <= calls[i][1]:
                out[i].append((a, b, name))
    return out


def span_ms(ctx, span: str, call: str) -> Optional[float]:
    """Host ms of the port's span ``span`` inside the benchmark's range
    ``call``, summed over the window's calls and divided by their number;
    None where the trace holds no such span inside a call."""
    if ctx.trace is None:
        return None
    per_call = within(ctx.trace, [span], call)
    if not any(per_call):
        return None
    return sum(b - a for spans in per_call for a, b, _ in spans) / len(per_call) / 1e3


def coverage(trace, bench: Iterable[str]) -> Dict[str, dict]:
    """For each of the benchmark's ranges ``bench`` that the trace holds:
    its calls, their mean ms, the share of their time that the port's
    spans inside them cover (the union of every span not in ``bench``),
    and each such span's ms a call."""
    bench = set(bench)
    port = [k for k in trace.ranges if k not in bench]
    out = {}
    for call in sorted(bench):
        calls = trace.instances(call)
        if not calls:
            continue
        covered, per = 0.0, defaultdict(float)
        for spans in within(trace, port, call):
            end = float("-inf")
            for a, b, name in sorted(spans):
                per[name] += b - a
                covered += max(0.0, b - max(a, end))
                end = max(end, b)
        total = sum(b - a for a, b in calls)
        out[call] = {"calls": len(calls), "ms_a_call": total / len(calls) / 1e3,
                     "covered": covered / total if total else None,
                     "span_ms_a_call": {k: v / len(calls) / 1e3 for k, v in
                                        sorted(per.items(), key=lambda kv: -kv[1])}}
    return out


def idle_under_port(gaps: List[list], bench: Iterable[str]) -> Optional[float]:
    """The share of ``Trace.idle_gaps``' seconds that fall under a span of
    the port, not under one of the benchmark's ranges ``bench`` or
    between them (``harness``)."""
    bench = set(bench) | {"harness"}
    total = sum(s for _, s in gaps)
    return sum(s for k, s in gaps if k not in bench) / total if total else None
