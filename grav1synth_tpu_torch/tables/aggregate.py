"""Per-frame grain headers -> time-segmented grain table.

Behavior parity with reference grav1synth aggregate_grain_headers
(src/main.rs:719-772): frames sit on a fixed fps time grid in 1/10^7-s
ticks with float-accumulated ceil()ed packet ends; Disable closes the
open segment, CopyRefFrame extends it, UpdateGrain extends iff the
parameters match (seed excluded) else opens a new segment.

The fold is associative over frame ranges given the absolute frame
index (the grid is absolute, not relative), so shards aggregated
independently merge exactly — merge_segment_runs() is the combiner the
distributed inspect pipeline uses (SURVEY §5 long-context mapping).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

from ..obu.types import GrainAction, GrainHeader, GrainTableSegment

TICKS_PER_SECOND = 10_000_000


def packet_bounds(index: int, fps_num: int, fps_den: int) -> Tuple[int, int]:
    """[start, end) ticks of frame ``index`` on the fps grid.

    Exact integer arithmetic (ceil of the rational product) rather than
    the reference's accumulated-float ceil (main.rs:726-727): the exact
    grid is identical except for rare 1-tick float-drift cases, and it
    makes aggregation a pure function of the absolute frame index — the
    property multi-shard determinism requires (SURVEY §7 hard part 6)."""
    start = 0 if index == 0 else -(-fps_den * TICKS_PER_SECOND * index // fps_num)
    end = -(-fps_den * TICKS_PER_SECOND * (index + 1) // fps_num)
    return start, end


def aggregate_grain_headers(
    headers: Sequence[GrainHeader],
    fps_num: int,
    fps_den: int,
    start_index: int = 0,
) -> List[GrainTableSegment]:
    """Fold shown-frame grain headers into table segments.

    ``start_index`` offsets the time grid so a shard of frames
    [start_index, start_index + len) aggregates against absolute time.
    """
    acc: List[GrainTableSegment] = []
    idx = start_index
    cur_start, cur_end = packet_bounds(idx, fps_num, fps_den)
    for h in headers:
        prev_has_grain = bool(acc) and acc[-1].end_time == cur_start
        if prev_has_grain:
            if h.action == GrainAction.DISABLE:
                pass  # closes the segment
            elif h.action == GrainAction.COPY_REF:
                acc[-1].end_time = cur_end
            else:
                assert h.params is not None
                if h.params.equal_ignoring_seed(acc[-1].params):
                    acc[-1].end_time = cur_end
                else:
                    acc.append(GrainTableSegment(cur_start, cur_end, h.params))
        elif h.action == GrainAction.UPDATE:
            assert h.params is not None
            acc.append(GrainTableSegment(cur_start, cur_end, h.params))
        idx += 1
        cur_start, cur_end = packet_bounds(idx, fps_num, fps_den)
    return acc


def merge_segment_runs(
    runs: Sequence[List[GrainTableSegment]],
) -> List[GrainTableSegment]:
    """Associative combiner for per-shard aggregation results.

    Two adjacent runs merge by joining the first run's tail segment with
    the second run's head segment when they abut in time and share
    parameters (same rule as the in-shard fold). CopyRefFrame headers at
    a shard head degrade to Disable only if the previous shard ended
    without grain — which this merge reproduces because such a head
    segment can only exist if the shard-local fold saw an UpdateGrain
    first (shards must start at keyframes, where CopyRefFrame cannot
    occur)."""
    out: List[GrainTableSegment] = []
    for run in runs:
        if not run:
            continue
        if out:
            tail, head = out[-1], run[0]
            if tail.end_time == head.start_time and tail.params.equal_ignoring_seed(
                head.params
            ):
                tail.end_time = head.end_time
                out.extend(run[1:])
                continue
        out.extend(run)
    return out
