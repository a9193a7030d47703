"""The yardstick: the card's published peaks, the least work each path
needs, and the reduction of a profiler trace to device time by the
benchmark's own ranges.

The peaks and the work arithmetic are copied from the repository's
``chip_smoke.py`` (``timing``, ``luma_work``, ``pair_work``,
``pattern_work``, ``stats_work``, ``self_stats_work`` and their per-sample
operation counts, at commit 301318fd362891bc8f8c0520c6b680db7a8800b4),
rewritten to reckon from shapes, tables and the flat-pixel counts of the
benchmark's own reference, over a whole path instead of one kernel: each
input of the path is read once and each output written once (the planes,
the parameter buffer, the statistics); what the path makes and uses on
the card (patterns, tables, blurred planes, flat maps) is not counted.
``device_busy``'s union of device intervals is ``chip_smoke.device_busy``
on the trace's events.

A path's roofline share is its least time, summed over the calls that a
range of the benchmark wraps, over the device kernel time those calls
launched. Kernels belong to a range by their launch (the correlation of
each device event with the runtime or driver call that issued it), never
by name, so a change to the program's kernels leaves the yardstick
reading the same work.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import tempfile
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

# NVIDIA H100 SXM, the data sheet's dense rates at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
FP64_OPS_PER_S = 67e12  # on the tensor cores

# Integer operations per sample (a multiply-add counts two). Grain: scaling
# input clamp 2, scale x noise + rounding 2, shift 1, add 1, clip 2. Chroma
# adds the pair average (3 a sample, shared by Cb and Cr) and, where a plane
# combines luma and chroma, two multiply-adds, a shift, the offset and a
# clamp (8).
GRAIN_OPS, AVG_OPS, COMBINE_OPS = 8, 3, 8
# flat-block activity: two differences, two absolute values, two adds
ACTIVITY_OPS = 6
# blur: the vertical and horizontal running sums (an add and a subtraction
# each), the rounding add, the division by 81 (a multiply-high and a
# shift), the clip (2) and q = 81 f - S (a multiply-add)
BLUR_OPS = 11
# pattern generation: per Gaussian sample an LFSR step, the table read and
# a Round2 (6); per AR position a Round2 and a clamp (4) beside one
# multiply-add per tap
GAUSS_OPS, AR_POS_OPS = 6, 4
GRAIN_H, GRAIN_W = 73, 82
PARAMS_BYTES = 158 * 4  # one frame's row of the parameter buffer
NUM_BINS = 64
STATS_BYTES = 8  # float64 statistics


def least_ms(moved: float, int_ops: float, fp64_ops: float = 0.0) -> float:
    """The least time of some work on the card: the larger of its bytes
    over the HBM rate and its operations over their peaks."""
    return max(moved / HBM_BYTES_PER_S, int_ops / INT32_OPS_PER_S + fp64_ops / FP64_OPS_PER_S) * 1e3


# ---------------------------------------------------------------------------
# Work of each path, per frame


def pattern_ops(table: dict, sub_x: int, sub_y: int) -> float:
    """Operations of one frame's grain patterns: Gaussian samples and AR
    taps of each active plane at the table's lag."""
    ch = 38 if sub_y else GRAIN_H
    cw = 44 if sub_x else GRAIN_W
    has_y = bool(table["scaling_points_y"])
    taps = 2 * table["ar_coeff_lag"] * (table["ar_coeff_lag"] + 1)
    ops = 0.0
    if has_y:
        ops += GAUSS_OPS * GRAIN_H * GRAIN_W + (GRAIN_H - 3) * (GRAIN_W - 6) * (2 * taps + AR_POS_OPS)
    for pts in (table["scaling_points_cb"], table["scaling_points_cr"]):
        if pts or table["chroma_scaling_from_luma"]:
            ops += GAUSS_OPS * ch * cw + (ch - 3) * (cw - 6) * (2 * (taps + has_y) + AR_POS_OPS)
    return ops


def apply_frame_work(table: dict, shapes, sub_x: int, sub_y: int) -> Tuple[float, float]:
    """(bytes, operations) of grain on one frame: its int16 planes read and
    written, its parameter row read; patterns, luma grain, and on each
    active chroma plane grain and, unless scaled from luma, the
    combination, beside the pair average."""
    luma = shapes[0][0] * shapes[0][1]
    chroma = shapes[1][0] * shapes[1][1] if len(shapes) == 3 else 0
    moved = 2 * 2 * (luma + 2 * chroma) + PARAMS_BYTES
    ops = pattern_ops(table, sub_x, sub_y)
    if table["scaling_points_y"]:
        ops += GRAIN_OPS * luma
    active = [bool(p) or table["chroma_scaling_from_luma"]
              for p in (table["scaling_points_cb"], table["scaling_points_cr"])]
    if chroma and any(active):
        per = GRAIN_OPS + (0 if table["chroma_scaling_from_luma"] else COMBINE_OPS)
        ops += AVG_OPS * chroma + per * chroma * sum(active)
    return moved, ops


def _n_design(lag: int, aux: bool) -> int:
    return 1 + 2 * lag * (lag + 1) + int(aux)


def _stats_bytes(n: int) -> int:
    return STATS_BYTES * ((n - 1) * (n - 1) + (n - 1) + 1 + 3 * NUM_BINS)


def diff_frame_work(stats, shapes, sample_bytes: int, lag: int) -> Tuple[float, float]:
    """(bytes, operations) of one frame pair's statistics: both planes of
    each pair read once as staged, the statistics written; per sample the
    flat-block activity, the residual and the flat test, the luma pooling
    for the chroma column; per Gram pixel the n(n+1)/2 multiply-adds over
    its n design columns, per binned pixel 4. ``stats`` are the
    reference's (y, cb, cr) dicts of this frame."""
    moved = ops = 0.0
    for k, (h, w) in enumerate(shapes):
        st = stats[k]
        n = _n_design(lag, k > 0)
        moved += 2 * sample_bytes * h * w + _stats_bytes(n)
        ops += (ACTIVITY_OPS + 2) * h * w
        ops += float(st["n_ar"]) * n * (n + 1) + 4 * float(st["bin_cnt"].sum())
    if len(shapes) == 3:
        ops += 2 * shapes[0][0] * shapes[0][1] + 2 * shapes[1][0] * shapes[1][1]
    return moved, ops


def estimate_frame_work(stats, shapes, sample_bytes: int, lag: int) -> Tuple[float, float, float]:
    """(bytes, integer operations, float64 operations) of one grainy
    frame's statistics: each plane read once as staged, the statistics
    written; per sample the blur, the flat-block activity of the blurred
    plane and the mask test, the luma pooling for the chroma column; per
    masked pixel 4 for the binned moments and, in float64, the n(n+1)/2
    multiply-adds of the Gram over its n design values."""
    moved = ops = fp64 = 0.0
    for k, (h, w) in enumerate(shapes):
        st = stats[k]
        n = _n_design(lag, k > 0)
        moved += sample_bytes * h * w + _stats_bytes(n)
        ops += (BLUR_OPS + ACTIVITY_OPS + 2) * h * w + 4 * float(st["n_ar"])
        fp64 += float(st["n_ar"]) * n * (n + 1)
    if len(shapes) == 3:
        ops += shapes[0][0] * shapes[0][1]
    return moved, ops, fp64


# ---------------------------------------------------------------------------
# Host spans


class Spans:
    """Host-clock spans the path drivers record around their calls into
    each layer; with ``profile`` each is also a profiler range. A span may
    carry the work it covers (the frames of a batch), which the path's
    ``least_ms`` turns into the least time after the run's check."""

    def __init__(self, profile: bool = False):
        self.profile = profile
        self.spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self.work: Dict[str, list] = defaultdict(list)

    def span(self, name: str, work=None):
        return _Span(self, name, work)

    def durations_ms(self, name: str) -> List[float]:
        return [(b - a) * 1e3 for a, b in self.spans.get(name, ())]


class _Span:
    __slots__ = ("owner", "name", "work", "t0", "rf")

    def __init__(self, owner: Spans, name: str, work):
        self.owner, self.name, self.work, self.rf = owner, name, work, None

    def __enter__(self):
        if self.owner.profile:
            from torch.profiler import record_function

            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.owner.spans[self.name].append((self.t0, t1))
        if self.work is not None:
            self.owner.work[self.name].append(self.work)
        return False


# ---------------------------------------------------------------------------
# Trace reduction

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Trace:
    """The device events of one profiled window, each tied to the host
    ranges of the benchmark that were open when it was launched."""

    def __init__(self, events: List[dict], window: str):
        self.ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        launches: Dict[int, float] = {}  # correlation -> host ts of the launch
        self.device: List[dict] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat == "user_annotation":
                self.ranges[e["name"]].append((e["ts"], e["ts"] + e.get("dur", 0.0)))
            elif cat in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = e["ts"]
            elif cat in DEVICE_CATS:
                self.device.append(e)
        for v in self.ranges.values():
            v.sort()
        if not self.ranges.get(window):
            raise RuntimeError(f"the trace holds no {window!r} range")
        self.window = self.ranges[window][0]
        for e in self.device:
            corr = (e.get("args") or {}).get("correlation")
            e["_launch"] = launches.get(corr)

    def instances(self, name: str) -> List[Tuple[float, float]]:
        return self.ranges.get(name, [])

    def by_instance(self, name: str, cats: Iterable[str], match: str = "") -> List[float]:
        """Device us of the events of ``cats`` (with ``match`` in their
        name) launched inside each instance of range ``name``."""
        spans = self.instances(name)
        starts = [a for a, _ in spans]
        out = [0.0] * len(spans)
        cats = tuple(cats)
        for e in self.device:
            t = e["_launch"]
            if t is None or e.get("cat") not in cats or match not in e.get("name", ""):
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out[i] += e.get("dur", 0.0)
        return out

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device intervals inside the window, sorted."""
        w0, w1 = self.window
        spans = sorted((max(e["ts"], w0), min(e["ts"] + e.get("dur", 0.0), w1)) for e in self.device)
        out: List[Tuple[float, float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def top_device_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = defaultdict(float)
        for e in self.device:
            tot[e.get("name", "?")[:120]] += e.get("dur", 0.0) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, window: str, n: int = 10) -> List[list]:
        """Device idle seconds inside the window, by the innermost
        benchmark range open on the host at each gap's middle."""
        w0, w1 = self.window
        busy = self.busy_intervals()
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        named = sorted((a, b, k) for k, v in self.ranges.items() if k != window for a, b in v)
        tot: Dict[str, float] = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            inner = [(b2 - a2, k) for a2, b2, k in named if a2 <= mid <= b2]
            tot[min(inner)[1] if inner else "harness"] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def read_trace(prof, window: str) -> Trace:
    """The profiler's events through its Chrome trace, written to a file
    under the temporary directory and removed once read."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            data = json.load(fh)
    finally:
        os.remove(path)
    return Trace(data["traceEvents"] if isinstance(data, dict) else data, window)


# ---------------------------------------------------------------------------
# Readings the per-layer metrics share


def mean_span_ms(ctx, name: str) -> Optional[float]:
    """Mean host ms of span ``name`` in the untraced part of the window."""
    d = ctx.spans.durations_ms(name)
    return statistics.fmean(d) if d else None


def roofline_pct(ctx, name: str) -> Optional[float]:
    """Least time of the calls in range ``name`` over the kernel time they
    launched, in %; both from the traced part of the window."""
    work = ctx.traced.work.get(name)
    kernel_us = ctx.trace.by_instance(name, ("kernel",)) if ctx.trace else []
    if not work or len(work) != len(kernel_us) or sum(kernel_us) <= 0:
        return None
    return 100.0 * sum(ctx.least_ms(w) for w in work) / (sum(kernel_us) / 1e3)


def copy_ms(ctx, name: str, direction: str) -> Optional[float]:
    """Mean device ms a call of range ``name`` spent in copies of
    ``direction`` ("HtoD", "DtoH")."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    per = ctx.trace.by_instance(name, ("gpu_memcpy",), direction)
    return statistics.fmean(per) / 1e3 if per else None


def idle_pct(ctx) -> Optional[float]:
    if ctx.trace is None or not ctx.trace.device or ctx.trace.window_s() <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s())
