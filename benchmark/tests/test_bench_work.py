"""The yardstick's work arithmetic against hand counts at small shapes,
and its trace reduction on a hand-made trace."""

import numpy as np
import pytest
from types import SimpleNamespace

import yardstick as ys

TABLE = dict(scaling_points_y=[(0, 20), (255, 40)], scaling_points_cb=[(0, 10)],
             scaling_points_cr=[], ar_coeff_lag=1, chroma_scaling_from_luma=False)


def test_least_ms_takes_the_larger_bound():
    assert ys.least_ms(3.35e9, 0) == pytest.approx(1.0)
    assert ys.least_ms(0, 33.5e9) == pytest.approx(1.0)
    assert ys.least_ms(0, 33.5e9, 67e9) == pytest.approx(2.0)
    assert ys.least_ms(6.7e9, 33.5e9) == pytest.approx(2.0)


def test_pattern_ops_by_hand():
    # lag 1: 4 taps. Luma: 73*82 Gaussian samples at 6, 70*76 positions at
    # 2*4 + 4. Cb only (4:2:0, 38x44): 38*44 at 6, 35*38 at 2*(4+1) + 4.
    want = 6 * 73 * 82 + 70 * 76 * 12 + 6 * 38 * 44 + 35 * 38 * 14
    assert ys.pattern_ops(TABLE, 1, 1) == want


def test_apply_frame_work_by_hand():
    shapes = [(32, 64), (16, 32), (16, 32)]
    moved, ops = ys.apply_frame_work(TABLE, shapes, 1, 1)
    assert moved == 2 * 2 * (32 * 64 + 2 * 16 * 32) + 158 * 4
    # luma 8 a sample; Cb active: the pair average 3 and grain + combine 16
    assert ops == ys.pattern_ops(TABLE, 1, 1) + 8 * 2048 + 3 * 512 + 16 * 512
    luma_only = dict(TABLE, scaling_points_cb=[])
    assert ys.apply_frame_work(luma_only, shapes, 1, 1)[1] == ys.pattern_ops(luma_only, 1, 1) + 8 * 2048


def _stats(n_ar, binned):
    return {"n_ar": np.float64(n_ar), "bin_cnt": np.full(64, binned / 64.0)}


def test_diff_frame_work_by_hand():
    shapes = [(32, 64), (16, 32), (16, 32)]
    st = (_stats(100, 640), _stats(10, 64), _stats(0, 0))
    moved, ops = ys.diff_frame_work(st, shapes, 1, 1)
    # lag 1: 5 design columns on luma, 6 on chroma
    stats_bytes = 8 * (16 + 4 + 1 + 192) + 2 * 8 * (25 + 5 + 1 + 192)
    assert moved == 2 * (2048 + 1024) + stats_bytes
    want = 8 * (2048 + 1024) + 100 * 30 + 4 * 640 + 10 * 42 + 4 * 64 + 2 * 2048 + 2 * 512
    assert ops == want


def test_estimate_frame_work_by_hand():
    shapes = [(32, 64)]
    moved, ops, fp64 = ys.estimate_frame_work((_stats(500, 500),), shapes, 2, 2)
    # lag 2: 13 design values
    assert moved == 2 * 2048 + 8 * (144 + 12 + 1 + 192)
    assert ops == (11 + 6 + 2) * 2048 + 4 * 500
    assert fp64 == 500 * 13 * 14


def _trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0.0, "dur": 100.0, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "apply.issue", "ts": 10.0, "dur": 10.0, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "apply.issue", "ts": 50.0, "dur": 10.0, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 12.0, "dur": 1.0,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 55.0, "dur": 1.0,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 30.0, "dur": 1.0,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 20.0, "dur": 5.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 24.0, "dur": 6.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 60.0, "dur": 4.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 40.0,
         "dur": 8.0, "args": {"correlation": 3}},
    ]
    return ys.Trace(ev, "bench.window")


def test_trace_reduction_by_hand():
    tr = _trace()
    assert tr.by_instance("apply.issue", ("kernel",)) == [11.0, 4.0]
    assert tr.by_instance("apply.issue", ("gpu_memcpy",), "HtoD") == [0.0, 0.0]
    # busy: [20, 30) [40, 48) [60, 64)
    assert tr.busy_s() == pytest.approx(22e-6)
    assert tr.window_s() == pytest.approx(100e-6)
    assert tr.top_device_ops()[0] == ["k_a", pytest.approx(9e-6)]
    gaps = dict((k, v) for k, v in tr.idle_gaps("bench.window"))
    # idle 78 us, each gap named by the range open at its middle: [0, 20)
    # and [48, 60) under apply.issue, [30, 40) and [64, 100) under none
    assert sum(gaps.values()) == pytest.approx(78e-6)
    assert gaps["apply.issue"] == pytest.approx(32e-6)
    assert gaps["harness"] == pytest.approx(46e-6)


def test_readers_on_a_hand_trace():
    tr = _trace()
    spans = ys.Spans()
    spans.spans["apply.issue"] = [(0.0, 0.001), (0.0, 0.003)]
    spans.work["apply.issue"] = [1, 3]
    ctx = SimpleNamespace(spans=spans, traced=spans, trace=tr, least_ms=lambda w: w * 1e-3)
    assert ys.mean_span_ms(ctx, "apply.issue") == pytest.approx(2.0)
    # least 4 us over 15 us of kernels
    assert ys.roofline_pct(ctx, "apply.issue") == pytest.approx(100 * 4 / 15)
    assert ys.idle_pct(ctx) == pytest.approx(78.0)
    assert ys.copy_ms(ctx, "apply.issue", "HtoD") == 0.0
    assert ys.mean_span_ms(ctx, "apply.upload") is None
    assert ys.roofline_pct(ctx, "diff.batch") is None
