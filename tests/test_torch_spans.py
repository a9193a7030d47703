"""The port's spans and counters (``grav1synth_tpu_torch.utils.spans``), on
the CPU:

- off (no profiler, the ``spans`` logger below DEBUG), a span is the
  shared no-op object: the staging, dispatch and estimate paths make no
  profiler range and sum nothing;
- under ``torch.profiler`` (CPU activity), ``pipelines._upload``,
  ``pack_params`` with ``apply_grain``, and ``NoiseEstimator.push_batch``
  give their named ranges in the exported Chrome trace, each inside the
  caller's range;
- with the logger at DEBUG, counts, totals, self times and counters are
  summed and tabled; ``GRAV1_LOG=spans=debug`` turns that on from the
  command line, and ``estimate`` logs the table at its end.
"""

import json
import logging
import threading
import time

import numpy as np
import pytest
import torch

from grav1synth_tpu_torch import cli as torch_cli
from grav1synth_tpu_torch import pipelines
from grav1synth_tpu_torch.obu.types import FilmGrainParams
from grav1synth_tpu_torch.ops import grain as tg
from grav1synth_tpu_torch.ops.estimate import NoiseEstimator
from grav1synth_tpu_torch.utils import spans

from test_render import _grainy_ivf

CPU = torch.device("cpu")
H, W = 64, 96  # 4:2:0 luma; chroma 32 x 48


def _params(n: int):
    return [FilmGrainParams(
        grain_seed=7391 + i, scaling_points_y=[(0, 20), (40, 35), (120, 30), (255, 25)],
        scaling_points_cb=[(0, 10), (255, 12)], scaling_points_cr=[(0, 8), (128, 16)],
        scaling_shift=8, ar_coeff_lag=2, ar_coeffs_y=[3, -2, 5, 1, -7, 4, 2, -1, 6, 0, -3, 2],
        ar_coeffs_cb=[1, 0, -1, 2, 3, -2, 1, 0, -4, 2, 1, -1, 5],
        ar_coeffs_cr=[-2, 1, 0, -1, 2, 1, -3, 2, 0, 1, -2, 3, -6], ar_coeff_shift=6,
        cb_mult=128, cb_luma_mult=192, cb_offset=256, cr_mult=130, cr_luma_mult=190,
        cr_offset=250, overlap_flag=True) for i in range(n)]


def _frames(n: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 1024, (h, w), dtype=np.uint16)
             for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))] for _ in range(n)]


def _upload(frames):
    return [pipelines._upload([f[k] for f in frames], CPU) for k in range(3)]


def _apply(frames):
    y, cb, cr = _upload(frames)
    return tg.apply_grain(y, cb, cr, tg.pack_params(_params(len(frames)), CPU), 10, 1, 1, False)


def _estimate(frames):
    NoiseEstimator((24, 1), 10, device=CPU).push_batch(frames)


# path -> (run, spans a run, the ``upload.`` counters it adds)
PATHS = {
    "upload": (_upload, {"upload.stack": 3, "upload.pin": 3, "upload.copy": 3},
               {"frames": 6}),
    "apply": (_apply, {"upload.stack": 3, "grain.pack": 1, "program.replay": 1,
                       "grain.launch": 1}, {"frames": 6}),
    "estimate": (_estimate, {"stage.planes": 3, "estimate.launch": 4, "estimate.download": 1,
                             "estimate.ingest": 1}, {}),
}


@pytest.fixture
def summing():
    """The ``spans`` logger at DEBUG, sums cleared; restored after."""
    prev = spans.log.level
    spans.log.setLevel(logging.DEBUG)
    spans.reset()
    yield
    spans.log.setLevel(prev)
    spans.reset()


@pytest.mark.parametrize("path", sorted(PATHS))
def test_off_makes_no_range_and_sums_nothing(path, monkeypatch):
    assert not spans.log.isEnabledFor(logging.DEBUG)
    assert spans.span("upload.stack") is spans.span("grain.pack")

    def no_range(name, args=None):
        raise AssertionError(f"a profiler range {name!r} while spans are off")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    spans.reset()
    PATHS[path][0](_frames(2))
    assert spans.snapshot()["spans"] == {}


def _user_ranges(prof, tmp_path):
    out = tmp_path / "trace.json"
    prof.export_chrome_trace(str(out))
    events = json.loads(out.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    return [(e["name"], e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_profiled_ranges_nest_in_the_callers(path, tmp_path):
    run, want, _ = PATHS[path]
    frames = _frames(2)
    spans.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller"):
            run(frames)
    ranges = _user_ranges(prof, tmp_path)
    (_, c0, c1), = [r for r in ranges if r[0] == "caller"]
    got = {}
    for name, a, b in ranges:
        if name in want:
            assert c0 <= a <= b <= c1, f"{name} [{a}, {b}] outside the caller's [{c0}, {c1}]"
            got[name] = got.get(name, 0) + 1
    assert got == want
    # with the logger off nothing is summed in memory
    assert spans.snapshot()["spans"] == {}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_summed_counts(path, summing):
    run, want, counted = PATHS[path]
    run(_frames(2))
    got = spans.snapshot()["spans"]
    assert {k: got[k]["count"] for k in want} == want
    assert spans.counters("upload.") == counted
    for s in got.values():
        assert 0 <= s["self_ms"] <= s["total_ms"] and s["max_ms"] <= s["total_ms"]


def test_nesting_self_time_and_threads(summing):
    def worker():
        with spans.span("t.other"):
            time.sleep(0.02)

    with spans.span("t.outer"):
        th = threading.Thread(target=worker)
        th.start()
        for _ in range(2):
            with spans.span("t.inner"):
                time.sleep(0.01)
        th.join()
    got = spans.snapshot()["spans"]
    outer, inner, other = got["t.outer"], got["t.inner"], got["t.other"]
    assert (outer["count"], inner["count"], other["count"]) == (1, 2, 1)
    # the other thread's span is no child of the outer one
    assert outer["self_ms"] == pytest.approx(outer["total_ms"] - inner["total_ms"], abs=1e-6)
    assert inner["self_ms"] == inner["total_ms"] >= 20.0
    assert inner["max_ms"] >= 10.0 and other["self_ms"] == other["total_ms"] >= 20.0


def test_counters_and_summary(summing):
    spans.count("launch.grain_luma")
    spans.count("launch.grain_luma", 2)
    spans.count("program.replays")
    with spans.span("grain.pack"):
        pass
    assert spans.counter("launch.grain_luma") == 3 and spans.counter("launch.nothing") == 0
    assert spans.counters("launch.") == {"grain_luma": 3}
    assert spans.snapshot()["counters"] == {"launch.grain_luma": 3, "program.replays": 1}
    table = spans.log_summary()
    rows = {line.split()[0]: line.split()[1:] for line in table.splitlines()[1:]}
    assert rows["grain.pack"][0] == "1" and rows["launch.grain_luma"] == ["3"]
    assert rows["program.replays"] == ["1"]
    spans.reset()
    assert spans.snapshot() == {"spans": {}, "counters": {}}
    spans.log.setLevel(logging.WARNING)
    assert spans.log_summary() is None


def test_operator_view_from_the_command_line(tmp_path, monkeypatch, caplog):
    """``GRAV1_LOG=spans=debug`` turns the sums on; ``estimate`` logs the
    table at its end."""
    path, _ = _grainy_ivf(tmp_path, 64, 64, 10, False, 3, "")
    root = logging.getLogger()
    prev = root.level, spans.log.level
    monkeypatch.setenv("GRAV1_LOG", "error,spans=debug")
    spans.reset()
    try:
        assert torch_cli.main(["estimate", path, "-o", str(tmp_path / "t.tbl"),
                               "--device", "cpu", "-y"]) == 0
        assert spans.log.isEnabledFor(logging.DEBUG)
    finally:
        root.setLevel(prev[0])
        spans.log.setLevel(prev[1])
    got = spans.snapshot()["spans"]
    assert got["estimate.ingest"]["count"] == 1 and got["stage.planes"]["count"] == 3
    table = [r.getMessage() for r in caplog.records if r.name == "spans"]
    assert len(table) == 1 and "estimate.launch" in table[0]
    spans.reset()
