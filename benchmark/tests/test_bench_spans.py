"""The per-layer metrics read from the port's own spans: each reads a
positive host time in a traced run of its cells on the CPU, and nothing
from a trace without the port's spans (a port that has none). Also the
coverage of the benchmark's ranges by the spans, and
``scripts/span_coverage.py``, which reports it."""

import importlib.util
import math
import os

import pytest
import torch

import harness
import program_spans
import yardstick

SPAN_METRICS = ("apply.stack_ms", "apply.pin_ms", "apply.pack_ms", "apply.replay_ms",
                "apply.launch_ms", "estimate.stage_ms", "estimate.launch_ms",
                "estimate.ingest_ms")


def _cells():
    b = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    out = {}
    for m in b["per_layer"]:
        if m["name"] in SPAN_METRICS:
            for w in m["workloads"]:
                out.setdefault(w, []).append(m["name"])
    return out


def test_every_span_metric_names_its_cells():
    cells = _cells()
    assert {m for ms in cells.values() for m in ms} == set(SPAN_METRICS)
    assert cells["uhd10_420.resident_film_b16"] == ["apply.pack_ms", "apply.replay_ms",
                                                   "apply.launch_ms"]


@pytest.mark.parametrize("workload", sorted(_cells()))
def test_span_metrics_read_in_a_traced_run(tiny, workload):
    cell = harness.Cell(harness.load_json(os.path.join(tiny, "BENCHMARK.json")), workload,
                        root=tiny)
    result = harness.run_cell(cell, 2**31 + 91, 0.6, True, torch.device("cpu"),
                              log=lambda m: None)
    assert result["correct"]
    for name in _cells()[workload]:
        value = result["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)


def _trace(ranges):
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
              for n, a, b in ranges]
    return yardstick.Trace(events, "bench.window")


class _Ctx:
    def __init__(self, trace):
        self.trace = trace


def test_span_ms_sums_inside_calls_and_divides_by_them():
    tr = _trace([("bench.window", 0, 1000), ("apply.issue", 100, 200), ("apply.issue", 300, 400),
                 ("grain.pack", 110, 130), ("grain.pack", 310, 350),
                 ("grain.pack", 500, 900)])  # outside every call: not read
    assert program_spans.span_ms(_Ctx(tr), "grain.pack", "apply.issue") == pytest.approx(0.03)


def test_span_ms_reads_nothing_without_the_ports_spans():
    tr = _trace([("bench.window", 0, 1000), ("apply.issue", 100, 200)])
    assert program_spans.span_ms(_Ctx(tr), "grain.pack", "apply.issue") is None
    assert program_spans.span_ms(_Ctx(None), "grain.pack", "apply.issue") is None
    # a span but no call around it
    tr = _trace([("bench.window", 0, 1000), ("grain.pack", 100, 200)])
    assert program_spans.span_ms(_Ctx(tr), "grain.pack", "apply.issue") is None


def test_coverage_counts_the_union_of_the_spans_inside_each_call():
    tr = _trace([("bench.window", 0, 1000), ("apply.issue", 100, 200), ("apply.issue", 300, 400),
                 ("grain.pack", 110, 150), ("program.replay", 140, 160),  # overlap 10
                 ("program.capture", 145, 155),  # inside the replay: covers nothing more
                 ("grain.pack", 300, 380), ("grain.pack", 500, 900)])  # the last outside
    cov = program_spans.coverage(tr, {"bench.window", "apply.issue"})
    issue = cov["apply.issue"]
    assert issue["calls"] == 2 and issue["ms_a_call"] == pytest.approx(0.1)
    assert issue["covered"] == pytest.approx((50 + 80) / 200)
    assert issue["span_ms_a_call"] == pytest.approx(
        {"grain.pack": 0.06, "program.replay": 0.01, "program.capture": 0.005})
    assert list(issue["span_ms_a_call"])[0] == "grain.pack"  # the largest first


def test_idle_under_port_leaves_out_the_benchmarks_ranges_and_the_harness():
    gaps = [["grain.pack", 3.0], ["apply.issue", 0.5], ["harness", 0.5], ["upload.stack", 1.0]]
    assert program_spans.idle_under_port(gaps, {"apply.issue", "bench.window"}) == \
        pytest.approx(0.8)
    assert program_spans.idle_under_port([], {"apply.issue"}) is None


def _script():
    path = os.path.join(harness.ROOT, "scripts", "span_coverage.py")
    spec = importlib.util.spec_from_file_location("span_coverage", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_span_coverage_reads_a_traced_window(tiny):
    script = _script()
    cell = harness.Cell(harness.load_json(os.path.join(tiny, "BENCHMARK.json")),
                        "uhd10_420.resident_film_b16", root=tiny)
    driver = cell.driver(2**31 + 93, torch.device("cpu"))
    driver.setup()
    _, host, prof = harness.run_window(driver, 0.6, True)
    out = script.read(driver, host, prof)
    assert set(out["coverage"]) == {"apply.issue"}  # the window is left out
    issue = out["coverage"]["apply.issue"]
    assert 0 < issue["covered"] <= 1
    assert {"grain.pack", "program.replay", "grain.launch"} <= set(issue["span_ms_a_call"])
    assert out["host_ms_a_call_untraced"]["apply.issue"] > 0
    assert out["idle"]["idle_s"] > 0  # no device events on the CPU: the window is one gap
    assert 0 <= out["idle"]["under_port_spans"] <= 1


def test_span_coverage_times_a_span_in_each_mode():
    cost = _script().span_cost(n=2000)
    assert set(cost) == {"off", "summed", "profiled", "profiled_and_summed"}
    assert all(math.isfinite(v) for v in cost.values())
