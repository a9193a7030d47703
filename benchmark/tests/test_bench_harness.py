"""The harness finds each cell's configuration, mix, path driver and
metrics by name; a cell, configuration, mix and metric added from files
alone run; the result line has the contract's shape; BENCHMARK.json keeps
the contract's limits."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

import harness
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = harness.Cell(bench(), workload)
    assert cell.config["name"] == cell.entry["config"]
    assert os.path.isfile(cell.driver_path)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)


def test_unknown_cell_is_refused():
    with pytest.raises(harness.BenchError):
        harness.Cell(bench(), "uhd10_420.nothing")


def test_benchmark_file_keeps_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"][1] == "benchmark/run.py"
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, c["file"]))
    cells = {w["name"] for w in b["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 0 < len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = set()
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert set(m["workloads"]) <= cells
        layers.add(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert layers == {"host staging", "dispatch", "kernels", "device"}


def _check_line(result: dict, trace: bool):
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert isinstance(result["correct"], bool)
    assert result["attempted"] > 0 and result["failed"] == 0
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    json.loads(json.dumps(result))


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]] + ["fhd8_420.diff_b32"])
def test_result_line_shape(tiny, workload):
    cell = harness.Cell(harness.load_json(os.path.join(tiny, "BENCHMARK.json")), workload, root=tiny)
    result = harness.run_cell(cell, 2**31 + 77, 0.5, False, torch.device("cpu"), log=lambda m: None)
    _check_line(result, False)
    assert result["correct"]
    assert {m["name"] for m in cell.end_to_end} == set(result["metrics"])


def test_trace_line_shape(tiny):
    name = "fhd8_420.diff_b32"
    cell = harness.Cell(harness.load_json(os.path.join(tiny, "BENCHMARK.json")), name, root=tiny)
    result = harness.run_cell(cell, 5, 0.5, True, torch.device("cpu"), log=lambda m: None)
    _check_line(result, True)
    # no card, so nothing that reads device time reports
    assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert "diff_roofline" not in result["metrics"]


def test_host_spans_come_from_the_untraced_part():
    """In a traced run the host-clock metrics read spans taken with no
    profiler on; the profiled part keeps spans of its own."""

    class Stepper:
        def __init__(self):
            self.profiled = []

        def step(self):
            with self.spans.span("apply.issue", 1):
                self.profiled.append(self.spans.profile)

        def drain(self):
            pass

    d = Stepper()
    t0, host, prof = harness.run_window(d, 0.2, True)
    assert prof is not None and host is not d.spans
    assert not host.profile and d.spans.profile
    assert host.spans["apply.issue"] and d.spans.spans["apply.issue"]
    assert max(b for _, b in host.spans["apply.issue"]) <= min(a for a, _ in d.spans.spans["apply.issue"])
    assert d.profiled.count(False) == len(host.spans["apply.issue"])
    t0, host, prof = harness.run_window(d, 0.1, False)
    assert prof is None and host is d.spans and not host.profile


def test_cell_config_mix_and_metric_from_files_alone(tiny):
    """A new configuration, mix, cell and per-layer metric, added as files
    and entries only, are found and run."""
    with open(os.path.join(tiny, "benchmark", "configs", "uhd10_420.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="fhd10_422", subsampling=[1, 0], grain=dict(cfg["grain"], ar_lag=3))
    with open(os.path.join(tiny, "benchmark", "configs", "fhd10_422.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(tiny, "benchmark", "traffic", "render_film_b16.json")) as fh:
        mix = json.load(fh)
    mix.update(batch=3, grain={"cb_points": 0, "cr_points": 0})
    with open(os.path.join(tiny, "benchmark", "traffic", "render_luma_b3.json"), "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(tiny, "benchmark", "layer_metrics", "apply.download_ms.py"), "w") as fh:
        fh.write("from yardstick import mean_span_ms\n\n\ndef read(ctx):\n"
                 "    return mean_span_ms(ctx, 'apply.download')\n")
    path = os.path.join(tiny, "BENCHMARK.json")
    b = harness.load_json(path)
    b["configs"].append({"name": "fhd10_422", "source": "x", "file": "benchmark/configs/fhd10_422.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "fhd10_422.render_luma_b3", "config": "fhd10_422",
                           "traffic": "render_luma_b3", "chips": 1, "why": "x"})
    for m in b["end_to_end"]:
        if m["name"] == "apply_fps":
            m["workloads"].append("fhd10_422.render_luma_b3")
    b["per_layer"].append({"name": "apply.download_ms", "unit": "ms", "better": "lower",
                           "source": "host_clock", "layer": "host staging", "moves": "apply_fps",
                           "workloads": ["fhd10_422.render_luma_b3"]})
    with open(path, "w") as fh:
        json.dump(b, fh)
    cell = harness.Cell(harness.load_json(path), "fhd10_422.render_luma_b3", root=tiny)
    assert cell.config["subsampling"] == [1, 0] and cell.traffic["batch"] == 3
    result = harness.run_cell(cell, 9, 0.5, False, torch.device("cpu"), log=lambda m: None)
    assert result["correct"] and set(result["metrics"]) == {"apply_fps", "setup_s"}
    result = harness.run_cell(cell, 9, 0.5, True, torch.device("cpu"), log=lambda m: None)
    assert result["correct"] and "apply.download_ms" in result["metrics"]


def _run(argv, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *argv], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_cli_refuses_without_a_card():
    p = _run(["benchmark/run.py", "--workload", "fhd8_420.render_film_b16", "--seed", str(2**31 + 5),
              "--seconds", "1", "--trace", "0"], ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_cli_refuses_an_unknown_cell():
    p = _run(["benchmark/run.py", "--workload", "nothing", "--seed", "1", "--seconds", "1"], ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder has
    no port to run, and gives no result."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = _run(["benchmark/run.py", "--workload", "uhd10_420.estimate_b16", "--seed", "3",
              "--seconds", "1", "--trace", "0"], tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
