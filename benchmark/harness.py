"""The benchmark's driver: one run of one cell.

A cell is a ``workloads`` entry of ``BENCHMARK.json``. It names a
configuration (``configs[].file``, a JSON file of sizes and guarantees)
and a traffic mix (``traffic/<traffic>.json``); the mix names the path
driver (``paths/<path>.py``) that drives the port. Each per-layer metric
is read by ``layer_metrics/<metric>.py``. So a new cell, configuration,
mix or metric is new files and a new entry, and no edit here.

A run: the card is checked; the path driver makes its inputs from the
seed, loads the kernels and warms up (set-up); the window drives the port
for ``seconds`` (with ``trace``, its last ``TRACE_SECONDS`` under
torch.profiler); the peak device memory is read; the driver frees the
program's state and checks what the window produced against the plain
reference; the run fails if a JAX module or the JAX package was loaded;
the last line of standard output is one JSON object.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "grav1synth_tpu")
TRACE_SECONDS = 4.0
WINDOW = "bench.window"


class BenchError(RuntimeError):
    """A run that cannot give a result."""


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    """A module of the benchmark by its file, under a private name."""
    if not os.path.isfile(path):
        raise BenchError(f"no file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``grav1synth_tpu_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Cell:
    """One workload of a benchmark file with everything it names."""

    def __init__(self, bench: dict, name: str, root: str = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise BenchError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(os.path.join(root, configs[self.entry["config"]]["file"]))
        bench_dir = os.path.join(root, "benchmark")
        self.traffic = load_json(os.path.join(bench_dir, "traffic", self.entry["traffic"] + ".json"))
        self.driver_path = os.path.join(bench_dir, "paths", self.traffic["path"] + ".py")
        self.metrics_dir = os.path.join(bench_dir, "layer_metrics")
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)
        ]

    def driver(self, seed: int, device):
        mod = load_module(self.driver_path, "bench_path_" + self.traffic["path"])
        return mod.Driver(self.config, self.traffic, seed, device)

    def reader(self, metric: str):
        return load_module(os.path.join(self.metrics_dir, metric + ".py"),
                           "bench_metric_" + metric.replace(".", "_"))


def card(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": 1}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i",
             str(device.index or 0)], capture_output=True, text=True, timeout=30)
        out["power_limit"] = smi.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["power_limit"] = "not read"
    return out


def _drive(driver, seconds: float) -> float:
    """Step ``driver`` for ``seconds``, then complete the batches in
    flight; returns the start."""
    t0 = time.perf_counter()
    while time.perf_counter() < t0 + seconds:
        driver.step()
    driver.drain()
    return t0


def run_window(driver, seconds: float, trace: bool):
    """Drive ``driver`` for ``seconds``; returns (the window's start, its
    host spans, the profiler or None).

    With ``trace`` the window's last ``TRACE_SECONDS`` (at most half of
    it) run under torch.profiler with spans of their own: the host spans
    returned, which the host-clock metrics read, come from the part
    before, where no profiler slows the host."""
    import torch

    from yardstick import Spans

    traced = min(TRACE_SECONDS, seconds / 2) if trace else 0.0
    driver.spans = host = Spans()
    t0 = _drive(driver, seconds - traced)
    if not trace:
        return t0, host, None
    driver.spans = Spans(profile=True)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
    with prof:
        with driver.spans.span(WINDOW):
            _drive(driver, traced)
    return t0, host, prof


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: Optional[float] = None, log=None) -> dict:
    """One run of ``cell`` on ``device``; returns the result object. The
    tests call this on the CPU; ``main`` on the card only."""
    import torch

    import yardstick

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    driver = cell.driver(seed, device)
    driver.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    t0, host, prof = run_window(driver, seconds, trace)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dev = card(device)
    dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    tr = yardstick.read_trace(prof, WINDOW) if prof is not None else None
    checks = driver.check()
    correct = all(v <= lim for v, lim in checks.values())
    metrics: Dict[str, dict] = {}
    if trace:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s()
        ctx = SimpleNamespace(spans=host, traced=driver.spans, trace=tr, least_ms=driver.least_ms)
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(driver.end_to_end(t0), setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": driver.attempted,
        "failed": driver.attempted - sum(b for _, _, b in driver.done),
        "metrics": metrics,
        "device": dev,
    }
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps(WINDOW)}
    # an infinite gap (a statistic missing) prints as the largest float
    result["checks"] = {k: {"value": v if math.isfinite(v) else sys.float_info.max, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"check {k} {v!r} limit {lim!r}")
    return result


def parse_args(argv):
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    try:
        cell = Cell(load_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    except (OSError, BenchError, KeyError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0
