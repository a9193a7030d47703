"""The benchmark's CPU tests: its own folder and the checkout on the path,
the card marker, and a copy of the benchmark at a tiny size."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

TINY = {"width": 128, "height": 96}
# the diff path's cell, kept out of BENCHMARK.json while its runs spread
# wider than its bound allows (PERF.md §7), added to the tiny copy as
# entries alone, as a later PR would add it
DIFF_CELL = {"name": "fhd8_420.diff_b32", "config": "fhd8_420", "traffic": "diff_b32", "chips": 1,
             "why": "grav1synth diff, B=32 1080p8 pairs"}
DIFF_METRICS = [
    {"name": "diff.h2d_ms", "unit": "ms", "better": "lower", "source": "device_trace",
     "layer": "host staging", "moves": "diff_fps", "workloads": ["fhd8_420.diff_b32"]},
    {"name": "diff_roofline", "unit": "%", "better": "higher", "source": "device_trace",
     "layer": "kernels", "moves": "diff_fps", "workloads": ["fhd8_420.diff_b32"]},
    {"name": "diff.idle_share", "unit": "%", "better": "lower", "source": "device_trace",
     "layer": "device", "moves": "diff_fps", "workloads": ["fhd8_420.diff_b32"]},
]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips where there is none)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the port's CUDA kernels")
    return torch.device("cuda", 0)


def tiny_copy(dest) -> str:
    """The benchmark (BENCHMARK.json and its folder) copied under ``dest``,
    every configuration cut to 128x96 and every mix to batches of 4 from
    pools of 8 frames, the diff cell added; returns the copy's root."""
    root = str(dest)
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for c in bench["configs"]:
        path = os.path.join(root, c["file"])
        with open(path) as fh:
            cfg = json.load(fh)
        cfg.update(TINY)
        with open(path, "w") as fh:
            json.dump(cfg, fh)
    traffic = os.path.join(root, "benchmark", "traffic")
    for name in os.listdir(traffic):
        with open(os.path.join(traffic, name)) as fh:
            mix = json.load(fh)
        mix.update(batch=4, pool_frames=8, warmup_batches=1)
        if "table_pool" in mix:
            mix["table_pool"] = 6
        with open(os.path.join(traffic, name), "w") as fh:
            json.dump(mix, fh)
    bench["workloads"].append(DIFF_CELL)
    bench["end_to_end"].insert(0, {"name": "diff_fps", "unit": "frames/s", "better": "higher",
                                   "bound": 0.25, "source": "host_clock",
                                   "workloads": ["fhd8_420.diff_b32"]})
    bench["per_layer"] += DIFF_METRICS
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return root


@pytest.fixture
def tiny(tmp_path):
    return tiny_copy(tmp_path)
