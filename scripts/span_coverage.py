"""How much of the benchmark's ranges the port's own spans cover, and what
a span costs. Runs on a CUDA card.

    python scripts/span_coverage.py --workload CELL [--seed N] [--seconds S]
    python scripts/span_coverage.py --cost

With ``--workload`` it runs one cell of ``BENCHMARK.json`` as the benchmark
does (``benchmark/harness.py``: set-up, then a window of ``--seconds`` whose
last 4 s run under torch.profiler), then reads the traced part with
``benchmark/program_spans.py``: for each range the benchmark opened around
a call into the port, the share of its time that the port's spans inside
it cover and each span's host ms a call; and the share of the device's
idle time (``yardstick.Trace.idle_gaps``) that falls under a span of the
port. The benchmark's ranges are the ones its path driver recorded.

With ``--cost`` it times one empty span, a million times a mode: off,
summed (the ``spans`` logger at DEBUG), under the profiler, and both.

One JSON line to standard output, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or "no card read"


def span_cost(n: int = 1_000_000) -> dict:
    """us a span costs in each mode: ``with span(name): pass``, less an
    empty loop."""
    import torch

    from grav1synth_tpu_torch.utils import spans

    def loop(body) -> float:
        t0 = time.perf_counter()
        body()
        return (time.perf_counter() - t0) / n * 1e6

    def empty():
        for _ in range(n):
            pass

    def spanned():
        for _ in range(n):
            with spans.span("cost.span"):
                pass

    base = loop(empty)
    out = {"off": loop(spanned) - base}
    spans.log.setLevel(logging.DEBUG)
    out["summed"] = loop(spanned) - base
    spans.log.setLevel(logging.WARNING)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out["profiled"] = loop(spanned) - base
        spans.log.setLevel(logging.DEBUG)
        out["profiled_and_summed"] = loop(spanned) - base
        spans.log.setLevel(logging.WARNING)
    spans.reset()
    return out


def read(driver, host, prof) -> dict:
    """Coverage and idle by span of a window that ``harness.run_window``
    drove with ``trace``; ``host`` holds its untraced spans, ``prof`` its
    profiler."""
    import harness
    import program_spans
    import yardstick

    tr = yardstick.read_trace(prof, harness.WINDOW)
    bench = set(driver.spans.spans)  # the traced part's ranges, the window's among them
    cov = program_spans.coverage(tr, bench)
    cov.pop(harness.WINDOW, None)
    gaps = tr.idle_gaps(harness.WINDOW, n=10_000)
    return {"host_ms_a_call_untraced": {k: sum(v) / len(v) for k in sorted(host.spans)
                                        if (v := host.durations_ms(k))},
            "coverage": cov,
            "idle": {"idle_s": sum(s for _, s in gaps), "window_s": tr.window_s(),
                     "under_port_spans": program_spans.idle_under_port(gaps, bench),
                     "by_range": gaps[:12]}}


def run(workload: str, seed: int, seconds: float) -> dict:
    import torch

    import harness

    cell = harness.Cell(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), workload)
    driver = cell.driver(seed, torch.device("cuda", 0))
    driver.setup()
    _, host, prof = harness.run_window(driver, seconds, True)
    return {"workload": workload, "seed": seed, **read(driver, host, prof)}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--cost", action="store_true")
    args = ap.parse_args(argv)
    out = {"card": card(), "torch": torch.__version__}
    if args.cost:
        out["span_us"] = span_cost()
    if args.workload:
        out.update(run(args.workload, args.seed, args.seconds))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
