"""Readings the check's limits are set from, for one cell, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... \
        --seconds 3 --control-seeds 3 [--out FILE]

For each seed: the cell's set-up, a short window at the cell's own load,
the check (the sound program's readings), and for the first
``--control-seeds`` seeds the control (the reference one precision down
in the program's place). One JSON line a seed, on standard output and in
``--out``. The benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    cell = harness.Cell(harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json")),
                        args.workload)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        driver = cell.driver(seed, dev)
        driver.setup()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        w0, _, _ = harness.run_window(driver, args.seconds, False)
        rec = {"workload": args.workload, "seed": seed, "setup_s": setup_s,
               "rates": driver.end_to_end(w0)}
        t1 = time.perf_counter()
        rec["checks"] = {k: v for k, (v, _) in driver.check().items()}
        rec["check_s"] = time.perf_counter() - t1
        if i < args.control_seeds:
            t2 = time.perf_counter()
            rec["control"] = driver.control()
            rec["control_s"] = time.perf_counter() - t2
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del driver
        gc.collect()
        torch.cuda.empty_cache()
    bad = harness.forbidden_modules()
    if bad:
        print(f"calibrate: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
