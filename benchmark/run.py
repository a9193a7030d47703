"""Run one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the run's result as one JSON object;
the numbers the check compared, each with its limit, are the last lines of
standard error. See ``harness.py``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
