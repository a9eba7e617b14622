"""Runs one cell of the port's H100 benchmark:

    python3 h100_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the run's numbers, then as its last
line one JSON object (correct, attempted, failed, metrics, device, with
--trace 1 breakdown, and last the compared numbers beside their limits).
Exits non-zero, printing no result, without a CUDA device, with fewer
devices than the cell asks for, or when JAX or the JAX package got
loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    # the checkout's root in place of this folder, whose module names
    # (checks, devtrace, ...) must not shadow others
    sys.path[0] = ROOT
    from h100_bench.harness import main

    sys.exit(main(t_start=T_START))
