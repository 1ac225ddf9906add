"""Run one cell of the benchmark once on the card and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic,
metrics and limits are found by name from BENCHMARK.json (see
portbench/README.md). The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer metrics), device, with --trace 1 the
breakdown, and last the numbers compared with their limits ("checks"),
which also end standard error. Exits non-zero without a result when no
CUDA device is present, the cell asks for more devices than there are, or
JAX or the JAX package was loaded.
"""

import os
import sys
import time

T0 = time.perf_counter()  # set-up counts from here

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from portbench.harness.main import main

    sys.exit(main(sys.argv[1:], T0))
