#!/usr/bin/env python3
"""The benchmark's one command, run from the root of a checkout:

  python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

One process: set-up, warm-up, a window of ``--seconds``, the comparison
with the plain reference, and one JSON line on standard output.  Cells,
configurations, traffic mixes and metrics are found by name from
``BENCHMARK.json`` (see ``perfbench/harness/main.py``)."""

import time

PROCESS_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

# load from one process with few threads: the host side of a task is
# small NumPy and PyTorch calls, and idle OpenMP workers spinning beside
# it only add jitter to the timed path
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from perfbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], PROCESS_START, ROOT))
