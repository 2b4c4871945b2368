#!/usr/bin/env python3
"""The controls of ``correct``, found through the cell's driver
(``perfbench/drivers/<driver>.py``'s ``CONTROLS``: name -> control):
each puts something below the configuration's precision, or a planted
fault, in the program's place and is judged by the same comparison as a
run, at the cell's own size.  Its numbers have to exceed the cell's
limits.  Not run by the benchmark's runs.  The served split's one
control is ``bfloat16``, the plain reference in bfloat16 (the precision
below the configurations' float32).

  python3 perfbench/control.py --workload <cell> --seeds 1 2 3 \\
      --seconds 10 [--tasks N] [--control NAME ...]

A closed cell's ``--tasks`` (required there) is the number of tasks a
run serves; each control's line names it under ``dtype`` where it is a
precision, else under ``control``.
"""

import importlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def controls(limits) -> dict:
    """The cell's controls, by name, from its driver."""
    return importlib.import_module(
        f"perfbench.drivers.{limits['driver']}").CONTROLS


def control(bench, cell, conf, traffic, limits, seed, seconds, tasks, dev,
            name):
    """(numbers, correct, lines) of the cell's control ``name`` for one
    seed."""
    return controls(limits)[name](bench, cell, conf, traffic, limits, seed,
                                  seconds, tasks, dev)


def main(argv):
    import argparse
    import json

    import torch

    from perfbench.harness.main import load
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tasks", type=int, default=0)
    ap.add_argument("--control", nargs="+", default=None)
    args = ap.parse_args(argv)
    bench, cell, conf, traffic, limits = load(ROOT, args.workload)
    from perfbench.harness import traffic as T
    if T.due_times(traffic, args.seconds) is None and args.tasks < 1:
        ap.error(f"{args.workload} is a closed cell: --tasks, the number "
                 f"of tasks a run of it serves, is required")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    for name in args.control or list(controls(limits)):
        key = "dtype" if isinstance(getattr(torch, name, None),
                                    torch.dtype) else "control"
        for seed in args.seeds:
            numbers, ok, lines = control(bench, cell, conf, traffic, limits,
                                         seed, args.seconds, args.tasks, dev,
                                         name)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              key: name, "correct": ok,
                              "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
