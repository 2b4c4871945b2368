#!/usr/bin/env python3
"""The control of ``correct``: the plain reference put in the program's
place and computed in bfloat16 (the precision below the configurations'
float32), judged by the same comparison as a run, at the cell's own
size: the same weights, calibration and tasks as a run of that seed, as
many tasks as a run serves (an open cell's ``rate * seconds``; a closed
cell's ``--tasks``) and the same seeded sample.  Its numbers have to
exceed the cell's limits.  Not run by the benchmark's runs.

  python3 perfbench/control.py --workload <cell> --seeds 1 2 3 \\
      --seconds 10 [--tasks N]
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def control(bench, cell, conf, traffic, limits, seed, seconds, tasks, dev,
            dtype):
    """(numbers, correct, lines) of the reference in ``dtype`` against
    the reference in float32, for one seed."""
    from perfbench.harness import judge as J
    from perfbench.harness import traffic as T
    from perfbench.harness import weights as W
    from perfbench.harness.main import verdict
    from perfbench.harness.served import CALIB_TASKS, port_config
    from perfbench.harness.taskstream import TaskStream, task_tokens
    from perfbench.harness.window import sample_of
    from repro_torch.models import model as M

    cfg = port_config(conf)
    S = int(traffic["seq_len"])
    meta = M.init_params(cfg, device="meta")
    params = W.make(meta, seed, dev)
    stream = TaskStream(n_labels=int(traffic["n_labels"]), dim=cfg.d_model,
                        correlation=traffic["correlation"], seed=seed)
    due = T.due_times(traffic, seconds)
    n = len(due) if due is not None else tasks
    calib = [(task_tokens(t, S, cfg.vocab_size), t.label)
             for t in stream.tasks(CALIB_TASKS)]
    served = [(task_tokens(t, S, cfg.vocab_size), t.label)
              for t in stream.tasks(n)]
    calib_labels = [y for _, y in calib]
    labels = [y for _, y in served]
    sample = sample_of(seed, n)
    got = J.serve_like(conf, traffic,
                       J.outputs(conf, params, calib, served, sample, S, dev,
                                 dtype), calib_labels, labels, dtype)
    want = J.outputs(conf, params, calib, served, sample, S, dev,
                     packets=got["packets"])
    numbers = J.compare(conf, traffic, got, want, calib_labels, labels)
    ok, lines = verdict(numbers, limits["limits"])
    return numbers, ok, lines


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
    args = ap.parse_args(argv)
    bench, cell, conf, traffic, limits = load(ROOT, args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    for seed in args.seeds:
        numbers, ok, lines = control(bench, cell, conf, traffic, limits,
                                     seed, args.seconds, args.tasks, dev,
                                     torch.bfloat16)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": "bfloat16", "correct": ok,
                          "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
