"""One run of one cell: set-up, the window, the metrics, the comparison
with the reference, the result line.

Found by name: the cell in ``BENCHMARK.json``'s ``workloads``; its
configuration (``configs`` entry's ``file``), traffic mix
(``perfbench/traffic/<traffic>.json``, its arrivals
``perfbench/traffic/kinds/<arrivals>.py``), driver and limits
(``perfbench/workloads/<cell>.json``: ``driver`` names
``perfbench/drivers/<driver>.py``); each metric's reader
(``perfbench/metrics/<name before the dot>.py``).  With ``--trace 0``
the cell's end-to-end metrics are reported, with ``--trace 1`` its
per-layer metrics.

Exit codes: 0 a result was printed; 2 no usable CUDA device or a bad
argument; 3 JAX or the JAX package was loaded; 4 the window broke the
harness's rules (a capture inside it, a task that did not go through
K1 and K2)."""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import os
import sys
import time

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Run:
    """What a reader sees of a finished window: the records, the
    window's and set-up's seconds, the trace, and the driver's fields."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def latencies(self):
        return [r.end - r.due if r.ok else math.inf for r in self.records]

    def completed(self):
        return sum(1 for r in self.records if r.ok)

    def untraced(self):
        a, b = self.trace_range or (0, 0)
        return [r for r in self.records if not a <= r.idx < b]


def applies(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: it lists the cell, or
    it lists none."""
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load(root, name):
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    path = confs[cell["config"]]["file"]
    # the file's own path, for errors that name it
    conf = dict(json.load(open(os.path.join(root, path))), file=path)
    from perfbench.harness import traffic as T
    limits = json.load(open(os.path.join(root, "perfbench", "workloads",
                                         f"{name}.json")))
    return bench, cell, conf, T.load(cell["traffic"]), limits


def verdict(numbers, limits):
    """(correct, lines): each number beside its limit."""
    lines, ok = [], True
    for k, v in numbers.items():
        lim = limits[k]
        good = bool(v <= lim)
        ok &= good
        lines.append(f"{k} {v!r} limit {lim!r} {'ok' if good else 'OVER'}")
    return ok, lines


def main(argv, process_start: float, root: str) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, cell, conf, traffic, limits = load(root, args.workload)

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    out = execute(bench, cell, conf, traffic, limits, args.seed,
                  args.seconds, bool(args.trace), dev, process_start)
    if isinstance(out, int):
        return out
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded {found}: the benchmark runs the port "
              f"without JAX or the JAX package", file=sys.stderr)
        return 3
    for line in out.pop("_lines"):
        print(line, file=sys.stderr)
    print(json.dumps(out))
    return 0


def execute(bench, cell, conf, traffic, limits, seed, seconds, trace, dev,
            process_start, fault=None):
    """The run after the look for a device: a result dict (its
    ``_lines`` go to standard error), or an exit code.  ``fault``, a
    callable given the set-up driver, breaks the program underneath
    (the harness's tests)."""
    import torch

    from perfbench.harness import traffic as T
    from perfbench.harness import window as WIN
    from perfbench.harness.trace import read as read_trace

    on_cuda = dev.type == "cuda"
    drivers = importlib.import_module(
        f"perfbench.drivers.{limits['driver']}")
    drv = drivers.Driver(conf, traffic, seed, dev, traced=trace)
    if fault is not None:
        fault(drv)
    if trace and on_cuda:
        WIN.warm_profiler(drv)
    due = T.due_times(traffic, seconds)
    mark = drv.mark()
    # set-up's objects out of the collector's way: a full collection in
    # the window then walks only what the window made
    gc.collect()
    gc.freeze()
    setup_s = time.time() - process_start
    w = WIN.run(drv, seed, seconds, due, trace and on_cuda)
    recs, prof = w["records"], w["profile"]
    trace_range = (prof.first, prof.first + prof.tasks) \
        if prof is not None else None
    problem, more, fields = drv.after_window(mark, recs, trace_range)
    lines = [f"window: {len(recs)} tasks, {w['t1'] - w['t0']:.3f} s, "
             f"{len(w['failures'])} failed"] + more + w["failures"][:5]
    if problem is not None:
        print(f"perfbench: {problem}", file=sys.stderr)
        return 4
    peak = torch.cuda.max_memory_allocated(dev) if on_cuda else 0
    service = [r.end - r.start for r in recs if r.ok]
    if service:
        lines.append(f"service ms: median {1e3 * float(np.median(service))!r}"
                     f" p95 {1e3 * float(np.percentile(service, 95))!r}")
    if due is not None:
        late = [r.start - r.due for r in recs]
        lines.append(f"generator lateness s: median "
                     f"{float(np.median(late))!r} max {max(late)!r}")
    tr = read_trace(prof) if prof is not None else None
    run = Run(records=recs, window_s=w["t1"] - w["t0"], setup_s=setup_s,
              trace=tr, trace_range=trace_range, **fields)
    metrics = {}
    for m in (bench["per_layer"] if trace else bench["end_to_end"]):
        if not applies(m, cell["name"]):
            continue
        reader = importlib.import_module(
            f"perfbench.metrics.{m['name'].split('.')[0]}")
        v = reader.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # ---- the comparison, with the program's state freed
    gc.unfreeze()
    if not w["failures"]:
        t_ref = time.perf_counter()
        numbers = drv.judge(w)
        lines.append(f"reference s: {time.perf_counter() - t_ref!r}")
        correct, check_lines = verdict(numbers, limits["limits"])
    else:
        numbers, correct, check_lines = {}, False, ["failed tasks: no "
                                                    "comparison"]
    del drv
    device = {"platform": "gpu" if on_cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    out = {"correct": bool(correct), "attempted": len(recs),
           "failed": len(recs) - run.completed(), "metrics": metrics,
           "device": device}
    if tr is not None:
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": limits["limits"][k]}
                     for k, v in numbers.items()}
    out["_lines"] = lines + check_lines
    return out
