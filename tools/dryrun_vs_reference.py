#!/usr/bin/env python3
"""The port's dry-run held pair for pair against the reference's.

For each (arch, shape) pair, the reference's ``repro.launch.dryrun.
lower_pair`` compiles the step for a fake XLA host platform of the mesh's
device count, in a subprocess of its own; the port's
``repro_torch.launch.dryrun.lower_pair`` traces it on a fake process group
of the same size, in a second subprocess.  Per device, the table sets side
by side each program's roofline flops, roofline collective bytes (both
trip-count-aware: the reference's ``collectives`` dict counts a loop body
once, so it is not the figure to compare) and ``total_nonalias_bytes``,
with the port's figure over the reference's.

The installed JAX makes ``jax.make_mesh``'s axes Explicit by default, and
``with_sharding_constraint`` (the reference's ``shardctx.constrain``)
refuses an Explicit axis.  So the reference's subprocess replaces
``jax.make_mesh`` with a version that asks for Auto axes before it imports
``repro.launch.dryrun``: the reference's own code then compiles as it was
written to.

  python3 tools/dryrun_vs_reference.py gemma2-2b:train_4k [pair ...]
      [--all] [--arch A] [--multi-pod] [--mesh 16,16] [--jobs N]
      [--side both|ref|port] [--by-line] [--hlo DIR] [--json FILE]

``--all`` takes every supported pair (``--arch`` narrows it to one arch);
``--mesh`` sets ``REPRO_MESH_SHAPE`` for both sides; ``--jobs`` runs the
pairs in that many pairs of subprocesses at once.  ``--by-line`` prints
the port's flops and collective bytes grouped by the ``repro_torch``
source line that issued them; ``--hlo DIR`` writes the reference's
``compiled.as_text()`` of each pair there, where each ``dot``'s
``sharding={...}`` shows the layout XLA chose.  ``--json`` writes every
number and ratio; ``--side port`` runs the port alone (on a host without
JAX, such as the card's machine).  Both sides run on CPU meshes (the port's subprocess hides any card), so two hosts' counts
compare.  The exit code is 1 if a pair failed on either side.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

# source lines shown a pair with --by-line, the costliest first
BY_LINE_ROWS = 16

# the three figures compared, each per device: (key, label)
METRICS = (("flops", "flops"), ("coll_bytes", "coll B"),
           ("memory_bytes", "memory B"))

_REF = r"""
import json, os, sys
import jax

_make_mesh = jax.make_mesh


def make_mesh(shape, axes, *args, **kwargs):
    kwargs.setdefault("axis_types",
                      (jax.sharding.AxisType.Auto,) * len(shape))
    return _make_mesh(shape, axes, *args, **kwargs)


jax.make_mesh = make_mesh
from repro.launch import dryrun as D  # XLA_FLAGS is set on its import

pairs, multi_pod, hlo_dir = json.loads(sys.argv[1])
for arch, shape in pairs:
    try:
        _, compiled, rep = D.lower_pair(arch, shape, multi_pod)
        rep["jax"] = jax.__version__
        if compiled is not None and hlo_dir:
            with open(os.path.join(hlo_dir, f"{arch}_{shape}.hlo"), "w") as f:
                f.write(compiled.as_text())
    except Exception as e:  # one pair's failure must not stop the others
        rep = {"arch": arch, "shape": shape, "error": repr(e)}
    print("REPORT " + json.dumps(rep), flush=True)
"""

_PORT = r"""
import collections, json, math, sys, traceback
import torch
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_cost as HC
from repro_torch.launch.mesh import production_shape

torch.set_num_threads(1)  # meta tensors: nothing to compute
pairs, multi_pod, by_line = json.loads(sys.argv[1])
lines = collections.defaultdict(lambda: [0.0, 0.0])
if by_line:
    dispatch = HC._Recorder.__torch_dispatch__

    # a backward op is filed under the forward line that made its node
    # (anomaly mode keeps each node's forward stack), and a forward op that
    # a checkpoint reruns in the backward pass under its own line; an op of
    # shardctx's (a pin's redistribution) under the model line calling it
    torch.autograd.set_detect_anomaly(True, check_nan=False)

    def port_line(frames):
        for path, lineno in reversed(frames):
            if "repro_torch" in path and "hlo_cost" not in path \
                    and "shardctx" not in path:
                return f"{path[path.rindex('repro_torch'):]}:{lineno}"
        return None

    def where():
        line = port_line([(f.filename, f.lineno)
                          for f in traceback.extract_stack()]) or "?"
        node = torch._C._current_autograd_node()
        if node is None:
            return line
        if not line.startswith("repro_torch/launch/steps.py"):
            return line + " (recompute)"
        stack = "".join(node.metadata.get("traceback_", []))
        fwd = port_line([(l.split('"')[1], l.split("line ")[1].split(",")[0])
                         for l in stack.splitlines()
                         if l.strip().startswith("File ")])
        return (fwd or line) + " (backward)"

    def recorded(self, func, types, args=(), kwargs=None):
        n = len(self.ops)
        out = dispatch(self, func, types, args, kwargs)
        if len(self.ops) > n:
            op = self.ops[-1]
            if op.flops or op.coll_bytes:
                acc = lines[where()]
                acc[0] += op.flops
                acc[1] += op.coll_bytes
        return out

    HC._Recorder.__torch_dispatch__ = recorded
D.init_fake_group(math.prod(production_shape(multi_pod)))
for arch, shape in pairs:
    lines.clear()
    try:
        _, rep = D.lower_pair(arch, shape, multi_pod)
        rep["torch"] = torch.__version__
        rep["by_line"] = dict(lines)
    except Exception as e:  # one pair's failure must not stop the others
        rep = {"arch": arch, "shape": shape, "error": repr(e)}
    print("REPORT " + json.dumps(rep), flush=True)
"""


def figures(rep: dict) -> dict:
    """The compared figures of one side's report.  Flops and collective
    bytes are the roofline's, which multiply a loop body by its trip
    count; the reference's ``collectives`` dict counts each body once."""
    return {"flops": rep["roofline"]["flops"],
            "coll_bytes": rep["roofline"]["coll_bytes"],
            "memory_bytes": rep["memory"]["total_nonalias_bytes"]}


def supported_pairs(arch=None):
    sys.path.insert(0, SRC)
    from repro_torch.configs import ARCHS, SHAPES, get_config, shape_supported
    return [(a, s) for a in ARCHS for s in SHAPES
            if arch in (None, a) and shape_supported(get_config(a),
                                                      SHAPES[s])[0]]


def _start(script, payload, env):
    return subprocess.Popen([sys.executable, "-c", script,
                             json.dumps(payload)], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _reports(proc, side):
    out, err = proc.communicate()
    reps = {}
    for line in out.splitlines():
        if line.startswith("REPORT "):
            rep = json.loads(line[len("REPORT "):])
            reps[(rep["arch"], rep["shape"])] = rep
    if proc.returncode:
        print(f"[{side}] exited {proc.returncode}: {err[-3000:]}",
              file=sys.stderr)
    return reps


def run(pairs, multi_pod=False, mesh=None, jobs=1, side="both",
        by_line=False, hlo_dir=None):
    """{(arch, shape): {"ref": report, "port": report}} of ``pairs``,
    ``jobs`` chunks at a time, each chunk a reference and a port
    subprocess side by side."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               REPRO_DRYRUN_DEVICES=str(
                   math.prod(mesh) if mesh else (512 if multi_pod else 256)),
               CUDA_VISIBLE_DEVICES="")
    if mesh:
        env["REPRO_MESH_SHAPE"] = ",".join(map(str, mesh))
    else:
        env.pop("REPRO_MESH_SHAPE", None)
    if hlo_dir:
        os.makedirs(hlo_dir, exist_ok=True)
    chunks = [pairs[i::jobs] for i in range(min(jobs, len(pairs)))]
    procs = []
    for chunk in chunks:
        if side in ("both", "ref"):
            procs.append(("ref", _start(_REF, [chunk, multi_pod, hlo_dir],
                                        env)))
        if side in ("both", "port"):
            procs.append(("port", _start(_PORT, [chunk, multi_pod, by_line],
                                         env)))
    out = {p: {} for p in pairs}
    for name, proc in procs:
        for key, rep in _reports(proc, name).items():
            out[key][name] = rep
    return out


def _fmt(rep, key):
    if rep is None:
        return "-"
    if "error" in rep:
        return "FAIL"
    return f"{figures(rep)[key]:.4g}"


def ratios(res: dict) -> dict:
    """Port over reference, per compared figure (when both sides ran)."""
    ref, port = res.get("ref"), res.get("port")
    if not ref or not port or "error" in ref or "error" in port:
        return {}
    r, p = figures(ref), figures(port)
    return {k: p[k] / r[k] if r[k] else math.inf for k, _ in METRICS}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("pairs", nargs="*", help="arch:shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None, help="e.g. 2,2 (REPRO_MESH_SHAPE)")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--side", choices=("both", "ref", "port"),
                    default="both")
    ap.add_argument("--by-line", action="store_true")
    ap.add_argument("--hlo", default=None, metavar="DIR")
    ap.add_argument("--json", default=None, metavar="FILE")
    args = ap.parse_args()
    pairs = [tuple(p.split(":")) for p in args.pairs]
    t0 = time.time()
    if args.all:
        pairs += supported_pairs(args.arch)
    assert pairs, "give arch:shape pairs or --all"
    mesh = tuple(int(v) for v in args.mesh.split(",")) if args.mesh else None
    res = run(pairs, args.multi_pod, mesh, args.jobs, args.side,
              args.by_line, args.hlo)
    versions = sorted({f"{k} {rep[k]}" for r in res.values()
                       for rep in r.values() if isinstance(rep, dict)
                       for k in ("torch", "jax") if k in rep})
    print(f"per device, {', '.join(versions)} "
          f"({time.time() - t0:.0f} s)")
    print(f"{'pair':34s}" + "".join(
        f"{'ref ' + lab:>14s}{'port ' + lab:>14s}{'x':>7s}"
        for _, lab in METRICS))
    failed = 0
    for pair in pairs:
        r = res[pair]
        ref, port = r.get("ref"), r.get("port")
        failed += any(s is not None and "error" in s for s in (ref, port))
        rat = ratios(r)
        print(f"{pair[0] + ' ' + pair[1]:34s}" + "".join(
            f"{_fmt(ref, k):>14s}{_fmt(port, k):>14s}"
            + (f"{rat[k]:>7.2f}" if k in rat else f"{'-':>7s}")
            for k, _ in METRICS))
        for side in ("ref", "port"):
            if r.get(side) and "error" in r[side]:
                print(f"    {side} failed: {r[side]['error'][:300]}")
        if args.by_line and port and "by_line" in port:
            rows = sorted(port["by_line"].items(),
                          key=lambda kv: -(kv[1][0] + kv[1][1]))
            tot = figures(port)
            for line, (fl, cb) in rows[:BY_LINE_ROWS]:
                print(f"    {line:44s} flops {fl:10.4g} "
                      f"({100 * fl / max(tot['flops'], 1):5.1f}%)  coll B "
                      f"{cb:10.4g} "
                      f"({100 * cb / max(tot['coll_bytes'], 1):5.1f}%)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({f"{a} {s}": {**v, "ratios": ratios(v)}
                       for (a, s), v in res.items()}, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
