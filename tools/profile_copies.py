#!/usr/bin/env python3
"""Where a steady request's copy kernels come from, and whether their
profiler records drift between profiles.

  python3 tools/profile_copies.py [--arch mamba2-130m] [--profiles 8]
                                  [--requests 3]

Builds ``chip_smoke.py``'s runtime of phases 5-7 for ``--arch`` (full
width, random weights from seed 0, the planner's cut), with its segment
functions called bare (``chip_smoke.eager_twin``: no CUDA graphs), and
its steady request (fused end step + cloud step), then profiles ``--requests``
requests ``--profiles`` times under ``torch.profiler`` with
``with_stack=True``.  For each profile it counts, for every source line
of the port under which an op launched a ``direct_copy_kernel_cuda``, the
kernel launches the CUDA runtime recorded under that op (its
``cudaLaunchKernel`` children) beside the kernel records that came back;
and over the whole profile all runtime launches beside all kernel
records.  A launch without its kernel record is a record the profiler
dropped; a line whose launches differ between profiles is a copy the
program made a different number of times.  Last, it captures one request
in a CUDA graph and counts its kernel nodes, a count that does not rest
on the profiler.  Prints the card's name and power limit, then one JSON
object.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = "direct_copy_kernel_cuda"


def _is_launch(e) -> bool:
    return "LaunchKernel" in e.name


def _port_line(e) -> str:
    """The innermost frame of the port in the op's Python stack."""
    for frame in e.stack or ():
        if "repro_torch" in frame:
            return frame[frame.index("repro_torch"):]
    return "?"


def copy_census(torch, request, n):
    """One profile of ``n`` requests: {source line: [runtime launches,
    copy kernel records]} over the ops that launched a copy kernel or a
    kernel whose record is missing, and the profile's totals."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # verbose: the ops' Python stacks reach their events
    with torch.no_grad(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            with_stack=True,
            experimental_config=_ExperimentalConfig(verbose=True)) as prof:
        for _ in range(n):
            request()
        torch.cuda.synchronize()
    lines = collections.defaultdict(lambda: [0, 0])
    launches = records = 0
    for e in prof.events():
        if e.device_type != DeviceType.CPU or _is_launch(e):
            continue
        own = sum(1 for c in e.cpu_children if _is_launch(c))
        kernels = [k.name for k in e.kernels
                   if not k.name.startswith(("Memcpy", "Memset"))]
        launches += own
        records += len(kernels)
        copies = sum(1 for k in kernels if COPY in k)
        if copies or own > len(kernels):
            line = lines[f"{e.name} @ {_port_line(e)}"]
            line[0] += own
            line[1] += copies
    return dict(lines), launches, records


def graph_kernel_nodes(torch, CS, request):
    """Kernel nodes of one request captured in a CUDA graph, or the
    reason it could not be captured."""
    try:
        with torch.no_grad():
            return sum(1 for t in CS.graph_node_types(torch, request)
                       if t == 0)
    except Exception as e:  # a request that syncs cannot be captured
        return f"not captured: {type(e).__name__}: {str(e)[:120]}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--profiles", type=int, default=8)
    ap.add_argument("--requests", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.core.collab import CollabRuntime
    from repro_torch.core.costs import (A6000_SERVER, JETSON_NX, WIFI_5GHZ,
                                        transformer_graph)
    from repro_torch.core.partitioner import coach_offline
    from repro_torch.kernels import _build as KB
    from repro_torch.models import model as M
    KB.build()
    KB.lib()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    params = CS.init_params(torch, M, cfg)
    off = coach_offline(transformer_graph(cfg, batch=1, seq=128), JETSON_NX,
                        A6000_SERVER, WIFI_5GHZ(50.0))
    n_end = sum(1 for i in off.decision.end_set if 0 < i <= cfg.num_layers)
    cut_group = min(max(1, round(n_end / cfg.group_size)),
                    cfg.num_groups - 1)
    rt = CS.eager_twin(CollabRuntime(cfg, params, cut_group))
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (1, 8), generator=gen,
                         device="cuda", dtype=torch.int32)
    centers = torch.randn((16, cfg.d_model), generator=gen, device="cuda")

    def request():
        pkt, _ = rt.end_step_fused(toks, centers)
        return rt.cloud_step(pkt)

    with torch.no_grad():
        for _ in range(3):
            request()
    torch.cuda.synchronize()
    profiles = []
    for i in range(args.profiles):
        lines, launches, records = copy_census(torch, request, args.requests)
        profiles.append({"launches": launches, "records": records,
                         "lines": lines})
        print(f"profile {i}: {launches} runtime launches, {records} kernel "
              f"records; copy lines: " + "; ".join(
                  f"{k} {v[0]} launched / {v[1]} copy records"
                  for k, v in sorted(lines.items())), flush=True)
    nodes = graph_kernel_nodes(torch, CS, request)
    print(f"one request captured in a CUDA graph: kernel nodes {nodes}",
          flush=True)
    print(json.dumps({"arch": args.arch, "cut_group": cut_group,
                      "requests": args.requests, "profiles": profiles,
                      "graph_kernel_nodes": nodes, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
