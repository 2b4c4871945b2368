"""Quickstart: the whole COACH loop on a small model, in one script, in
the PyTorch port (the twin of ``examples/quickstart.py``).

  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

1. build a reduced gemma2 and its layer-cost graph
2. offline component: joint partition + quantization (Algorithm 1)
3. split the model at the chosen group boundary (CollabRuntime)
4. run a task: end segment -> UAQ-quantized wire packet (the quantize
   kernel) -> cloud segment (the dequantize kernel); compare against the
   monolithic model
5. online component: semantic-cache probe (the probe kernel) -> early
   exit / precision choice

Runs on the CUDA device by default; ``--device cpu`` runs the kernels'
plain PyTorch versions on the CPU.  ``main`` draws the weights and inputs
from seeds and hands them to ``run``, which does the rest.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.configs import get_config
from repro_torch.core import online as ON
from repro_torch.core.collab import CollabRuntime
from repro_torch.core.costs import (A6000_SERVER, JETSON_NX, WIFI_5GHZ,
                                    transformer_graph)
from repro_torch.core.partitioner import coach_offline
from repro_torch.models import model as M


def run(cfg, params, x, centers):
    """Steps 1-5 on ``params`` (on the device of ``x`` and ``centers``),
    the (4, 32) tokens ``x`` and the (8, d_model) probe ``centers``.
    Returns the split's error against the monolithic model and each
    task's separability and choice ("exit", label) or ("bits", b)."""
    # 1. model + cost graph -------------------------------------------------
    graph = transformer_graph(cfg, batch=1, seq=128)
    print(f"model: {cfg.name}  layers={cfg.num_layers}  "
          f"params={M.param_count(params):,}")

    # 2. offline component ---------------------------------------------------
    link = WIFI_5GHZ(50)
    t0 = time.perf_counter()
    off = coach_offline(graph, JETSON_NX, A6000_SERVER, link)
    plan_s = time.perf_counter() - t0
    t = off.times
    print(f"offline: |V_e|={len(off.decision.end_set)} of {len(graph)} "
          f"bits={sorted(set(off.decision.bits.values()))} "
          f"T_e={t.T_e*1e3:.2f}ms T_t={t.T_t*1e3:.2f}ms T_c={t.T_c*1e3:.2f}ms "
          f"B_c={t.B_c*1e3:.2f} B_t={t.B_t*1e3:.2f} obj={off.objective*1e3:.2f}")
    print(f"planner: {off.candidates} candidates in {plan_s*1e3:.1f}ms "
          f"({off.candidates/max(plan_s, 1e-9):.0f} cand/s, batched fast "
          f"scorer + event-sim rescoring)")

    # 3./4. collaborative execution ------------------------------------------
    rt = CollabRuntime(cfg, params, cut_group=1, default_bits=8)
    pkt, boundary = rt.end_step(x)
    logits = rt.cloud_step(pkt)
    ref = rt.monolithic(params, x)
    rel = float(torch.max(torch.abs(logits - ref)) / torch.max(torch.abs(ref)))
    print(f"collab: wire={pkt.wire_bytes}B (fp32 would be "
          f"{boundary.numel()*4}B) rel-err={rel:.4f}")

    # 5. online component -----------------------------------------------------
    sep, best, sims = rt.probe(boundary.to(torch.float32), centers)
    sep, best = sep.cpu().numpy(), best.cpu().numpy()
    th = ON.Thresholds(s_ext=float(np.median(sep)),
                       s_adj=((1.0, 3), (0.5, 4), (0.1, 6)))
    choices = []
    for i in range(4):
        s = float(sep[i])
        if s > th.s_ext:
            choices.append((s, "exit", int(best[i])))
            print(f"task {i}: separability={s:.3f} -> EARLY EXIT "
                  f"label={int(best[i])} (Eq. 10)")
        else:
            b = ON.choose_bits(th.required_bits(s), boundary[i].numel(),
                               50e6, t.T_e, t.T_c)
            choices.append((s, "bits", b))
            print(f"task {i}: separability={s:.3f} -> transmit at "
                  f"{b} bits (Eq. 11)")
    return {"rel_err": rel, "choices": choices}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    cfg = get_config("gemma2-2b").reduced()
    params = M.init_params(cfg, seed=0, device=dev)
    x = torch.randint(0, cfg.vocab_size, (4, 32), device=dev,
                      generator=torch.Generator(dev).manual_seed(1))
    centers = torch.randn((8, cfg.d_model), device=dev,
                          generator=torch.Generator(dev).manual_seed(2))
    return run(cfg, params, x, centers)


if __name__ == "__main__":
    main()
