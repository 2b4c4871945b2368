"""Serving launcher: the COACH collaborative split (end / cloud) with the
online scheduler in the loop, in PyTorch (mirrors
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --requests 64

Runs on the CUDA device by default; ``serve(..., device="cpu")`` runs the
plain PyTorch versions of the kernels on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import online as ON
from repro_torch.core.collab import CollabRuntime
from repro_torch.core.costs import (A6000_SERVER, JETSON_NX, WIFI_5GHZ,
                                    transformer_graph)
from repro_torch.core.partitioner import coach_offline
from repro_torch.data.pipeline import CorrelatedTaskStream
from repro_torch.models import model as M
from repro_torch.obs.bubbles import attribute, chain_resources
from repro_torch.obs.export import text_summary
from repro_torch.obs.trace import TraceRecorder
from repro_torch.serving.engine import CoachEngine, EngineConfig


def serve(arch: str, *, smoke: bool = True, requests: int = 200,
          bandwidth_mbps: float = 50.0, correlation: str = "medium",
          seed: int = 0, verbose: bool = True, device="cuda", params=None):
    """``params`` (the port's parameter dict on ``device``, e.g. from
    ``models.model.params_from_numpy``) replaces the seeded random
    weights."""
    dev = require_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.reduced()
    if params is None:
        params = M.init_params(cfg, seed=seed, device=dev)

    # ---- offline component: partition + precision on the cost graph
    graph = transformer_graph(cfg, batch=1, seq=128)
    link = WIFI_5GHZ(bandwidth_mbps)
    off = coach_offline(graph, JETSON_NX, A6000_SERVER, link)
    # map the layer cut to a group boundary (embed node is id 0)
    n_end_layers = sum(1 for i in off.decision.end_set
                       if 0 < i <= cfg.num_layers)
    cut_group = min(max(1, round(n_end_layers / cfg.group_size)),
                    cfg.num_groups - 1)
    rt = CollabRuntime(cfg, params, cut_group)

    # ---- online component: semantic cache keyed on *real* boundary GAP
    # features (the exact features the fused boundary pass emits), so the
    # fused probe's Eq. 8-10 outputs are consistent with the cache state
    stream = CorrelatedTaskStream(n_labels=16, dim=cfg.d_model,
                                  correlation=correlation, seed=seed)

    def task_input(task):
        if cfg.embed_inputs:
            return torch.as_tensor(np.tile(task.features[None, None, :],
                                           (1, 8, 1)), dtype=torch.float32,
                                   device=dev)
        toks = (np.abs((task.features[:8] * 1000).astype(np.int64))
                % cfg.vocab_size).astype(np.int32)
        return torch.as_tensor(toks, device=dev)[None]

    calib_tasks = stream.tasks(300)
    calib_inp = torch.cat([task_input(t) for t in calib_tasks], dim=0)
    h_calib = rt._seg_fns[0](rt.p_end, calib_inp)
    # same sum/seq_len GAP expression as kernels.boundary's epilogue
    feats = (torch.sum(h_calib.to(torch.float32), dim=1)
             / h_calib.shape[1]).cpu().numpy()
    labels = np.asarray([t.label for t in calib_tasks])
    rec = TraceRecorder()
    engine = CoachEngine(rt, off.times, JETSON_NX, link, A6000_SERVER,
                         n_labels=16, calib_feats=feats, calib_labels=labels,
                         boundary_elems=128 * cfg.d_model,
                         cfg=EngineConfig(trace=rec))

    def classify(task):
        # fused boundary path: the end segment's forward + quantize +
        # pack + semantic probe read the boundary activation once; the
        # probe outputs (against the cache's current trained centers)
        # feed the scheduler directly instead of a second GAP/cosine pass
        centers, valid = engine.sched.probe_centers()
        pkt, probe = rt.end_step_fused(
            task_input(task),
            torch.as_tensor(centers, dtype=torch.float32, device=dev))
        logits = rt.cloud_step(pkt)
        pr = ON.ProbeResult.from_fused(
            probe.sims[0].cpu().numpy(), probe.sep[0].cpu().numpy(),
            probe.best[0].cpu().numpy(), valid, n_labels=stream.n_labels)
        return (probe.feat[0].cpu().numpy(),
                int(np.argmax(logits[0].cpu().numpy()) % stream.n_labels),
                pr)

    tasks = stream.tasks(requests)
    t0 = time.time()
    stats = engine.run_stream(tasks, arrival_period=off.times.max_stage,
                              classify=classify)
    wall = time.time() - t0
    if verbose:
        pr = stats.pipeline
        print(f"arch={cfg.name} cut_group={cut_group}/{cfg.num_groups} "
              f"bits(offline)={sorted(set(off.decision.bits.values()))}")
        print(f"requests={requests} exit_ratio={stats.exit_ratio:.2%} "
              f"mean_bits={stats.mean_bits:.1f} "
              f"wire_kb/task={stats.wire_kb_per_task:.1f}")
        print(f"latency mean={pr.mean_latency*1e3:.2f}ms p99="
              f"{pr.p99_latency*1e3:.2f}ms thpt={pr.throughput:.1f} it/s "
              f"cloud_bubbles={pr.bubble_fraction('cloud'):.2%} "
              f"(wall {wall:.1f}s)")
        att = attribute(rec, resources=chain_resources(
            pr.n_hops, pr.pool_sizes or None))
        print("bubble attribution (why each resource idled):")
        print(text_summary(att))
    return stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="gemma2-2b")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--bandwidth", type=float, default=50.0)
    ap.add_argument("--correlation", choices=("low", "medium", "high"),
                    default="medium")
    args = ap.parse_args()
    serve(args.arch, requests=args.requests,
          bandwidth_mbps=args.bandwidth, correlation=args.correlation)


if __name__ == "__main__":
    main()
