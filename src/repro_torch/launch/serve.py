"""Serving launcher: the COACH collaborative split (end / cloud) with the
online scheduler in the loop, in PyTorch (mirrors
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --requests 64

Runs on the CUDA device by default; ``--device cpu`` (``serve(...,
device="cpu")``) runs the plain PyTorch versions of the kernels on the
CPU.

The latency, throughput and bubble figures it prints are modelled from
the cost profiles (Jetson NX end, A6000 cloud, the WiFi link), not
measured.  ``--trace PATH`` (``serve(..., trace_path=PATH)``) records the
runtime's wall-clock spans (``obs.runtime``) over the served tasks, prints
their medians a task beside the modelled figures, and writes them to
``PATH`` as Chrome trace-event JSON on the Unix-epoch clock, to open
beside a ``torch.profiler`` export.
"""

from __future__ import annotations

import argparse
import dataclasses
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
from repro_torch.obs import runtime as RT
from repro_torch.obs.bubbles import attribute, chain_resources
from repro_torch.obs.export import text_summary, write_runtime_trace
from repro_torch.obs.trace import TraceRecorder
from repro_torch.serving.engine import CoachEngine, EngineConfig


def serve(arch: str, *, smoke: bool = True, requests: int = 200,
          bandwidth_mbps: float = 50.0, correlation: str = "medium",
          seed: int = 0, verbose: bool = True, device="cuda", params=None,
          trace_path=None):
    """``params`` (the port's parameter dict on ``device``, e.g. from
    ``models.model.params_from_numpy``) replaces the seeded random
    weights; the model then runs at their depth (their group count times
    the pattern's length), so a depth-cut model serves too.
    ``trace_path`` records the served tasks' wall-clock spans and writes
    them there (see the module's docstring)."""
    dev = require_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.reduced()
    if params is None:
        params = M.init_params(cfg, seed=seed, device=dev)
    else:
        cfg = dataclasses.replace(cfg, num_layers=cfg.group_size
                                  * M.group_count(params["groups"]))

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
    if trace_path is not None:
        RT.enable().clear()
    t0 = time.time()
    try:
        stats = engine.run_stream(tasks, arrival_period=off.times.max_stage,
                                  classify=classify)
    finally:
        if trace_path is not None:
            RT.disable()
    wall = time.time() - t0
    spans = RT.RECORDER.spans() if trace_path is not None else []
    if trace_path is not None:
        write_runtime_trace(trace_path, spans, RT.RECORDER.offset_ns)
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
              f"(wall {wall:.1f}s; latency, throughput and bubbles "
              f"modelled from the cost profiles, not measured)")
        if spans:
            print(measured_summary(spans, [t.id for t in tasks]))
        att = attribute(rec, resources=chain_resources(
            pr.n_hops, pr.pool_sizes or None))
        print("bubble attribution (why each resource idled):")
        print(text_summary(att))
    return stats


def measured_summary(spans, tasks) -> str:
    """The medians a task of the runtime's wall-clock spans: the
    scheduler's own time (``decide`` less ``classify``, ``plan_for``,
    ``account``), the host time in ``segment`` and in ``jit`` spans, and
    the device time of the graph replays (on a card)."""
    def med(names, less=(), value=RT.host_ns):
        ms = RT.median_ms(spans, tasks, names, less, value)
        return "-" if ms is None else f"{ms:.3f}ms"

    sched = med(("decide", "plan_for", "account"), less=("classify",))
    return (f"measured (wall-clock spans, median a task): scheduler {sched} "
            f"segment {med(('segment',))} jit {med(('jit',))} "
            f"graph device {med(('jit.replay',), value=RT.device_ns)}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="gemma2-2b")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--bandwidth", type=float, default=50.0)
    ap.add_argument("--correlation", choices=("low", "medium", "high"),
                    default="medium")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="record the runtime's wall-clock spans and write "
                         "them to PATH (Chrome trace-event JSON)")
    args = ap.parse_args()
    serve(args.arch, requests=args.requests,
          bandwidth_mbps=args.bandwidth, correlation=args.correlation,
          device=args.device, trace_path=args.trace)


if __name__ == "__main__":
    main()
