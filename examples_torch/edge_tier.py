"""End -> edge -> cloud (3-hop) collaborative serving scenario, in the
PyTorch port (the twin of ``examples/edge_tier.py``).

The full COACH stack on a three-tier deployment: the multi-hop offline
component picks an ordered multi-cut (Jetson end, AGX-Orin edge, A6000
cloud; WiFi uplink + metro-ethernet backhaul), the model runs as three
``CollabRuntime`` segments with one quantized ``WirePacket`` per hop, the
online component decides early exit / adaptive precision per task —
including *hop-level* semantic exits: the edge tier runs its own
calibrated probe on its boundary activation and terminates confident
tasks there, releasing the backhaul and the cloud — and the
``2n+1``-resource pipeline accounts latency, throughput, and
per-resource bubbles.  A classic 2-tier (end -> cloud) run of the same
model/stream prints alongside for comparison; the ``exit_hops``
histogram line shows where tasks left the chain (segment 0 = end
device, 1 = edge tier).

  PYTHONPATH=src python examples_torch/edge_tier.py \
      [--arch gemma2-2b] [--requests 64] [--bandwidth 50] [--device cpu]

Runs on the CUDA device by default; ``--device cpu`` runs the kernels'
plain PyTorch versions on the CPU.  ``chip_smoke.py`` phase 9 plans and
serves its three-tier runs through ``make_stream``, ``plan_tier``,
``engine_kwargs`` and ``make_classify``.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.collab import CollabRuntime
from repro_torch.core.costs import (A6000_SERVER, EDGE_AGX_ORIN, ETH_LAN,
                                    JETSON_NX, WIFI_5GHZ, transformer_graph)
from repro_torch.core.partitioner import coach_offline_multihop
from repro_torch.data.pipeline import (CorrelatedTaskStream,
                                       make_hop_calibration_sets)
from repro_torch.models import model as M
from repro_torch.serving.async_engine import AsyncCoachEngine
from repro_torch.serving.engine import CoachEngine


def group_cuts_from_frontiers(decision, cfg):
    """Map the layer-level multi-cut onto strictly increasing group
    boundaries of the stacked parameters (embed node is id 0)."""
    cuts = []
    lo = 1
    for k, frontier in enumerate(decision.cuts):
        n_layers = sum(1 for i in frontier if 0 < i <= cfg.num_layers)
        hi = cfg.num_groups - (decision.n_hops - k)
        cut = min(max(lo, round(n_layers / cfg.group_size)), hi)
        cuts.append(cut)
        lo = cut + 1
    return tuple(cuts)


def make_stream(cfg, seed):
    """(task stream, calibration sets): two probe depths, the end
    device's boundary and the edge tier's (decay 0.9, matching
    benchmarks/multihop.py's cascade)."""
    stream = CorrelatedTaskStream(n_labels=16, dim=cfg.d_model,
                                  correlation="medium", seed=seed,
                                  n_probe_depths=2, depth_decay=0.9)
    return stream, make_hop_calibration_sets(stream, n=300)


def plan_tier(cfg, params, graph, devices, links):
    """The offline plan of one deployment and the runtime split by it:
    (plan, group cuts, bits a hop, runtime, planner seconds)."""
    t0 = time.perf_counter()
    off = coach_offline_multihop(graph, devices, links)
    plan_s = time.perf_counter() - t0
    cuts = group_cuts_from_frontiers(off.decision, cfg)
    hop_bits = [int(np.mean(list(b.values()))) if b else 8
                for b in off.decision.all_hop_bits]
    rt = CollabRuntime(cfg, params, cuts, default_bits=hop_bits)
    return off, cuts, hop_bits, rt, plan_s


def engine_kwargs(cfg, links, hop_bits, calib_sets):
    """The engines' options: one calibration set per intermediate tier
    activates that tier's semantic probe (hop-level early exit); the
    2-tier run gets none."""
    feats, labels = calib_sets[0]
    return dict(n_labels=16, calib_feats=feats, calib_labels=labels,
                boundary_elems=128 * cfg.d_model, links=list(links),
                hop_bits_offline=hop_bits,
                hop_calib=calib_sets[1:len(links)])


def make_classify(rt, cfg, stream, device):
    """(tokens, classify): a task's 8 tokens on ``device``, and the
    engines' ``classify``, which runs them through ``rt.run``."""
    def tokens(task):
        toks = (np.abs((task.features[:8] * 1000).astype(np.int64))
                % cfg.vocab_size).astype(np.int32)
        return torch.as_tensor(toks, device=device)[None]

    def classify(task):
        logits, _packets = rt.run(tokens(task))
        return (task.hop_features, int(torch.argmax(logits[0]))
                % stream.n_labels)

    return tokens, classify


def run_tier(cfg, params, graph, devices, links, stream, calib_sets,
             requests: int, seed: int, device="cuda"):
    off, cuts, hop_bits, rt, plan_s = plan_tier(cfg, params, graph,
                                                devices, links)
    kw = engine_kwargs(cfg, links, hop_bits, calib_sets)
    mk_engine = lambda cls: cls(rt, off.times, devices[0], links[0],
                                devices[-1], **kw)
    _, classify = make_classify(rt, cfg, stream, device)

    tasks = stream.tasks(requests)
    with torch.no_grad():
        stats = mk_engine(CoachEngine).run_stream(
            list(tasks), arrival_period=off.times.max_stage,
            classify=classify)
        # same stream through the async hop-queue executor (fresh engine,
        # so the semantic cache sees an identical decision sequence)
        astats = mk_engine(AsyncCoachEngine).run_stream(
            list(tasks), arrival_period=off.times.max_stage,
            classify=classify)
    return off, cuts, stats, astats, plan_s


def main(argv=None, params=None):
    """``params`` (the port's parameter dict on the device) replaces the
    seeded random weights."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="gemma2-2b")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--bandwidth", type=float, default=50.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    cfg = get_config(args.arch).reduced(num_layers=4 * len(
        get_config(args.arch).pattern))  # >= 4 groups for a 3-segment split
    if params is None:
        params = M.init_params(cfg, seed=args.seed, device=dev)
    graph = transformer_graph(cfg, batch=1, seq=128)
    stream, calib_sets = make_stream(cfg, args.seed)

    tiers = {
        "end->cloud": ((JETSON_NX, A6000_SERVER),
                       (WIFI_5GHZ(args.bandwidth),)),
        "end->edge->cloud": ((JETSON_NX, EDGE_AGX_ORIN, A6000_SERVER),
                             (WIFI_5GHZ(args.bandwidth), ETH_LAN())),
    }
    out = {}
    for name, (devices, links) in tiers.items():
        off, cuts, stats, astats, plan_s = run_tier(
            cfg, params, graph, devices, links, stream, calib_sets,
            args.requests, args.seed, dev)
        out[name] = (cuts, stats, astats)
        pr = stats.pipeline
        bubbles = " ".join(
            f"c{k}={pr.bubble_fraction(('compute', k)):.2f}"
            for k in range(len(devices)))
        bubbles += " " + " ".join(
            f"l{k}={pr.bubble_fraction(('link', k)):.2f}"
            for k in range(len(links)))
        print(f"[{name}] arch={cfg.name} cuts={cuts}/{cfg.num_groups} "
              f"objective={off.objective * 1e3:.2f}ms")
        print(f"  planner: {off.candidates} candidates in "
              f"{plan_s * 1e3:.1f}ms "
              f"({off.candidates / max(plan_s, 1e-9):.0f} cand/s)")
        print(f"  exit_ratio={stats.exit_ratio:.2%} "
              f"exit_hops={stats.exit_hops or {}} "
              f"mean_bits={stats.mean_bits:.1f} "
              f"wire_kb/task={stats.wire_kb_per_task:.1f}")
        print(f"  latency mean={pr.mean_latency * 1e3:.2f}ms "
              f"p99={pr.p99_latency * 1e3:.2f}ms "
              f"thpt={pr.throughput:.1f} it/s bubbles: {bubbles}")
        pa = astats.pipeline
        same = (astats.exit_ratio == stats.exit_ratio
                and astats.mean_bits == stats.mean_bits
                and astats.accuracy == stats.accuracy)
        print(f"  [async] latency mean={pa.mean_latency * 1e3:.2f}ms "
              f"p99={pa.p99_latency * 1e3:.2f}ms "
              f"thpt={pa.throughput:.1f} it/s "
              f"decisions_match_sync={same}")
    return out


if __name__ == "__main__":
    main()
