"""Multi-pod dry-run: run every (architecture x input shape) step once on
the production meshes, on meta DTensors, and record per-device memory,
cost and collective analysis (the port's counterpart of
``repro.launch.dryrun``).

The reference lowers and compiles each step for 512 fake XLA host
devices.  Here a fake process group of the mesh's size (256 or 512
ranks) stands in for the cluster: this process is rank 0, the
collectives DTensor issues complete without sending anything, and the
parameters, optimizer state, caches and inputs are meta DTensors laid
out by ``launch.sharding``, so nothing is allocated.  The step runs once
under ``activation_sharding(layout_specs(...))`` and
``implicit_replication()`` and ``hlo_cost.trace_step`` records rank 0's
local ops.  The report has the reference's keys, except that the
reference's ``lower_s`` and ``compile_s`` become ``trace_s`` (the wall
time of the recorded step) and XLA's own uncorrected cost counters
(``xla_flops_raw``, ``xla_bytes_raw``) have no counterpart.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--arch A] [--multi-pod] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_supported
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import hlo_cost as HC
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.launch.sharding import (NamedSharding, P, batch_spec,
                                         distribute, layout_specs,
                                         serving_layout_fits, shard_cache,
                                         shard_params)
from repro_torch.models.shardctx import activation_sharding
from repro_torch.training.optim import AdamWConfig, AdamWState


def init_fake_group(world_size: int):
    """This process as rank 0 of a fake process group of ``world_size``
    ranks (collectives return at once and send nothing)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        assert dist.get_world_size() == world_size, \
            "a process group of another size is already initialized"
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def lower_pair(arch: str, shape_name: str, multi_pod: bool,
               dtype=torch.bfloat16):
    """Returns (step trace or None, report dict).  The process group must
    be initialized with the mesh's device count (``init_fake_group``).

    The mesh is a CUDA mesh where CUDA is available.  Elsewhere it is a CPU
    mesh (DTensor's shape inference for a CUDA mesh needs a CUDA build),
    where DTensor moves a shard between dims by an all-gather and a chunk
    (gloo has no all-to-all): on such a host those bytes count as
    all-gather, not all-to-all."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_supported(cfg, shape)
    if not ok:
        return None, {"arch": arch, "shape": shape_name, "skipped": why}
    mesh = make_production_mesh(
        multi_pod=multi_pod,
        device_type="cuda" if torch.cuda.is_available() else "cpu")
    aparams = ST.abstract_params(cfg, dtype)
    # serving steps use the model-parallel-only weight layout when the model
    # fits (no per-step FSDP all-gathers)
    serving = shape.kind != "train" and serving_layout_fits(aparams, mesh) \
        and os.environ.get("REPRO_SERVING_LAYOUT", "1") == "1"
    params = distribute(aparams, shard_params(aparams, mesh, cfg,
                                              serving=serving))
    specs = ST.input_specs(cfg, shape, dtype)
    repl = NamedSharding(mesh, P())
    B = shape.global_batch

    def batch(t):
        return distribute(t, NamedSharding(mesh, batch_spec(mesh, B,
                                                            t.ndim - 1)))

    with activation_sharding(layout_specs(cfg, mesh, B)), \
            implicit_replication():
        if shape.kind == "train":
            # bf16 moments for the >100B configs (HBM budget), f32 otherwise
            big = H._active_params(cfg) > 2e10 or cfg.num_experts > 0
            opt_cfg = AdamWConfig(
                state_dtype=torch.bfloat16 if big else torch.float32,
                compute_dtype=torch.bfloat16 if big else torch.float32)
            aopt = ST.abstract_opt_state(aparams, opt_cfg)
            # moments share the param tree structure => inherit param
            # shardings
            oshard = shard_params(aopt.m, mesh, cfg)
            opt = AdamWState(step=distribute(aopt.step, repl),
                             m=distribute(aopt.m, oshard),
                             v=distribute(aopt.v, oshard))
            fn = ST.make_train_step(
                cfg, opt_cfg, donate=True,
                microbatches=int(os.environ.get("REPRO_MICROBATCHES", "4")))
            trace = HC.trace_step(fn, params, opt,
                                  {k: batch(v) for k, v in specs.items()})
        elif shape.kind == "prefill":
            fn = ST.make_prefill_step(
                cfg, max_seq=shape.seq_len,
                batch_chunks=int(os.environ.get("REPRO_PREFILL_CHUNKS",
                                                "1")))
            trace = HC.trace_step(fn, params, batch(specs["inputs"]))
        else:  # decode: one token at the last position of a full cache
            acache = ST.abstract_cache(cfg, B, shape.seq_len, dtype)
            cache = distribute(acache, shard_cache(acache, mesh, cfg, B))
            fn = ST.make_serve_step(cfg)
            trace = HC.trace_step(fn, params, cache, batch(specs["inputs"]),
                                  shape.seq_len - 1)

    hc = HC.analyze(trace)
    dims = tuple(mesh.shape)
    roof = H.Roofline(flops=hc.flops, hbm_bytes=hc.hbm_bytes,
                      coll_bytes=hc.coll_bytes, link_bw=H.link_bw(dims))
    model_fl = H.model_flops_estimate(cfg, shape)
    n_dev = math.prod(dims)
    report = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, dims)),
        "devices": n_dev,
        "serving_layout": serving,
        "trace_s": round(trace.trace_s, 2),
        "memory": H.memory_stats(trace),
        "cost": {"flops_per_dev": roof.flops,
                 "hbm_bytes_per_dev": roof.hbm_bytes},
        "collectives": H.collective_bytes(trace),
        "roofline": roof.as_dict(),
        "model_flops_total": model_fl,
        "model_flops_per_dev": model_fl / n_dev,
        "useful_flop_frac": (model_fl / n_dev) / roof.flops
        if roof.flops else None,
    }
    return trace, report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args()

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    if args.all:  # with --arch: every shape of that arch
        pairs = [(a, s) for a in ARCHS for s in SHAPES
                 if args.arch in (None, a)]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        pairs = [(args.arch, args.shape)]

    init_fake_group(math.prod(production_shape(args.multi_pod)))
    failures = 0
    for (a, s) in pairs:
        tag = f"{a}_{s}_{'multi' if args.multi_pod else 'single'}"
        try:
            trace, rep = lower_pair(a, s, args.multi_pod)
            if trace is not None:
                print(f"[dryrun] {tag}: trace_s={rep['trace_s']} "
                      f"bottleneck={rep['roofline']['bottleneck']} "
                      f"mem={rep['memory']['total_nonalias_bytes'] / 1e9:.2f}"
                      f"GB/dev flops/dev={rep['cost']['flops_per_dev']:.4g} "
                      f"coll={rep['collectives']['total'] / 1e9:.3f}GB/dev",
                      flush=True)
            else:
                print(f"[dryrun] {tag}: SKIP ({rep['skipped']})")
        except Exception as e:  # one pair's failure must not stop --all
            failures += 1
            rep = {"arch": a, "shape": s, "error": repr(e),
                   "traceback": traceback.format_exc()}
            print(f"[dryrun] {tag}: FAIL {e!r}", flush=True)
        (outdir / f"{tag}.json").write_text(json.dumps(rep, indent=2))
    dist.destroy_process_group()
    if failures:
        raise SystemExit(f"{failures} dry-run failures")


if __name__ == "__main__":
    main()
