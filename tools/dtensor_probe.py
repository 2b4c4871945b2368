#!/usr/bin/env python3
"""Which of the port's steps run on DTensors under this torch release.

Every reduced arch's forward (serving and FSDP layouts), train step (two
microbatches), prefill and decode run once on meta DTensors over a fake
process group laid out as a DATA x MODEL mesh, with the activation hooks
live.  Each line says ok or FAIL, and a failure names the exception, the
last port source line it passed through and the last DTensor op
dispatched.  With ``--heal`` every op DTensor refuses is logged (op,
shapes, placements, and for a backward op the autograd node and the port
lines of its forward, from anomaly mode) and run again on replicated
arguments, so one run finds every refusal of a step.  Nothing is
allocated, so any mesh size runs on any host; the mesh is a CUDA mesh
where CUDA is available.

  python3 tools/dtensor_probe.py 2,2 [arch,arch,...] [--jobs train,decode]
                                 [--heal]
"""

import argparse
import collections
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate  # noqa: E402
from torch.distributed.tensor.experimental import \
    implicit_replication  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.sharding import (NamedSharding,  # noqa: E402
                                         activation_specs, batch_spec,
                                         distribute, shard_cache,
                                         shard_params)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.shardctx import activation_sharding  # noqa: E402
from repro_torch.training.optim import (AdamWConfig, AdamWState,  # noqa: E402
                                        adamw_init)

B, S = 4, 32


class LastOp(TorchDispatchMode):
    """Remembers the last DTensor op dispatched (and lets DTensor run it)."""
    op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            LastOp.op = (str(func), [tuple(a.placements) for a in args
                                     if isinstance(a, DTensor)])
            return NotImplemented
        return func(*args, **(kwargs or {}))


def _port_frames(lines):
    """file:line of the port's frames in formatted stack ``lines``."""
    out = []
    for line in "".join(lines).splitlines():
        line = line.strip()
        if line.startswith("File") and "repro_torch" in line:
            path, lineno = line.split('"')[1], line.split("line ")[1]
            out.append(f"{path[path.index('repro_torch'):]}:"
                       f"{lineno.split(',')[0]}")
    return out


class Heal(TorchDispatchMode):
    """Logs each DTensor op that fails and runs it again on replicated
    arguments."""
    refusals = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            return func(*args, **kwargs)
        except Exception as e:
            if not any(isinstance(a, DTensor) for a in args):
                raise
            node = torch._C._current_autograd_node()
            stack = (node.metadata.get("traceback_", []) if node is not None
                     else traceback.format_stack())
            where = _port_frames(stack if isinstance(stack, list)
                                 else [stack])[-2:]
            Heal.refusals.append((
                str(func), str([(tuple(a.shape), tuple(a.placements))
                                if isinstance(a, DTensor) else a
                                for a in args if isinstance(a, DTensor)
                                or not isinstance(a, torch.Tensor)]),
                node.name() if node is not None else "forward",
                " <- ".join(reversed(where)),
                str(e).strip().splitlines()[0][:120] if str(e) else ""))
            return func(*[a.redistribute(a.device_mesh, [Replicate()]
                                         * a.device_mesh.ndim)
                          if isinstance(a, DTensor) else a for a in args],
                        **kwargs)


def jobs(cfg, mesh):
    ap = M.init_params(cfg, dtype=torch.float32, device="meta")
    x = torch.empty((B, S, cfg.d_model) if cfg.embed_inputs else (B, S),
                    dtype=torch.float32 if cfg.embed_inputs else torch.int32,
                    device="meta")

    def on_batch(t):
        return distribute(t, NamedSharding(mesh, batch_spec(mesh, B,
                                                            t.ndim - 1)))

    def params(serving):
        return distribute(ap, shard_params(ap, mesh, cfg, serving=serving))

    def forward(serving):
        p = params(serving)
        h, _, _ = M.forward(p, cfg, on_batch(x))
        return M._lm_head(p, cfg, h)

    def train():
        opt_cfg = AdamWConfig()
        opt = adamw_init(ap, opt_cfg)
        osh = shard_params(opt.m, mesh, cfg)
        dopt = AdamWState(step=opt.step, m=distribute(opt.m, osh),
                          v=distribute(opt.v, osh))
        labels = torch.empty((B, S), dtype=torch.int32, device="meta")
        batch = {"embeds" if cfg.embed_inputs else "tokens": on_batch(x),
                 "labels": on_batch(labels)}
        return ST.make_train_step(cfg, opt_cfg, microbatches=2)(
            params(False), dopt, batch)

    def prefill():
        return ST.make_prefill_step(cfg, S + 4)(params(True), on_batch(x))

    def decode():
        cache = M.init_cache(cfg, B, S + 4, dtype=torch.float32,
                             device="meta")
        cache = distribute(cache, shard_cache(cache, mesh, cfg, B))
        return ST.make_serve_step(cfg)(params(True), cache,
                                       on_batch(x[:, :1]), S)

    out = [("forward_serving", lambda: forward(True)),
           ("forward_fsdp", lambda: forward(False)), ("train", train)]
    if cfg.supports_decode:
        out += [("prefill", prefill), ("decode", decode)]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mesh", help="DATA,MODEL, e.g. 4,4")
    ap.add_argument("archs", nargs="?", default=",".join(sorted(ARCHS)))
    ap.add_argument("--jobs", default=None,
                    help="only these steps, e.g. train (default: all)")
    ap.add_argument("--heal", action="store_true",
                    help="log every refused op and go on past it")
    args = ap.parse_args()
    shape = tuple(int(v) for v in args.mesh.split(","))
    archs = args.archs.split(",")
    only = args.jobs.split(",") if args.jobs else None
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=shape[0] * shape[1])
    mesh = init_device_mesh("cuda" if torch.cuda.is_available() else "cpu",
                            shape, mesh_dim_names=("data", "model"))
    print(f"torch {torch.__version__}, mesh {mesh}", flush=True)
    if args.heal:  # the forward traceback of each backward node
        torch.autograd.set_detect_anomaly(True, check_nan=False)
    fails = 0
    for arch in archs:
        cfg = get_config(arch).reduced()
        for name, fn in jobs(cfg, mesh):
            if only is not None and name not in only:
                continue
            t0 = time.time()
            Heal.refusals = []
            try:
                with activation_sharding(activation_specs(cfg, mesh, B)), \
                        implicit_replication(), \
                        Heal() if args.heal else LastOp():
                    fn()
                if Heal.refusals:
                    fails += 1
                    print(f"FAIL {arch} {name}: {len(Heal.refusals)} ops "
                          f"refused (each run again on replicated "
                          f"arguments):", flush=True)
                    for r, n in collections.Counter(Heal.refusals).items():
                        print(f"       x{n} {r[0]} {r[1]} in {r[2]}, "
                              f"forward at {r[3] or '?'}: {r[4]}",
                              flush=True)
                else:
                    print(f"ok   {arch} {name} {time.time() - t0:.1f}s",
                          flush=True)
            except Exception as e:  # report every step, then go on
                fails += 1
                lines = str(e).strip().splitlines() or [repr(e)]
                frames = [f for f in traceback.extract_tb(e.__traceback__)
                          if "repro_torch" in f.filename]
                where = (f"{os.path.basename(frames[-1].filename)}:"
                         f"{frames[-1].lineno}") if frames else "?"
                print(f"FAIL {arch} {name}: {type(e).__name__}: "
                      f"{lines[0][:200]} @ {where}; last DTensor op "
                      f"{LastOp.op}", flush=True)
    dist.destroy_process_group()
    print(f"{fails} failed", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
