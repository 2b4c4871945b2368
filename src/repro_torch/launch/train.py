"""Training launcher in PyTorch, mirroring ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b --production

Runs on the CUDA device by default; ``train(..., device="cpu")`` runs on
the CPU.  One device, no mesh: the JAX launcher builds one but does not
use it.  ``production`` trains the full-size model with bfloat16 weights.
The step is jitted with the parameters and the optimizer state donated,
as the JAX launcher's is: on the card one CUDA graph, captured at the
first step and replayed at every other (``core.jit``); on the CPU the
step itself.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                   save_checkpoint)
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.jit import jit
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import steps as ST
from repro_torch.models import model as M
from repro_torch.training.optim import AdamWConfig, adamw_init


def train(arch: str, *, smoke: bool = True, steps: int = 50,
          batch: int = 8, seq: int = 256, lr: float = 3e-4,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
          microbatches: int = 1, log_every: int = 10, seed: int = 0,
          production: bool = False, device="cuda",
          step_seconds: Optional[List[float]] = None):
    """Train ``arch`` on ``SyntheticLM`` tokens (the same tokens as the JAX
    launcher for the same ``seed``).  Parameters come from
    ``models.model.init_params`` and, for archs that take embeddings, the
    embeds of step i from a ``torch.Generator`` seeded by (seed, i): both
    differ from ``jax.random``'s numbers.  The jitted step updates the
    parameters and the optimizer state in place (the JAX launcher donates
    them).  Returns (params, losses); ``step_seconds``, if given, receives
    each step's wall time, from the batch on the device to its loss
    read back (which waits for the device)."""
    dev = require_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.reduced()
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                          total_steps=steps)

    params = M.init_params(cfg, seed=seed, device=dev,
                           dtype=torch.bfloat16 if production
                           else torch.float32)
    opt = adamw_init(params, opt_cfg)
    start = 0
    if ckpt_dir and (s := latest_step(ckpt_dir)) is not None:
        params = load_checkpoint(ckpt_dir, s, params)
        start = s

    step_fn = jit(ST.make_train_step(cfg, opt_cfg,
                                     microbatches=microbatches, donate=True),
                  donate=("params", "opt_state"))
    data = SyntheticLM(cfg.vocab_size, seed=seed)
    losses: List[float] = []
    t0 = time.time()
    for i in range(start, steps):
        toks = torch.from_numpy(data.batch(batch, seq)).to(dev)
        if cfg.embed_inputs:
            gen = torch.Generator(device=dev).manual_seed(int(
                np.random.SeedSequence([seed, i]).generate_state(1)[0]))
            emb = torch.randn((batch, seq, cfg.d_model), generator=gen,
                              device=dev) * 0.3
            b = {"embeds": emb, "labels": toks}
        else:
            b = {"tokens": toks, "labels": toks}
        t_step = time.time()
        params, opt, loss, mets = step_fn(params, opt, b)
        losses.append(float(loss))
        if step_seconds is not None:
            step_seconds.append(time.time() - t_step)
        if (i + 1) % log_every == 0:
            dt = (time.time() - t0) / log_every
            print(f"step {i+1:5d} loss {np.mean(losses[-log_every:]):.4f} "
                  f"({dt*1e3:.0f} ms/step)")
            t0 = time.time()
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, i + 1, params)
    return params, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args()
    train(args.arch, smoke=not args.production, steps=args.steps,
          batch=args.batch, seq=args.seq, lr=args.lr,
          microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
          production=args.production)


if __name__ == "__main__":
    main()
