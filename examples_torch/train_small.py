"""Train a small LM for a few hundred steps on learnable synthetic data
(order-1 Markov stream) and watch the loss drop, in the PyTorch port (the
twin of ``examples/train_small.py``).

  PYTHONPATH=src python examples_torch/train_small.py [--steps 200] [--arch ...] [--device cpu]

The default ~10M-param gemma2-family variant fits a few-minute CPU budget;
pass --arch mamba2-130m --full for the real 130M config if you have time.
Runs on the CUDA device by default (the step is a CUDA graph there);
``--device cpu`` trains on the CPU.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np

from repro_torch.launch.train import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="use the full (not reduced) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, losses = train(args.arch, smoke=not args.full, steps=args.steps,
                      batch=args.batch, seq=args.seq, lr=3e-3,
                      ckpt_dir=args.ckpt_dir, log_every=10,
                      device=args.device)
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"loss: {first:.3f} -> {last:.3f} "
          f"({'LEARNED' if last < first - 0.3 else 'check hyperparams'})")
    return losses


if __name__ == "__main__":
    main()
