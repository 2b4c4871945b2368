"""Fused semantic-cache probe (GAP -> L2-normalize -> cosine against the
label centers -> top-2 -> separability, Eq. 8-10): wrapper of the Hopper
kernel that replaces the Pallas ``semantic_probe``
(``repro/kernels/semantic_cache.py``).

It is the fused boundary kernel's GAP pass without the quantize, plus the
same probe epilogue (``csrc/coach_kernels.cu``).  On a CUDA tensor the
wrapper launches the kernel or raises; on a CPU tensor it runs
``ref.semantic_probe_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build as KB
from repro_torch.kernels import ref


def semantic_probe(x: torch.Tensor, centers: torch.Tensor):
    """x: (B,S,D) float32, centers: (L,D) float32 -> (sep (B,),
    best (B,) int32, sims (B,L))."""
    if KB.on_cpu(x):
        return ref.semantic_probe_ref(x, centers)
    dev = x.device
    B, S, D, L = KB.require_probe_inputs(x, centers)
    r = KB.rows_per_cta(B, S)
    ws = torch.empty((B, -(-S // r), D), dtype=torch.float32, device=dev)
    sep = torch.empty((B,), dtype=torch.float32, device=dev)
    best = torch.empty((B,), dtype=torch.int32, device=dev)
    sims = torch.empty((B, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = KB.lib().coach_semantic_probe(
            x.data_ptr(), centers.data_ptr(), ws.data_ptr(), sep.data_ptr(),
            best.data_ptr(), sims.data_ptr(), B, S, D, L, r,
            KB.stream_of(x))
    KB.check(err, "semantic_probe")
    KB.LAUNCHES["semantic_probe"] += 1
    return sep, best, sims
