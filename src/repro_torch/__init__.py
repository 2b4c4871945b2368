"""COACH in PyTorch: the port of ``repro`` (JAX/Pallas on a TPU) to PyTorch
and hand-written CUDA kernels on an NVIDIA Hopper card.

Module paths mirror ``repro``.  Entry points take an explicit ``device``
that defaults to ``"cuda"``; ``require_device`` raises when CUDA is asked
for and none is present, so nothing silently runs on the CPU.  Only an
explicit ``device="cpu"`` (as the tests pass) runs the plain PyTorch
versions of the kernels.
"""

from __future__ import annotations

import torch


def require_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is available (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU")
    return dev
