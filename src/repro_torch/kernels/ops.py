"""Public entry points of the boundary kernels, with the JAX package's
dispatch rules (``repro/kernels/ops.py``).

A CUDA tensor at ``bits in KERNEL_BITS`` with ``use_kernel=True`` goes to
the Hopper kernel; if the launch fails, the call raises.  A CPU tensor, or
``use_kernel=False``, goes to the plain PyTorch version.  Other bit widths
(3/5/6, which Eq. 11 can pick) have no packed wire format and run the
plain version on the tensor's own device, as in the JAX package.

``quantize_activation`` / ``dequantize_activation`` take boundary tensors
of any rank, flattened to (tokens, channels).  ``boundary_pass`` is the
fused single-pass hop; the JAX package donates its ``x``, so callers must
not reuse ``x`` after the call.  ``wire_quantize`` / ``wire_dequantize``
are the 2-D wire entry points the pipeline paths share.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.boundary import fused_boundary
from repro_torch.kernels.semantic_cache import semantic_probe
from repro_torch.kernels.uaq import uaq_dequantize, uaq_quantize

KERNEL_BITS = (4, 8)


def _as2d(x):
    return x.reshape(-1, x.shape[-1]), x.shape


def quantize_activation(x, bits: int = 8, use_kernel: bool = True):
    """(..., N) -> (packed (..., ceil(N*bits/8)) uint8, scale, zp).  An
    odd N at 4 bits carries a zero-nibble pad; dequantize with
    ``channels=N`` to slice back exactly."""
    x2, shape = _as2d(x)
    if use_kernel and bits in KERNEL_BITS:
        p, s, z = uaq_quantize(x2, bits)
    else:
        p, s, z = ref.uaq_quantize_ref(x2, bits)
    lead = shape[:-1]
    return (p.reshape(*lead, -1), s.reshape(*lead, 1), z.reshape(*lead, 1))


def dequantize_activation(packed, scale, zp, bits: int = 8,
                          out_dtype=torch.float32, use_kernel: bool = True,
                          channels: Optional[int] = None):
    """``channels`` is the true channel count when the 4-bit payload was
    packed from an odd N (defaults to the payload's full width)."""
    p2, shape = _as2d(packed)
    s2 = scale.reshape(-1, 1)
    z2 = zp.reshape(-1, 1)
    if use_kernel and bits in KERNEL_BITS:
        x = uaq_dequantize(p2, s2, z2, bits, out_dtype, n=channels)
    else:
        x = ref.uaq_dequantize_ref(p2, s2, z2, bits, out_dtype, n=channels)
    return x.reshape(*shape[:-1], -1)


def probe_cache(x, centers) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Fused GAP+cosine+separability.  x: (B,S,D); centers: (L,D)."""
    return semantic_probe(x, centers)


def boundary_pass(x, centers, bits: int = 8, use_kernel: bool = True):
    """Single-pass fused boundary hop: x (B,S,D), centers (L,D) ->
    (payload, scale, zp, feat, sep, best, sims).  One read of ``x``
    produces the wire packet fields and the semantic-probe outputs.  The
    caller hands ``x`` over: do not reuse it after this call."""
    if use_kernel and bits in KERNEL_BITS:
        return fused_boundary(x, centers, bits)
    return ref.fused_boundary_ref(x, centers, bits)


def wire_quantize(x, bits: int, use_kernel: bool = True):
    """Shared 2-D wire quantize entry: x (M, N) -> (packed, scale, zp)."""
    if use_kernel and bits in KERNEL_BITS:
        return uaq_quantize(x, bits)
    return ref.uaq_quantize_ref(x, bits)


def wire_dequantize(packed, scale, zp, bits: int, out_dtype=torch.float32,
                    channels: Optional[int] = None, use_kernel: bool = True):
    if use_kernel and bits in KERNEL_BITS:
        return uaq_dequantize(packed, scale, zp, bits, out_dtype,
                              n=channels)
    return ref.uaq_dequantize_ref(packed, scale, zp, bits, out_dtype,
                                  n=channels)
