"""UAQ quantize (+int4 pack) and dequantize: wrappers of the Hopper
kernels that replace the Pallas ``uaq_quantize`` / ``uaq_dequantize``
(``repro/kernels/uaq.py``).

On a CUDA tensor each wrapper launches its kernel
(``csrc/uaq_quantize.cu``, ``csrc/coach_kernels.cu``) or raises; on a CPU tensor it runs the plain PyTorch version in
``kernels.ref``.  Unlike the Pallas kernels, any row count M works (no
block-multiple assert).  Like the Pallas kernels, they read float32,
bfloat16 or float16 activations (all quantize math in float32) and write
the dequantized values in any of the three.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build as KB
from repro_torch.kernels import ref


def uaq_quantize(x: torch.Tensor, bits: int):
    """x: (M, N) -> (packed (M, ceil(N*bits/8)) uint8, scale (M,1),
    zp (M,1)).  An odd N at 4 bits is zero-nibble padded in the payload;
    pass ``n=N`` to ``uaq_dequantize`` to slice back exactly."""
    KB.check_bits(bits)
    if KB.on_cpu(x):
        return ref.uaq_quantize_ref(x, bits)
    KB.require(x, "x", KB.ACTIVATION_DTYPES, 2, x.device)
    M, N = x.shape
    if M == 0 or N == 0:
        raise ValueError(f"x has shape {tuple(x.shape)}: nothing to quantize")
    KB.check_row_width(N)
    P = (N + 1) // 2 if bits == 4 else N
    payload = torch.empty((M, P), dtype=torch.uint8, device=x.device)
    scale = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    zp = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = KB.lib().coach_uaq_quantize(
            x.data_ptr(), payload.data_ptr(), scale.data_ptr(),
            zp.data_ptr(), M, N, bits, KB.quantize_warps(M, N),
            KB.DTYPE_CODES[x.dtype], KB.stream_of(x))
    KB.check(err, "uaq_quantize")
    KB.LAUNCHES["uaq_quantize"] += 1
    return payload, scale, zp


def uaq_dequantize(packed: torch.Tensor, scale: torch.Tensor,
                   zp: torch.Tensor, bits: int,
                   out_dtype: torch.dtype = torch.float32,
                   n: Optional[int] = None) -> torch.Tensor:
    """packed (M, P) uint8, scale/zp (M, 1) -> (M, N) ``out_dtype``.
    ``n`` is the true channel count when the 4-bit payload carries an
    odd-N zero-nibble pad (defaults to the payload's full width)."""
    KB.check_bits(bits)
    M, n_in = packed.shape
    N = n if n is not None else n_in * 8 // bits
    if not (0 < N <= n_in * 8 // bits) or (bits == 8 and N != n_in):
        raise ValueError(f"n={n} does not fit a {bits}-bit payload of "
                         f"width {n_in}")
    if KB.on_cpu(packed):
        return ref.uaq_dequantize_ref(packed, scale, zp, bits, out_dtype,
                                      n=n)
    dev = packed.device
    KB.require(packed, "packed", torch.uint8, 2, dev)
    for name, t in (("scale", scale), ("zp", zp)):
        KB.require(t, name, torch.float32, 2, dev)
        if tuple(t.shape) != (M, 1):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"({M}, 1)")
    if out_dtype not in KB.DTYPE_CODES:
        raise TypeError(f"out_dtype={out_dtype}: the kernel writes "
                        f"float32, bfloat16 or float16")
    if M == 0:
        raise ValueError("packed has no rows: nothing to dequantize")
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        err = KB.lib().coach_uaq_dequantize(
            packed.data_ptr(), scale.data_ptr(), zp.data_ptr(),
            out.data_ptr(), M, n_in, N, bits, KB.DTYPE_CODES[out_dtype],
            KB.stream_of(packed))
    KB.check(err, "uaq_dequantize")
    KB.LAUNCHES["uaq_dequantize"] += 1
    return out
