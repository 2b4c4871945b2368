"""Single-pass fused boundary hop (quantize -> int4/int8 pack -> semantic
probe): wrapper of the Hopper kernel that replaces the Pallas
``fused_boundary`` (``repro/kernels/boundary.py``).

The kernel reads the (B, S, D) boundary activation once, in one launch:
each warp row-quantizes and packs a token row into the wire fields and
each CTA sums its run of tokens into a GAP partial; the last CTA of each
batch row reduces the partials in a fixed order and runs the probe
epilogue (Eq. 8-9).  See ``csrc/coach_kernels.cu``.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs ``ref.fused_boundary_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build as KB
from repro_torch.kernels import ref


def fused_boundary(x: torch.Tensor, centers: torch.Tensor, bits: int):
    """x: (B,S,D) float32, bfloat16 or float16, centers: (L,D) float32 ->
    (payload (B,S,P) uint8, scale (B,S,1), zp (B,S,1), feat (B,D),
    sep (B,), best (B,) int32, sims (B,L)), all float32 but payload and
    best; P = ceil(D * bits / 8).  An odd ``D`` at 4 bits is zero-nibble
    padded in the payload."""
    KB.check_bits(bits)
    if KB.on_cpu(x):
        return ref.fused_boundary_ref(x, centers, bits)
    dev = x.device
    B, S, D, L = KB.require_probe_inputs(x, centers)
    P = (D + 1) // 2 if bits == 4 else D
    r, wpr = KB.launch_shape(B, S, D)
    n_chunks = -(-S // r)

    def out(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    payload = out(B, S, P, dtype=torch.uint8)
    scale, zp = out(B, S, 1), out(B, S, 1)
    feat, sep, best, sims = out(B, D), out(B), out(B, dtype=torch.int32), \
        out(B, L)
    ws = out(B, n_chunks, D)  # per-CTA GAP partial sums
    with torch.cuda.device(dev):
        counters = KB.arrival_counters(x, B)
        err = KB.lib().coach_fused_boundary(
            x.data_ptr(), centers.data_ptr(), payload.data_ptr(),
            scale.data_ptr(), zp.data_ptr(), ws.data_ptr(),
            counters.data_ptr(), feat.data_ptr(), sep.data_ptr(),
            best.data_ptr(), sims.data_ptr(), B, S, D, L, bits, r, wpr,
            KB.DTYPE_CODES[x.dtype], KB.stream_of(x))
    KB.check(err, "fused_boundary")
    KB.LAUNCHES["fused_boundary"] += 1
    return payload, scale, zp, feat, sep, best, sims
