"""Plain PyTorch versions of the four boundary kernels (the correctness
contract), mirroring ``repro.kernels.ref``.

The CUDA kernels in ``csrc/coach_kernels.cu`` are held to these on the
card, and these are held to the JAX package's jitted references and
interpret-mode Pallas kernels on the CPU (tests/test_torch_kernels.py).

Numerics of the wire fields (payload, scale, zp), which must come out
bit-equal everywhere:

  * XLA rewrites the jitted ``max(hi - lo, 1e-8) / qmax`` into a multiply
    by the float32 reciprocal of ``qmax``, so ``scale`` is computed that
    way here (a true division gives a different last bit);
  * ``zp`` and ``q`` use true float32 division and round half to even
    (``torch.round``, like ``jnp.round``).
"""

from __future__ import annotations

from typing import Optional

import torch


# ----------------------------------------------------------------- UAQ ref
def uaq_rowwise_ref(x: torch.Tensor, bits: int):
    """Row-wise UAQ: x (M, N) -> (q (M,N) uint8, scale (M,1), zp (M,1))."""
    qmax = (1 << bits) - 1
    xf = x.to(torch.float32)  # contract: all quant math in f32
    lo = torch.amin(xf, dim=1, keepdim=True)
    hi = torch.amax(xf, dim=1, keepdim=True)
    # a Python scalar operand is applied in float32: 1/qmax rounds to the
    # same float32 reciprocal XLA multiplies by
    scale = torch.clamp(hi - lo, min=1e-8) * (1.0 / qmax)
    zp = torch.round(-lo / scale)
    q = torch.clamp(torch.round(xf / scale + zp), 0, qmax)
    return q.to(torch.uint8), scale, zp


def pack4_ref(q: torch.Tensor) -> torch.Tensor:
    """Pack uint4 values (..., N) -> (..., ceil(N/2)) bytes, low nibble =
    even channel.  An odd N is zero-nibble padded (in the quantized
    domain, so the row's scale/zp are untouched)."""
    if q.shape[-1] % 2:
        q = torch.cat([q, torch.zeros_like(q[..., :1])], dim=-1)
    lo = q[..., 0::2].to(torch.uint8)
    hi = q[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack4_ref(p: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """Unpack nibbles (..., P) -> (..., 2P), sliced to the true channel
    count ``n`` when the producer zero-padded an odd N."""
    lo = p & 0xF
    hi = p >> 4
    q = torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], -1)
    return q if n is None else q[..., :n]


def uaq_quantize_ref(x: torch.Tensor, bits: int):
    q, scale, zp = uaq_rowwise_ref(x, bits)
    if bits == 4:
        return pack4_ref(q), scale, zp
    return q, scale, zp


def uaq_dequantize_ref(packed, scale, zp, bits: int,
                       out_dtype=torch.float32, n: Optional[int] = None):
    q = unpack4_ref(packed, n=n) if bits == 4 else packed
    return ((q.to(torch.float32) - zp) * scale).to(out_dtype)


# ----------------------------------------------------------- probe epilogue
def _probe_epilogue(f: torch.Tensor, centers: torch.Tensor):
    """GAP feature (B, D) -> (sep (B,), best (B,) int32, sims (B, L)):
    L2-normalize, cosine -> [0, 1] (Eq. 8), top-2 separability (Eq. 9)."""
    fn = f / torch.clamp(torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)),
                         min=1e-12)
    c = centers.to(torch.float32)
    cn = c / torch.clamp(torch.sqrt(torch.sum(c * c, dim=1, keepdim=True)),
                         min=1e-12)
    sims = (fn @ cn.T + 1.0) * 0.5  # Eq. 8 -> [0,1]
    t_h = torch.amax(sims, dim=1)
    best = torch.argmax(sims, dim=1)  # first index on ties, like jnp
    onehot = best[:, None] == torch.arange(sims.shape[1],
                                           device=sims.device)[None, :]
    t_sh = torch.amax(torch.where(onehot, -torch.inf, sims), dim=1)
    norm = torch.sqrt(torch.sum(sims * sims, dim=1))
    sep = norm * (t_h - t_sh) * t_h / torch.clamp(t_sh, min=1e-12)  # Eq. 9
    return sep, best.to(torch.int32), sims


# ------------------------------------------------------ fused boundary ref
def fused_boundary_ref(x: torch.Tensor, centers: torch.Tensor, bits: int):
    """x: (B, S, D) boundary activation; centers: (L, D).  Returns
    (payload (B,S,P) uint8, scale (B,S,1), zp (B,S,1), feat (B,D),
    sep (B,), best (B,) int32, sims (B,L)) — the wire packet of every
    token plus the GAP feature and probe outputs of every batch row."""
    B, S, D = x.shape
    payload, scale, zp = uaq_quantize_ref(x.reshape(B * S, D), bits)
    f = torch.sum(x.to(torch.float32), dim=1) / S  # GAP, sum then divide
    sep, best, sims = _probe_epilogue(f, centers)
    return (payload.reshape(B, S, -1), scale.reshape(B, S, 1),
            zp.reshape(B, S, 1), f, sep, best, sims)


# ------------------------------------------------------- semantic cache ref
def semantic_probe_ref(x: torch.Tensor, centers: torch.Tensor):
    """Fused GAP + cosine similarity + top-2 separability (Eq. 8-10).
    x: (B, S, D); centers: (L, D) -> (sep (B,), best (B,) int32,
    sims (B, L) in [0, 1])."""
    f = torch.mean(x.to(torch.float32), dim=1)  # GAP over sequence
    return _probe_epilogue(f, centers)
