"""Core NN layers in PyTorch, mirroring ``repro.models.layers`` (the
full-sequence part): RMSNorm, rotary embeddings (incl. M-RoPE), GQA
attention (global / sliding-window / chunked, logit softcap, qk-norm) and
gated MLPs.

Plain tensor ops on explicit parameter dicts.  Attention is written out
(matmuls, fp32 softmax, a ``-1e30`` mask) as in the JAX package, not a
fused library attention.  Full-sequence attention is query-chunked over
``Q_CHUNK`` so (S x S) score matrices stay bounded.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import LayerSpec, ModelConfig

# Query-chunk length for memory-efficient full-sequence attention.
Q_CHUNK = 1024


# --------------------------------------------------------------------------- norm
def init_rmsnorm(d: int, dtype=torch.float32, device="cpu", lead=()):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def rms_norm(x, params, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].to(torch.float32)).to(dt)


# --------------------------------------------------------------------------- rope
def rope_angles(positions, head_dim: int, theta: float,
                mrope_sections: Optional[Tuple[int, int, int]] = None):
    """positions: (..., S) int, or (3, ..., S) for M-RoPE.

    Returns cos, sin with shape (..., S, head_dim // 2), float32.
    """
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / (theta ** exps)
    if mrope_sections is not None:
        # Each frequency index is driven by one of the (t, h, w) position
        # streams [arXiv:2409.12191].  Text-only inputs use identical streams.
        if positions.dim() == 2:  # plain (B,S) text positions -> broadcast
            positions = positions[None].expand((3,) + tuple(positions.shape))
        sec_id = torch.repeat_interleave(
            torch.arange(3, device=positions.device),
            torch.tensor(mrope_sections, device=positions.device))  # (half,)
        pos = positions[sec_id]  # (half, ..., S)
        ang = torch.movedim(pos, 0, -1).to(torch.float32) * inv_freq
    else:
        ang = positions[..., None].to(torch.float32) * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, hd); cos/sin: (B, S, half) or (S, half)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        cos_, sin_ = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos_, sin_ = cos[:, :, None, :], sin[:, :, None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos_ - x2 * sin_, x2 * cos_ + x1 * sin_], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------- attention
def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   dtype=torch.float32, device="cpu", lead=()):
    """``lead`` prepends stacking dims (the group axis of a stacked
    parameter tree)."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)

    def normal(*shape):
        return torch.randn(tuple(lead) + shape, generator=gen,
                           dtype=torch.float32, device=device)

    p = {
        "wq": (normal(d, h * hd) * s).to(dtype),
        "wk": (normal(d, kv * hd) * s).to(dtype),
        "wv": (normal(d, kv * hd) * s).to(dtype),
        "wo": (normal(h * hd, d) * (1.0 / math.sqrt(h * hd))).to(dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, device, lead)
        p["k_norm"] = init_rmsnorm(hd, dtype, device, lead)
    return p


def _qkv(params, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, h, hd)
    k = (x @ params["wk"]).reshape(B, S, kv, hd)
    v = (x @ params["wv"]).reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        cos, sin = rope_angles(positions, hd, cfg.rope_theta,
                               cfg.mrope_sections)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _scores_mask(q_pos, k_pos, cfg: ModelConfig, spec: LayerSpec,
                 causal: bool):
    """(Q, K) boolean mask from absolute positions."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    m = kp >= 0  # invalid (unwritten ring slots) carry negative positions
    if causal:
        m = m & (kp <= qp)
    if spec.attn_kind == "local":
        m = m & (kp > qp - cfg.sliding_window)
    elif spec.attn_kind == "chunked":
        m = m & ((kp // cfg.attn_chunk) == (qp // cfg.attn_chunk))
    return m


def _attend(q, k, v, mask, cfg: ModelConfig):
    """q: (B,Q,H,hd)  k/v: (B,K,KV,hd)  mask: (Q,K) or (B,Q,K)."""
    B, Q, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    scale = cfg.attn_scale if cfg.attn_scale is not None \
        else 1.0 / math.sqrt(hd)
    qr = q.reshape(B, Q, KV, rep, hd)
    logits = torch.einsum("bqkrd,bskd->bkrqs", qr, k).to(torch.float32) \
        * scale
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        logits = c * torch.tanh(logits / c)
    if mask.dim() == 2:
        mask = mask[None, None, None]
    else:
        mask = mask[:, None, None]
    logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkrqs,bskd->bqkrd", w, v)
    return out.reshape(B, Q, H * hd)


def attention_full(params, x, cfg: ModelConfig, spec: LayerSpec,
                   positions=None):
    """Full-sequence attention (prefill), query-chunked over S.
    Returns (out (B,S,D), (k, v))."""
    B, S, _ = x.shape
    kpos = torch.arange(S, dtype=torch.int32, device=x.device)
    if positions is None:
        positions = kpos[None].expand(B, S)
    q, k, v = _qkv(params, x, cfg, positions)
    causal = cfg.causal

    if S <= Q_CHUNK:
        mask = _scores_mask(kpos, kpos, cfg, spec, causal)
        out = _attend(q, k, v, mask, cfg)
    else:
        assert S % Q_CHUNK == 0, f"S={S} not divisible by Q_CHUNK={Q_CHUNK}"
        outs = []
        for i in range(S // Q_CHUNK):
            qpos = kpos[i * Q_CHUNK:(i + 1) * Q_CHUNK]
            mask = _scores_mask(qpos, kpos, cfg, spec, causal)
            outs.append(_attend(q[:, i * Q_CHUNK:(i + 1) * Q_CHUNK], k, v,
                                mask, cfg))
        out = torch.cat(outs, dim=1)
    return out @ params["wo"], (k, v)


# --------------------------------------------------------------------------- MLP
def init_mlp(d: int, f: int, gen: torch.Generator, dtype=torch.float32,
             device="cpu", lead=()):
    s, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)

    def normal(*shape):
        return torch.randn(tuple(lead) + shape, generator=gen,
                           dtype=torch.float32, device=device)

    return {
        "w_gate": (normal(d, f) * s).to(dtype),
        "w_up": (normal(d, f) * s).to(dtype),
        "w_down": (normal(f, d) * so).to(dtype),
    }


def mlp(params, x, act: str = "silu"):
    # jax.nn.gelu defaults to the tanh approximation
    a = F.silu(x @ params["w_gate"]) if act == "silu" \
        else F.gelu(x @ params["w_gate"], approximate="tanh")
    return (a * (x @ params["w_up"])) @ params["w_down"]
