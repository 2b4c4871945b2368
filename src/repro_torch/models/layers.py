"""Core NN layers in PyTorch, mirroring ``repro.models.layers``: RMSNorm,
rotary embeddings (incl. M-RoPE), GQA attention (global / sliding-window /
chunked, logit softcap, qk-norm) with its KV-cache decode, and gated MLPs.

Plain tensor ops on explicit parameter dicts.  Attention is written out
(matmuls, fp32 softmax, a ``-1e30`` mask) as in the JAX package, not a
fused library attention.  Full-sequence attention is query-chunked over
``Q_CHUNK`` so (S x S) score matrices stay bounded.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.shardctx import (SUM, constrain, grad_in_layout,
                                         on_shards, reshape, split_axes,
                                         split_reduce)

# Query-chunk length for memory-efficient full-sequence attention.
Q_CHUNK = 1024


# --------------------------------------------------------------------------- norm
def init_rmsnorm(d: int, dtype, device, lead=()):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def rms_norm(x, params, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    # the scale is sharded over the model axis: whole on every device, so
    # the product keeps x's layout (a sharded scale would shard x's last
    # dim, and the products that follow would contract over a sharded dim
    # and sum partial results in place of splitting their work)
    return (x * constrain(params["scale"], "norm_scale").to(torch.float32)
            ).to(dt)


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
        # the stream of each frequency index, (half,), from the section
        # sizes on the device (a host-to-device copy of them would stop a
        # CUDA-graph capture)
        idx = torch.arange(half, device=positions.device)
        sec_id = sum((idx >= b).long()
                     for b in itertools.accumulate(mrope_sections[:-1]))
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
def init_attention(cfg: ModelConfig, gen: torch.Generator, dtype, device,
                   lead=()):
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


def column(x, w):
    """``x @ w`` for a column-parallel weight ``w`` (in, out), its
    operands laid out as ``launch.sharding.product_specs`` has them
    ("col_in", "col_w"): the product comes out sharded on the model axis
    and each device computes its share (the reference's HLO runs each
    such dot on a 1/16 slice of the output width on the 16x16 mesh, and
    on long_500k, a batch of one, also splits its contraction over the
    data axis)."""
    return constrain(x, "col_in") @ constrain(w, "col_w")


def row(w):
    """A row-parallel weight (in, out) laid out for its product
    ("row_w"): sharded on the model axis over its input dim, which the
    activations arrive sharded on.  The product is a partial sum over the
    model axis, which ``residual`` reduces."""
    return constrain(w, "row_w")


def residual(y):
    """A row-parallel product ``y`` (B, S, D) in the residual stream's
    layout ("hidden"), forward and backward: the forward all-reduces the
    partial sums over the model axis, and the backward all-reduces the
    residual stream's gradient, a partial sum there (the column products'
    input gradients are), before the product's backward takes it.  Left
    partial, that gradient meets the weight's model sharding, and the
    product's backward runs whole on every device (16 times the work on
    the 16x16 mesh).  The reference's HLO all-reduces both over the model
    axis."""
    return constrain(grad_in_layout(y), "hidden")


def _qkv(params, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = reshape(column(x, params["wq"]), B, S, h, hd)
    k = reshape(column(x, params["wk"]), B, S, kv, hd)
    v = reshape(column(x, params["wv"]), B, S, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        cos, sin = rope_angles(positions, hd, cfg.rope_theta,
                               cfg.mrope_sections)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return (constrain(q, "q_heads"), constrain(k, "kv_heads"),
            constrain(v, "kv_heads"))


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


def _attend(q, k, v, mask, cfg: ModelConfig, keys: bool = False):
    """q: (B,Q,H,hd)  k/v: (B,K,KV,hd)  mask: (Q,K) or (B,Q,K).  On
    DTensors each device attends its own batch rows and its heads, where
    the head counts divide the model axis, else its slice of the queries,
    each against every key (the reference's XLA splits such heads only as
    far as the head count allows, gcd(H, 16) ways on the 16x16 mesh, and
    repeats each head's scores on the remaining devices).  ``keys`` splits
    the keys instead (a
    decode step: one query, and the cache sharded on its sequence): each
    device attends its slice of the cache, and the softmax's max and sum
    and the output are reduced over the devices, as the reference's HLO
    all-reduces them."""
    b = 0 if mask.dim() == 3 else None
    if keys:
        dims = ((0, None, None), (0, None, 1), (0, None, 1),
                (b, None, mask.dim() - 1))
        out_dims = (0, None, SUM)
    else:
        dims = ((0, 2, 1), (0, 2), (0, 2), (b, None, mask.dim() - 2))
        out_dims = (0, 2, 1)
    out = on_shards(functools.partial(_attend_rows, cfg=cfg, keys=keys),
                    (q, k, v, mask), dims=dims, out_dims=out_dims)
    return constrain(out, "attn_out")


def _attend_rows(q, k, v, mask, cfg: ModelConfig, keys: bool = False):
    """The attention of one device's rows; where ``keys`` are split over
    devices (``shardctx.split_axes``), the softmax of the whole row."""
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
    if keys and split_axes():
        m = split_reduce(torch.amax(logits, dim=-1, keepdim=True), "max")
        e = torch.exp(logits - m)
        w = (e / split_reduce(torch.sum(e, dim=-1, keepdim=True), "sum")
             ).to(v.dtype)
    else:
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
    return residual(out @ row(params["wo"])), (k, v)


# ------------------------------------------------------------------ KV cache utils
def cache_len(cfg: ModelConfig, spec: LayerSpec, max_seq: int) -> int:
    if spec.attn_kind == "local":
        return min(max_seq, cfg.sliding_window)
    if spec.attn_kind == "chunked":
        return min(max_seq, cfg.attn_chunk)
    return max_seq


def init_kv_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                  max_seq: int, dtype, device):
    L = cache_len(cfg, spec, max_seq)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, L, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, L, kv, hd), dtype=dtype, device=device),
        # absolute position held by each slot; -1 => empty
        "pos": torch.full((L,), -1, dtype=torch.int32, device=device),
    }


def pad_seq(t, n: int, front: bool = False):
    """``t`` with ``n`` zero steps appended to (or put in front of) its
    axis 1: ``F.pad``'s values by a concatenation, which DTensor's rules
    take in every torch release (some mishandle ``constant_pad_nd``).  On
    a DTensor the zeros are laid out as ``t`` is, so the concatenation
    keeps ``t``'s layout (a plain tensor of zeros counts as replicated,
    and the concatenation would gather ``t``)."""
    shape = (t.shape[0], n) + tuple(t.shape[2:])
    if isinstance(t, DTensor):
        z = torch.zeros_like(t[:, :1]).expand(shape)
    else:
        z = torch.zeros(shape, dtype=t.dtype, device=t.device)
    return torch.cat([z, t] if front else [t, z], dim=1)


def _seq_sharded(t):
    """A cache leaf (B, L, KV, hd) in the decode cache's layout ("kv_seq":
    the sequence over the model axis, as the reference's compiled prefill
    returns its caches).  Left as the attention made it, a leaf follows
    the kv heads, which rarely divide the model axis, and is whole on
    every device of it."""
    return constrain(t, "kv_seq")


def prefill_to_cache(cfg, spec, k, v, max_seq: int):
    """Convert full-sequence rope'd k/v (B,S,KV,hd) into a decode cache of
    length ``cache_len`` (ring layout: slot = pos % L)."""
    B, S, KV, hd = k.shape
    L = cache_len(cfg, spec, max_seq)
    dev = k.device
    if L == max_seq and S <= L:
        pad = L - S
        kc = pad_seq(k, pad)
        vc = pad_seq(v, pad)
        pos = torch.cat([torch.arange(S, dtype=torch.int32, device=dev),
                         torch.full((pad,), -1, dtype=torch.int32,
                                    device=dev)])
        return {"k": _seq_sharded(kc), "v": _seq_sharded(vc), "pos": pos}
    # keep last L positions, ring-ordered: position p in slot p % L, so
    # the last L positions rolled by start % L (a roll as two slices: not
    # every torch release has a DTensor rule for roll)
    start = S - L
    ppos = start + torch.arange(L, dtype=torch.int32, device=dev)
    cut = L - start % L

    def ring(t, dim):
        t = t.narrow(dim, t.shape[dim] - L, L)
        return torch.cat([t.narrow(dim, cut, L - cut),
                          t.narrow(dim, 0, cut)], dim=dim)

    return {"k": _seq_sharded(ring(k, 1)), "v": _seq_sharded(ring(v, 1)),
            "pos": ring(ppos, 0)}


def attention_decode(params, x, cache, pos, cfg: ModelConfig,
                     spec: LayerSpec):
    """One-token decode.  x: (B,1,D); pos: the position of x, an int or a
    0-d int32 tensor on x's device (read on the device only, so a captured
    step serves every position).  Returns the output and a new cache;
    ``cache`` itself is not changed."""
    B = x.shape[0]
    pos = pos.to(torch.int32) if isinstance(pos, torch.Tensor) else \
        torch.full((), pos, dtype=torch.int32, device=x.device)
    positions = pos.reshape(1, 1).expand(B, 1)
    q, k, v = _qkv(params, x, cfg, positions)  # (B,1,·,hd), rope'd at abs pos
    L = cache["k"].shape[1]
    # the new entry goes to slot pos % L by selection, not by an indexed
    # write: a select keeps the cache's sequence sharding on DTensors.  The
    # entry is whole but for its batch rows there, so the selection takes
    # the cache's layout (an entry sharded on its heads, where they divide
    # the model axis, may lead DTensor to move the whole cache to it)
    hit = torch.arange(L, device=x.device) == pos % L
    k, v = constrain(k, "kv_new"), constrain(v, "kv_new")
    kc = torch.where(hit[:, None, None], k.to(cache["k"].dtype), cache["k"])
    vc = torch.where(hit[:, None, None], v.to(cache["v"].dtype), cache["v"])
    cpos = torch.where(hit, pos, cache["pos"])
    mask = _scores_mask(positions[0], cpos, cfg, spec, causal=True)  # (1,L)
    out = _attend(q, kc, vc, mask, cfg, keys=True)
    # the (B, H*hd) @ wo product matmul folds (B, 1, H*hd) into; a DTensor
    # can carry another stride on the size-1 query dim, which stops the
    # fold and runs a bmm over an expanded wo, summed in another order
    out = residual((out[:, 0] @ row(params["wo"]))[:, None])
    return out, {"k": kc, "v": vc, "pos": cpos}


# --------------------------------------------------------------------------- MLP
def init_mlp(d: int, f: int, gen: torch.Generator, dtype, device,
             lead=()):
    s, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)

    def normal(*shape):
        return torch.randn(tuple(lead) + shape, generator=gen,
                           dtype=torch.float32, device=device)

    return {
        "w_gate": (normal(d, f) * s).to(dtype),
        "w_up": (normal(d, f) * s).to(dtype),
        "w_down": (normal(f, d) * so).to(dtype),
    }


def activation(x, act: str):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


def mlp(params, x, act: str = "silu"):
    h = constrain(activation(column(x, params["w_gate"]), act)
                  * column(x, params["w_up"]), "ffn")
    return residual(h @ row(params["w_down"]))
