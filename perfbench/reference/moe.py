"""Plain reference of a Mixtral stack [arXiv:2401.04088].  A layer:
pre-norm RMSNorm; grouped-query attention with rotary embeddings
(rotate-half, ``rope_theta``), causal, within ``sliding_window``; the
residual; RMSNorm; a sparse MoE FFN (float32 router, softmax, top-k with
ties to the lower expert, gates renormalized over the k, SwiGLU
experts); the residual.  Untied head.

Departure from the published, dropless model, as the program serves it:
each task's tokens are dispatched by capacity, ``max(4, min(ceil(S * k
* capacity_factor / E), S * k))`` slots an expert, taken in token-major
order of (token, choice); a choice past its expert's capacity adds
nothing."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.common import embed, head, rms_norm


def _rope(x, theta):
    """x (B, S, H, hd), positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def attention(a, i, x, model, dtype):
    B, S, D = x.shape
    H, KV, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    q = (x @ a["wq"][i].to(dtype)).reshape(B, S, H, hd)
    k = (x @ a["wk"][i].to(dtype)).reshape(B, S, KV, hd)
    v = (x @ a["wv"][i].to(dtype)).reshape(B, S, KV, hd)
    q, k = _rope(q, model["rope_theta"]), _rope(k, model["rope_theta"])
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    scores = (q.transpose(1, 2) @ k.permute(0, 2, 3, 1)).to(torch.float32) \
        / math.sqrt(hd)                                      # (B, H, S, S)
    pos = torch.arange(S, device=x.device)
    keep = (pos[None, :] <= pos[:, None]) \
        & (pos[None, :] > pos[:, None] - model["sliding_window"])
    w = torch.softmax(scores.masked_fill(~keep, -math.inf), dim=-1)
    out = (w.to(dtype) @ v.transpose(1, 2)).transpose(1, 2).reshape(B, S, D)
    return out @ a["wo"][i].to(dtype)


def capacity(S, model):
    k, E = model["experts_per_token"], model["num_experts"]
    c = math.ceil(S * k * model["capacity_factor"] / E)
    return max(4, min(c, S * k))


def moe(m, i, x, model, dtype):
    B, S, D = x.shape
    k, E = model["experts_per_token"], model["num_experts"]
    probs = torch.softmax(x.to(torch.float32)
                          @ m["router"][i].to(torch.float32), dim=-1)
    ids = torch.sort(probs, dim=-1, descending=True, stable=True
                     ).indices[..., :k]                       # (B, S, k)
    gates = torch.gather(probs, -1, ids)
    gates = (gates / gates.sum(-1, keepdim=True)).to(dtype)
    flat = ids.reshape(B, S * k)
    seen = torch.cumsum(F.one_hot(flat, E), dim=1)             # (B, Sk, E)
    slot = torch.gather(seen, 2, flat[..., None])[..., 0] - 1
    kept = (slot < capacity(S, model)).reshape(B, S, k)
    xf = x.reshape(B * S, D)
    y = torch.zeros((B * S, D), dtype=dtype, device=x.device)
    for e in range(E):
        b, s, j = torch.nonzero((ids == e) & kept, as_tuple=True)
        if b.numel() == 0:
            continue
        rows = b * S + s
        xe = xf[rows]
        he = F.silu(xe @ m["w_gate"][i, e].to(dtype)) \
            * (xe @ m["w_up"][i, e].to(dtype))
        ye = he @ m["w_down"][i, e].to(dtype)
        y.index_add_(0, rows, ye * gates[b, s, j][:, None])
    return y.reshape(B, S, D)


def layer(g, i, h, model, dtype):
    x = rms_norm(h, g["norm1"]["scale"][i], model["norm_eps"])
    h = h + attention(g["attn"], i, x, model, dtype)
    x = rms_norm(h, g["norm2"]["scale"][i], model["norm_eps"])
    return h + moe(g["moe"], i, x, model, dtype)


def forward(params, model, x, layers, dtype=torch.float32, first=False,
            last=False):
    """As ``ssm.forward``."""
    g = params["groups"][0]
    h = embed(params, x, dtype) if first else x.to(dtype)
    for i in layers:
        h = layer(g, i, h, model, dtype)
    return head(params, model, h, dtype) if last else h
