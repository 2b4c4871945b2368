"""Plain reference of a Qwen3 dense stack [arXiv:2505.09388].  A layer:
pre-norm RMSNorm; grouped-query attention whose queries and keys are
RMS-normalized over the head dim (``q_norm``, ``k_norm``) before rotary
embeddings (rotate-half, ``rope_theta``), causal over the whole
sequence; the residual; RMSNorm; a SwiGLU MLP; the residual.  Untied
head.  The weights are upcast a layer at a time.

``pipeline`` composes the stack as COACH's two-pod step does: the first
pod's layers, the boundary rows quantized to the wire's bits and
dequantized, the second pod's layers, the final norm and the head of
each sequence's last token.

``dtype`` is the precision of every matrix product's operands.  Below
float32 it makes a control: ``torch.float8_e4m3fn`` rounds each
product's left operand by rows and its right operand by columns, each
with its own scale (its largest magnitude over 448, e4m3's largest), and
multiplies in float32; another dtype computes in that dtype."""

from __future__ import annotations

import math

import torch

from perfbench.reference.common import dequantize, quantize, rms_norm
from perfbench.reference.moe import _rope

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def _round8(x, dim):
    """``x`` rounded to e4m3 with one scale a slice along ``dim``."""
    s = torch.clamp(torch.amax(torch.abs(x), dim=dim, keepdim=True),
                    min=1e-30) / FP8_MAX
    return (x / s).to(FP8).to(torch.float32) * s


def mm(a, b, dtype):
    """``a @ b`` with its operands in ``dtype``."""
    if dtype == FP8:
        return _round8(a.to(torch.float32), -1) \
            @ _round8(b.to(torch.float32), -2)
    return a.to(dtype) @ b.to(dtype)


def act(dtype):
    """The activations' dtype: float32 under an fp8 control."""
    return torch.float32 if dtype == FP8 else dtype


def attention(a, i, x, model, dtype):
    B, S, D = x.shape
    H, KV, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    eps = model["norm_eps"]
    q = mm(x, a["wq"][i], dtype).reshape(B, S, H, hd)
    k = mm(x, a["wk"][i], dtype).reshape(B, S, KV, hd)
    v = mm(x, a["wv"][i], dtype).reshape(B, S, KV, hd)
    q = rms_norm(q, a["q_norm"]["scale"][i], eps)
    k = rms_norm(k, a["k_norm"]["scale"][i], eps)
    q, k = _rope(q, model["rope_theta"]), _rope(k, model["rope_theta"])
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    scores = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1), dtype).to(
        torch.float32) / math.sqrt(hd)                        # (B, H, S, S)
    pos = torch.arange(S, device=x.device)
    keep = pos[None, :] <= pos[:, None]
    w = torch.softmax(scores.masked_fill(~keep, -math.inf), dim=-1)
    out = mm(w, v.transpose(1, 2), dtype).transpose(1, 2).reshape(B, S, D)
    return mm(out, a["wo"][i], dtype)


def mlp(m, i, x, dtype):
    h = torch.nn.functional.silu(mm(x, m["w_gate"][i], dtype)) \
        * mm(x, m["w_up"][i], dtype)
    return mm(h, m["w_down"][i], dtype)


def layer(g, i, h, model, dtype):
    x = rms_norm(h, g["norm1"]["scale"][i], model["norm_eps"])
    h = h + attention(g["attn"], i, x, model, dtype)
    x = rms_norm(h, g["norm2"]["scale"][i], model["norm_eps"])
    return h + mlp(g["mlp"], i, x, dtype)


def forward(params, model, x, layers, dtype=torch.float32, first=False,
            last=False):
    """As ``ssm.forward``: ``x`` token ids (B, S) with ``first`` (the
    rows of the embedding are looked up, then upcast), else (B, S, D)
    activations; with ``last`` the final norm and the head of the last
    token, (B, V) float32."""
    g = params["groups"][0]
    h = params["embed"][x.long()].to(act(dtype)) if first \
        else x.to(act(dtype))
    for i in layers:
        h = layer(g, i, h, model, dtype)
    if not last:
        return h
    h = rms_norm(h[:, -1], params["final_norm"]["scale"], model["norm_eps"])
    return mm(h, params["lm_head"], dtype).to(torch.float32)


def pipeline(params, model, tokens, split, bits, dtype=torch.float32):
    """The two pods composed: layers ``[0, split)`` on token ids (B, S),
    the boundary's rows through a ``bits``-bit wire, the remaining
    layers, and the last token's logits (B, V) float32."""
    h = forward(params, model, tokens, range(split), dtype, first=True)
    B, S, D = h.shape
    wire = quantize(h.reshape(B * S, D), bits)
    h = dequantize(*wire, bits, D).reshape(B, S, D)
    return forward(params, model, h, range(split, model["num_layers"]),
                   dtype, last=True)
