"""Plain reference of a Mamba2 (SSD) stack [arXiv:2405.21060], with the
state-space scan written as the sequential recurrence

    h_t = exp(dt_t * A) h_{t-1} + dt_t * x_t B_t^T,   y_t = h_t C_t + D x_t

(the program computes it by chunks).  A layer: pre-norm RMSNorm; z, x,
B, C and dt projections; depthwise causal convolution with bias and SiLU
on x, B and C; dt = softplus(dt + dt_bias); the scan; y * SiLU(z) then
RMSNorm (the gated norm); the out projection; the residual.  One group
of B/C for all heads.  The head is tied to the embedding."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import embed, head, rms_norm


def _conv(x, w, b):
    """Depthwise causal convolution: x (B, S, C), w (K, C), b (C,)."""
    K, C = w.shape
    xp = F.pad(x.transpose(1, 2), (K - 1, 0))
    return F.silu(F.conv1d(xp, w.T[:, None, :], b, groups=C).transpose(1, 2))


def layer(g, i, h, model, dtype):
    m = {k: v[i] for k, v in g["mamba"].items()}
    B_, S, _ = h.shape
    P, N = model["ssm_head_dim"], model["ssm_state"]
    x = rms_norm(h, g["norm1"]["scale"][i], model["norm_eps"])

    def proj(name):
        return x @ m[name].to(dtype)

    z, xr, Br, Cr, dt = (proj(n) for n in ("in_z", "in_x", "in_B", "in_C",
                                           "in_dt"))
    xs = _conv(xr, m["conv_x"].to(dtype), m["conv_bx"].to(dtype))
    Bm = _conv(Br, m["conv_B"].to(dtype), m["conv_bB"].to(dtype))
    Cm = _conv(Cr, m["conv_C"].to(dtype), m["conv_bC"].to(dtype))
    H = dt.shape[-1]
    A = -torch.exp(m["A_log"].to(torch.float32))
    dt = F.softplus(dt.to(torch.float32) + m["dt_bias"].to(torch.float32))
    xs = xs.reshape(B_, S, H, P)
    state = torch.zeros((B_, H, P, N), dtype=dtype, device=h.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A).to(dtype)             # (B, H)
        xdt = xs[:, t] * dt[:, t, :, None].to(dtype)          # (B, H, P)
        state = state * decay[..., None, None] \
            + xdt[..., None] @ Bm[:, t, None, None, :]        # (B, H, P, N)
        ys.append((state @ Cm[:, t, None, :, None])[..., 0])  # (B, H, P)
    y = torch.stack(ys, dim=1) + m["D"].to(dtype)[:, None] * xs
    y = y.reshape(B_, S, H * P) * F.silu(z)
    y = rms_norm(y, m["norm_scale"], model["norm_eps"])
    return h + y @ m["out_proj"].to(dtype)


def forward(params, model, x, layers, dtype=torch.float32, first=False,
            last=False):
    """Layers ``layers`` (a range) of the stack on ``x``: token ids when
    ``first`` (the embedding runs first), else the (B, S, D) activation;
    with ``last`` the final norm and the head of the last token follow,
    and the (B, V) float32 logits come back."""
    g = params["groups"][0]
    h = embed(params, x, dtype) if first else x.to(dtype)
    for i in layers:
        h = layer(g, i, h, model, dtype)
    return head(params, model, h, dtype) if last else h
