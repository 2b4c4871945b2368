"""Mamba2 / SSD (state-space duality) mixer in PyTorch, mirroring
``repro.models.ssm`` [arXiv:2405.21060].

Chunked SSD: intra-chunk quadratic attention-like term + inter-chunk
recurrence over per-chunk states (a Python loop over chunks where the JAX
package scans), giving O(S * Q) compute, O(1)-state decode, and exact
equivalence with the sequential recurrence.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import pad_seq
from repro_torch.models.shardctx import (constrain, grad_in_layout,
                                         on_shards, reshape)

SSM_GROUPS = 1  # n_groups for the B/C projections


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.ssm_inner + 2 * SSM_GROUPS * cfg.ssm_state


def init_mamba(cfg: ModelConfig, gen: torch.Generator, dtype, device,
               lead=()):
    """Separate z / x / B / C / dt projections and per-stream conv kernels,
    as in the JAX package's tree.  ``lead`` prepends stacking dims (the
    group axis of a stacked parameter tree)."""
    d, di, n, h = cfg.d_model, cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    gn = SSM_GROUPS * n
    lead = tuple(lead)
    s = 1.0 / math.sqrt(d)

    def rnd(shape, sc):
        return (torch.randn(lead + shape, generator=gen, dtype=torch.float32,
                            device=device) * sc).to(dtype)

    def full(shape, value, dt=dtype):
        return torch.full(lead + shape, value, dtype=dt, device=device)

    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                     device=device))
    u = torch.rand(lead + (h,), generator=gen, dtype=torch.float32,
                   device=device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return {
        "in_z": rnd((d, di), s),
        "in_x": rnd((d, di), s),
        "in_B": rnd((d, gn), s),
        "in_C": rnd((d, gn), s),
        "in_dt": rnd((d, h), s),
        "conv_x": rnd((cfg.ssm_conv, di), 0.1),
        "conv_B": rnd((cfg.ssm_conv, gn), 0.1),
        "conv_C": rnd((cfg.ssm_conv, gn), 0.1),
        "conv_bx": full((di,), 0.0),
        "conv_bB": full((gn,), 0.0),
        "conv_bC": full((gn,), 0.0),
        "A_log": a_log.expand(lead + (h,)).clone(),
        "D": full((h,), 1.0, torch.float32),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "norm_scale": full((di,), 1.0),
        "out_proj": rnd((di, d), 1.0 / math.sqrt(di)),
    }


def _causal_conv(xc, w, b):
    """Depthwise causal conv.  xc: (B,S,Dc); w: (K,Dc)."""
    K, S = w.shape[0], xc.shape[1]
    pad = pad_seq(xc, K - 1, front=True)
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(K))
    return F.silu(out + b)


def _gated_norm(y, z, scale, eps):
    y = y * F.silu(z)
    dt = y.dtype
    yf = y.to(torch.float32)
    var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(dt)


def _segsum_decay(dA_cum):
    """dA_cum: (..., Q, H) within-chunk inclusive cumsum of dt*A.
    Returns L: (..., H, Q, Q) with L[i,j] = exp(cum_i - cum_j) for i>=j else 0.
    """
    ci = dA_cum[..., :, None, :]  # (...,Q,1,H)
    cj = dA_cum[..., None, :, :]  # (...,1,Q,H)
    Q = dA_cum.shape[-2]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=dA_cum.device))
    # masked before exp, so no inf - inf above the diagonal
    diff = torch.where(mask[..., None], ci - cj, -math.inf)
    return torch.exp(torch.movedim(diff, -1, -3))  # (...,H,Q,Q)


def ssd_chunked(cfg: ModelConfig, x, dt, A, Bm, Cm, h0=None):
    """Chunked SSD scan.

    x: (B,S,H,P)  dt: (B,S,H)  A: (H,)  Bm/Cm: (B,S,G,N)
    Returns y: (B,S,H,P), final state (B,H,P,N).
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(cfg.ssm_chunk, S)
    S_real = S
    if S % Q != 0:
        # pad with dt=0 steps: decay exp(0)=1 and zero input leave the state
        # recurrence unchanged; padded outputs are discarded below.
        pad = Q - S % Q

        def z2(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))

        x, dt, Bm, Cm = z2(x), z2(dt), z2(Bm), z2(Cm)
        S = S + pad
    nc = S // Q
    rep = H // Bm.shape[2]
    Bh = torch.repeat_interleave(Bm, rep, dim=2)  # (B,S,H,N)
    Ch = torch.repeat_interleave(Cm, rep, dim=2)

    # the reference shards the chunk axis nc of every intra-chunk tensor
    # over "model" here (launch.sharding.activation_specs); the port runs
    # the scan on each device's rows and heads instead (mamba_forward), so
    # these constraints meet local tensors and leave them as they are
    def r(t, name):
        return constrain(t.reshape((Bsz, nc, Q) + tuple(t.shape[2:])), name)

    xc, dtc = r(x, "ssm_chunk_x"), r(dt, "ssm_chunk_dt")
    Bc, Cc = r(Bh, "ssm_chunk_bc"), r(Ch, "ssm_chunk_bc")
    dA = dtc * A  # (B,nc,Q,H)
    cum = torch.cumsum(dA, dim=2)
    xdt = xc * dtc[..., None]

    # intra-chunk (diagonal blocks)
    L = constrain(_segsum_decay(cum), "ssm_chunk_l")  # (B,nc,H,Q,Q)
    CB = constrain(torch.einsum("bcihn,bcjhn->bchij", Cc, Bc), "ssm_chunk_l")
    Yd = constrain(torch.einsum("bchij,bcjhp->bcihp", CB * L, xdt),
                   "ssm_chunk_x")

    # per-chunk state contributions
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)  # (B,nc,Q,H)
    Sc = constrain(torch.einsum("bcjhn,bcjhp->bchpn", Bc,
                                xdt * decay_out[..., None]), "ssm_chunk_s")

    # inter-chunk recurrence: the final state and the state entering each
    # chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,nc,H)
    h = torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, c, :, None, None] + Sc[:, c]
    h_in = torch.stack(h_in, dim=1)  # (B,nc,H,P,N)

    Yo = constrain(torch.einsum("bcihn,bchpn->bcihp",
                                Cc * torch.exp(cum)[..., None], h_in),
                   "ssm_chunk_x")
    y = (Yd + Yo).reshape(Bsz, S, H, P)[:, :S_real]
    return y, h


def mamba_forward(params, x, cfg: ModelConfig, h0=None,
                  return_cache: bool = False):
    """Full-sequence mamba2 block.  x: (B,S,D)."""
    Bsz, S, _ = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z = constrain(x @ params["in_z"], "ssm_inner")
    xr = constrain(x @ params["in_x"], "ssm_inner")
    Br = x @ params["in_B"]
    Cr = x @ params["in_C"]
    dt = grad_in_layout(x @ params["in_dt"])
    xs = constrain(_causal_conv(xr, params["conv_x"], params["conv_bx"]),
                   "ssm_inner")
    Bm = _causal_conv(Br, params["conv_B"], params["conv_bB"])
    Cm = _causal_conv(Cr, params["conv_C"], params["conv_bC"])
    xs = constrain(reshape(xs, Bsz, S, H, P), "ssm_heads")
    Bm = reshape(Bm, Bsz, S, SSM_GROUPS, N)
    Cm = reshape(Cm, Bsz, S, SSM_GROUPS, N)
    A = -torch.exp(params["A_log"])
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x itself above
    # its threshold of 20, where log1p(exp(-x)) < 2.1e-9 is below half an
    # fp32 ulp of x, so the two agree in fp32
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])
    # on DTensors the scan runs on each device's batch rows and heads (the
    # B/C streams are shared by the heads)
    y, hT = on_shards(functools.partial(ssd_chunked, cfg),
                      (xs, dt.to(xs.dtype), A.to(xs.dtype), Bm, Cm, h0),
                      dims=((0, 2), (0, 2), (None, 0), (0, None), (0, None),
                            (0, 1)),
                      out_dims=((0, 2), (0, 1)))
    y = y + params["D"].to(y.dtype)[:, None] * xs
    y = constrain(y.reshape(Bsz, S, -1), "ssm_inner")
    out = _gated_norm(y, z, params["norm_scale"], cfg.norm_eps) \
        @ params["out_proj"]
    if return_cache:
        K = cfg.ssm_conv
        conv_cache = {
            "x": _left_pad_tail(xr, K - 1),
            "B": _left_pad_tail(Br, K - 1),
            "C": _left_pad_tail(Cr, K - 1),
        }
        return out, {"state": hT, "conv": conv_cache}
    return out


def _left_pad_tail(xc, n):
    """Last n steps of xc, left-padded with zeros if S < n."""
    S = xc.shape[1]
    if S >= n:
        return xc[:, -n:]
    return pad_seq(xc, n - S, front=True)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device):
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    K = cfg.ssm_conv
    gn = SSM_GROUPS * N

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "state": zeros(batch, H, P, N),
        "conv": {
            "x": zeros(batch, K - 1, cfg.ssm_inner),
            "B": zeros(batch, K - 1, gn),
            "C": zeros(batch, K - 1, gn),
        },
    }


def _decode_conv(hist_prev, cur, w, b):
    """One step of a causal conv stream: (output, new history)."""
    hist = torch.cat([hist_prev, cur[:, None]], dim=1)  # (B,K,·)
    return F.silu(torch.einsum("bkd,kd->bd", hist, w) + b), hist[:, 1:]


def _decode_state(xs, Bm, Cm, dt, A, Dp, state):
    """The O(1) state update of one token: (y (B,H,P), state (B,H,P,N));
    the B/C streams (B,G,N) are shared by the heads of a group."""
    H = xs.shape[1]
    Bm = torch.repeat_interleave(Bm, H // Bm.shape[1], dim=1)
    Cm = torch.repeat_interleave(Cm, H // Cm.shape[1], dim=1)
    dA = torch.exp(dt * A).to(xs.dtype)  # (B,H)
    dBx = torch.einsum("bh,bhn,bhp->bhpn", dt.to(xs.dtype), Bm, xs)
    h = state * dA[..., None, None] + dBx
    y = torch.einsum("bhn,bhpn->bhp", Cm, h) + Dp.to(xs.dtype)[:, None] * xs
    return y, h


def mamba_decode(params, x, cache, cfg: ModelConfig):
    """One-token decode.  x: (B,1,D).  O(1) state update.  Returns the
    output and a new cache; ``cache`` itself is not changed.  On DTensors
    the convs and the update run on each device's batch rows and
    channels or heads."""
    Bsz = x.shape[0]
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x0 = x[:, 0]
    z = x0 @ params["in_z"]
    xr = x0 @ params["in_x"]
    Br = x0 @ params["in_B"]
    Cr = x0 @ params["in_C"]
    dt = x0 @ params["in_dt"]

    def dconv(stream, cur):
        return on_shards(_decode_conv, (cache["conv"][stream], cur,
                                        params[f"conv_{stream}"],
                                        params[f"conv_b{stream}"]),
                         dims=((0, 2), (0, 1), (None, 1), (None, 0)),
                         out_dims=((0, 1), (0, 2)))

    xs, cx = dconv("x", xr)
    Bm, cB = dconv("B", Br)
    Cm, cC = dconv("C", Cr)
    A = -torch.exp(params["A_log"])
    # F.softplus == jax.nn.softplus in fp32 (see mamba_forward)
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])  # (B,H)
    y, h = on_shards(_decode_state,
                     (reshape(xs, Bsz, H, P), reshape(Bm, Bsz, SSM_GROUPS, N),
                      reshape(Cm, Bsz, SSM_GROUPS, N), dt, A, params["D"],
                      cache["state"]),
                     dims=((0, 1), (0, None), (0, None), (0, 1), (None, 0),
                           (None, 0), (0, 1)),
                     out_dims=((0, 1), (0, 1)))
    y = y.reshape(Bsz, -1)
    out = _gated_norm(y, z, params["norm_scale"], cfg.norm_eps) \
        @ params["out_proj"]
    new_cache = {"state": h, "conv": {"x": cx, "B": cB, "C": cC}}
    return out[:, None], new_cache
