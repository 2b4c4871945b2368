"""Mamba2 / SSD (state-space duality) mixer in PyTorch, mirroring
``repro.models.ssm`` [arXiv:2405.21060].

Chunked SSD: intra-chunk quadratic attention-like term + inter-chunk
recurrence over per-chunk states (a Python loop over chunks where the JAX
package scans), giving O(S * Q) compute, O(1)-state decode, and exact
equivalence with the sequential recurrence.
"""

from __future__ import annotations

import collections
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build as KB
from repro_torch.kernels import ssd as SSD
from repro_torch.kernels import ssd_proj as PROJ
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import column, pad_seq, residual, row
from repro_torch.models.shardctx import (constrain, grad_in_layout,
                                         on_shards, reshape)

SSM_GROUPS = 1  # n_groups for the B/C projections

# the path of each ``mamba_forward`` call, one count a call: "fused" (the
# SSD mixer kernels, ``kernels/ssd.py``) or "plain.<reason>" (the chain
# ``mixer_plain``; the reasons are ``plain_reason``'s).  Inside a jitted
# function it counts at capture.
PATHS: collections.Counter = collections.Counter()
# the path of each ``mamba_forward`` call's projections, one count a call:
# "fused" (the five input projections and out_proj on the projection
# kernels, ``kernels/ssd_proj.py``) or "plain.<reason>" (``layers.column``
# and ``@``; the reasons are ``proj_plain_reason``'s)
PROJ_PATHS: collections.Counter = collections.Counter()
IN_PROJ = ("in_z", "in_x", "in_B", "in_C", "in_dt")


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


def _chunk_terms(xc, dtc, A, Bc, Cc):
    """The intra-chunk output and each chunk's state contribution of the
    chunks given.  xc: (B,nc,Q,H,P)  dtc: (B,nc,Q,H)  A: (H,)
    Bc: (B,nc,Q,G,N)  Cc: (B,nc,Q,H,N).  Returns Yd (B,nc,Q,H,P), Sc
    (B,nc,H,P,N) and the within-chunk cumsum of dt*A (B,nc,Q,H)."""
    Bc = torch.repeat_interleave(Bc, xc.shape[3] // Bc.shape[3],
                                 dim=3)  # (B,nc,Q,H,N)
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
    return Yd, Sc, cum


def _recurrence(Sc, last, h0):
    """The inter-chunk recurrence over every chunk: the state entering
    each chunk (B,nc,H,P,N) and the final state (B,H,P,N).  last: the
    cumsum's last step of each chunk (B,nc,H)."""
    Bsz, nc, H, P, N = Sc.shape
    chunk_decay = torch.exp(last)  # (B,nc,H)
    h = torch.zeros((Bsz, H, P, N), dtype=Sc.dtype, device=Sc.device) \
        if h0 is None else h0
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, c, :, None, None] + Sc[:, c]
    return torch.stack(h_in, dim=1), h


def _chunk_out(Cc, cum, h_in):
    """Each chunk's output from the state entering it (B,nc,Q,H,P).
    Cc: (B,nc,Q,H,N)."""
    return constrain(torch.einsum("bcihn,bchpn->bcihp",
                                  Cc * torch.exp(cum)[..., None], h_in),
                     "ssm_chunk_x")


def ssd_chunked(cfg: ModelConfig, x, dt, A, Bm, Cm, h0=None):
    """Chunked SSD scan.

    x: (B,S,H,P)  dt: (B,S,H)  A: (H,)  Bm/Cm: (B,S,G,N)
    Returns y: (B,S,H,P), final state (B,H,P,N).

    On DTensors the intra-chunk terms and outputs run on each device's
    batch rows and its slice of the chunks, the chunk axis sharded over
    the model axis as the reference's "ssm_chunk_*" specs shard it; the
    recurrence between chunks runs on every chunk's state on each device
    (the states are small: one (H, P, N) a chunk and row).
    """
    Bsz, S, H, P = x.shape
    Q = min(cfg.ssm_chunk, S)
    S_real = S
    if S % Q != 0:
        # pad with dt=0 steps: decay exp(0)=1 and zero input leave the state
        # recurrence unchanged; padded outputs are discarded below.
        pad = Q - S % Q

        def z2(t):
            if isinstance(t, DTensor):
                return pad_seq(t, pad)
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))

        x, dt, Bm, Cm = z2(x), z2(dt), z2(Bm), z2(Cm)
        S = S + pad
    nc = S // Q

    def r(t, name):
        return constrain(reshape(t, (Bsz, nc, Q) + tuple(t.shape[2:])), name)

    xc, dtc = r(x, "ssm_chunk_x"), r(dt, "ssm_chunk_dt")
    Bc, Cc = r(Bm, "ssm_chunk_bc"), r(Cm, "ssm_chunk_bc")
    # C is repeated over the heads once, for both of its uses, as the
    # reference repeats it; B has one use, in the intra-chunk terms
    Cc = torch.repeat_interleave(Cc, H // Cc.shape[3], dim=3)
    Yd, Sc, cum = on_shards(_chunk_terms, (xc, dtc, A, Bc, Cc),
                            dims=((0, 3, 1), (0, 3, 1), (None, 0),
                                  (0, None, 1), (0, 3, 1)),
                            out_dims=((0, 3, 1), (0, 2, 1), (0, 3, 1)))
    h_in, h = on_shards(_recurrence, (Sc, cum[:, :, -1, :], h0),
                        dims=((0, 2), (0, 2), (0, 1)),
                        out_dims=((0, 2), (0, 1)))
    Yo = on_shards(_chunk_out, (Cc, cum, h_in),
                   dims=((0, 3, 1), (0, 3, 1), (0, 2, 1)),
                   out_dims=(0, 3, 1))
    y = reshape(Yd + Yo, Bsz, S, H, P)[:, :S_real]
    return y, h


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def plain_reason(params, acts, cfg: ModelConfig,
                 h0=None) -> Optional[str]:
    """None where the fused SSD mixer takes a ``mamba_forward`` call with
    the projections' outputs ``acts`` (z, xr, Br, Cr, dt), else why the
    plain chain runs it, the cases where the kernels cannot: "dtensor" (a
    sharded step), "cpu" (a tensor off the card), "grad" (grad mode and a
    tensor that requires grad), "dtype" (activations of a type the kernels
    do not take) or "shape" (groups, head dim, state, taps or chunk length
    the kernels are not built for).  Layout and the parameters' types are
    no reason: ``_as_taken`` gives the kernels what they take."""
    every = list(acts) + [params[k] for k in SSD.TYPED_PARAMS
                          + SSD.HEAD_PARAMS] + ([] if h0 is None else [h0])
    if any(isinstance(t, DTensor) for t in every):
        return "dtensor"
    if not all(_on_card(t) for t in every):
        return "cpu"
    if torch.is_grad_enabled() and any(t.requires_grad for t in every):
        return "grad"
    if acts[1].dtype not in KB.ACTIVATION_DTYPES:
        return "dtype"
    B, S = acts[1].shape[:2]
    if SSM_GROUPS != 1 or not SSD.takes_shape(
            B, S, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv,
            cfg.ssm_chunk):
        return "shape"
    return None


def proj_plain_reason(params, x) -> Optional[str]:
    """None where the projection kernels take a ``mamba_forward`` call on
    x (B,S,D), else why ``layers.column`` and ``@`` run its projections:
    "dtensor" (a sharded step), "cpu" (a tensor off the card), "grad"
    (grad mode and a tensor that requires grad), "dtype" (x or a weight
    not float32), "rows" (B*S over ``kernels.ssd_proj.MAX_ROWS``: more
    rows make the product compute-bound, which streaming weights does not
    serve) or "shape" (widths or a weight's layout the kernels do not
    take)."""
    ws = [params[k] for k in IN_PROJ + ("out_proj",)]
    every = [x] + ws
    if any(isinstance(t, DTensor) for t in every):
        return "dtensor"
    if not all(_on_card(t) for t in every):
        return "cpu"
    if torch.is_grad_enabled() and any(t.requires_grad for t in every):
        return "grad"
    if any(t.dtype != torch.float32 for t in every):
        return "dtype"
    rows = math.prod(x.shape[:-1])
    if not 1 <= rows <= PROJ.MAX_ROWS:
        return "rows"
    out_w = ws.pop()
    if not (PROJ.takes(rows, x.shape[-1], [w.shape[1] for w in ws])
            and PROJ.takes(rows, out_w.shape[0], [out_w.shape[1]])
            and all(w.is_contiguous() and PROJ.aligned(w)
                    for w in ws + [out_w])):
        return "shape"
    return None


def _as_taken(params, acts, h0):
    """The fused mixer's inputs as the kernels take them: contiguous, in
    xr's type, with A_log, D and dt_bias in float32 (the tensors
    themselves where they are so already, as a model's own are)."""
    dtype = acts[1].dtype

    def typed(t):
        return t.to(dtype).contiguous()

    taken = {k: typed(params[k]) for k in SSD.TYPED_PARAMS}
    taken.update({k: params[k].to(torch.float32).contiguous()
                  for k in SSD.HEAD_PARAMS})
    return (tuple(typed(t) for t in acts), taken,
            None if h0 is None else typed(h0))


def mixer_plain(params, z, xr, Br, Cr, dt, cfg: ModelConfig, h0=None):
    """The mixer of ``mamba_forward`` from its projections' outputs, op by
    op: the convs, softplus, ``ssd_chunked``, the D skip and the gated
    norm.  Returns the input of ``out_proj`` and the final state."""
    Bsz, S, _ = xr.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
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
    y, hT = ssd_chunked(cfg, xs, dt.to(xs.dtype), A.to(xs.dtype), Bm, Cm,
                        h0)
    y = y + params["D"].to(y.dtype)[:, None] * xs
    y = constrain(y.reshape(Bsz, S, -1), "ssm_inner")
    return _gated_norm(y, z, params["norm_scale"], cfg.norm_eps), hT


def mamba_forward(params, x, cfg: ModelConfig, h0=None,
                  return_cache: bool = False):
    """Full-sequence mamba2 block.  x: (B,S,D).  The projections run on
    the projection kernels where they take the call
    (``proj_plain_reason``), as ``layers.column`` and ``@`` elsewhere;
    between them the fused SSD mixer kernels run where they take the call
    (``plain_reason``), the plain chain ``mixer_plain`` elsewhere."""
    proj = proj_plain_reason(params, x)
    PROJ_PATHS["fused" if proj is None else f"plain.{proj}"] += 1
    if proj is None:
        z, xr, Br, Cr, dt = PROJ.ssd_in_proj(
            x.contiguous(), *(params[k] for k in IN_PROJ))
    else:
        # z's gradient comes out of the gated norm as a partial sum over
        # the model axis (its variance reduces over the sharded inner
        # dim): reduced to z's layout before the product's backward takes
        # it, as for ``layers.residual``
        z = grad_in_layout(constrain(column(x, params["in_z"]),
                                     "ssm_inner"))
        xr = constrain(column(x, params["in_x"]), "ssm_inner")
        Br = column(x, params["in_B"])
        Cr = column(x, params["in_C"])
        dt = grad_in_layout(column(x, params["in_dt"]))
    why = plain_reason(params, (z, xr, Br, Cr, dt), cfg, h0)
    PATHS["fused" if why is None else f"plain.{why}"] += 1
    if why is None:
        acts, taken, h0 = _as_taken(params, (z, xr, Br, Cr, dt), h0)
        g, hT = SSD.ssd_mixer(*acts, taken, chunk=cfg.ssm_chunk,
                              eps=cfg.norm_eps, h0=h0,
                              want_state=return_cache)
    else:
        g, hT = mixer_plain(params, z, xr, Br, Cr, dt, cfg, h0)
    out = residual(PROJ.ssd_out_proj(g.contiguous(), params["out_proj"])
                   if proj is None else g @ row(params["out_proj"]))
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
    channels, and heads or, where the heads do not divide the model axis,
    a slice of each head's dims (the update is independent per dim)."""
    Bsz = x.shape[0]
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x0 = x[:, 0]
    z = column(x0, params["in_z"])
    xr = column(x0, params["in_x"])
    Br = column(x0, params["in_B"])
    Cr = column(x0, params["in_C"])
    dt = column(x0, params["in_dt"])

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
                     dims=((0, 1, 2), (0, None), (0, None), (0, 1),
                           (None, 0), (None, 0), (0, 1, 2)),
                     out_dims=((0, 1, 2), (0, 1, 2)))
    y = reshape(y, Bsz, -1)
    out = _gated_norm(y, z, params["norm_scale"], cfg.norm_eps) \
        @ row(params["out_proj"])
    new_cache = {"state": h, "conv": {"x": cx, "B": cB, "C": cC}}
    return residual(out[:, None]), new_cache
