"""Mixture-of-Experts FFN with capacity-based token dispatch, in PyTorch,
mirroring ``repro.models.moe``.

Dispatch avoids the classic (T, E, C) one-hot blow-up: slots are computed
with a running per-expert cumsum, token indices are scattered into a
(G, E, C+1) map (overflow tokens land in the sacrificial last slot), the
activations are gathered into a (G, E, C+1, D) buffer, expert FFNs run as
one batched einsum over E, and results are gathered back and
gate-combined.

The integer routing tables and both gathers are built per token group, so
on DTensors they run on each device's own groups (``shardctx.on_shards``):
the group axis G keeps its sharding over the data axes, and every other
axis is whole on every device.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.shardctx import (constrain, grad_in_layout,
                                         on_shards)


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype, device,
             lead=()):
    """``lead`` prepends stacking dims (the group axis of a stacked
    parameter tree).  The router stays float32, as in the JAX package."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    s, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    lead = tuple(lead)

    def normal(shape, sc, dt=dtype):
        return (torch.randn(lead + shape, generator=gen, dtype=torch.float32,
                            device=device) * sc).to(dt)

    p = {
        "router": normal((d, e), s, torch.float32),
        "w_gate": normal((e, d, f), s),
        "w_up": normal((e, d, f), s),
        "w_down": normal((e, f, d), so),
    }
    if cfg.shared_expert:
        p["shared"] = {
            "w_gate": normal((d, f), s),
            "w_up": normal((d, f), s),
            "w_down": normal((f, d), so),
        }
    return p


def capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(tokens_per_group * cfg.experts_per_token
                      * cfg.capacity_factor / cfg.num_experts))
    return max(4, min(c, tokens_per_group * cfg.experts_per_token))


def _per_group(fn, *ts):
    """``fn(*ts)`` on each device's token groups (axis 0 of every
    tensor)."""
    return on_shards(fn, ts, dims=((0, None),) * len(ts), out_dims=(0, None))


def _dispatch(x, flat_ids, slot, *, E: int, cap: int):
    """(G, E, cap+1, D) buffer of the tokens routed to each expert slot.
    A token-index map + gather: slots below cap are unique per (g, e);
    every overflow token writes slot cap, and which of those writes wins
    is unspecified (on CUDA, index_put_ with repeated indices is
    nondeterministic).  The output does not depend on it: the combine
    zeroes what is gathered back from slot cap.  The sentinel row T
    gathers zeros."""
    G, T, D = x.shape
    k = flat_ids.shape[1] // T
    dev = x.device
    gi = torch.arange(G, device=dev)[:, None].expand(G, T * k)
    tok = torch.arange(T, device=dev).repeat_interleave(k)[None].expand(
        G, T * k)
    tok_map = torch.full((G, E, cap + 1), T, dtype=torch.long, device=dev)
    tok_map[gi, flat_ids, slot] = tok
    x_pad = torch.cat([x, torch.zeros((G, 1, D), dtype=x.dtype, device=dev)],
                      dim=1)
    return x_pad[torch.arange(G, device=dev)[:, None, None], tok_map]


def _swap01(a):
    """DTensor ``a`` with axes 0 and 1 swapped, each shard copied
    contiguous in the new order."""
    swap = {0: 1, 1: 0}
    pl = [Shard(swap.get(p.dim, p.dim)) if isinstance(p, Shard) else p
          for p in a.placements]
    shape = (a.shape[1], a.shape[0]) + tuple(a.shape[2:])
    return DTensor.from_local(
        a.to_local().transpose(0, 1).contiguous(), a.device_mesh, pl,
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


class _SwapGE(torch.autograd.Function):
    """``_swap01`` forward and backward."""

    @staticmethod
    def forward(ctx, a):
        return _swap01(a)

    @staticmethod
    def backward(ctx, g):
        return _swap01(g)


def _expert_product(eq: str, a, w):
    """``torch.einsum(eq, a, w)`` for "gec?,e??->gec?".  On DTensors the
    product runs E-major ("egc?") on shards made contiguous in that order,
    forward and backward: DTensor's einsum merges the G and C axes of a
    shard with a view, and its stride metadata can call a permuted shard
    contiguous."""
    if not isinstance(a, DTensor):
        return torch.einsum(eq, a, w)
    return _SwapGE.apply(torch.einsum(eq.replace("gec", "egc"),
                                      _SwapGE.apply(a), w))


def _gather_back(yb, flat_ids, slot):
    """(G, Tk, D): each routed token's expert output."""
    G = yb.shape[0]
    gi = torch.arange(G, device=yb.device)[:, None].expand(flat_ids.shape)
    return yb[gi, flat_ids, slot]


def moe_ffn(params, x, cfg: ModelConfig):
    """x: (G, T, D) token groups.  Returns (y, aux_loss)."""
    G, T, D = x.shape
    k, E = cfg.experts_per_token, cfg.num_experts
    cap = capacity(T, cfg)

    logits = grad_in_layout(L.column(x.to(torch.float32),
                                     params["router"]))  # (G,T,E)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k puts the lower index first on ties; a stable
    # descending sort does the same (torch.topk promises no order), so
    # slots and overflow match the JAX package
    ids = torch.sort(probs, dim=-1, descending=True, stable=True
                     ).indices[..., :k]  # (G,T,k)
    gates = torch.gather(probs, -1, ids)
    gates = gates / torch.clamp(torch.sum(gates, -1, keepdim=True), min=1e-9)
    gates = gates.to(x.dtype)

    # Switch-style load-balance auxiliary loss
    me = torch.mean(probs, dim=(0, 1))  # (E,)
    ce = torch.mean(torch.sum(F.one_hot(ids, E).to(torch.float32), dim=2),
                    dim=(0, 1))
    aux = cfg.router_aux_coef * E * torch.sum(me * ce / k)

    # slots: running per-(group, expert) assignment count
    flat_ids = ids.reshape(G, T * k)
    oh = constrain(F.one_hot(flat_ids, E), "moe_oh")
    slot = torch.cumsum(oh, dim=1) - 1  # (G,Tk,E)
    slot = torch.gather(slot, 2, flat_ids[..., None])[..., 0]
    slot = torch.where(slot < cap, slot, cap)  # overflow -> sacrificial slot

    buf = constrain(_per_group(functools.partial(_dispatch, E=E, cap=cap),
                               x, flat_ids, slot), "moe_buf")

    # expert FFN (active FLOPs only: G * E * cap * D * F).  Each layer's
    # expert stacks are laid out as a dense FFN's weights
    # (``launch.sharding.product_specs``): each device computes its share
    # of F, and the weight gradients are reduce-scattered a layer at a time
    buf = constrain(buf, "expert_in")
    h = constrain(_expert_product(
        "gecd,edf->gecf", buf, constrain(params["w_gate"], "expert_col_w")),
        "moe_h")
    u = constrain(_expert_product(
        "gecd,edf->gecf", buf, constrain(params["w_up"], "expert_col_w")),
        "moe_h")
    act = L.activation(h, cfg.mlp_act) * u
    yb = constrain(_expert_product(
        "gecf,efd->gecd", act.to(x.dtype),
        constrain(params["w_down"], "expert_row_w")).to(x.dtype), "moe_buf")

    # gather back + gate combine; overflow slot contributes zero via mask
    out_k = _per_group(_gather_back, yb, flat_ids, slot)  # (G,Tk,D)
    valid = (slot < cap).to(gates.dtype).reshape(G, T, k)
    y = constrain(torch.sum(out_k.reshape(G, T, k, D)
                            * (gates * valid)[..., None], dim=2), "hidden")

    if cfg.shared_expert:
        y = y + L.mlp(params["shared"], x, cfg.mlp_act)
    return y, aux
