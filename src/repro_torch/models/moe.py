"""Mixture-of-Experts FFN with capacity-based token dispatch, in PyTorch,
mirroring ``repro.models.moe``.

Dispatch avoids the classic (T, E, C) one-hot blow-up: slots are computed
with a running per-expert cumsum, token indices are scattered into a
(G, E, C+1) map (overflow tokens land in the sacrificial last slot), the
activations are gathered into a (G, E, C+1, D) buffer, expert FFNs run as
one batched einsum over E, and results are gathered back and
gate-combined.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


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


def moe_ffn(params, x, cfg: ModelConfig):
    """x: (G, T, D) token groups.  Returns (y, aux_loss)."""
    G, T, D = x.shape
    k, E = cfg.experts_per_token, cfg.num_experts
    cap = capacity(T, cfg)
    dev = x.device

    logits = x.to(torch.float32) @ params["router"]  # (G,T,E)
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
    oh = F.one_hot(flat_ids, E)
    slot = torch.cumsum(oh, dim=1) - 1  # (G,Tk,E)
    slot = torch.gather(slot, 2, flat_ids[..., None])[..., 0]
    slot = torch.where(slot < cap, slot, cap)  # overflow -> sacrificial slot

    gi = torch.arange(G, device=dev)[:, None].expand(G, T * k)
    tok = torch.arange(T, device=dev).repeat_interleave(k)[None].expand(
        G, T * k)
    # dispatch via a token-index map + gather.  Slots below cap are unique
    # per (g, e); every overflow token writes slot cap, and which of those
    # writes wins is unspecified (on CUDA, index_put_ with repeated indices
    # is nondeterministic).  The output does not depend on it: ``valid``
    # below zeroes what is gathered back from slot cap.  The sentinel row T
    # gathers zeros.
    tok_map = torch.full((G, E, cap + 1), T, dtype=torch.long, device=dev)
    tok_map[gi, flat_ids, slot] = tok
    x_pad = torch.cat([x, torch.zeros((G, 1, D), dtype=x.dtype, device=dev)],
                      dim=1)
    buf = x_pad[torch.arange(G, device=dev)[:, None, None], tok_map]

    # expert FFN (active FLOPs only: G * E * cap * D * F)
    h = torch.einsum("gecd,edf->gecf", buf, params["w_gate"])
    u = torch.einsum("gecd,edf->gecf", buf, params["w_up"])
    act = L.activation(h, cfg.mlp_act) * u
    yb = torch.einsum("gecf,efd->gecd", act.to(x.dtype), params["w_down"]
                      ).to(x.dtype)

    # gather back + gate combine; overflow slot contributes zero via mask
    out_k = yb[gi, flat_ids, slot]  # (G,Tk,D)
    valid = (slot < cap).to(gates.dtype).reshape(G, T, k)
    y = torch.sum(out_k.reshape(G, T, k, D) * (gates * valid)[..., None],
                  dim=2)

    if cfg.shared_expert:
        y = y + L.mlp(params["shared"], x, cfg.mlp_act)
    return y, aux
