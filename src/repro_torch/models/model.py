"""Unified model in PyTorch, mirroring ``repro.models.model``: embedding ->
layer groups -> norm -> lm head, for every mixer of the registry
(attention, Mamba2/SSD) and every FFN (gated MLP, MoE).  Entry points:

  forward(params, cfg, inputs, remat=False)    -> h, cache_or_None, aux
  forward_train(params, cfg, batch)            -> loss, {"nll", "aux"}
  prefill(params, cfg, inputs, max_seq)        -> logits_last, cache
  decode_step(params, cfg, cache, token, pos)  -> logits, cache

Parameters are a plain dict that mirrors the JAX package's pytree:
``params["groups"]`` is a tuple (one entry per position in
``cfg.pattern``) of dicts whose leaves are stacked over
``cfg.num_groups``; decode caches have the same layout.  The JAX
package's ``lax.scan`` over groups is a Python loop over that stacked
axis here.  ``params_from_numpy`` converts a JAX parameter tree (with
numpy leaves) so both packages compute the same function.  Training
takes gradients with autograd through these same functions: the JAX
package defines no custom gradient, so neither does the port.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import require_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import LayerSpec, ModelConfig


# ------------------------------------------------------------------------ init
def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> Dict[str, Any]:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the numbers differ from ``jax.random``'s; use
    ``params_from_numpy`` to run the JAX package's weights)."""
    dev = require_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    G = (cfg.num_groups,)
    params: Dict[str, Any] = {}
    if not cfg.embed_inputs:
        params["embed"] = (torch.randn((cfg.vocab_size, cfg.d_model),
                                       generator=gen, device=dev)
                           * 0.02).to(dtype)

    def block(spec: LayerSpec):
        p: Dict[str, Any] = {
            "norm1": L.init_rmsnorm(cfg.d_model, dtype, dev, G)}
        if spec.mixer == "attn":
            p["attn"] = L.init_attention(cfg, gen, dtype, dev, G)
        else:
            p["mamba"] = SSM.init_mamba(cfg, gen, dtype, dev, G)
        if cfg.d_ff > 0:
            p["norm2"] = L.init_rmsnorm(cfg.d_model, dtype, dev, G)
            if spec.moe:
                p["moe"] = MOE.init_moe(cfg, gen, dtype, dev, G)
            else:
                p["mlp"] = L.init_mlp(cfg.d_model, cfg.d_ff, gen, dtype,
                                      dev, G)
        return p

    params["groups"] = tuple(block(spec) for spec in cfg.pattern)
    params["final_norm"] = L.init_rmsnorm(cfg.d_model, dtype, dev)
    if cfg.embed_inputs or not cfg.tie_embeddings:
        params["lm_head"] = (torch.randn((cfg.d_model, cfg.vocab_size),
                                         generator=gen, device=dev)
                             * 0.02).to(dtype)
    return params


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """The JAX package's ``init_params`` tree with numpy leaves
    (``jax.tree.map(np.asarray, params)``) -> the port's parameter dict on
    ``device``, leaf for leaf."""
    dev = require_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return tuple(conv(v) for v in t)
        a = np.array(t)  # a writable copy
        if a.dtype.name == "bfloat16":  # ml_dtypes' type: by its bits
            return torch.from_numpy(a.view(np.uint16)).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    return conv(tree)


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (tuple, list)):
        return sum(param_count(v) for v in params)
    return params.numel()


def group_slice(tree, idx):
    """Index every leaf of a stacked parameter tree along the group axis
    (``idx`` an int or a slice)."""
    if isinstance(tree, dict):
        return {k: group_slice(v, idx) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(group_slice(v, idx) for v in tree)
    return tree[idx]


def _stack(trees):
    """Per-group trees (same structure) -> one tree with leaves stacked on
    a new group axis 0."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _stack([x[k] for x in trees]) for k in t}
    return torch.stack(trees)


def group_count(groups) -> int:
    """How many groups a stacked ``params["groups"]`` tree holds."""
    return groups[0]["norm1"]["scale"].shape[0]


# --------------------------------------------------------------------- block fwd
def _block_full(p, h, cfg: ModelConfig, spec: LayerSpec, positions,
                want_cache: bool, max_seq: int):
    """Full-sequence block. Returns (h, cache_or_None, MoE aux or None)."""
    aux = None
    x = L.rms_norm(h, p["norm1"], cfg.norm_eps)
    cache = None
    if spec.mixer == "attn":
        y, (k, v) = L.attention_full(p["attn"], x, cfg, spec, positions)
        if want_cache:
            cache = L.prefill_to_cache(cfg, spec, k, v, max_seq)
    elif want_cache:
        y, cache = SSM.mamba_forward(p["mamba"], x, cfg, return_cache=True)
    else:
        y = SSM.mamba_forward(p["mamba"], x, cfg)
    h = h + y
    if cfg.d_ff > 0:
        x = L.rms_norm(h, p["norm2"], cfg.norm_eps)
        if spec.moe:
            y, aux = MOE.moe_ffn(p["moe"], x, cfg)
        else:
            y = L.mlp(p["mlp"], x, cfg.mlp_act)
        h = h + y
    return h, cache, aux


def _block_decode(p, h, cache, pos: int, cfg: ModelConfig, spec: LayerSpec):
    x = L.rms_norm(h, p["norm1"], cfg.norm_eps)
    if spec.mixer == "attn":
        y, cache = L.attention_decode(p["attn"], x, cache, pos, cfg, spec)
    else:
        y, cache = SSM.mamba_decode(p["mamba"], x, cache, cfg)
    h = h + y
    if cfg.d_ff > 0:
        x = L.rms_norm(h, p["norm2"], cfg.norm_eps)
        if spec.moe:
            # (B,1,D): each decode token is its own dispatch group
            y, _ = MOE.moe_ffn(p["moe"], x, cfg)
        else:
            y = L.mlp(p["mlp"], x, cfg.mlp_act)
        h = h + y
    return h, cache


def _group_full(gp, h, cfg: ModelConfig, positions, want_cache: bool,
                max_seq: int):
    """One group (``cfg.pattern``'s blocks): (h, caches, its MoE aux or
    None without MoE)."""
    caches = []
    aux = None
    for i, spec in enumerate(cfg.pattern):
        h, c, a = _block_full(gp[i], h, cfg, spec, positions, want_cache,
                              max_seq)
        caches.append(c)
        if a is not None:
            aux = a if aux is None else aux + a
    return h, caches, aux


def _groups_full(groups, h, cfg: ModelConfig, positions,
                 want_cache: bool = False, max_seq: int = 0,
                 remat: bool = False):
    """Apply a stack of layer groups (leaves stacked on axis 0) to h.
    Returns (h, cache or None, MoE aux summed over the layers).  With
    ``remat`` each group is checkpointed, as the JAX package checkpoints
    its scan body: its activations are recomputed in the backward pass."""
    caches = [[] for _ in cfg.pattern]
    auxs = []
    for g in range(group_count(groups)):
        gp = group_slice(groups, g)
        if remat:
            h, cs, a = checkpoint(_group_full, gp, h, cfg, positions,
                                  want_cache, max_seq, use_reentrant=False)
        else:
            h, cs, a = _group_full(gp, h, cfg, positions, want_cache,
                                   max_seq)
        for i, c in enumerate(cs):
            caches[i].append(c)
        if a is not None:
            auxs.append(a)
    cache = tuple(_stack(c) for c in caches) if want_cache else None
    aux = torch.sum(torch.stack(auxs)) if auxs else torch.zeros(
        (), dtype=torch.float32, device=h.device)
    return h, cache, aux


def run_groups(groups, h, cfg: ModelConfig, positions):
    """Apply a stack of layer groups (leaves stacked on axis 0) to h."""
    return _groups_full(groups, h, cfg, positions)[0]


# ------------------------------------------------------------------- embeddings
def _embed(params, cfg: ModelConfig, inputs):
    if cfg.embed_inputs:
        h = inputs  # (B,S,D) precomputed frontend embeddings
    else:
        h = params["embed"][inputs.long()]
    if cfg.scale_embeddings:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype,
                             device=h.device)
    return h


def _lm_head(params, cfg: ModelConfig, h):
    if "lm_head" in params:
        logits = h @ params["lm_head"]
    else:
        logits = h @ params["embed"].T
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = (c * torch.tanh(logits.to(torch.float32) / c)
                  ).to(logits.dtype)
    return logits


def positions_for(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
        B, S)


# ------------------------------------------------------------------ full forward
def forward(params, cfg: ModelConfig, inputs, *, want_cache: bool = False,
            max_seq: Optional[int] = None, remat: bool = False):
    """Returns (h after the final norm, cache or None, aux): the cache
    (``want_cache``) is laid out as ``init_cache``'s, and ``aux`` is the
    MoE load-balance loss summed over the layers (0 without MoE).
    ``remat`` checkpoints each group (``torch.utils.checkpoint``)."""
    B, S = inputs.shape[0], inputs.shape[1]
    h = _embed(params, cfg, inputs)
    h, cache, aux = _groups_full(params["groups"], h, cfg,
                                 positions_for(B, S, h.device), want_cache,
                                 max_seq or S, remat)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, cache, aux


# sequence-chunked cross-entropy: full (B,S,V) float32 logits never exist
# (with 256k vocabs they would dominate device memory)
LOSS_CHUNK = 512


def _xent_chunk(params, cfg: ModelConfig, hc, lc, mc):
    """(summed NLL, count) of one chunk's masked positions."""
    logits = _lm_head(params, cfg, hc).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, lc[..., None].long(), dim=-1)[..., 0]
    tot = torch.sum(torch.where(mc, lse - gold, 0.0))
    return tot, torch.sum(mc.to(torch.float32))


def _chunked_xent(params, cfg: ModelConfig, h, labels, mask):
    """h: (B,S,D); labels/mask: (B,S).  Mean NLL over masked positions.
    The sequence is padded to a multiple of the chunk and taken one
    checkpointed chunk at a time, so one chunk's logits exist at once, in
    the forward and in the backward pass."""
    B, S, D = h.shape
    C = min(LOSS_CHUNK, S)
    if S % C:
        pad = C - S % C
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
        S += pad
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, C):
        t, n = checkpoint(_xent_chunk, params, cfg, h[:, c0:c0 + C],
                          labels[:, c0:c0 + C], mask[:, c0:c0 + C],
                          use_reentrant=False)
        tot = tot + t
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def forward_train(params, cfg: ModelConfig, batch, remat: bool = True):
    """batch: {"tokens"|"embeds", "labels"}.  Returns (loss, metrics)."""
    inputs = batch["embeds"] if cfg.embed_inputs else batch["tokens"]
    labels = batch["labels"]
    h, _, aux = forward(params, cfg, inputs, remat=remat)
    if not cfg.embed_inputs:  # next-token LM: shift
        h, labels = h[:, :-1], labels[:, 1:]
    mask = torch.ones(labels.shape, dtype=torch.bool, device=h.device)
    nll = _chunked_xent(params, cfg, h, labels, mask)
    loss = nll + aux
    return loss, {"nll": nll, "aux": aux}


def prefill(params, cfg: ModelConfig, inputs, max_seq: int):
    """Returns (last-position logits, cache)."""
    h, cache, _ = forward(params, cfg, inputs, want_cache=True,
                          max_seq=max_seq)
    return _lm_head(params, cfg, h[:, -1]), cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.float32, device="cuda"):
    """Empty decode cache, structure matching prefill output: a tuple (per
    pattern position) of trees with leaves stacked over groups."""
    dev = require_device(device)

    def one(spec: LayerSpec):
        if spec.mixer == "attn":
            c = L.init_kv_cache(cfg, spec, batch, max_seq, dtype, dev)
        else:
            c = SSM.init_mamba_cache(cfg, batch, dtype, dev)
        return _stack([c] * cfg.num_groups)

    return tuple(one(spec) for spec in cfg.pattern)


def decode_step(params, cfg: ModelConfig, cache, inputs, pos: int):
    """inputs: (B,1) tokens or (B,1,D) embeds; pos: the position of the
    input (an int).  Returns (logits (B,V), new cache); ``cache`` itself
    is not changed."""
    h = _embed(params, cfg, inputs)
    groups = params["groups"]
    new = [[] for _ in cfg.pattern]
    for g in range(group_count(groups)):
        gp, gc = group_slice(groups, g), group_slice(cache, g)
        for i, spec in enumerate(cfg.pattern):
            h, c = _block_decode(gp[i], h, gc[i], pos, cfg, spec)
            new[i].append(c)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _lm_head(params, cfg, h[:, 0]), tuple(_stack(c) for c in new)
