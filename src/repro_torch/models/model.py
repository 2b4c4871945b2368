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

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch import require_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.shardctx import (SUM, constrain, on_shards,
                                         spec_of, split_axes, split_index,
                                         split_reduce)


# ------------------------------------------------------------------------ init
def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> Dict[str, Any]:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the numbers differ from ``jax.random``'s; use
    ``params_from_numpy`` to run the JAX package's weights).  On
    ``device="meta"`` the tree is abstract: shapes and dtypes, no numbers
    and no generator."""
    dev = require_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
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


def _block_decode(p, h, cache, pos, cfg: ModelConfig, spec: LayerSpec):
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
        h = constrain(h, "hidden")
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
def _in_slice(ids, n: int):
    """``ids`` as indices into this device's slice of ``n`` rows, where
    rows are split over devices (``shardctx.split_index``), and which of
    them fall in the slice (the others index row 0)."""
    ids = ids.long() - split_index() * n
    hit = (ids >= 0) & (ids < n)
    return torch.where(hit, ids, 0), hit


def _lookup(ids, table):
    """``table``'s rows at ``ids``; where the table's rows are split over
    devices (``shardctx.split_axes``), each device looks up the ids in its
    slice and gives zeros elsewhere: a partial sum over the devices."""
    if not split_axes():
        return table[ids.long()]
    ids, hit = _in_slice(ids, table.shape[0])
    return torch.where(hit[..., None], table[ids], 0.0)


def _embed(params, cfg: ModelConfig, inputs):
    if cfg.embed_inputs:
        h = inputs  # (B,S,D) precomputed frontend embeddings
    else:
        # on DTensors each device looks up its own batch rows in its slice
        # of the table's rows, and the rows are summed over the model axis
        # (DTensor's rules for a lookup in a sharded table differ between
        # releases, forward and backward; the reference's HLO all-reduces
        # the looked-up rows over the model axis)
        h = constrain(on_shards(_lookup, (inputs, params["embed"]),
                                dims=((0, None, None), (None, None, 0)),
                                out_dims=(0, None, SUM)), "hidden")
    if cfg.scale_embeddings:
        # the scale rounded to h's dtype, as the reference's
        # jnp.asarray(..., h.dtype), and passed as a number: on the card a
        # tensor made on the host would be copied to the device, which
        # stops a CUDA-graph capture of the step (``core.jit``)
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype).item()
    return h


def _lm_head(params, cfg: ModelConfig, h):
    # the head's weight whole on the data axes and sharded on the vocab
    # over the model axis, so the logits come out vocab-sharded, as the
    # "logits" spec has them; where the vocab does not divide the axis,
    # the product contracts over d_model split there, and the logits are
    # summed (the reference's HLO splits the contraction and all-reduces
    # the logits likewise)
    h = constrain(h, "head_in")
    if "lm_head" in params:
        logits = h @ constrain(params["lm_head"], "head_w")
    else:
        logits = h @ constrain(params["embed"], "head_embed").T
    logits = constrain(logits, "head_out")
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = (c * torch.tanh(logits.to(torch.float32) / c)
                  ).to(logits.dtype)
    return constrain(logits, "logits")


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
    h = constrain(_embed(params, cfg, inputs), "hidden")
    h, cache, aux = _groups_full(params["groups"], h, cfg,
                                 positions_for(B, S, h.device), want_cache,
                                 max_seq or S, remat)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, cache, aux


# sequence-chunked cross-entropy: full (B,S,V) float32 logits never exist
# (with 256k vocabs they would dominate device memory)
LOSS_CHUNK = 512


class _SplitLSE(torch.autograd.Function):
    """Log-sum-exp over the last dim, split over devices: each device
    holds a slice of the dim, and the max and the sum of exponentials are
    all-reduced over the split axes (``shardctx.split_reduce``; the
    reference's HLO all-reduces the two (rows,) vectors likewise).  The
    result is whole on every device, so the gradient of each slice is
    local: the incoming gradient times the slice's softmax."""

    @staticmethod
    def forward(ctx, x):
        m = split_reduce(torch.amax(x, dim=-1, keepdim=True), "max")
        e = torch.exp(x - m)
        s = split_reduce(torch.sum(e, dim=-1, keepdim=True), "sum")
        ctx.save_for_backward(e / s)
        return (torch.log(s) + m)[..., 0]

    @staticmethod
    def backward(ctx, g):
        p, = ctx.saved_tensors
        return g[..., None] * p


def _lse(logits):
    """``torch.logsumexp`` over the last dim, which may be split over
    devices."""
    if not split_axes():
        return torch.logsumexp(logits, dim=-1)
    return _SplitLSE.apply(logits)


def _gold(logits, labels):
    """Each row's logit at its label; where the vocab is split over
    devices (``shardctx.split_axes``), each device takes the labels in
    its slice and gives zeros elsewhere: a partial sum over the
    devices."""
    if not split_axes():
        return torch.take_along_dim(logits, labels[..., None].long(),
                                    dim=-1)[..., 0]
    ids, hit = _in_slice(labels, logits.shape[-1])
    g = torch.take_along_dim(logits, ids[..., None], dim=-1)[..., 0]
    return torch.where(hit, g, 0.0)


def _xent_rows(hc, lc, mc, w, cfg: ModelConfig, key: str):
    """Each row's (summed NLL, count) of a chunk's masked positions, with
    the head's weight ``w`` (``params[key]``) whole."""
    logits = _lm_head({key: w}, cfg, hc).to(torch.float32)
    nll = torch.logsumexp(logits, dim=-1) - torch.take_along_dim(
        logits, lc[..., None].long(), dim=-1)[..., 0]
    return (torch.sum(torch.where(mc, nll, 0.0), dim=1),
            torch.sum(mc.to(torch.float32), dim=1))


def _xent_chunk(params, cfg: ModelConfig, hc, lc, mc):
    """(summed NLL, count) of one chunk's masked positions."""
    if isinstance(hc, DTensor) and spec_of("logits")[-1] is None:
        # the vocab does not divide the model axis (so "logits" keeps it
        # whole): each device takes its rows and a slice of the chunk's
        # positions, against the whole head, in place of repeating the
        # head's product on every device of the model axis
        key = "lm_head" if "lm_head" in params else "embed"
        tot, cnt = on_shards(functools.partial(_xent_rows, cfg=cfg, key=key),
                             (hc, lc, mc, params[key]),
                             dims=((0, None, 1), (0, None, 1), (0, None, 1),
                                   (None, None)),
                             out_dims=((0, None, SUM), (0, None, SUM)))
        return torch.sum(tot), torch.sum(cnt)
    logits = _lm_head(params, cfg, hc).to(torch.float32)
    # on DTensors each device takes its rows and its slice of the vocab
    lse = on_shards(_lse, (logits,), dims=((0, None, 2),), out_dims=(0, None))
    gold = on_shards(_gold, (logits, lc), dims=((0, None, 2), (0, None)),
                     out_dims=(0, None, SUM))
    tot = torch.sum(torch.where(mc, lse - gold, 0.0))
    return tot, torch.sum(mc.to(torch.float32))


def _chunked_xent(params, cfg: ModelConfig, h, labels, mask):
    """h: (B,S,D); labels/mask: (B,S).  Mean NLL over masked positions.
    The sequence is padded to a multiple of the chunk and taken one
    checkpointed chunk at a time, so one chunk's logits exist at once, in
    the forward and in the backward pass.  A sequence of one chunk is not
    checkpointed: its logits are all there is, and recomputing them would
    do a head product that the reference's compiled step does not (XLA
    inlines the one-trip loop and shares the product with the forward)."""
    B, S, D = h.shape
    C = min(LOSS_CHUNK, S)
    if S == C:
        tot, cnt = _xent_chunk(params, cfg, h, labels, mask)
        return tot / torch.clamp(cnt, min=1.0)
    if S % C:
        pad = C - S % C
        h, labels, mask = (L.pad_seq(t, pad) for t in (h, labels, mask))
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


def decode_step(params, cfg: ModelConfig, cache, inputs, pos):
    """inputs: (B,1) tokens or (B,1,D) embeds; pos: the position of the
    input, an int or a 0-d int32 tensor (the reference's traced
    ``jnp.int32``).  Returns (logits (B,V), new cache); ``cache`` itself
    is not changed."""
    h = _embed(params, cfg, inputs)
    groups = params["groups"]
    new = [[] for _ in cfg.pattern]
    for g in range(group_count(groups)):
        gp, gc = group_slice(groups, g), group_slice(cache, g)
        for i, spec in enumerate(cfg.pattern):
            h, c = _block_decode(gp[i], h, gc[i], pos, cfg, spec)
            h = constrain(h, "hidden")
            new[i].append(c)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _lm_head(params, cfg, h[:, 0]), tuple(_stack(c) for c in new)
