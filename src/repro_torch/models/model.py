"""Unified model in PyTorch, mirroring ``repro.models.model`` (the
full-sequence forward of attention architectures): embedding -> layer
groups -> norm -> lm head.

Parameters are a plain dict that mirrors the JAX package's pytree:
``params["groups"]`` is a tuple (one entry per position in
``cfg.pattern``) of dicts whose leaves are stacked over
``cfg.num_groups``.  The JAX package's ``lax.scan`` over groups is a
Python loop over that stacked axis here.  ``params_from_numpy`` converts a
JAX parameter tree (with numpy leaves) so both packages compute the same
function.

Mamba and MoE layers are not ported yet (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.models import layers as L
from repro_torch.models.config import LayerSpec, ModelConfig


def _attention_only(cfg: ModelConfig) -> None:
    for spec in cfg.pattern:
        if spec.mixer != "attn" or spec.moe:
            raise NotImplementedError(
                f"{cfg.name}: {spec} is not ported yet (mamba and MoE "
                f"layers are ROADMAP queue 1 item 10)")


# ------------------------------------------------------------------------ init
def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> Dict[str, Any]:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the numbers differ from ``jax.random``'s; use
    ``params_from_numpy`` to run the JAX package's weights)."""
    _attention_only(cfg)
    dev = require_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    G = (cfg.num_groups,)
    params: Dict[str, Any] = {}
    if not cfg.embed_inputs:
        params["embed"] = (torch.randn((cfg.vocab_size, cfg.d_model),
                                       generator=gen, device=dev)
                           * 0.02).to(dtype)

    def block():
        p: Dict[str, Any] = {
            "norm1": L.init_rmsnorm(cfg.d_model, dtype, dev, G),
            "attn": L.init_attention(cfg, gen, dtype, dev, G)}
        if cfg.d_ff > 0:
            p["norm2"] = L.init_rmsnorm(cfg.d_model, dtype, dev, G)
            p["mlp"] = L.init_mlp(cfg.d_model, cfg.d_ff, gen, dtype, dev, G)
        return p

    params["groups"] = tuple(block() for _ in cfg.pattern)
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
    _attention_only(cfg)
    dev = require_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return tuple(conv(v) for v in t)
        return torch.from_numpy(np.array(t)).to(dev)  # a writable copy

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


# --------------------------------------------------------------------- block fwd
def _block_full(p, h, cfg: ModelConfig, spec: LayerSpec, positions):
    """Full-sequence attention block: h -> h."""
    x = L.rms_norm(h, p["norm1"], cfg.norm_eps)
    y, _ = L.attention_full(p["attn"], x, cfg, spec, positions)
    h = h + y
    if cfg.d_ff > 0:
        x = L.rms_norm(h, p["norm2"], cfg.norm_eps)
        h = h + L.mlp(p["mlp"], x, cfg.mlp_act)
    return h


def run_groups(groups, h, cfg: ModelConfig, positions):
    """Apply a stack of layer groups (leaves stacked on axis 0) to h."""
    n = groups[0]["norm1"]["scale"].shape[0]
    for g in range(n):
        gp = group_slice(groups, g)
        for i, spec in enumerate(cfg.pattern):
            h = _block_full(gp[i], h, cfg, spec, positions)
    return h


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
def forward(params, cfg: ModelConfig, inputs):
    """Returns (h after the final norm, None, aux) like the JAX package's
    ``forward`` without a cache; ``aux`` (the MoE loss) is 0 here."""
    _attention_only(cfg)
    B, S = inputs.shape[0], inputs.shape[1]
    h = _embed(params, cfg, inputs)
    h = run_groups(params["groups"], h, cfg,
                   positions_for(B, S, h.device))
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, None, torch.zeros((), dtype=torch.float32, device=h.device)
