"""Step functions (train / prefill / decode) and abstract input specs for
every (architecture x input shape) pair in PyTorch, mirroring
``repro.launch.steps``: shared by the dry-run, the training launcher and
the tests.

Gradients come from autograd through ``models.model.forward_train`` (the
JAX package takes ``jax.value_and_grad`` of the same function).  The
abstract specs are trees of ``device="meta"`` tensors (the reference's
``jax.ShapeDtypeStruct`` stand-ins): shapes and dtypes, never allocated,
so the 398B configs cost nothing here.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import InputShape
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.shardctx import row_block
from repro_torch.training.optim import (AdamWConfig, adamw_init,
                                        adamw_update, tree_from_leaves,
                                        tree_leaves, tree_map)


def loss_and_grads(params, cfg: ModelConfig, batch, remat: bool = True,
                   microbatches: int = 1):
    """(loss, metrics, grads) of ``forward_train`` at ``params``: grads
    has the structure of ``params``; loss and metrics are detached.
    ``microbatches > 1`` averages them over K sequential microbatches
    (the reference's ``lax.scan``): activation memory scales 1/K."""
    if microbatches > 1:
        return _accumulate(params, cfg, batch, remat, microbatches)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = M.forward_train(tree_from_leaves(params, leaves), cfg,
                                    batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_from_leaves(params, grads))


def microbatch(x, K: int, i: int):
    """Microbatch ``i`` of ``K`` of a batch leaf ``x``: rows
    ``[i * B/K, (i+1) * B/K)``, the reference's split.  On a DTensor the
    rows come out sharded as ``x``'s are, so that each device computes on
    its share of the microbatch (``shardctx.row_block``)."""
    b = x.shape[0] // K
    return row_block(x, i * b, (i + 1) * b)


def _accumulate(params, cfg: ModelConfig, batch, remat: bool, K: int):
    grads, losses, mets = None, [], []
    for i in range(K):
        b = tree_map(lambda x: microbatch(x, K, i), batch)
        lk, mk, gk = loss_and_grads(params, cfg, b, remat)
        grads = gk if grads is None else tree_map(torch.add, grads, gk)
        losses.append(lk)
        mets.append(mk)
    metrics = {k: torch.mean(torch.stack([m[k] for m in mets]))
               for k in mets[0]}
    return sum(losses) / K, metrics, tree_map(lambda g: g / K, grads)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1, donate: bool = False):
    """One optimizer step on ``loss_and_grads``'s gradients, over
    ``microbatches`` microbatches: the params/optimizer footprint does not
    change with them.  ``donate`` updates ``params`` and ``opt_state`` in
    place (the JAX launcher's ``donate_argnums``)."""

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(params, cfg, batch,
                                              microbatches=microbatches)
        with torch.no_grad():
            params, opt_state = adamw_update(grads, opt_state, params,
                                             opt_cfg, inplace=donate)
        return params, opt_state, loss, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, max_seq: int, batch_chunks: int = 1):
    """``batch_chunks > 1`` runs the prefill over batch sub-chunks one
    after another (the reference's ``lax.map``): activation memory scales
    ~1/chunks while the returned logits and caches are identical."""

    def prefill_step(params, inputs):
        if batch_chunks == 1:
            return M.prefill(params, cfg, inputs, max_seq)
        B = inputs.shape[0]
        assert B % batch_chunks == 0
        outs = [M.prefill(params, cfg, x, max_seq)
                for x in inputs.reshape((batch_chunks, B // batch_chunks)
                                        + inputs.shape[1:])]
        logits = torch.cat([o[0] for o in outs])
        # batched cache leaves are (G, b, ...) -> (G, B, ...) in chunk
        # order; batch-free leaves (kv "pos", (G, L)) are chunk-invariant
        caches = tree_map(
            lambda *ts: torch.cat(ts, dim=1) if ts[0].ndim >= 4 else ts[0],
            *(o[1] for o in outs))
        return logits, caches

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, tokens, pos):
        return M.decode_step(params, cfg, cache, tokens, pos)
    return serve_step


# ----------------------------------------------------------------- specs
def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16):
    return M.init_params(cfg, dtype=dtype, device="meta")


def abstract_opt_state(aparams, opt_cfg: AdamWConfig):
    return adamw_init(aparams, opt_cfg)


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int,
                   dtype=torch.bfloat16):
    return M.init_cache(cfg, batch, max_seq, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Abstract model inputs for one assigned input shape.

    train:   {"tokens"|"embeds", "labels"}
    prefill: {"inputs"}
    decode:  {"tokens"|"embeds" (B,1[,D]), "pos"} (+ cache built separately)
    """
    B, S = shape.global_batch, shape.seq_len

    def tok(*s):
        return torch.empty(s, dtype=torch.int32, device="meta")

    def emb(*s):
        return torch.empty(s, dtype=dtype, device="meta")

    if shape.kind == "train":
        x = {"embeds": emb(B, S, cfg.d_model)} if cfg.embed_inputs \
            else {"tokens": tok(B, S)}
        return {**x, "labels": tok(B, S)}
    if shape.kind == "prefill":
        return {"inputs": emb(B, S, cfg.d_model) if cfg.embed_inputs
                else tok(B, S)}
    if shape.kind == "decode":
        x = emb(B, 1, cfg.d_model) if cfg.embed_inputs else tok(B, 1)
        return {"inputs": x, "pos": tok()}
    raise ValueError(shape.kind)
