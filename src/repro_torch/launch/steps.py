"""Step functions (train / prefill / decode) in PyTorch, mirroring
``repro.launch.steps``: shared by the training launcher and the tests.

Gradients come from autograd through ``models.model.forward_train`` (the
JAX package takes ``jax.value_and_grad`` of the same function).  The
abstract specs of the reference (``abstract_*``, ``input_specs``) serve
its XLA dry-run and are not ported here.
"""

from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.training.optim import (AdamWConfig, adamw_update,
                                        tree_from_leaves, tree_leaves,
                                        tree_map)


def loss_and_grads(params, cfg: ModelConfig, batch, remat: bool = True):
    """(loss, metrics, grads) of ``forward_train`` at ``params``: grads
    has the structure of ``params``; loss and metrics are detached."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = M.forward_train(tree_from_leaves(params, leaves), cfg,
                                    batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_from_leaves(params, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1, donate: bool = False):
    """One optimizer step.  ``microbatches > 1`` accumulates gradients over
    K sequential microbatches (the reference's ``lax.scan``): activation
    memory scales 1/K while the params/optimizer footprint is unchanged.
    ``donate`` updates ``params`` and ``opt_state`` in place (the JAX
    launcher's ``donate_argnums``)."""

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(params, cfg, batch)
        else:
            K = microbatches
            mbs = [tree_map(lambda x: x.reshape((K, x.shape[0] // K)
                                                + x.shape[1:])[i], batch)
                   for i in range(K)]
            grads, losses, mets = None, [], []
            for b in mbs:
                lk, mk, gk = loss_and_grads(params, cfg, b)
                grads = gk if grads is None else tree_map(torch.add, grads,
                                                          gk)
                losses.append(lk)
                mets.append(mk)
            grads = tree_map(lambda g: g / K, grads)
            loss = sum(losses) / K
            metrics = {k: torch.mean(torch.stack([m[k] for m in mets]))
                       for k in mets[0]}
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
