"""AdamW with a cosine schedule in PyTorch, mirroring
``repro.training.optim``: written out by hand (not ``torch.optim.AdamW``)
in the reference's order of operations and casts, on parameter trees
(dicts and tuples of tensors, as ``models.model`` builds them), so the
optimizer state has the parameters' structure.

``state_dtype`` controls the m/v moment precision: float32 for real
training, bfloat16 where moment memory dominates.  ``compute_dtype`` is the
type of the moment/update arithmetic.

The JAX package's update is pure, and its training launcher donates the
parameters and the state to the jitted step.  Here ``inplace=True`` is
that donation: the new moments and parameters are written into the old
tensors, one leaf at a time, so a step needs no second copy of the
parameters and moments (the full-width gemma2-2b in fp32 would not fit
one 80 GB card twice).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: Any = torch.float32
    # dtype for the moment/update arithmetic; bfloat16 halves the optimizer
    # temp traffic for the >100B configs (paired with bf16 state)
    compute_dtype: Any = torch.float32


# ------------------------------------------------------------- trees
def tree_map(fn: Callable, tree, *rest):
    """``fn`` on the leaves (tensors) of ``tree`` and of the trees in
    ``rest``, which have its structure (dicts, tuples, lists and
    NamedTuples), into a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


# ---------------------------------------------------------- schedule
def cosine_lr(cfg: AdamWConfig, step):
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


# --------------------------------------------------------- optimizer
_CONSTANTS: dict = {}


def _constants(cfg: AdamWConfig, device):
    """b1, 1 - b1, b2, 1 - b2, eps and the weight decay as 0-d tensors of
    the compute dtype on ``device`` (the reference's ``jnp.asarray(v,
    ct)``), made once a (config, device), by ``adamw_init``: a
    tensor made from a host value is a host-to-device copy, which a
    CUDA-graph capture of the update refuses."""
    key = (cfg, torch.device(device))
    if key not in _CONSTANTS:
        _CONSTANTS[key] = tuple(
            torch.tensor(v, dtype=cfg.compute_dtype, device=device)
            for v in (cfg.b1, 1 - cfg.b1, cfg.b2, 1 - cfg.b2, cfg.eps,
                      cfg.weight_decay))
    return _CONSTANTS[key]


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    def z(p):
        return torch.zeros_like(p, dtype=cfg.state_dtype)

    device = tree_leaves(params)[0].device
    _constants(cfg, device)
    step = torch.zeros((), dtype=torch.int32, device=device)
    return AdamWState(step=step, m=tree_map(z, params),
                      v=tree_map(z, params))


def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig,
                 inplace: bool = False):
    """One AdamW step.  Returns (new params, new state); with ``inplace``
    they are ``params`` and ``state``'s own tensors, updated (see the
    module docstring)."""
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    bc1 = 1 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1 - cfg.b2 ** step.to(torch.float32)
    ct, st = cfg.compute_dtype, cfg.state_dtype
    b1, b1c, b2, b2c, eps, wd = _constants(cfg, step.device)
    bc1c, bc2c, lrc = bc1.to(ct), bc2.to(ct), lr.to(ct)

    def leaf(g, m, v, p):
        gc = g.to(ct)
        m2 = (b1 * m.to(ct) + b1c * gc).to(st)
        v2 = (b2 * v.to(ct) + b2c * gc * gc).to(st)
        upd = (m2.to(ct) / bc1c) / (torch.sqrt(v2.to(ct) / bc2c) + eps)
        upd = upd + wd * p.to(ct)
        p2 = (p.to(ct) - lrc * upd).to(p.dtype)
        if not inplace:
            return m2, v2, p2
        m.copy_(m2)
        v.copy_(v2)
        p.copy_(p2)
        return m, v, p

    new: list = []
    tree_map(lambda *t: new.append(leaf(*t)), grads, state.m, state.v,
             params)
    m2, v2, p2 = (tree_from_leaves(params, [n[i] for n in new])
                  for i in range(3))
    if inplace:
        state.step.copy_(step)
        step = state.step
    return p2, AdamWState(step=step, m=m2, v=v2)


def tree_from_leaves(like, leaves):
    """``leaves`` (in ``tree_map``'s order) in the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
