"""The weights of a run, made by the benchmark from the seed on the
device, in the parameter tree the program takes.  The tree's layout
(names, shapes, dtypes) is read from the program's abstract tree
(``init_params(..., device="meta")``: no numbers); the numbers are
drawn here, one large call a leaf, leaves in sorted order, from one
``torch.Generator`` on the card.  Both the program and the reference
get these same tensors."""

from __future__ import annotations

import math

import torch

ONES = ("scale", "norm_scale", "D")
ZEROS = ("conv_bx", "conv_bB", "conv_bC")
FIXED_STD = {"embed": 0.02, "lm_head": 0.02, "conv_x": 0.1,
             "conv_B": 0.1, "conv_C": 0.1}


def leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict / tuple tree."""
    if isinstance(tree, dict):
        for k in tree:
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def rebuild(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(rebuild(v, fn, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _fill(path: tuple, t: torch.Tensor, gen: torch.Generator):
    name = path[-1]
    if name in ONES:
        return t.fill_(1.0)
    if name in ZEROS:
        return t.zero_()
    if name == "A_log":  # A = -exp(A_log), A uniform in [1, 16]
        return t.uniform_(1.0, 16.0, generator=gen).log_()
    if name == "dt_bias":  # softplus(dt_bias) log-uniform in [1e-3, 0.1]
        t.uniform_(math.log(1e-3), math.log(0.1), generator=gen)
        return t.exp_().expm1_().log_()
    if name in FIXED_STD:
        std = FIXED_STD[name]
    elif t.dim() >= 2:  # a matrix's fan-in
        std = 1.0 / math.sqrt(t.shape[-2])
    else:
        raise ValueError(f"weights: no rule draws the {t.dim()}-D leaf "
                         f"{'/'.join(map(str, path))}")
    return t.normal_(0.0, std, generator=gen)


def make(meta_tree, seed: int, device) -> dict:
    """A tree like ``meta_tree`` (shapes and dtypes) with numbers drawn
    from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for path, m in sorted(leaves(meta_tree), key=lambda pl: str(pl[0])):
        t = torch.empty(m.shape, dtype=torch.float32, device=device)
        out[path] = _fill(path, t, gen).to(m.dtype)
    return rebuild(meta_tree, lambda path, _: out[path])

