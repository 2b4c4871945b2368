"""Tree checkpointing in PyTorch, mirroring ``repro.checkpoint.io`` and
its on-disk format, so a checkpoint written by either package loads into
the other: ``step_%08d/arrays.npz`` with one array a leaf, keyed by the
leaf's path, and ``manifest.json`` with the step and each key's dtype.

Paths are the strings the JAX package makes from
``jax.tree_util.tree_flatten_with_path``: dict keys (sorted) and tuple
indices joined by ``/``, a NamedTuple field as ``.name`` (``groups/0/attn/
wq``, ``final_norm/scale``, ``.step``, ``.m/embed``).  bfloat16 is stored
as its uint16 bits (numpy has no bfloat16) with dtype ``"bfloat16"``.
Writes are atomic (tmp dir + rename), so a crashed writer never corrupts
the latest checkpoint.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

_BF16 = "bfloat16"


def _flatten(tree, prefix: str = "", out: Optional[Dict] = None) -> Dict:
    """{path: leaf tensor} in the JAX package's key strings."""
    out = {} if out is None else out

    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], join(k), out)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            _flatten(v, join(f".{name}"), out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(v, join(i), out)
    else:
        out[prefix] = tree
    return out


def _unflatten(like, arrays: Dict, prefix: str = ""):
    """``like``'s structure with the leaf at each path from ``arrays``."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(like, dict):
        return {k: _unflatten(v, arrays, join(k)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, arrays, join(f".{n}"))
                            for n, v in zip(like._fields, like)))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, arrays, join(i))
                          for i, v in enumerate(like))
    return arrays[prefix]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    manifest = {}
    npz = {}
    for k, t in _flatten(tree).items():
        npz[k] = _to_numpy(t)
        manifest[k] = (_BF16 if t.dtype == torch.bfloat16
                       else npz[k].dtype.name)
    tmp = tempfile.mkdtemp(dir=d)
    np.savez(os.path.join(tmp, "arrays.npz"), **npz)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "dtypes": manifest}, f)
    final = d / f"step_{step:08d}"
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return str(final)


def latest_step(ckpt_dir: str) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")]
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: int, like_tree):
    """Restore into the structure of ``like_tree`` (shapes must match);
    each leaf keeps the stored dtype and goes to its ``like`` leaf's
    device."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)
    data = np.load(d / "arrays.npz")
    like = _flatten(like_tree)
    arrays = {}
    for k, t in like.items():
        a = data[k]
        if manifest["dtypes"][k] == _BF16:
            x = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            x = torch.from_numpy(np.array(a))
        arrays[k] = x.to(t.device)
    return _unflatten(like_tree, arrays)
