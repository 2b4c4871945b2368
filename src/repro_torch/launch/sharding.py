"""Parameter / activation / cache sharding rules for the production mesh,
mirroring ``repro.launch.sharding`` rule for rule.

Strategy (the reference's paper-faithful baseline):

  - every >=2D weight is FSDP-sharded: dim_a over the data axes, dim_b over
    the model axis (when divisible);
  - MoE expert stacks (E, D, F) shard D over data, F over model;
  - 1D scales shard over model when divisible;
  - the leading scan-group stack dim is always replicated;
  - batch shards over ("pod","data"); decode KV caches shard the *sequence*
    axis over "model" (kv-head counts don't divide 16) and batch over data.

A spec is a tuple with one entry per tensor dim, each ``None``, a mesh
axis name or a tuple of names: ``tuple()`` of the reference's
``PartitionSpec``, normalized as it normalizes (``()`` is ``None``, a
one-name tuple is the name).  ``spec_placements`` turns a spec into
DTensor placements over a ``DeviceMesh``.  The rules take a
``DeviceMesh`` or any shape-only mesh with ``shape`` (name -> size) and
``axis_names``, as the tests' stand-in has.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.models.config import ModelConfig
from repro_torch.training.optim import tree_map

Spec = Tuple[Any, ...]


def P(*parts) -> Spec:
    """A spec from its entries, normalized as ``PartitionSpec`` is."""
    def norm(e):
        if isinstance(e, tuple):
            return None if not e else (e[0] if len(e) == 1 else e)
        return e
    return tuple(norm(e) for e in parts)


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        return math.prod(_axis_size(mesh, n) for n in name)
    if hasattr(mesh, "mesh_dim_names"):
        return mesh.size(mesh.mesh_dim_names.index(name))
    return mesh.shape[name]


def _fit(dim: int, mesh, axis) -> Optional[Any]:
    """axis if it divides dim else None."""
    if axis == () or axis is None:
        return None
    return axis if dim % _axis_size(mesh, axis) == 0 else None


def spec_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``: ``Shard(d)`` on each
    mesh axis that tensor dim ``d`` names, ``Replicate()`` on the others.
    An entry naming several axes shards its dim over them major to minor
    in the order it lists them; DTensor shards one dim over several mesh
    dims in mesh order, so the entry must list them in mesh order (every
    rule here does, e.g. ("pod", "data"))."""
    names = axis_names(mesh)
    placements = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        assert idx == sorted(idx), \
            f"spec entry {entry} does not list its axes in mesh order {names}"
        for i in idx:
            assert placements[i] == Replicate(), \
                f"mesh axis {names[i]} used twice in {spec}"
            placements[i] = Shard(d)
    return tuple(placements)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of jax's ``NamedSharding``)."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return spec_placements(self.spec, self.mesh)


def distribute(tree, shardings):
    """Every tensor of ``tree`` as a DTensor laid out by the
    ``NamedSharding`` at the same place in ``shardings``.  Each rank
    keeps its own shard of the tensor it holds (no data is sent: every
    rank is expected to hold the same full tensor, as one seed gives); a
    meta tensor gives a meta DTensor of its shape, which costs nothing.
    Each shard is made contiguous: a shard of a dim past the first is a
    strided view, on which DTensor's local views can fail."""
    def one(t, s):
        if isinstance(t, DTensor):
            return t.redistribute(s.mesh, s.placements)
        d = distribute_tensor(t, s.mesh, s.placements, src_data_rank=None)
        if d.to_local().is_contiguous():
            return d
        return DTensor.from_local(d.to_local().contiguous(), s.mesh,
                                  s.placements, run_check=False,
                                  shape=d.shape, stride=d.stride())
    return tree_map(one, tree, shardings)


# row-parallel matrices: contraction (input) dim is the one the activations
# arrive sharded on (model axis); output dim joins the data/FSDP axis.
_ROW_PARALLEL = ("w_down", "wo", "out_proj")


def param_spec(path: str, shape: Tuple[int, ...], mesh,
               n_groups: int, serving: bool = False) -> Spec:
    """Spec for one parameter leaf (path = '/'-joined keys).

    Column-parallel (default): (in, out) -> (data, model), activations leave
    sharded on the model axis.  Row-parallel (w_down/wo/out_proj): (in, out)
    -> (model, data), consuming model-sharded activations with a reduction.
    Both orientations FSDP-shard the other dim over data for HBM.

    ``serving=True`` drops the data-axis (FSDP) shardings: tensor-parallel
    over "model" only, weights replicated across data, is the serving
    layout whenever the model fits (params/16 within the HBM budget).
    """
    data = ("pod", "data") if "pod" in axis_names(mesh) else ("data",)
    if serving:
        data = ()
    shape = tuple(shape)
    stacked = shape[:1] == (n_groups,) and "groups" in path
    core = shape[1:] if stacked else shape
    lead = (None,) if stacked else ()
    row = any(path.endswith(r) for r in _ROW_PARALLEL)

    def spec(*parts):
        return P(*lead, *parts)

    if len(core) == 3:  # MoE expert stacks
        if row:  # w_down (E, F, D)
            return spec(None, _fit(core[1], mesh, "model"),
                        _fit(core[2], mesh, data))
        return spec(None, _fit(core[1], mesh, data),
                    _fit(core[2], mesh, "model"))
    if len(core) == 2:
        if row or path.endswith("embed"):
            # embed (V, D): V over model so tied-head logits come out
            # model-sharded, matching the "logits" activation constraint
            a = _fit(core[0], mesh, "model")
            b = _fit(core[1], mesh, data)
            return spec(a, b)
        a = _fit(core[0], mesh, data)
        b = _fit(core[1], mesh, "model")
        if a is None and b is None:
            a = _fit(core[0], mesh, "model")
            b = _fit(core[1], mesh, data) if a is not None else None
        return spec(a, b)
    if len(core) == 1:
        return spec(_fit(core[0], mesh, "model"))
    return spec(*([None] * len(core)))


def leaves_with_path(tree, prefix: str = ""):
    """(path, leaf) of every leaf in ``tree_map``'s order; the path joins
    dict keys and sequence indices with '/', as the reference's
    ``tree_flatten_with_path`` keys are joined."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += leaves_with_path(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def shard_params(params, mesh, cfg: ModelConfig, serving: bool = False):
    """``NamedSharding`` tree matching ``params``' structure."""
    return _unflatten(params, [
        NamedSharding(mesh, param_spec(path, leaf.shape, mesh,
                                       cfg.num_groups, serving=serving))
        for path, leaf in leaves_with_path(params)])


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def serving_layout_fits(params, mesh, budget_bytes: float = 8e9) -> bool:
    """True if model-parallel-only weights fit the per-device budget."""
    total = sum(_nbytes(leaf) for _, leaf in leaves_with_path(params))
    return total / _axis_size(mesh, "model") <= budget_bytes


# ------------------------------------------------------------- activations
def batch_spec(mesh, batch: int, extra_dims: int = 1) -> Spec:
    data = ("pod", "data") if "pod" in axis_names(mesh) else ("data",)
    ax = data if batch % _axis_size(mesh, data) == 0 else (
        "data" if batch % _axis_size(mesh, "data") == 0 else None)
    return P(ax, *([None] * extra_dims))


def cache_spec(mesh, cfg: ModelConfig, batch: int, leaf_shape) -> Spec:
    """Decode-cache leaf shardings.  Leaves (leading group dim G):
       attn k/v  (G, B, L, KV, hd) -> batch over data, seq L over model
       attn pos  (G, L)
       ssm state (G, B, H, P, N)   -> batch over data, heads over model
       ssm conv  (G, B, K-1, Dc)   -> batch over data, Dc over model
    """
    data = ("pod", "data") if "pod" in axis_names(mesh) else ("data",)
    leaf_shape = tuple(leaf_shape)
    nd = len(leaf_shape)
    if nd == 5 and leaf_shape[3] == cfg.num_kv_heads \
            and leaf_shape[4] == cfg.head_dim:  # kv cache
        b_ax = _fit(leaf_shape[1], mesh, data) or _fit(leaf_shape[1], mesh,
                                                       "data")
        s_ax = _fit(leaf_shape[2], mesh, "model")
        if b_ax is None:  # batch=1 long-context: shard seq over everything
            s_ax = _fit(leaf_shape[2], mesh, ("data", "model")) or s_ax
        return P(None, b_ax, s_ax, None, None)
    if nd == 5:  # ssm state (G,B,H,P,N)
        b_ax = _fit(leaf_shape[1], mesh, data) or _fit(leaf_shape[1], mesh,
                                                       "data")
        return P(None, b_ax, _fit(leaf_shape[2], mesh, "model"), None, None)
    if nd == 4:  # ssm conv (G,B,K-1,Dc)
        b_ax = _fit(leaf_shape[1], mesh, data) or _fit(leaf_shape[1], mesh,
                                                       "data")
        return P(None, b_ax, None, _fit(leaf_shape[3], mesh, "model"))
    if nd == 2:  # kv pos (G, L)
        return P(None, None)
    return P(*([None] * nd))


def shard_cache(cache, mesh, cfg: ModelConfig, batch: int):
    return tree_map(lambda leaf: NamedSharding(
        mesh, cache_spec(mesh, cfg, batch, leaf.shape)), cache)


def activation_specs(cfg: ModelConfig, mesh, batch: int,
                     collab: bool = False):
    """Specs for ``repro_torch.models.shardctx`` constraint points.

    Model-parallel axes only apply when the dimension divides the axis size
    (e.g. qwen2-vl's 12 heads stay replicated on a 16-way model axis).
    ``collab=True`` builds specs for inside the pod-manual region of the
    collaborative pipeline, where "pod" must not appear."""
    data = ("pod", "data") if ("pod" in axis_names(mesh) and not collab) \
        else ("data",)
    b = data if batch % _axis_size(mesh, data) == 0 else (
        "data" if batch % _axis_size(mesh, "data") == 0 else None)

    def m(dim):
        return _fit(dim, mesh, "model")

    hd = cfg.head_dim
    return {
        "hidden": P(b, None, None),
        "q_heads": P(b, None, m(cfg.num_heads), None),
        "kv_heads": P(b, None, m(cfg.num_kv_heads), None),
        "attn_out": P(b, None, m(cfg.num_heads * hd)),
        "ffn": P(b, None, m(cfg.d_ff) if cfg.d_ff else None),
        "logits": P(b, None, m(cfg.vocab_size)),
        "ssm_heads": P(b, None, m(cfg.ssm_heads), None)
        if cfg.ssm_state else None,
        "ssm_inner": P(b, None, m(cfg.ssm_inner)) if cfg.ssm_state else None,
        "conv": P(b, None, m(cfg.ssm_inner + 2 * cfg.ssm_state))
        if cfg.ssm_state else None,
        # MoE dispatch: token groups over data, expert FFN width over model
        "moe_oh": P(b, None, None),
        "moe_buf": P(b, None, None, None),
        "moe_h": P(b, None, None, m(cfg.d_ff) if cfg.d_ff else None),
        # intra-chunk SSD tensors: shard the chunk axis over "model"
        "ssm_chunk_x": P(b, "model", None, None, None),
        "ssm_chunk_dt": P(b, "model", None, None),
        "ssm_chunk_bc": P(b, "model", None, None, None),
        "ssm_chunk_l": P(b, "model", None, None, None),
        "ssm_chunk_s": P(b, "model", None, None, None),
    }


def product_specs(cfg: ModelConfig, mesh, batch: int, collab: bool = False):
    """Specs of the operands of the models' products, by name.  The
    reference has no such points: XLA propagates its activation specs
    back into each product, and DTensor propagates forward, op by op, so
    the port constrains the operands to the layouts the reference's
    compiled HLO gives them.  ``...`` stands for the dims between (an
    operand with or without a sequence dim).

    A weight is whole on the data axes (the all-gather of FSDP) and
    sharded on the model axis over its output dim, column-parallel
    ("col_w", "expert_col_w"), or its input dim, row-parallel ("row_w",
    "expert_row_w"), as ``param_spec`` orients it; a norm's scale is whole.
    Data axes that carry no batch rows (a batch of one) split a product's
    contraction ("col_in", "expert_in") or a row-parallel product's
    output instead.  The head's weight is sharded on the vocab; where the
    vocab does not divide the model axis, on d_model, and the head's input
    ("head_in") with it, and the logits are whole ("head_out").  A prefill
    leaves the decode cache's keys and values sharded on the sequence
    ("kv_seq", as ``cache_spec``), and a decode step's new entry is whole
    but for its rows ("kv_new")."""
    data = ("pod", "data") if ("pod" in axis_names(mesh) and not collab) \
        else ("data",)
    b = activation_specs(cfg, mesh, batch, collab)["hidden"][0]
    used = b if isinstance(b, tuple) else (b,)
    idle = P(tuple(a for a in data if a not in used
                   and _axis_size(mesh, a) > 1))[0]
    vocab = _fit(cfg.vocab_size, mesh, "model")
    return {
        "norm_scale": P(None),
        "col_in": P(b, ..., idle) if idle else None,
        "col_w": P(idle, "model"),
        "row_w": P("model", idle),
        "expert_in": P(b, None, None, idle) if idle else None,
        "expert_col_w": P(None, idle, "model"),
        "expert_row_w": P(None, "model", idle),
        "head_in": None if vocab else P(b, ..., "model"),
        "head_w": P(None, "model") if vocab else P("model", None),
        "head_embed": P("model", None) if vocab else P(None, "model"),
        "head_out": None if vocab else P(b, ..., None),
        "kv_seq": P(b, "model", None, None),
        "kv_new": P(b, None, None, None),
    }


def layout_specs(cfg: ModelConfig, mesh, batch: int, collab: bool = False):
    """``activation_specs`` and ``product_specs`` in one dict: what a
    launcher gives ``shardctx.activation_sharding``."""
    return {**activation_specs(cfg, mesh, batch, collab),
            **product_specs(cfg, mesh, batch, collab)}
