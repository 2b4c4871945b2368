"""The port's sharding rules (``repro_torch.launch.sharding``) and abstract
trees (``repro_torch.launch.steps``): twins of ``tests/test_sharding.py``'s
four checks on the port's rules, then the rules and trees of both
packages side by side: every spec of the port equal to ``tuple()`` of the
reference's, for every arch, leaf and shape on the (16, 16) and
(2, 16, 16) meshes, and the port's meta trees equal in shape and dtype
to the reference's ``eval_shape`` trees for all 10 archs at full size.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import sharding as JS  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.training.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.configs import shape_supported  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.mesh import batch_axes  # noqa: E402
from repro_torch.launch.sharding import (activation_specs,  # noqa: E402
                                         batch_spec, cache_spec,
                                         leaves_with_path, param_spec,
                                         shard_cache, shard_params,
                                         spec_placements)
from repro_torch.training.optim import AdamWConfig  # noqa: E402


class FakeMesh:
    """Shape-only stand-in (no devices needed to validate the rules)."""

    def __init__(self, shape_map):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)


MESHES = [FakeMesh({"data": 16, "model": 16}),
          FakeMesh({"pod": 2, "data": 16, "model": 16})]


def _axis_size(mesh, entry):
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        return int(np.prod([mesh.shape[e] for e in entry]))
    return mesh.shape[entry]


def _check_spec(spec, shape, mesh, what):
    assert len(spec) <= len(shape), (what, spec, shape)
    for dim, entry in zip(shape, spec):
        size = _axis_size(mesh, entry)
        assert dim % size == 0, (what, spec, shape, dim, size)
    # no mesh axis used twice
    used = []
    for entry in spec:
        if entry is None:
            continue
        used += list(entry) if isinstance(entry, tuple) else [entry]
    assert len(used) == len(set(used)), (what, spec)


# --------------------------------------- twins of tests/test_sharding.py
@pytest.mark.parametrize("mesh", MESHES, ids=["single", "multi"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_divide(arch, mesh):
    cfg = get_config(arch)
    aparams = ST.abstract_params(cfg, torch.bfloat16)
    for pstr, leaf in leaves_with_path(aparams):
        spec = param_spec(pstr, leaf.shape, mesh, cfg.num_groups)
        _check_spec(spec, leaf.shape, mesh, f"{arch}:{pstr}")


@pytest.mark.parametrize("mesh", MESHES, ids=["single", "multi"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_divide(arch, mesh):
    cfg = get_config(arch)
    for sname in ("decode_32k", "long_500k"):
        shape = SHAPES[sname]
        ok, _ = shape_supported(cfg, shape)
        if not ok:
            continue
        acache = ST.abstract_cache(cfg, shape.global_batch, shape.seq_len)
        for _, leaf in leaves_with_path(acache):
            spec = cache_spec(mesh, cfg, shape.global_batch, leaf.shape)
            _check_spec(spec, leaf.shape, mesh,
                        f"{arch}:{sname}:{tuple(leaf.shape)}")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_activation_specs_well_formed(arch):
    cfg = get_config(arch)
    for mesh in MESHES:
        specs = activation_specs(cfg, mesh, 256)
        for name, spec in specs.items():
            if spec is None:
                continue
            used = []
            for entry in spec:
                if entry is None:
                    continue
                used += list(entry) if isinstance(entry, tuple) else [entry]
            assert len(used) == len(set(used)), (arch, name, spec)


def test_row_parallel_orientation():
    mesh = MESHES[0]
    # w_down: contraction dim (F) on model, output on data
    s = param_spec("groups/0/mlp/w_down", (13, 9216, 2304), mesh, 13)
    assert s[1] == "model"
    # w_gate: column-parallel
    s = param_spec("groups/0/mlp/w_gate", (13, 2304, 9216), mesh, 13)
    assert s[2] == "model"
    # embed: vocab on model (matches logits constraint)
    s = param_spec("embed", (256000, 2304), mesh, 13)
    assert s[0] == "model"


# ------------------------------------------------- against the reference
def _jpath(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _jleaves(tree):
    return {_jpath(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tdtype(t):
    return str(t.dtype).replace("torch.", "")


def _same_tree(jtree, ttree, what):
    want = {p: (tuple(l.shape), str(l.dtype))
            for p, l in _jleaves(jtree).items()}
    got = {p: (tuple(l.shape), _tdtype(l))
           for p, l in leaves_with_path(ttree)}
    assert got == want, what
    assert all(l.device.type == "meta" for _, l in leaves_with_path(ttree))


@pytest.mark.parametrize("mesh", MESHES, ids=["single", "multi"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_the_reference(arch, mesh):
    """param_spec (both layouts), cache_spec, batch_spec and
    activation_specs of the port equal tuple() of the reference's, leaf
    for leaf and shape for shape."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    jparams = _jleaves(JST.abstract_params(jcfg, jnp.bfloat16))
    for pstr, leaf in leaves_with_path(ST.abstract_params(cfg)):
        for serving in (False, True):
            want = JS.param_spec(pstr, jparams[pstr].shape, mesh,
                                 jcfg.num_groups, serving=serving)
            assert param_spec(pstr, leaf.shape, mesh, cfg.num_groups,
                              serving=serving) == tuple(want), (pstr, serving)
    for sname, shape in SHAPES.items():
        B = shape.global_batch
        for extra in (1, 2):
            assert batch_spec(mesh, B, extra) == tuple(
                JS.batch_spec(mesh, B, extra))
        got = activation_specs(cfg, mesh, B)
        want = JS.activation_specs(jcfg, mesh, B)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == (None if want[k] is None else tuple(want[k])), k
        if not shape_supported(cfg, shape)[0] or shape.kind != "decode":
            continue
        jc = JST.abstract_cache(jcfg, B, shape.seq_len)
        for _, leaf in leaves_with_path(ST.abstract_cache(cfg, B,
                                                          shape.seq_len)):
            assert cache_spec(mesh, cfg, B, leaf.shape) == tuple(
                JS.cache_spec(mesh, jcfg, B, tuple(leaf.shape))), sname
        assert len(jax.tree.leaves(jc)) == len(leaves_with_path(
            ST.abstract_cache(cfg, B, shape.seq_len)))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_trees_equal_the_reference(arch):
    """abstract_params, abstract_opt_state (f32 and bf16 moments),
    abstract_cache and input_specs at full size, for every shape: the
    port's meta trees have the reference's leaves, shapes and dtypes."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    jp = JST.abstract_params(jcfg, jnp.bfloat16)
    tp = ST.abstract_params(cfg, torch.bfloat16)
    _same_tree(jp, tp, "params")
    for sd in ("float32", "bfloat16"):
        jo = JST.abstract_opt_state(jp, JAdamWConfig(
            state_dtype=getattr(jnp, sd)))
        to = ST.abstract_opt_state(tp, AdamWConfig(
            state_dtype=getattr(torch, sd)))
        _same_tree(jo.m, to.m, "m")
        _same_tree(jo.v, to.v, "v")
        assert (tuple(to.step.shape), _tdtype(to.step)) == (
            tuple(jo.step.shape), str(jo.step.dtype))
    for sname, shape in SHAPES.items():
        _same_tree(JST.input_specs(jcfg, J_SHAPES[sname]),
                   ST.input_specs(cfg, shape), sname)
        if shape.kind == "decode" and shape_supported(cfg, shape)[0]:
            B, S = shape.global_batch, shape.seq_len
            _same_tree(JST.abstract_cache(jcfg, B, S),
                       ST.abstract_cache(cfg, B, S), sname)


def test_shardings_trees_and_placements():
    """shard_params / shard_cache give one NamedSharding a leaf; a spec's
    placements shard each named mesh axis on its dim, and a multi-axis
    entry must list its axes in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    cfg = get_config("mixtral-8x7b")
    mesh = MESHES[1]
    tp = ST.abstract_params(cfg)
    sh = shard_params(tp, mesh, cfg)
    for (pstr, leaf), (_, s) in zip(leaves_with_path(tp),
                                    leaves_with_path(sh)):
        assert s.spec == param_spec(pstr, leaf.shape, mesh, cfg.num_groups)
    shape = SHAPES["decode_32k"]
    cache = ST.abstract_cache(cfg, shape.global_batch, shape.seq_len)
    assert len(leaves_with_path(shard_cache(cache, mesh, cfg, 128))) == \
        len(leaves_with_path(cache))
    assert spec_placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert spec_placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(AssertionError):
        spec_placements((("data", "pod"),), mesh)
    assert batch_axes(mesh) == ("pod", "data")
    assert batch_axes(MESHES[0]) == ("data",)
