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


# ------------------- a weight on ("pod", "data") gathered in one all-gather
_FLAT_GATHER_TRACE = r"""
import json
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import hlo_cost as HC
from repro_torch.launch.dryrun import init_fake_group
from repro_torch.models.shardctx import activation_sharding, constrain
init_fake_group(8)
mesh = init_device_mesh("cpu", (2, 2, 2),
                        mesh_dim_names=("pod", "data", "model"))
E, D, F = 4, 64, 32  # an MoE stack: D on ("pod", "data"), F on "model"
w = DTensor.from_local(torch.empty((E, D // 4, F // 2), device="meta"),
                       mesh, [Shard(1), Shard(1), Shard(2)], run_check=False)


def pinned():
    with activation_sharding({"expert_col_w": (None, None, "model")}):
        return constrain(w, "expert_col_w")


out = {}
# DTensor's own first: once a flattened ("pod", "data") mesh exists, some
# torch releases (2.13) gather over it themselves
for name, fn in (("dtensor", lambda: w.redistribute(
        mesh, [Replicate(), Replicate(), Shard(2)])), ("pinned", pinned)):
    tr = HC.trace_step(fn)
    out[name] = [[op.coll_kind, op.coll_bytes] for op in tr.ops
                 if op.coll_kind]
    out[name + "/placements"] = tuple(tr.out.placements) == (
        Replicate(), Replicate(), Shard(2))
    out[name + "/local"] = list(tr.out.to_local().shape)
print(json.dumps(out))
"""


def test_a_pod_data_weight_gather_counts_one_all_gather_of_its_shard():
    """On a fake 2x2x2 ("pod", "data", "model") mesh (a subprocess: no
    process group leaks into this one), an MoE stack (E, D, F) sharded
    ``S(1)`` on "pod" and "data" and ``S(2)`` on "model", pinned whole on
    the data axes, is gathered in one all-gather over the flattened
    ("pod", "data") group whose operand is the local shard, as XLA's HLO
    gathers it; DTensor's own redistribute, on a mesh with no flattened
    group yet, gathers over "data" and then over "pod", two collectives of
    the shard and twice the shard."""
    import json
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    r = subprocess.run([sys.executable, "-c", _FLAT_GATHER_TRACE],
                       env=dict(os.environ, PYTHONPATH=src),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    shard = 4 * (64 // 4) * (32 // 2) * 4  # the local shard's bytes
    assert out["pinned"] == [["all-gather", shard]]
    assert out["dtensor"] == [["all-gather", shard],
                              ["all-gather", 2 * shard]]
    for name in ("pinned", "dtensor"):
        assert out[name + "/placements"]
        assert out[name + "/local"] == [4, 64, 16]


_FLAT_GATHER_RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from repro_torch.models.shardctx import activation_sharding, constrain
rank, d = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)  # eight ranks beside the other test workers
dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                        world_size=8)
mesh = init_device_mesh("cpu", (2, 2, 2),
                        mesh_dim_names=("pod", "data", "model"))
w0 = torch.from_numpy(np.load(f"{d}/w.npy"))
g_all = torch.from_numpy(np.load(f"{d}/g.npy"))
F = w0.shape[2]
m = mesh.get_local_rank("model")
mine = g_all[rank][:, :, m * F // 2:(m + 1) * F // 2].contiguous()
out = {}
for name in ("pinned", "dtensor"):
    for grad in ("partial", "replicate"):
        w = distribute_tensor(w0, mesh, [Shard(1), Shard(1), Shard(2)])
        w = w.detach().requires_grad_()
        if name == "pinned":
            with activation_sharding({"w": (None, None, "model")}):
                y = constrain(w, "w")
        else:
            y = w.redistribute(mesh, [Replicate(), Replicate(), Shard(2)])
        if grad == "partial":  # a product's weight gradient: each device's
            g = DTensor.from_local(mine, mesh, [Partial(), Partial(),
                                                Shard(2)], run_check=False)
        else:
            g = DTensor.from_local(g_all[0][:, :, m * F // 2:
                                            (m + 1) * F // 2].contiguous(),
                                   mesh, [Replicate(), Replicate(), Shard(2)],
                                   run_check=False)
        y.backward(g)
        key = f"{name}/{grad}"
        out[key + "/y"] = y.detach().full_tensor().numpy()
        out[key + "/y_local"] = y.detach().to_local().numpy()
        out[key + "/grad"] = w.grad.full_tensor().numpy()
        assert tuple(y.placements) == (Replicate(), Replicate(), Shard(2))
        assert tuple(w.grad.placements) == (Shard(1), Shard(1), Shard(2))
np.savez(f"{d}/out{rank}.npz", **out)
dist.destroy_process_group()
"""


def test_a_pod_data_weight_gather_and_its_gradient_on_eight_gloo_ranks(
        tmp_path):
    """Eight gloo ranks on a 2x2x2 ("pod", "data", "model") CPU mesh: the
    pinned gather of a (4, 8, 6) weight sharded ``S(1)`` on "pod" and
    "data" and ``S(2)`` on "model" (one all-gather over the flattened
    group) gives every device the weight, bit for bit, as DTensor's own
    redistribute does; and the weight's gradient, from a partial sum over
    the data axes (one reduce-scatter) or from a replica, equals DTensor's
    and the sum of the ranks' partials (1e-6 relative)."""
    import os
    import subprocess
    import sys
    rng = np.random.default_rng(11)
    w0 = rng.standard_normal((4, 8, 6)).astype(np.float32)
    g_all = rng.standard_normal((8, 4, 8, 6)).astype(np.float32)
    np.save(tmp_path / "w.npy", w0)
    np.save(tmp_path / "g.npy", g_all)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    procs = [subprocess.Popen([sys.executable, "-c", _FLAT_GATHER_RANK,
                               str(r), str(tmp_path)],
                              env=dict(os.environ, PYTHONPATH=src),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(8)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    # rank = pod * 4 + data * 2 + model: the model-axis slice m of the
    # gradient sums the partials of the four ranks with that m
    want_partial = np.zeros_like(w0)
    for m in range(2):
        cols = slice(3 * m, 3 * m + 3)
        want_partial[:, :, cols] = sum(g_all[r][:, :, cols]
                                       for r in range(8) if r % 2 == m)
    for r in range(8):
        got = np.load(tmp_path / f"out{r}.npz")
        cols = slice(3 * (r % 2), 3 * (r % 2) + 3)
        for grad, want in (("partial", want_partial), ("replicate",
                                                       g_all[0])):
            for name in ("pinned", "dtensor"):
                key = f"{name}/{grad}"
                np.testing.assert_array_equal(got[key + "/y"], w0)
                np.testing.assert_array_equal(got[key + "/y_local"],
                                              w0[:, :, cols])
                np.testing.assert_allclose(got[key + "/grad"], want,
                                           rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(got[f"pinned/{grad}/grad"],
                                       got[f"dtensor/{grad}/grad"],
                                       rtol=1e-6, atol=1e-6)


# ------------- a constraint that only moves axes of size 1 copies nothing
_SIZE_ONE_AXES = r"""
import json
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.dryrun import init_fake_group
from repro_torch.models.shardctx import activation_sharding, constrain
init_fake_group(1)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
stacked = torch.randn((3, 8, 6), generator=torch.Generator().manual_seed(0))
w = DTensor.from_local(stacked, mesh, [Replicate(), Shard(2)],
                       run_check=False)
g = w[1]  # one group's weight: a slice of the stacked one
with activation_sharding({"col_w": (None, "model")}):
    out = constrain(g, "col_w")
print(json.dumps({
    "placements": [type(p).__name__ for p in out.placements],
    "aliases": out.to_local().data_ptr() == g.to_local().data_ptr(),
    "equal": torch.equal(out.full_tensor(), stacked[1])}))
"""


def test_a_constraint_that_moves_only_size_one_axes_copies_nothing():
    """On the 1x1 mesh (a fake one-rank group in a subprocess), a group's
    weight sliced out of the stacked weights and constrained as a
    product operand changes placements only on axes of size 1: the
    constraint hands back the weight's own local tensor, not a copy (a
    copy of every weight a step was 6.3 ms of a full-width gemma2-2b
    decode step on the card's 1x1 mesh)."""
    import json
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    r = subprocess.run([sys.executable, "-c", _SIZE_ONE_AXES],
                       env=dict(os.environ, PYTHONPATH=src),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out == {"placements": ["Replicate", "Replicate"],
                   "aliases": True, "equal": True}, out
