"""``repro_torch.core.jit``, the port's counterpart of ``jax.jit``, on the
CPU: there ``jit(fn)`` calls ``fn`` (no CUDA graph exists on the CPU), so
a jitted function returns exactly what ``fn`` returns; what it refuses
(leaves that require grad, arguments on two kinds of device); and its
capture key, which the card's path looks up before it captures or
replays: static arguments, every tensor leaf's shape, dtype, stride and
device, the weights' addresses, and a DTensor's layout and the active
``activation_sharding`` specs.  The captures and
replays themselves run only on the card (``tests/test_torch_gpu.py``).
"""

import functools
import gc
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.collab import CollabRuntime as JCollabRuntime  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.collab import CollabRuntime  # noqa: E402
from repro_torch.core.jit import jit  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _affine(p, x, scale=1.0):
    return (x @ p["w"] + p["b"]) * scale


def _weights(seed=0, d=4):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((d, d), generator=g),
            "b": torch.randn((d,), generator=g)}


def test_jit_on_cpu_returns_what_fn_returns():
    p, x = _weights(), torch.randn((3, 4))
    f = jit(_affine)
    assert torch.equal(f(p, x, scale=2.0), _affine(p, x, scale=2.0))
    assert torch.equal(f(p, x=x), _affine(p, x))
    assert (f.captures, f.replays, f.copies) == (0, 0, 0)


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m",
                                  "mixtral-8x7b"])
def test_jitted_segments_on_cpu_equal_the_bare_ones_and_the_reference(arch):
    """Each jitted segment of a two-hop runtime gives what the bare
    segment function gives on the same input, bit for bit, and the
    runtime's logits match the JAX package's runtime on the same weights
    (rtol/atol 1e-4)."""
    jcfg = j_get_config(arch).reduced(num_layers=3 * len(
        j_get_config(arch).pattern))
    cfg = get_config(arch).reduced(num_layers=jcfg.num_layers)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = M.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    rt = CollabRuntime(cfg, params, (1, 2))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8)
                                             ).astype(np.int32)
    x = torch.from_numpy(toks)
    bare = [f.fn for f in rt._seg_fns]
    assert all(isinstance(f, jit) for f in rt._seg_fns)
    for k, fn in enumerate(bare):
        p = rt.p_segments[k]
        got = rt._seg_fns[k](p, x)
        assert torch.equal(got, fn(p, x))
        x = got
    logits, _ = rt.run(torch.from_numpy(toks))
    jlogits, _ = JCollabRuntime(jcfg, jp, (1, 2)).run(toks)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    assert sum(f.captures + f.replays for f in rt._seg_fns) == 0


def test_a_dropped_runtime_is_freed_without_the_cycle_collector():
    """A runtime and its jitted segments form no reference cycle, so
    dropping the runtime frees it (and, on the card, its CUDA graphs) at
    once: the cycle collector, which may run in the middle of another
    capture, never frees a graph."""
    import weakref
    cfg = get_config("gemma2-2b").reduced()
    rt = CollabRuntime(cfg, M.init_params(cfg, seed=0, device="cpu"), 1)
    seg, gone = weakref.ref(rt._seg_fns[0]), weakref.ref(rt)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del rt
        assert gone() is None and seg() is None
    finally:
        if collecting:
            gc.enable()


def test_jit_refuses_leaves_that_require_grad():
    p, x = _weights(), torch.randn((3, 4))
    f = jit(_affine)
    with pytest.raises(TypeError, match="requires grad"):
        f(p, x.requires_grad_())
    p["w"].requires_grad_()
    with pytest.raises(TypeError, match="requires grad"):
        f(p, torch.randn((3, 4)))


def test_jit_refuses_arguments_on_two_kinds_of_device():
    p = _weights()
    with pytest.raises(ValueError, match="meta"):
        jit(_affine)(p, torch.empty((3, 4), device="meta"))


_DTENSOR_SCRIPT = r"""
import json
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.core.jit import jit
from repro_torch.launch.dryrun import init_fake_group
from repro_torch.models.shardctx import activation_sharding
init_fake_group(1)
mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
g = torch.Generator().manual_seed(0)


def dt(t, placement=Replicate(), **kw):
    return DTensor.from_local(t, mesh, [placement], run_check=False, **kw)


def fn(p, x, scale=1.0):
    return {"y": (x @ p["w"] + p["b"]) * scale, "n": x.shape[0]}


p = {"w": dt(torch.randn((4, 4), generator=g)),
     "b": dt(torch.randn((4,), generator=g))}
x = dt(torch.randn((2, 4), generator=g), Shard(0))
f = jit(fn)
out = {}
got, want = f(p, x, scale=2.0), fn(p, x, scale=2.0)
out["returns_what_fn_returns"] = (
    isinstance(got["y"], DTensor) and got["n"] == want["n"] == 2
    and got["y"].placements == want["y"].placements
    and torch.equal(got["y"].full_tensor(), want["y"].full_tensor())
    and (f.captures, f.replays, f.copies) == (0, 0, 0))
key = f.key(p, x)
local = x.to_local()
out["key_holds_placements"] = (
    key != f.key(p, dt(local)) and key == f.key(p, dt(local, Shard(0))))
out["key_holds_global_shape"] = key != f.key(p, dt(
    local, Shard(0), shape=torch.Size((3, 4)), stride=(4, 1)))
a = {"hidden": ("data", None)}
with activation_sharding(a):
    under_a = f.key(p, x)
with activation_sharding(dict(a)):
    under_a_again = f.key(p, x)
with activation_sharding({"hidden": (None, None)}):
    under_b = f.key(p, x)
out["key_holds_the_layout"] = (
    under_a == under_a_again and len({key, under_a, under_b}) == 3)
p["w"].mul_(2.0)
same_p = f.key(p, x) == key
moved_p = f.key(dict(p, w=dt(p["w"].to_local().clone())), x) != key
copied_x = f.key(p, dt(local.clone(), Shard(0))) == key


def step(params, state, x):
    state["n"].add_(1)
    return params, state, x.sum()


h = jit(step, donate=("state",))
s = {"n": dt(torch.zeros((2,)))}
hk = h.key(p, s, x)
s["n"].add_(1)
out["bound_by_local_address"] = (
    same_p and moved_p and copied_x and h.key(p, s, x) == hk
    and h.key(p, {"n": dt(s["n"].to_local().clone())}, x) != hk
    and h.key(p, s, dt(local.clone(), Shard(0))) == hk)
refused = []
for args in (({"w": dt(torch.ones((4, 4)).requires_grad_()), "b": p["b"]},
              x), (p, dt(torch.ones((2, 4)).requires_grad_()))):
    try:
        f(*args)
    except TypeError as e:
        refused.append("requires grad" in str(e))
out["refuses_leaves_that_require_grad"] = refused == [True, True]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def dtensor_checks():
    """The checks of ``_DTENSOR_SCRIPT``, run once on a one-rank fake group
    in a subprocess, so that no process group leaks into this one."""
    r = subprocess.run([sys.executable, "-c", _DTENSOR_SCRIPT],
                       env=dict(os.environ, PYTHONPATH=SRC),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("check", [
    "returns_what_fn_returns", "key_holds_placements",
    "key_holds_global_shape", "key_holds_the_layout",
    "bound_by_local_address", "refuses_leaves_that_require_grad"])
def test_jit_takes_dtensor_leaves(dtensor_checks, check):
    """DTensor leaves, as ``jax.jit`` takes sharded arrays: on CPU
    DTensors the jitted function returns what ``fn`` returns; a DTensor's
    key entry holds its placements and global shape beside its local
    tensor's layout, and every key holds the active
    ``activation_sharding`` specs (equal specs, equal keys); DTensor
    weights and donated state are bound by their local tensor's address
    while a copied DTensor is keyed by its layout only; and a DTensor
    leaf that requires grad raises ``TypeError``."""
    assert dtensor_checks[check], check


def test_key_holds_the_static_arguments():
    p, x = _weights(), torch.randn((3, 4))
    f = jit(_affine)
    assert f.key(p, x, scale=2.0) == f.key(p, x, scale=2.0)
    assert f.key(p, x, scale=2.0) != f.key(p, x, scale=3.0)
    # a static argument passed by position or by name is one argument
    assert f.key(p, x, 2.0) == f.key(p, x, scale=2.0)
    # the arguments' structure is static too
    assert f.key(p, x) != f.key(dict(p, c=torch.zeros(1)), x)


def test_key_holds_shape_dtype_and_stride_of_every_tensor_leaf():
    p, x = _weights(), torch.randn((3, 4))
    f = jit(_affine)
    same = torch.randn((3, 4))
    assert f.key(p, x) == f.key(p, same)  # a copied input's values are not
    assert f.key(p, x) != f.key(p, torch.randn((5, 4)))  # a new batch
    assert f.key(p, x) != f.key(p, x.double())
    assert f.key(p, x) != f.key(p, torch.randn((4, 3)).T)  # a new stride
    # a weight's shape and dtype are in the key as well as its address
    assert f.key(p, x) != f.key(dict(p, b=p["b"][None]), x)


def test_key_binds_the_weights_by_address():
    """``p`` and ``params`` are bound by address: another tensor with
    the same values is another key (a new capture, as a new ``jax.Array``
    compiles again), an in-place update of the same tensor is not, and a
    copied input is keyed by its layout only."""
    p, x = _weights(), torch.randn((3, 4))
    f = jit(_affine)
    key = f.key(p, x)
    p["w"].mul_(2.0)
    assert f.key(p, x) == key
    assert f.key({k: v.clone() for k, v in p.items()}, x) != key
    assert f.key(dict(p), x.clone()) == key

    def step(params, cache, inputs, pos):
        return params["w"] * pos + cache

    g = jit(step)
    c = torch.zeros((4, 4))
    one = torch.tensor(1, dtype=torch.int32)
    assert g.key(p, c, x, one) == g.key(p, c.clone(), x.clone(),
                                        torch.tensor(7, dtype=torch.int32))
    assert g.key(p, c, x, 1) != g.key(p, c, x, 2)  # an int pos is static
    assert g.key({"w": p["w"].clone()}, c, x, one) != g.key(
        {"w": p["w"]}, c, x, one)


def test_key_of_a_partial_holds_its_call_arguments_only():
    """``jit(functools.partial(M.decode_step, cfg=cfg))`` as
    ``serving.generate`` builds it: the bound config is part of the
    function, the call's params, cache, tokens and 0-d position are the
    key's leaves."""
    cfg = get_config("gemma2-2b").reduced()
    step = jit(functools.partial(M.decode_step, cfg=cfg))
    params = M.init_params(cfg, seed=0, device="cpu")
    cache = M.init_cache(cfg, 1, 16, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int32)
    a = step.key(params, cache=cache, inputs=tok,
                 pos=torch.tensor(3, dtype=torch.int32))
    b = step.key(params, cache=M.init_cache(cfg, 1, 16, device="cpu"),
                 inputs=tok + 1, pos=torch.tensor(9, dtype=torch.int32))
    assert a == b
    assert a != step.key(params, cache=M.init_cache(cfg, 1, 32,
                                                    device="cpu"),
                         inputs=tok, pos=torch.tensor(3, dtype=torch.int32))


def _sgd_step(params, opt_state, x):
    """A donated step: the weights and the state are updated in place and
    returned, beside a fresh loss."""
    loss = (x @ params["w"]).sum()
    opt_state["n"].add_(1)
    params["w"].sub_(0.1 * x.sum(0)[:, None])
    return params, opt_state, loss


def test_donated_arguments_are_bound_by_address():
    """``jit(fn, donate=(...))`` binds the donated arguments as it binds
    ``params``: their addresses are in the key (an in-place update keeps
    it, another tensor changes it), while the batch is copied in and keyed
    by its layout; without ``donate`` the state would be copied."""
    p, x = _weights(), torch.randn((3, 4))
    s = {"n": torch.zeros((), dtype=torch.int32)}
    f = jit(_sgd_step, donate=("params", "opt_state"))
    key = f.key(p, s, x)
    s["n"].add_(1)
    p["w"].mul_(2.0)
    assert f.key(p, s, x) == key
    assert f.key(p, {"n": s["n"].clone()}, x) != key
    assert f.key({k: v.clone() for k, v in p.items()}, s, x) != key
    assert f.key(p, dict(s), x.clone()) == key
    g = jit(_sgd_step)
    assert g.key(p, s, x) == g.key(p, {"n": s["n"].clone()}, x)


def test_donate_names_arguments_of_the_function():
    with pytest.raises(ValueError, match="state"):
        jit(_sgd_step, donate=("params", "state"))


def test_jitted_donated_train_step_on_cpu_is_the_step():
    """On CPU arguments the jitted donated train step is the step: three
    steps return the caller's own params and state, updated in place
    (``step == 3``), bit-equal to three bare donated steps on a copy."""
    from repro_torch.launch import steps as ST
    from repro_torch.training.optim import (AdamWConfig, adamw_init,
                                            tree_leaves, tree_map)
    cfg = get_config("mamba2-130m").reduced()
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    b = {"tokens": toks, "labels": toks}
    params = M.init_params(cfg, seed=3, device="cpu")
    mine = tree_map(torch.clone, params)
    step = jit(ST.make_train_step(cfg, opt_cfg, donate=True),
               donate=("params", "opt_state"))
    bare = ST.make_train_step(cfg, opt_cfg, donate=True)
    opt, bare_opt = adamw_init(mine, opt_cfg), adamw_init(params, opt_cfg)
    for _ in range(3):
        p2, o2, loss, _ = step(mine, opt, b)
        assert all(a is w for a, w in zip(tree_leaves((p2, o2)),
                                          tree_leaves((mine, opt))))
        _, _, want, _ = bare(params, bare_opt, b)
        assert float(loss) == float(want)
    assert int(opt.step) == int(bare_opt.step) == 3
    assert (step.captures, step.replays, step.copies) == (0, 0, 0)
    for a, w in zip(tree_leaves((mine, opt)), tree_leaves((params,
                                                           bare_opt))):
        assert torch.equal(a, w)
