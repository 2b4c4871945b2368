"""The port's checkpoint IO (``repro_torch.checkpoint``): twins of the JAX
package's ``tests/test_checkpoint.py``, and the on-disk format shared with
it: a checkpoint written by either package (float32 and bfloat16
parameters, and an ``AdamWState``) loads into the other bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as JCK  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import optim as JO  # noqa: E402
from repro_torch.checkpoint import (latest_step, load_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.training import optim as O  # noqa: E402
from repro_torch.training.optim import tree_leaves, tree_map  # noqa: E402


def _equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_roundtrip_model_params(tmp_path):
    cfg = get_config("gemma2-2b").reduced()
    params = M.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    save_checkpoint(str(tmp_path), 7, params)
    assert latest_step(str(tmp_path)) == 7
    like = tree_map(torch.zeros_like, params)
    restored = load_checkpoint(str(tmp_path), 7, like)
    assert _equal(params, restored)
    assert tree_leaves(restored)[0].dtype == torch.bfloat16


def test_multiple_steps_and_overwrite(tmp_path):
    tree = {"a": torch.arange(5.0), "b": (torch.ones((2, 2)),)}
    save_checkpoint(str(tmp_path), 1, tree)
    save_checkpoint(str(tmp_path), 2, tree_map(lambda x: x * 2, tree))
    assert latest_step(str(tmp_path)) == 2
    r = load_checkpoint(str(tmp_path), 2, tree)
    np.testing.assert_allclose(r["a"].numpy(), np.arange(5.0) * 2)
    # overwrite same step
    save_checkpoint(str(tmp_path), 2, tree)
    r = load_checkpoint(str(tmp_path), 2, tree)
    np.testing.assert_allclose(r["a"].numpy(), np.arange(5.0))
    assert latest_step(str(tmp_path / "missing")) is None


def _states(dtype):
    """The same params and a stepped AdamWState in both packages."""
    cfg = get_config("gemma2-2b").reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(0), dtype=dtype)
    jcfg = JO.AdamWConfig(warmup_steps=1, total_steps=10)
    grads = jax.tree.map(lambda p: (p * 0.5 + 0.01).astype(p.dtype), jp)
    js = JO.adamw_init(jp, jcfg)
    _, js = JO.adamw_update(grads, js, jp, jcfg)
    tp = M.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    ts = O.AdamWState(
        step=torch.tensor(int(js.step), dtype=torch.int32),
        m=M.params_from_numpy(jax.tree.map(np.asarray, js.m), cfg, "cpu"),
        v=M.params_from_numpy(jax.tree.map(np.asarray, js.v), cfg, "cpu"))
    return {"params": jp, "opt": js}, {"params": tp, "opt": ts}


def _same_as_jax(t, j):
    jl = jax.tree.leaves(j)
    tl = tree_leaves(t)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        b = np.asarray(b)
        if b.dtype == jnp.bfloat16:
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                a.view(torch.int16).numpy().view(np.uint16),
                b.view(np.uint16))
        else:
            assert a.numpy().dtype == b.dtype
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_loads_into_the_port_and_back(tmp_path, dtype):
    """Params (in ``dtype``) and an AdamWState written by the JAX package
    load bit-equal into the port's trees; written back by the port, they
    load bit-equal into the JAX package's."""
    jtree, ttree = _states(getattr(jnp, dtype))
    JCK.save_checkpoint(str(tmp_path / "j"), 3, jtree)
    like = tree_map(torch.zeros_like, ttree)
    got = load_checkpoint(str(tmp_path / "j"), 3, like)
    _same_as_jax(got["params"], jtree["params"])
    assert isinstance(got["opt"], O.AdamWState)
    _same_as_jax(got["opt"], jtree["opt"])
    assert _equal(got, ttree)
    save_checkpoint(str(tmp_path / "t"), 4, got)
    back = JCK.load_checkpoint(str(tmp_path / "t"), 4,
                               jax.tree.map(jnp.zeros_like, jtree))
    ok = jax.tree.map(lambda a, b: a.dtype == b.dtype and bool(
        jnp.array_equal(a, b)), back, jtree)
    assert all(jax.tree.leaves(ok))
    assert JCK.latest_step(str(tmp_path / "t")) == latest_step(
        str(tmp_path / "t")) == 4
