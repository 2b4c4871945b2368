"""The port's training path (``repro_torch.training.optim``,
``models.model.forward_train``, ``launch.steps``, ``launch.train``):
twins of the JAX package's ``tests/test_training.py`` and of
``tests/test_smoke_archs.py``'s train-step and prefill tests (every
registered arch, reduced), then the same inputs through both packages.

Tolerances across packages: the optimizer on the same gradients 1e-6
(float32 elementwise arithmetic in the reference's order; ``pow`` and
``cos`` from other libraries), for the params 1e-6 of lr besides (an ulp
of the normalized update times lr); ``cosine_lr`` 1e-6; ``forward_train``'s
loss 1e-5 relative and each gradient leaf 1e-4 relative L2 (float32
forward and backward summed in other orders, on converted weights).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import optim as JO  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.training import optim as O  # noqa: E402
from repro_torch.training.optim import (AdamWConfig, adamw_init,  # noqa: E402
                                        tree_leaves, tree_map)


# ------------------------------------------ twins of tests/test_training.py
def test_cosine_schedule_shape():
    cfg = O.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1)
    lrs = [float(O.cosine_lr(cfg, torch.tensor(s))) for s in
           (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5, abs=1e-6)
    assert lrs[2] == pytest.approx(1.0, abs=1e-2)
    assert lrs[-1] == pytest.approx(0.1, abs=1e-2)
    assert lrs[3] > lrs[4]


def test_adamw_decreases_quadratic():
    cfg = O.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                        weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = O.adamw_init(params, cfg)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state = O.adamw_update(grads, state, params, cfg)
    assert float(params["w"].abs().max()) < 0.2


@pytest.mark.slow
def test_train_loss_decreases():
    _, losses = train("gemma2-2b", smoke=True, steps=40, batch=8, seq=128,
                      lr=3e-3, log_every=100, device="cpu")
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    assert last < first - 0.5, (first, last)


def test_train_checkpoint_resume(tmp_path):
    d = str(tmp_path / "ck")
    train("mamba2-130m", smoke=True, steps=4, batch=2, seq=64,
          ckpt_dir=d, ckpt_every=2, log_every=100, device="cpu")
    from repro_torch.checkpoint import latest_step
    assert latest_step(d) == 4
    # a second run resumes at step 4 of 4: nothing left to train
    _, losses = train("mamba2-130m", smoke=True, steps=4, batch=2, seq=64,
                      ckpt_dir=d, ckpt_every=2, log_every=100, device="cpu")
    assert losses == []


# ---------------------------- twins of tests/test_smoke_archs.py's steps
@pytest.fixture(scope="module", params=sorted(ARCHS))
def arch_setup(request):
    cfg = get_config(request.param).reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    return request.param, cfg, params


def _batch(cfg, B=2, S=32, seed=1):
    rng = np.random.default_rng(seed)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                              .astype(np.int32))
    if cfg.embed_inputs:
        return {"embeds": torch.from_numpy(
            (rng.standard_normal((B, S, cfg.d_model)) * 0.3)
            .astype(np.float32)), "labels": labels}
    return {"tokens": labels, "labels": labels}


def test_one_train_step(arch_setup):
    arch, cfg, params = arch_setup
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = ST.make_train_step(cfg, opt_cfg)
    opt = adamw_init(params, opt_cfg)
    b = _batch(cfg)
    p2, o2, loss, mets = step(params, opt, b)
    assert bool(torch.isfinite(loss))
    # params actually moved
    moved = [float((a - b_).abs().max()) for a, b_ in
             zip(tree_leaves(params), tree_leaves(p2))]
    assert max(moved) > 0


def test_microbatched_step_close_to_full(arch_setup):
    arch, cfg, params = arch_setup
    if cfg.num_experts:  # capacity drops differ between groupings
        cfg = dataclasses.replace(cfg, capacity_factor=100.0)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    b = _batch(cfg, B=4)
    opt = adamw_init(params, opt_cfg)
    _, _, l1, _ = ST.make_train_step(cfg, opt_cfg)(params, opt, b)
    _, _, l2, _ = ST.make_train_step(cfg, opt_cfg, microbatches=2)(
        params, opt, b)
    assert abs(float(l1) - float(l2)) < 5e-2


def test_batch_chunked_prefill_identical():
    """Chunked prefill must return identical logits and caches."""
    cfg = get_config("gemma2-2b").reduced()
    p = M.init_params(cfg, seed=0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 24)).astype(np.int32))
    l1, c1 = ST.make_prefill_step(cfg, 32)(p, x)
    l2, c2 = ST.make_prefill_step(cfg, 32, batch_chunks=2)(p, x)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=2e-5, atol=2e-5)
    for a, b in zip(tree_leaves(c1), tree_leaves(c2)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-5)


def test_donated_step_equals_the_pure_one():
    """``donate=True`` writes the same values into the caller's tensors."""
    cfg = get_config("mamba2-130m").reduced()
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    b = _batch(cfg)
    params = M.init_params(cfg, seed=2, device="cpu")
    p1, o1, l1, _ = ST.make_train_step(cfg, opt_cfg)(
        params, adamw_init(params, opt_cfg), b)
    mine = tree_map(torch.clone, params)
    opt = adamw_init(mine, opt_cfg)
    p2, o2, l2, _ = ST.make_train_step(cfg, opt_cfg, donate=True)(
        mine, opt, b)
    assert all(a is b_ for a, b_ in zip(tree_leaves(p2), tree_leaves(mine)))
    assert all(a is b_ for a, b_ in zip(tree_leaves(o2), tree_leaves(opt)))
    assert int(opt.step) == 1
    assert float(l1) == float(l2)
    for a, b_ in zip(tree_leaves((p1, o1)), tree_leaves((p2, o2))):
        assert torch.equal(a, b_)


# ------------------------------------------------------- across packages
def test_cosine_lr_matches_jax():
    for cfg in (O.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100),
                O.AdamWConfig(lr=1.0, warmup_steps=0, total_steps=7,
                              min_lr_frac=0.0)):
        jcfg = JO.AdamWConfig(**{k: getattr(cfg, k) for k in (
            "lr", "warmup_steps", "total_steps", "min_lr_frac")})
        steps = np.arange(121, dtype=np.int32)
        got = O.cosine_lr(cfg, torch.from_numpy(steps)).numpy()
        want = np.asarray(JO.cosine_lr(jcfg, jnp.asarray(steps)))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_adamw_same_grads_same_params_as_jax():
    """Three steps on the same converted weights and gradients."""
    cfg = j_get_config("gemma2-2b").reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = M.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    jcfg = JO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    tcfg = O.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    js, ts = JO.adamw_init(jp, jcfg), O.adamw_init(tp, tcfg)
    rng = np.random.default_rng(3)
    # op by op, as written (jitted, XLA contracts some products and sums
    # into FMAs, which round once instead of twice)
    update = JO.adamw_update
    for _ in range(3):
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
            np.float32), jax.tree.map(np.asarray, jp))
        jp, js = update(jax.tree.map(jnp.asarray, g), js, jp, jcfg)
        tp, ts = O.adamw_update(M.params_from_numpy(g, cfg, "cpu"), ts, tp,
                                tcfg)
    assert int(ts.step) == int(js.step) == 3
    # moments 1e-6; params 1e-6 of the value and of the step's size (an
    # ulp of the normalized update, ~1e-7, times lr)
    for t, j, atol in ((tp, jp, 1e-6 * tcfg.lr), (ts.m, js.m, 0.0),
                       (ts.v, js.v, 0.0)):
        for a, b in zip(tree_leaves(t), jax.tree.leaves(j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=atol)


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m",
                                  "mixtral-8x7b"])
def test_forward_train_loss_and_grads_match_jax(arch):
    """``forward_train`` (remat on, MoE aux loss in mixtral's) and its
    autograd gradients against ``jax.value_and_grad`` on converted
    weights and the same batch."""
    cfg = j_get_config(arch).reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = M.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    b = _batch(cfg, B=2, S=24, seed=4)
    jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(JM.forward_train, has_aux=True),
                           static_argnums=1)(jp, cfg, jb)
    loss, mets, grads = ST.loss_and_grads(tp, cfg, b)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    for k in ("nll", "aux"):
        assert float(mets[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                               abs=1e-7)
    if cfg.num_experts:
        assert float(mets["aux"]) > 0
    for a, w in zip(tree_leaves(grads), jax.tree.leaves(jg)):
        w = np.asarray(w)
        assert a.shape == w.shape
        err = np.linalg.norm(a.numpy() - w)
        assert err <= 1e-4 * np.linalg.norm(w) + 1e-12, (arch, err)


def test_train_on_cpu_matches_the_jax_launcher(tmp_path):
    """``train(..., device="cpu")``, its step jitted and donated, gives the
    JAX launcher's losses (1e-5 relative, as ``forward_train``'s loss
    across packages) over three steps of the same tokens, from the
    reference's initial weights (saved by the JAX package's checkpoint at
    step 0, which the port's launcher resumes from)."""
    from repro import checkpoint as JCK
    from repro.launch.train import train as j_train
    kw = dict(smoke=True, steps=3, batch=2, seq=32, log_every=100, seed=0)
    jcfg = j_get_config("gemma2-2b").reduced()
    JCK.save_checkpoint(str(tmp_path), 0, JM.init_params(
        jcfg, jax.random.PRNGKey(0)))
    _, want = j_train("gemma2-2b", **kw)
    _, got = train("gemma2-2b", ckpt_dir=str(tmp_path), ckpt_every=100,
                   device="cpu", **kw)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
