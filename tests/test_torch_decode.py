"""The port's decode path (``repro_torch.models.model.prefill`` /
``decode_step`` / ``init_cache`` and ``repro_torch.serving.generate``)
against the JAX package on the same weights, twins of
``tests/test_decode.py``: KV ring buffers, SSM state handoff and MoE
decode grouping, for every decode-capable architecture.

Caches are compared leaf by leaf (same tree paths; positions equal,
values within ``TOL``, rtol/atol 1e-4 as the model tests).  Decode against
the port's own full forward uses the reference tests' bounds: max error
relative to the largest logit below 1e-4 for one step, 2e-4 over many.
Weights are the JAX package's ``init_params`` output converted with
``params_from_numpy``; MoE archs run dropless (capacity_factor 100) as in
the reference test, so grouping differences do not bite.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.generate import generate as j_generate  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import generate  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_ARCHS = [a for a in ARCHS if get_config(a).supports_decode]


def _cfg(arch, **over):
    cfg = get_config(arch).reduced(**over)
    if cfg.num_experts:  # dropless so grouping differences don't bite
        cfg = dataclasses.replace(cfg, capacity_factor=100.0)
    return cfg


def _weights(cfg, seed=0):
    jp = jax.tree.map(np.asarray, JM.init_params(cfg,
                                                 jax.random.PRNGKey(seed)))
    return jp, M.params_from_numpy(jp, cfg, "cpu")


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return (rng.standard_normal((B, S, cfg.d_model)) * 0.5
                ).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _rel(out, ref):
    return float((out - ref).abs().max() / (ref.abs().max() + 1e-9))


def _same_cache(cache, jcache):
    """Leaf by leaf: same tree paths and shapes, int leaves (ring
    positions) equal, float leaves within TOL."""
    tl = jax.tree_util.tree_flatten_with_path(jax.tree.map(_np, cache))[0]
    jl = jax.tree_util.tree_flatten_with_path(jax.tree.map(_np, jcache))[0]
    assert [str(p) for p, _ in tl] == [str(p) for p, _ in jl]
    for (path, a), (_, b) in zip(tl, jl):
        assert a.shape == b.shape, path
        if np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=str(path))
        else:
            np.testing.assert_allclose(a, b, **TOL, err_msg=str(path))


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_then_decode_matches_jax_and_forward(arch):
    cfg = _cfg(arch)
    jp, tp = _weights(cfg)
    B, S, MAX = 2, 33, 64
    x = _inputs(cfg, B, S, seed=1)
    _same_cache(M.init_cache(cfg, B, MAX, device="cpu"),
                JM.init_cache(cfg, B, MAX))
    logits_p, cache = M.prefill(tp, cfg, _t(x[:, :-1]), MAX)
    jlogits_p, jcache = JM.prefill(jp, cfg, jnp.asarray(x[:, :-1]), MAX)
    np.testing.assert_allclose(_np(logits_p), _np(jlogits_p), **TOL)
    _same_cache(cache, jcache)
    out, cache2 = M.decode_step(tp, cfg, cache, _t(x[:, -1:]), S - 1)
    jout, jcache2 = JM.decode_step(jp, cfg, jcache, jnp.asarray(x[:, -1:]),
                                   jnp.int32(S - 1))
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    _same_cache(cache2, jcache2)
    _same_cache(cache, jcache)  # the step left its input cache as it was
    h, _, _ = M.forward(tp, cfg, _t(x))
    assert _rel(out, M._lm_head(tp, cfg, h[:, -1])) < 1e-4
    hp, _, _ = M.forward(tp, cfg, _t(x[:, :-1]))
    assert _rel(logits_p, M._lm_head(tp, cfg, hp[:, -1])) < 1e-4


@pytest.mark.parametrize("arch", ["gemma2-2b", "mixtral-8x7b",
                                  "mamba2-130m"])
def test_multi_step_decode(arch):
    """Decode 8 tokens; every step matches the growing forward."""
    cfg = _cfg(arch)
    _, tp = _weights(cfg, seed=1)
    B, S0, MAX = 1, 12, 64
    x = _t(_inputs(cfg, B, S0, seed=2))
    _, cache = M.prefill(tp, cfg, x, MAX)
    toks = x
    rng = np.random.default_rng(3)
    for t in range(8):
        nxt = _t(rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32))
        out, cache = M.decode_step(tp, cfg, cache, nxt, S0 + t)
        toks = torch.cat([toks, nxt], dim=1)
        h, _, _ = M.forward(tp, cfg, toks)
        rel = _rel(out, M._lm_head(tp, cfg, h[:, -1]))
        assert rel < 2e-4, f"{arch} step {t}: rel={rel}"


def test_decode_beyond_sliding_window():
    """Ring buffers stay correct once positions wrap the window."""
    cfg = _cfg("h2o-danube-3-4b", sliding_window=16)
    _, tp = _weights(cfg, seed=2)
    B, S = 1, 40  # 2.5x window
    x = _t(_inputs(cfg, B, S, seed=4))
    cache = M.init_cache(cfg, B, max_seq=S, device="cpu")
    outs = []
    for t in range(S):
        out, cache = M.decode_step(tp, cfg, cache, x[:, t:t + 1], t)
        outs.append(out)
    h, _, _ = M.forward(tp, cfg, x)
    ref = M._lm_head(tp, cfg, h)
    for t in (20, 30, 39):  # all beyond the window
        rel = _rel(outs[t], ref[:, t])
        assert rel < 2e-4, f"pos {t}: rel={rel}"


def test_gemma2_ring_prefill_and_decode_past_the_window_match_jax():
    """A prompt longer than gemma2's reduced sliding window of 64 with a
    longer max_seq fills the local layers' cache in ring order
    (``prefill_to_cache``'s second branch); 16 steps then decode past the
    window.  Caches and logits match the JAX package at every step."""
    cfg = _cfg("gemma2-2b")
    jp, tp = _weights(cfg, seed=3)
    B, S0, MAX = 1, 70, 90
    x = _inputs(cfg, B, S0 + 16, seed=5)
    _, cache = M.prefill(tp, cfg, _t(x[:, :S0]), MAX)
    _, jcache = JM.prefill(jp, cfg, jnp.asarray(x[:, :S0]), MAX)
    assert cache[0]["k"].shape[2] == cfg.sliding_window  # the local layer
    _same_cache(cache, jcache)
    jstep = jax.jit(functools.partial(JM.decode_step, cfg=cfg))
    for t in range(S0, S0 + 16):
        out, cache = M.decode_step(tp, cfg, cache, _t(x[:, t:t + 1]), t)
        jout, jcache = jstep(jp, cache=jcache, inputs=jnp.asarray(
            x[:, t:t + 1]), pos=jnp.int32(t))
        np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    _same_cache(cache, jcache)
    h, _, _ = M.forward(tp, cfg, _t(x))
    assert _rel(out, M._lm_head(tp, cfg, h[:, -1])) < 2e-4


@pytest.mark.parametrize("arch,S0,MAX", [
    ("gemma2-2b", 70, 90),  # a ring cache, decoded past its window
    ("h2o-danube-3-4b", 20, 40), ("mixtral-8x7b", 12, 24),
    ("mamba2-130m", 12, 24), ("jamba-1.5-large-398b", 12, 24)])
def test_decode_with_a_tensor_position_equals_the_int_form_and_jax(arch, S0,
                                                                   MAX):
    """``decode_step`` with ``pos`` a 0-d int32 tensor (as
    ``serving.generate`` passes it to the jitted step, and as the
    reference's ``pos=jnp.int32(...)`` is traced) gives the int form's
    logits and cache bit for bit, and the JAX package's jitted step's
    within ``TOL``, at every one of 8 steps."""
    over = {"sliding_window": 16} if arch.startswith("h2o") else {}
    cfg = _cfg(arch, **over)
    jp, tp = _weights(cfg, seed=4)
    x = _inputs(cfg, 1, S0 + 8, seed=9)
    _, cache = M.prefill(tp, cfg, _t(x[:, :S0]), MAX)
    _, jcache = JM.prefill(jp, cfg, jnp.asarray(x[:, :S0]), MAX)
    tcache = cache
    jstep = jax.jit(functools.partial(JM.decode_step, cfg=cfg))
    for t in range(S0, S0 + 8):
        tok = _t(x[:, t:t + 1])
        out, cache = M.decode_step(tp, cfg, cache, tok, t)
        tout, tcache = M.decode_step(tp, cfg, tcache, tok,
                                     torch.tensor(t, dtype=torch.int32))
        jout, jcache = jstep(jp, cache=jcache, inputs=jnp.asarray(
            x[:, t:t + 1]), pos=jnp.int32(t))
        assert torch.equal(tout, out)
        for a, b in zip(jax.tree.leaves(jax.tree.map(_np, tcache)),
                        jax.tree.leaves(jax.tree.map(_np, cache))):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(_np(tout), _np(jout), **TOL)
    _same_cache(tcache, jcache)


def test_greedy_generate_matches_jax_and_full_forward():
    """Greedy continuation == the JAX package's tokens == argmax over
    fresh full forwards at every step."""
    cfg = get_config("qwen3-14b").reduced()
    jp, tp = _weights(cfg, seed=7)
    prompt = _inputs(cfg, 2, 9, seed=6)
    out = generate(tp, cfg, _t(prompt), max_new_tokens=6, max_seq=32,
                   device="cpu")
    assert out.shape == (2, 15) and out.dtype == torch.int32
    jout = j_generate(jax.tree.map(jnp.asarray, jp), cfg,
                      jnp.asarray(prompt), max_new_tokens=6, max_seq=32)
    np.testing.assert_array_equal(_np(out), np.asarray(jout))
    toks = _t(prompt)
    for _ in range(6):
        h, _, _ = M.forward(tp, cfg, toks)
        nxt = torch.argmax(M._lm_head(tp, cfg, h[:, -1]), -1)[:, None]
        toks = torch.cat([toks, nxt.to(toks.dtype)], dim=1)
    assert torch.equal(out, toks)


def test_generate_samples_with_the_callers_generator(monkeypatch):
    cfg = get_config("gemma2-2b").reduced()
    tp = M.init_params(cfg, seed=0, device="cpu")
    prompt = _t(_inputs(cfg, 2, 5, seed=8))

    def sample(seed):
        return generate(tp, cfg, prompt, 4, temperature=1.0,
                        generator=torch.Generator().manual_seed(seed),
                        device="cpu")

    a, b = sample(0), sample(0)
    assert torch.equal(a, b) and a.shape == (2, 9)
    assert torch.equal(a[:, :5], prompt)
    assert bool(((a >= 0) & (a < cfg.vocab_size)).all())
    with pytest.raises(ValueError, match="Generator"):
        generate(tp, cfg, prompt, 4, temperature=1.0, device="cpu")
    assert torch.equal(generate(tp, cfg, prompt, 0, device="cpu"), prompt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(tp, cfg, prompt, 4)
