"""The port's model (``repro_torch.models``) against the JAX package on
the same weights: layers one by one (MoE FFN included), then the
full-sequence forward, the MoE aux loss and the head on reduced gemma2-2b,
qwen3-14b, mamba2-130m, mixtral-8x7b, llama4-scout and jamba.

Weights are the JAX package's ``init_params`` output converted with
``params_from_numpy``; other inputs come from numpy seeds.  Tolerance:
fp32 with matmuls, softmax and transcendentals evaluated in another order
by XLA and by torch, ``TOL`` = rtol 1e-4, atol 1e-4 (logits are bounded by
gemma2's softcap of 30; hidden states are O(1) after the final norm).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.config import LayerSpec, ModelConfig  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(**over):
    base = ModelConfig(
        name="t", arch_type="dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=97, head_dim=16,
        sliding_window=8, attn_chunk=8)
    return dataclasses.replace(base, **over)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(a, b, **tol):
    np.testing.assert_allclose(_np(a), _np(b), **(tol or TOL))


def _t(a):
    return torch.from_numpy(np.array(a))


def _conv(tree):
    return jax.tree.map(np.asarray, tree)


def _attn_params(cfg, seed):
    p = _conv(JL.init_attention(cfg, jax.random.PRNGKey(seed)))
    return p, M.params_from_numpy(p, cfg, "cpu")


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


# ----------------------------------------------------------- layers
def test_rms_norm_matches_jax():
    x = _x((2, 5, 64), 0, 3.0)
    scale = _x((64,), 1) + 1.0
    _close(L.rms_norm(_t(x), {"scale": _t(scale)}, 1e-6),
           JL.rms_norm(x, {"scale": scale}, 1e-6), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sections", [None, (2, 3, 3)])
def test_rope_angles_and_apply_match_jax(sections):
    pos = np.arange(12, dtype=np.int32)[None].repeat(2, 0)
    cos, sin = L.rope_angles(_t(pos), 16, 10_000.0, sections)
    jcos, jsin = JL.rope_angles(jnp.asarray(pos), 16, 10_000.0, sections)
    _close(cos, jcos, rtol=1e-5, atol=1e-5)
    _close(sin, jsin, rtol=1e-5, atol=1e-5)
    x = _x((2, 12, 3, 16), 2)
    _close(L.apply_rope(_t(x), cos, sin), JL.apply_rope(x, jcos, jsin),
           rtol=1e-5, atol=1e-5)


def test_rope_preserves_norm_and_relative():
    pos = torch.arange(12, dtype=torch.int32)[None]
    cos, sin = L.rope_angles(pos, 16, 10_000.0)
    x = _t(_x((1, 12, 2, 16), 3, 1.0))
    xr = L.apply_rope(x, cos, sin)
    _close(xr.norm(dim=-1), x.norm(dim=-1), rtol=1e-5, atol=0)
    q, k = _t(_x((1, 1, 1, 16), 4, 1.0)), _t(_x((1, 1, 1, 16), 5, 1.0))

    def dot_at(i, j):
        ci, si = L.rope_angles(torch.tensor([[i]], dtype=torch.int32), 16,
                               10_000.0)
        cj, sj = L.rope_angles(torch.tensor([[j]], dtype=torch.int32), 16,
                               10_000.0)
        return float((L.apply_rope(q, ci, si) * L.apply_rope(k, cj, sj)
                      ).sum())
    assert abs(dot_at(5, 3) - dot_at(9, 7)) < 1e-4


def test_mrope_distinct_streams_differ_from_1d():
    pos3 = torch.stack([torch.arange(8), torch.arange(8) * 2,
                        torch.zeros(8, dtype=torch.long)])[:, None, :]
    cos3, _ = L.rope_angles(pos3, 16, 10_000.0, mrope_sections=(2, 3, 3))
    jcos3, _ = JL.rope_angles(jnp.asarray(pos3.numpy(), jnp.int32), 16,
                              10_000.0, mrope_sections=(2, 3, 3))
    _close(cos3, jcos3, rtol=1e-5, atol=1e-5)
    cos1, _ = L.rope_angles(torch.arange(8)[None], 16, 10_000.0)
    assert not torch.allclose(cos3, cos1)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["global", "local", "chunked"])
def test_scores_mask_matches_jax(kind, causal):
    cfg = _cfg()
    spec = LayerSpec(attn_kind=kind)
    pos = np.arange(20, dtype=np.int32)
    np.testing.assert_array_equal(
        _np(L._scores_mask(_t(pos), _t(pos), cfg, spec, causal)),
        np.asarray(JL._scores_mask(jnp.asarray(pos), jnp.asarray(pos), cfg,
                                   spec, causal)))


@pytest.mark.parametrize("over", [
    {}, {"attn_logit_softcap": 5.0}, {"qk_norm": True},
    {"causal": False}, {"num_kv_heads": 4}, {"attn_scale": 0.1},
    {"mrope_sections": (2, 3, 3)}, {"use_rope": False}])
@pytest.mark.parametrize("kind", ["global", "local", "chunked"])
def test_attention_full_matches_jax(kind, over):
    cfg = _cfg(**over)
    spec = LayerSpec(attn_kind=kind)
    jp, tp = _attn_params(cfg, 6)
    x = _x((2, 21, cfg.d_model), 7)
    y, (k, v) = L.attention_full(tp, _t(x), cfg, spec)
    jy, (jk, jv) = JL.attention_full(jp, jnp.asarray(x), cfg, spec)
    _close(y, jy)
    _close(k, jk)
    _close(v, jv)


def test_query_chunked_attention_matches_jax_and_direct(monkeypatch):
    """S > Q_CHUNK takes the query-chunked path in both packages."""
    cfg = _cfg(d_model=32, num_heads=2, num_kv_heads=1, head_dim=16)
    spec = LayerSpec(attn_kind="local")
    jp, tp = _attn_params(cfg, 8)
    x = _x((1, 96, cfg.d_model), 9, 0.2)
    direct, _ = L.attention_full(tp, _t(x), cfg, spec)
    monkeypatch.setattr(L, "Q_CHUNK", 32)
    monkeypatch.setattr(JL, "Q_CHUNK", 32)
    chunked, _ = L.attention_full(tp, _t(x), cfg, spec)
    jchunked, _ = JL.attention_full(jp, jnp.asarray(x), cfg, spec)
    _close(chunked, direct, rtol=2e-4, atol=2e-4)
    _close(chunked, jchunked)


def test_gqa_equals_mha_when_kv_repeated():
    cfg_gqa = _cfg(num_heads=4, num_kv_heads=2)
    _, p = _attn_params(cfg_gqa, 10)
    x = _t(_x((2, 10, cfg_gqa.d_model), 11, 1.0))
    y_gqa, _ = L.attention_full(p, x, cfg_gqa, LayerSpec())
    cfg_mha = _cfg(num_heads=4, num_kv_heads=4)
    hd, d = cfg_gqa.head_dim, cfg_gqa.d_model
    pm = dict(p)
    for w in ("wk", "wv"):
        pm[w] = p[w].reshape(d, 2, hd).repeat_interleave(2, dim=1
                                                         ).reshape(d, 4 * hd)
    y_mha, _ = L.attention_full(pm, x, cfg_mha, LayerSpec())
    _close(y_gqa, y_mha, rtol=2e-4, atol=2e-4)


def test_softcap_bounds_logits():
    cfg = _cfg(attn_logit_softcap=5.0)
    q = _t(_x((1, 4, 4, 16), 12, 100.0))
    k = _t(_x((1, 4, 2, 16), 13, 100.0))
    v = _t(_x((1, 4, 2, 16), 14, 1.0))
    out = L._attend(q, k, v, torch.ones((4, 4), dtype=torch.bool), cfg)
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_jax(act):
    jp = _conv(JL.init_mlp(64, 128, jax.random.PRNGKey(15)))
    tp = M.params_from_numpy(jp, _cfg(), "cpu")
    x = _x((2, 7, 64), 16, 1.0)
    _close(L.mlp(tp, _t(x), act), JL.mlp(jp, jnp.asarray(x), act))


@pytest.mark.parametrize("capacity_factor", [100.0, 0.25])
def test_moe_ffn_matches_jax(capacity_factor):
    """llama4's FFN (top-1 routing and the shared expert) and mixtral's
    (top-2, no shared expert), dropless and with a capacity small enough
    that tokens overflow into the sacrificial slot.  Overflow tokens all
    write slot ``cap`` of the token map, and which write wins differs
    between packages (and on CUDA between runs); the output does not
    depend on it, so y and aux agree."""
    for arch in ("llama4-scout-17b-a16e", "mixtral-8x7b"):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  capacity_factor=capacity_factor)
        jp = _conv(JMOE.init_moe(cfg, jax.random.PRNGKey(18)))
        tp = M.params_from_numpy(jp, cfg, "cpu")
        assert ("shared" in tp) == cfg.shared_expert
        x = _x((3, 32, cfg.d_model), 19, 1.0)
        y, aux = MOE.moe_ffn(tp, _t(x), cfg)
        jy, jaux = JMOE.moe_ffn(jp, jnp.asarray(x), cfg)
        _close(y, jy)
        _close(aux, jaux)
        assert MOE.capacity(32, cfg) == JMOE.capacity(32, cfg)
        # how many (token, choice) pairs each expert was given
        probs = torch.softmax(_t(x) @ tp["router"], dim=-1)
        ids = torch.sort(probs, dim=-1, descending=True, stable=True
                         ).indices[..., :cfg.experts_per_token]
        load = torch.nn.functional.one_hot(ids, cfg.num_experts).sum((1, 2))
        overflow = bool((load > MOE.capacity(32, cfg)).any())
        assert overflow == (capacity_factor < 1.0)


def test_moe_top_k_takes_the_lower_index_on_ties():
    """Equal router probabilities: jax.lax.top_k's order (lower expert
    first) decides the slots, and the port follows it."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              capacity_factor=0.25)
    jp = _conv(JMOE.init_moe(cfg, jax.random.PRNGKey(20)))
    jp["router"] = np.zeros_like(jp["router"])  # every expert ties
    tp = M.params_from_numpy(jp, cfg, "cpu")
    x = _x((2, 16, cfg.d_model), 21, 1.0)
    y, aux = MOE.moe_ffn(tp, _t(x), cfg)
    jy, jaux = JMOE.moe_ffn(jp, jnp.asarray(x), cfg)
    _close(y, jy)
    _close(aux, jaux)


# ------------------------------------------------------ full forward
ARCHS = ["gemma2-2b", "qwen3-14b", "mamba2-130m", "mixtral-8x7b",
         "llama4-scout-17b-a16e", "jamba-1.5-large-398b"]


@pytest.fixture(scope="module", params=ARCHS)
def converted(request):
    cfg = get_config(request.param).reduced()
    jp = _conv(JM.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, jp, M.params_from_numpy(jp, t_get_config(
        request.param).reduced(), "cpu")


def test_forward_and_head_match_jax(converted):
    """S = 96 > gemma2's and mixtral's reduced sliding window of 64, so
    their local layers mask; mamba2's reduced SSD runs 6 chunks of 16; the
    MoE archs' aux loss (summed over layers) matches too."""
    cfg, jp, tp = converted
    toks = np.random.default_rng(17).integers(
        0, cfg.vocab_size, (2, 96)).astype(np.int32)
    h, cache, aux = M.forward(tp, cfg, _t(toks))
    jh, _, jaux = JM.forward(jp, cfg, jnp.asarray(toks))
    assert cache is None
    assert (float(aux) != 0.0) == bool(cfg.num_experts)
    _close(aux, jaux)
    _close(h, jh)
    _close(M._lm_head(tp, cfg, h[:, -1]), JM._lm_head(jp, cfg, jh[:, -1]))


def test_init_params_mirrors_the_jax_tree(converted):
    cfg, jp, _ = converted
    tp = M.init_params(cfg, seed=3, device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))[0]
    assert [str(k) for k, _ in jl] == [str(k) for k, _ in tl]
    assert [v.shape for _, v in jl] == [v.shape for _, v in tl]
    assert all(v.dtype == np.float32 for _, v in tl)
    again = jax.tree.leaves(jax.tree.map(
        lambda t: t.numpy(), M.init_params(cfg, seed=3, device="cpu")))
    assert all(np.array_equal(a, b) for (_, a), b in zip(tl, again))
    assert M.param_count(tp) == JM.param_count(jp)


def test_cuda_entry_points_raise_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.require_device("cuda")
    with pytest.raises(RuntimeError):
        M.init_params(t_get_config("gemma2-2b").reduced())
    assert repro_torch.require_device("cpu").type == "cpu"
