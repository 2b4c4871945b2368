"""The port's Mamba2/SSD mixer (``repro_torch.models.ssm``) against the JAX
package and against the sequential recurrence, twins of
``tests/test_ssm.py``: the chunked dual form for several chunk sizes
(padded when S % Q != 0), the state handoff, the full block with its
prefill cache, and token-by-token decode against the full forward.

Inputs and weights come from numpy seeds (weights: the JAX package's
``init_mamba`` output as numpy).  Tolerances are the reference tests':
rtol/atol 2e-4 for the scan, 3e-4 for decode against the forward (fp32,
the recurrence summed in another order), ``TOL`` (1e-4) for one block
across packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402

SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=3e-4, atol=3e-4)
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(chunk=8):
    return get_config("mamba2-130m").reduced(ssm_chunk=chunk)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def _ssd_inputs(cfg, B, S, seed):
    """x, dt, A, Bm, Cm as in tests/test_ssm.py, from a numpy seed."""
    rng = np.random.default_rng(seed)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    f = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(f)
    Bm = (rng.standard_normal((B, S, 1, N)) * 0.5).astype(f)
    Cm = (rng.standard_normal((B, S, 1, N)) * 0.5).astype(f)
    return x, dt, A, Bm, Cm


def _sequential_ssd(x, dt, A, Bm, Cm, h0=None):
    """Reference: step-by-step recurrence h' = h*exp(dt*A) + dt*B x."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    rep = H // Bm.shape[2]
    Bh, Ch = np.repeat(Bm, rep, 2), np.repeat(Cm, rep, 2)
    h = np.zeros((Bsz, H, P, N)) if h0 is None else np.array(h0)
    ys = np.zeros((Bsz, S, H, P))
    for t in range(S):
        dA = np.exp(dt[:, t] * A)  # (B,H)
        dBx = np.einsum("bh,bhn,bhp->bhpn", dt[:, t], Bh[:, t], x[:, t])
        h = h * dA[..., None, None] + dBx
        ys[:, t] = np.einsum("bhn,bhpn->bhp", Ch[:, t], h)
    return ys, h


def _mamba_params(cfg, seed):
    jp = jax.tree.map(np.asarray, JSSM.init_mamba(cfg,
                                                  jax.random.PRNGKey(seed)))
    return jp, {k: _t(v) for k, v in jp.items()}


@pytest.mark.parametrize("S,chunk", [(16, 8), (24, 8), (7, 8), (32, 4)])
def test_ssd_chunked_matches_jax_and_sequential(S, chunk):
    cfg = _cfg(chunk)
    args = _ssd_inputs(cfg, 2, S, seed=S * chunk)
    y, hT = SSM.ssd_chunked(cfg, *map(_t, args))
    jy, jhT = JSSM.ssd_chunked(cfg, *map(jnp.asarray, args))
    y_ref, h_ref = _sequential_ssd(*args)
    assert y.shape == (2, S, cfg.ssm_heads, cfg.ssm_head_dim)
    for got, want in ((y, jy), (hT, jhT), (y, y_ref), (hT, h_ref)):
        _close(got, want, SCAN_TOL)


def test_ssd_state_handoff():
    """Running [0:S1] then [S1:S] with the carried state == one pass, and
    the second half from a given state matches the JAX package."""
    cfg = _cfg(4)
    S, S1 = 16, 8
    x, dt, A, Bm, Cm = map(_t, _ssd_inputs(cfg, 2, S, seed=5))
    y_full, h_full = SSM.ssd_chunked(cfg, x, dt, A, Bm, Cm)
    y1, h1 = SSM.ssd_chunked(cfg, x[:, :S1], dt[:, :S1], A, Bm[:, :S1],
                             Cm[:, :S1])
    tail = (x[:, S1:], dt[:, S1:], A, Bm[:, S1:], Cm[:, S1:])
    y2, h2 = SSM.ssd_chunked(cfg, *tail, h0=h1)
    _close(torch.cat([y1, y2], 1), y_full, SCAN_TOL)
    _close(h2, h_full, SCAN_TOL)
    jy2, jh2 = JSSM.ssd_chunked(cfg, *(jnp.asarray(_np(t)) for t in tail),
                                h0=jnp.asarray(_np(h1)))
    _close(y2, jy2, SCAN_TOL)
    _close(h2, jh2, SCAN_TOL)


def test_segsum_decay_masks_before_exp():
    """Steep decays would overflow exp above the diagonal if the mask came
    after it (inf * 0 = nan); both packages give 0 there."""
    cum = np.cumsum(-np.linspace(50.0, 400.0, 2 * 8 * 3).reshape(2, 8, 3),
                    axis=1).astype(np.float32)
    got = SSM._segsum_decay(_t(cum))
    assert bool(torch.isfinite(got).all())
    assert bool((torch.triu(got, diagonal=1) == 0).all())
    # XLA flushes subnormal results to 0 on the CPU: atol below 2**-126
    _close(got, JSSM._segsum_decay(jnp.asarray(cum)), dict(rtol=1e-5,
                                                           atol=1e-38))


def test_mamba_forward_and_prefill_cache_match_jax():
    cfg = _cfg(8)
    jp, tp = _mamba_params(cfg, 3)
    x = (np.random.default_rng(4).standard_normal((2, 13, cfg.d_model))
         * 0.5).astype(np.float32)
    y, cache = SSM.mamba_forward(tp, _t(x), cfg, return_cache=True)
    jy, jcache = JSSM.mamba_forward(jp, jnp.asarray(x), cfg,
                                    return_cache=True)
    _close(y, jy, TOL)
    _close(cache["state"], jcache["state"], TOL)
    for k in ("x", "B", "C"):
        _close(cache["conv"][k], jcache["conv"][k], TOL)
    # fewer steps than the conv window: the tail is left-padded
    _, short = SSM.mamba_forward(tp, _t(x[:, :2]), cfg, return_cache=True)
    assert short["conv"]["x"].shape[1] == cfg.ssm_conv - 1
    assert bool((short["conv"]["x"][:, 0] == 0).all())


@pytest.mark.parametrize("seed,S", [(0, 3), (1, 9), (2, 24)])
def test_mamba_decode_matches_forward(seed, S):
    """Token-by-token decode reproduces the full forward pass, and each
    step matches the JAX package's decode."""
    cfg = _cfg(8)
    jp, tp = _mamba_params(cfg, seed)
    x = (np.random.default_rng(seed + 10).standard_normal(
        (2, S, cfg.d_model)) * 0.5).astype(np.float32)
    y_full = SSM.mamba_forward(tp, _t(x), cfg)
    cache = SSM.init_mamba_cache(cfg, 2, torch.float32, "cpu")
    jcache = JSSM.init_mamba_cache(cfg, 2)
    ys = []
    for t in range(S):
        y, cache = SSM.mamba_decode(tp, _t(x[:, t:t + 1]), cache, cfg)
        jy, jcache = JSSM.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                       jcache, cfg)
        _close(y, jy, TOL)
        ys.append(y)
    _close(torch.cat(ys, dim=1), y_full, DECODE_TOL)
    _close(cache["state"], jcache["state"], TOL)


def test_mamba_prefill_cache_continues_decode():
    cfg = _cfg(8)
    _, tp = _mamba_params(cfg, 11)
    x = _t((np.random.default_rng(11).standard_normal((2, 13, cfg.d_model))
            * 0.5).astype(np.float32))
    y_full = SSM.mamba_forward(tp, x, cfg)
    _, cache = SSM.mamba_forward(tp, x[:, :9], cfg, return_cache=True)
    before = {k: v.clone() for k, v in cache["conv"].items()}
    y = None
    for t in range(9, 13):
        y, new = SSM.mamba_decode(tp, x[:, t:t + 1], cache, cfg)
        if t == 9:  # decode returns a new cache and leaves its input be
            for k, v in before.items():
                assert torch.equal(cache["conv"][k], v)
        cache = new
    _close(y[:, 0], y_full[:, -1], DECODE_TOL)


def test_init_mamba_mirrors_the_jax_tree():
    cfg = _cfg(8)
    jp, _ = _mamba_params(cfg, 0)
    gen = torch.Generator().manual_seed(0)
    tp = SSM.init_mamba(cfg, gen, torch.float32, "cpu", lead=(3,))
    assert sorted(tp) == sorted(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == (3,) + v.shape, k
        assert tp[k].dtype == torch.float32
    for k in ("A_log", "D", "conv_bx", "norm_scale"):
        _close(tp[k][1], jp[k], dict(rtol=1e-6, atol=0))
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert bool(((dt >= 1e-3 * 0.999) & (dt <= 0.1 * 1.001)).all())
    assert SSM.conv_dim(cfg) == JSSM.conv_dim(cfg)


@pytest.mark.parametrize("S", [8, 13])
def test_ssd_chunked_repeats_b_and_c_once_each_as_jax(monkeypatch, S):
    """The scan repeats the B and C streams over the heads once each, as
    the reference's two ``jnp.repeat`` calls do, and gives its values."""
    cfg = _cfg()
    args = _ssd_inputs(cfg, 2, S, seed=5)
    calls = {"torch": 0, "jax": 0}
    t_rep, j_rep = torch.repeat_interleave, jnp.repeat

    def t_count(*a, **k):
        calls["torch"] += 1
        return t_rep(*a, **k)

    def j_count(*a, **k):
        calls["jax"] += 1
        return j_rep(*a, **k)

    monkeypatch.setattr(torch, "repeat_interleave", t_count)
    monkeypatch.setattr(jnp, "repeat", j_count)
    y, hT = SSM.ssd_chunked(cfg, *map(_t, args))
    jy, jhT = JSSM.ssd_chunked(cfg, *map(jnp.asarray, args))
    assert calls == {"torch": 2, "jax": 2}
    _close(y, jy, SCAN_TOL)
    _close(hT, jhT, SCAN_TOL)


def test_reduced_mamba_forward_dispatches_447_ops():
    """A reduced mamba2-130m forward (2 layers, tokens (1, 8)) dispatches
    447 aten ops: the count of the scan that repeats C once a layer (one
    ``repeat_interleave`` more a layer dispatched 455)."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import get_config as t_config
    from repro_torch.models import model as TM

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    cfg = t_config("mamba2-130m").reduced()
    assert cfg.num_layers == 2
    params = TM.init_params(cfg, seed=0, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with Count() as count:
        TM.forward(params, cfg, tokens)
    assert sum(count.ops.values()) == 447
