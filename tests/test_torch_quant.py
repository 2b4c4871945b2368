"""The port's UAQ helpers (``repro_torch.core.quant``): twins of the JAX
package's ``tests/test_quant.py`` (same hypothesis settings), and the same
numpy inputs through both packages.

Tolerances: scale, zp and roundtrip rtol 1e-6, quant_error rel 1e-5
(float32 division and norms in another library); codes within one level, and
equal in all but a handful of elements (a quotient x / scale + zp within
an ulp of .5 may round either way); the measured oracle's losses within
1e-6 (accuracies over 200 samples, a count apart is 0.005).
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quant as JQ  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402


def _normal(seed, shape, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        shape) * scale).astype(np.float32))


@given(st.integers(0, 10_000))
@settings(max_examples=25, deadline=None)
def test_roundtrip_error_halves_per_bit(seed):
    x = _normal(seed, (64, 64))
    errs = [Q.quant_error(x, b) for b in (3, 4, 5, 6, 8)]
    for a, b in zip(errs, errs[1:]):
        assert b < a * 0.75  # geometric decay


def test_quantize_within_levels():
    x = _normal(0, (32, 32), 5.0)
    for bits in (3, 4, 5, 8):
        q, s, z = Q.uaq_quantize(x, bits)
        assert int(q.max()) <= (1 << bits) - 1
        assert int(q.min()) >= 0


def test_per_axis_params():
    x = torch.stack([torch.linspace(0, 10, 8), torch.linspace(0, 0.1, 8)])
    s, z = Q.uaq_params(x, 8, axis=0)
    assert s.shape == (2, 1)
    assert float(s[0, 0]) != float(s[1, 0])


def test_packed_bytes():
    assert Q.packed_bytes(1000, 4) == 508
    assert Q.packed_bytes(1000, 3) == 383
    assert Q.packed_bytes(1000, 8) == 1008


def _oracle_inputs():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((16, 5)).astype(np.float32)
    feats = (rng.standard_normal((200, 16)) * 3).astype(np.float32)
    return w, feats, np.argmax(feats @ w, -1)


def test_measured_oracle_monotone():
    """Accuracy loss measured through a real head decreases with bits."""
    w, feats, labels = (torch.from_numpy(a) for a in _oracle_inputs())
    tail = lambda x: x @ w  # noqa: E731
    base = float(torch.mean((torch.argmax(tail(feats), -1) == labels)
                            .to(torch.float32)))
    oracle = Q.measured_acc_oracle(tail, feats, labels, base)
    losses = [oracle(b) for b in (2, 3, 4, 6, 8)]
    assert losses[0] >= losses[-1]
    assert losses[-1] <= 0.01


# ------------------------------------------------------- across packages
@pytest.mark.parametrize("axis", [None, 0, 1, -1])
@pytest.mark.parametrize("bits", [3, 4, 5, 8, 12])
def test_same_inputs_same_quantization_as_jax(bits, axis):
    xn = (np.random.default_rng(bits).standard_normal((48, 40)) * 2.5
          + 0.7).astype(np.float32)
    x = torch.from_numpy(xn)
    s, z = Q.uaq_params(x, bits, axis)
    js, jz = JQ.uaq_params(jnp.asarray(xn), bits, axis)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-6)
    q, _, _ = Q.uaq_quantize(x, bits, axis)
    jq, _, _ = JQ.uaq_quantize(jnp.asarray(xn), bits, axis)
    assert q.numpy().dtype == np.asarray(jq).dtype
    d = np.abs(q.numpy().astype(np.int64) - np.asarray(jq).astype(np.int64))
    assert d.max() <= 1 and (d > 0).sum() <= 4
    np.testing.assert_allclose(
        Q.uaq_roundtrip(x, bits, axis).numpy(),
        np.asarray(JQ.uaq_roundtrip(jnp.asarray(xn), bits, axis)),
        rtol=1e-6, atol=float(np.asarray(js).max()) * 1.001)
    if axis is None:
        assert Q.quant_error(x, bits) == pytest.approx(
            JQ.quant_error(jnp.asarray(xn), bits), rel=1e-5)


def test_measured_oracle_matches_jax():
    w, feats, labels = _oracle_inputs()
    tw, tf, tl = (torch.from_numpy(a) for a in (w, feats, labels))
    base = float(np.mean(np.argmax(feats @ w, -1) == labels))
    got = Q.measured_acc_oracle(lambda x: x @ tw, tf, tl, base)
    want = JQ.measured_acc_oracle(lambda x: x @ jnp.asarray(w),
                                  jnp.asarray(feats), jnp.asarray(labels),
                                  base)
    # accuracies are counts over 200 (steps of 0.005), taken as float32
    # means summed in another order
    assert [got(b) for b in (2, 3, 4, 6, 8)] == pytest.approx(
        [want(b) for b in (2, 3, 4, 6, 8)], abs=1e-6)
