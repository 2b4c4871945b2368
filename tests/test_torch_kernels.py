"""The port's boundary kernels (``repro_torch.kernels``) against the JAX
package: every plain PyTorch version against the interpret-mode Pallas
kernel and the jitted reference on the same numpy inputs, and the CPU
dispatch rules of the wrappers and ``ops``.  The Hopper kernels against
their plain versions on the card: tests/test_torch_gpu.py.

Tolerances: wire fields (payload, scale, zp, dequantized values) are
compared bit for bit.  Probe fields (feat, sims, sep) are fp32 values
summed in another order by XLA and by torch: ``PROBE_TOL`` (atol 1e-5,
rtol 1e-4), the tolerance the JAX package's own probe tests use.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.boundary import fused_boundary as j_fused  # noqa: E402
from repro.kernels.semantic_cache import semantic_probe as j_probe  # noqa: E402
from repro.kernels.uaq import uaq_dequantize as j_dequant  # noqa: E402
from repro.kernels.uaq import uaq_quantize as j_quant  # noqa: E402
from repro_torch.kernels import _build as KB  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.boundary import fused_boundary  # noqa: E402
from repro_torch.kernels.semantic_cache import semantic_probe  # noqa: E402
from repro_torch.kernels.uaq import uaq_dequantize, uaq_quantize  # noqa: E402

PROBE_TOL = dict(atol=1e-5, rtol=1e-4)
SHAPES = [(2, 64, 32, 5), (3, 100, 33, 4), (1, 1, 16, 2)]


def _inputs(B, S, D, L, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, D)) * 2.0 + 0.3).astype(np.float32)
    c = rng.standard_normal((L, D)).astype(np.float32)
    return x, c


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _near(a, b):
    np.testing.assert_allclose(_np(a), _np(b), **PROBE_TOL)


# ---------------------------------- plain versions vs Pallas + jitted ref
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B,S,D,L", SHAPES)
def test_fused_boundary_plain_matches_pallas_and_jitted_ref(B, S, D, L, bits):
    x, c = _inputs(B, S, D, L)
    got = ref.fused_boundary_ref(torch.from_numpy(x), torch.from_numpy(c),
                                 bits)
    pallas = j_fused(jnp.asarray(x), jnp.asarray(c), bits, interpret=True)
    jitted = jax.jit(lambda a, b: JR.fused_boundary_ref(a, b, bits))(x, c)
    assert got[0].shape == (B, S, (D + 1) // 2 if bits == 4 else D)
    for want in (pallas, jitted):
        for i in range(3):  # payload, scale, zp
            _eq(got[i], want[i])
        for i in (3, 4, 6):  # feat, sep, sims
            _near(got[i], want[i])
        _eq(got[5], want[5])  # best


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B,S,D,L", SHAPES)
def test_uaq_plain_matches_pallas_and_jitted_ref(B, S, D, L, bits):
    x, _ = _inputs(B, S, D, L, seed=1)
    x2 = x.reshape(B * S, D)
    got = ref.uaq_quantize_ref(torch.from_numpy(x2), bits)
    pallas = j_quant(jnp.asarray(x2), bits, block_m=B * S, interpret=True)
    jitted = jax.jit(lambda a: JR.uaq_quantize_ref(a, bits))(x2)
    for want in (pallas, jitted):
        for g, w in zip(got, want):
            _eq(g, w)
    p, s, z = (np.array(a) for a in jitted)
    deq = ref.uaq_dequantize_ref(torch.from_numpy(p), torch.from_numpy(s),
                                 torch.from_numpy(z), bits, n=D)
    _eq(deq, j_dequant(jnp.asarray(p), jnp.asarray(s), jnp.asarray(z), bits,
                       block_m=B * S, interpret=True, n=D))
    _eq(deq, jax.jit(lambda a, b, e: JR.uaq_dequantize_ref(
        a, b, e, bits, n=D))(p, s, z))


@pytest.mark.parametrize("B,S,D,L", SHAPES + [(13, 700, 64, 7)])
def test_semantic_probe_plain_matches_pallas_and_jitted_ref(B, S, D, L):
    x, c = _inputs(B, S, D, L, seed=2)
    sep, best, sims = ref.semantic_probe_ref(torch.from_numpy(x),
                                             torch.from_numpy(c))
    for want in (j_probe(jnp.asarray(x), jnp.asarray(c), interpret=True),
                 jax.jit(JR.semantic_probe_ref)(x, c)):
        _near(sep, want[0])
        _eq(best, want[1])
        _near(sims, want[2])


@pytest.mark.parametrize("n", [5, 33, 129])
@pytest.mark.parametrize("bits", [4, 8])
def test_odd_channel_roundtrip_matches_jitted_ref(n, bits):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((8, n)) * 3.0).astype(np.float32)
    got = ref.uaq_quantize_ref(torch.from_numpy(x), bits)
    want = jax.jit(lambda a: JR.uaq_quantize_ref(a, bits))(x)
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(ref.uaq_dequantize_ref(*got, bits, n=n),
        jax.jit(lambda a, b, c: JR.uaq_dequantize_ref(a, b, c, bits, n=n))(
            *want))


@pytest.mark.parametrize("bits", [4, 8])
def test_ragged_rows_match_jitted_ref(bits):
    """M = 300 rows (not a multiple of the Pallas kernel's block): the
    port has no block-multiple restriction."""
    rng = np.random.default_rng(300)
    x = (rng.standard_normal((300, 64)) * 2.0).astype(np.float32)
    got = uaq_quantize(torch.from_numpy(x), bits)
    want = jax.jit(lambda a: JR.uaq_quantize_ref(a, bits))(x)
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(uaq_dequantize(*got, bits), jax.jit(
        lambda a, b, c: JR.uaq_dequantize_ref(a, b, c, bits))(*want))


# ------------------------------------------------ dispatch on the CPU
@pytest.mark.parametrize("bits", [4, 8])
def test_boundary_pass_dispatches_to_exact_ref_on_cpu(bits):
    """Twin of the JAX package's off-TPU dispatch test: on a CPU tensor
    the entry point *is* the plain version, bit for bit, and launches no
    kernel."""
    x, c = _inputs(4, 32, 48, 6, seed=3)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    before = dict(KB.LAUNCHES)
    want = ref.fused_boundary_ref(xt, ct, bits)
    for got in (ops.boundary_pass(xt.clone(), ct, bits),
                ops.boundary_pass(xt.clone(), ct, bits, use_kernel=False),
                fused_boundary(xt, ct, bits)):
        for g, w in zip(got, want):
            _eq(g, w)
    assert dict(KB.LAUNCHES) == before


@pytest.mark.parametrize("n", [5, 33, 129])
@pytest.mark.parametrize("bits", [4, 8])
def test_wire_roundtrip_odd_channels(n, bits):
    """Twin of the JAX package's odd-channel regression: quantize ->
    dequantize through the shared entry points restores the true channel
    count with at most half a quantum of error."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.standard_normal((8, n)) * 3.0)
                         .astype(np.float32))
    for use_kernel in (False, True):
        p, s, z = ops.quantize_activation(x, bits, use_kernel=use_kernel)
        assert p.shape == (8, (n + 1) // 2 if bits == 4 else n)
        y = ops.dequantize_activation(p, s, z, bits, use_kernel=use_kernel,
                                      channels=n)
        assert y.shape == x.shape
        assert bool(((y - x).abs() <= s * 0.5 * (1 + 1e-3)).all())
    w = ops.wire_quantize(x, bits)
    _eq(ops.wire_dequantize(*w, bits, channels=n),
        ops.dequantize_activation(*w, bits, channels=n))


@pytest.mark.parametrize("bits", [3, 5, 6])
def test_non_wire_bits_run_the_plain_version(bits):
    """Bit widths without a packed wire format go to the plain version on
    the tensor's own device, as in the JAX package."""
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((2, 8, 40)).astype(np.float32)
    p, s, z = ops.quantize_activation(torch.from_numpy(x), bits)
    want = jax.jit(lambda a: JR.uaq_quantize_ref(a, bits))(x.reshape(-1, 40))
    _eq(p.reshape(-1, 40), want[0])
    _eq(s.reshape(-1, 1), want[1])
    y = ops.dequantize_activation(p, s, z, bits)
    assert y.shape == (2, 8, 40)
    with pytest.raises(ValueError):
        uaq_quantize(torch.from_numpy(x[0]), bits)


def test_quantize_activation_nd_shapes():
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 3, 5, 16)).astype(np.float32))
    p, s, z = ops.quantize_activation(x, 4)
    assert p.shape == (2, 3, 5, 8) and s.shape == (2, 3, 5, 1)
    y = ops.dequantize_activation(p, s, z, 4)
    assert y.shape == x.shape


def test_probe_cache_on_cpu_is_the_plain_version():
    x, c = _inputs(3, 10, 24, 4, seed=6)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    for g, w in zip(ops.probe_cache(xt, ct), ref.semantic_probe_ref(xt, ct)):
        _eq(g, w)
    for g, w in zip(semantic_probe(xt, ct), ref.semantic_probe_ref(xt, ct)):
        _eq(g, w)


def test_dequantize_rejects_a_width_the_payload_cannot_hold():
    p = torch.zeros((4, 3), dtype=torch.uint8)
    s = torch.ones((4, 1))
    with pytest.raises(ValueError):
        uaq_dequantize(p, s, s, 4, n=7)
    with pytest.raises(ValueError):
        uaq_dequantize(p, s, s, 8, n=2)


def test_require_checks_what_the_kernel_takes():
    cpu = torch.device("cpu")
    t = torch.zeros((4, 6))
    KB.require(t, "t", torch.float32, 2, cpu)
    with pytest.raises(TypeError):
        KB.require(t.double(), "t", torch.float32, 2, cpu)
    with pytest.raises(ValueError):
        KB.require(t, "t", torch.float32, 3, cpu)
    with pytest.raises(ValueError):
        KB.require(t.T, "t", torch.float32, 2, cpu)
    with pytest.raises(ValueError):
        KB.require(t, "t", torch.float32, 2, torch.device("meta"))
    assert KB.on_cpu(t)
    meta = torch.empty((2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_boundary(meta, torch.empty((3, 16), device="meta"), 8)
    with pytest.raises(ValueError, match="CUDA"):
        uaq_quantize(meta[0], 8)


def test_launch_shape_depends_on_the_shape_only():
    assert KB.rows_per_cta(1, 8) == 1
    assert KB.rows_per_cta(8, 4096) == 63  # 528 CTAs of 63 rows
    assert KB.rows_per_cta(300, 8) == 5


def test_build_is_for_sm_90a_without_fast_math(monkeypatch, tmp_path):
    flags = " ".join(KB.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert KB.library_path().parent == KB.BUILD_DIR
    assert KB.BUILD_DIR.parent.name == "kernels"
    assert all((KB.CSRC / s).exists() for s in KB.SOURCES)
    monkeypatch.setattr(KB.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        KB._nvcc()
