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

import ctypes
import re

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
# the probe also at many rows, and at more centers than the width
PROBE_SHAPES = SHAPES + [(13, 700, 64, 7), (2, 5, 16, 40)]
HALF = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
        "float16": (torch.float16, jnp.float16)}


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


@pytest.mark.parametrize("B,S,D,L", PROBE_SHAPES)
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


# ------------------------------- 16-bit activations and outputs vs Pallas
def _half(x, name):
    """The same 16-bit values in both frameworks (both round the float32
    numpy input to nearest even)."""
    tdt, jdt = HALF[name]
    xt, xj = torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)
    _eq(xt.float(), xj.astype(jnp.float32))
    return xt, xj


@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B,S,D,L", SHAPES)
def test_fused_boundary_16_bit_matches_pallas(B, S, D, L, bits, dtype):
    """The Pallas kernel widens x to float32 (``boundary.py:41``); so does
    the port, through its public entry point (the plain version on the
    CPU)."""
    x, c = _inputs(B, S, D, L)
    xt, xj = _half(x, dtype)
    got = fused_boundary(xt, torch.from_numpy(c), bits)
    want = j_fused(xj, jnp.asarray(c), bits, interpret=True)
    for i in range(3):  # payload, scale, zp
        _eq(got[i], want[i])
    for i in (3, 4, 6):  # feat, sep, sims
        _near(got[i], want[i])
    _eq(got[5], want[5])


@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B,S,D,L", SHAPES)
def test_uaq_16_bit_matches_pallas(B, S, D, L, bits, dtype):
    """16-bit activations into ``uaq_quantize`` (``uaq.py:28`` widens
    them) and 16-bit ``out_dtype`` out of ``uaq_dequantize``
    (``uaq.py:60-61`` rounds to it), bit for bit."""
    x, _ = _inputs(B, S, D, L, seed=1)
    xt, xj = _half(x.reshape(B * S, D), dtype)
    got = uaq_quantize(xt, bits)
    want = j_quant(xj, bits, block_m=B * S, interpret=True)
    for g, w in zip(got, want):
        _eq(g, w)
    tdt, jdt = HALF[dtype]
    deq = uaq_dequantize(*got, bits, tdt, n=D)
    assert deq.dtype == tdt
    _eq(deq.float(), j_dequant(*want, bits, out_dtype=jdt, block_m=B * S,
                               interpret=True, n=D).astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("B,S,D,L", PROBE_SHAPES)
def test_semantic_probe_16_bit_matches_pallas(B, S, D, L, dtype):
    x, c = _inputs(B, S, D, L, seed=2)
    xt, xj = _half(x, dtype)
    sep, best, sims = semantic_probe(xt, torch.from_numpy(c))
    want = j_probe(xj, jnp.asarray(c), interpret=True)
    _near(sep, want[0])
    _eq(best, want[1])
    _near(sims, want[2])


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
    for dtype in (torch.bfloat16, torch.float16):
        KB.require(t.to(dtype), "t", KB.ACTIVATION_DTYPES, 2, cpu)
    with pytest.raises(TypeError, match="bfloat16"):
        KB.require(t.double(), "t", KB.ACTIVATION_DTYPES, 2, cpu)
    KB.check_row_width(KB.MAX_ROW)
    with pytest.raises(ValueError):
        KB.check_row_width(KB.MAX_ROW + 8)
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
    assert KB.launch_shape(1, 8, 2304) == (1, 4)  # few rows: 4 warps a row
    assert KB.launch_shape(8, 4096, 2304) == (125, 1)  # 8 x 33 CTAs
    assert KB.launch_shape(300, 8, 2304) == (8, 1)  # a CTA a batch row
    assert KB.launch_shape(300, 8, 4608) == (8, 2)  # wide rows: 2 warps
    assert KB.launch_shape(1, 32768, 2304) == (125, 1)  # 263 CTAs
    assert KB.launch_shape(2, 64, 33) == (1, 4)
    assert KB.MAX_ROW == 9216


def _widths():
    from repro_torch.configs import ARCHS, get_config
    return sorted({get_config(a).d_model for a in ARCHS} | {KB.MAX_ROW})


def test_quantize_warps_depend_on_the_shape_only():
    """K3's warps a row for every config's d_model and the widest row:
    enough that a thread holds at most LANE_CAP elements, and, while the
    grid stays within FEW_WARPS warps, enough that it holds at most
    LANE_FEW (the chain of one row's steps is then the time)."""
    assert KB.quantize_warps(8, 768) == 2  # three-tier relays
    assert KB.quantize_warps(8, 2304) == 8  # serve, gemma2-2b
    assert KB.quantize_warps(8, 4096) == 8  # mixtral-8x7b
    assert KB.quantize_warps(256, 2304) == 4
    assert KB.quantize_warps(1024, 2304) == 1
    assert KB.quantize_warps(32768, 2304) == 1
    assert KB.quantize_warps(32768, KB.MAX_ROW) == 4
    for N in _widths():
        for M in (1, 8, 256, 1024, 1025, 32768):
            warps = KB.quantize_warps(M, N)
            assert warps == KB.quantize_warps(M, N) and warps in (1, 2, 4, 8)
            need = 1  # warps that hold the row
            while 32 * need * KB.LANE_CAP < N:
                need *= 2
            assert warps >= need
            assert warps == need or M * warps <= KB.FEW_WARPS
            assert warps == need or 16 * warps * KB.LANE_FEW < N


def test_probe_and_quantize_take_no_counters_or_workspace():
    """K4 is one cluster launch a batch row: its wrapper asks for no
    arrival counters (the fused boundary's wrapper still does) and its C
    entry point takes no workspace, counters or launch shape (its cluster
    size is fixed); K3's takes its own launch shape."""
    import inspect

    from repro_torch.kernels import boundary, semantic_cache, uaq
    assert "arrival_counters" not in inspect.getsource(semantic_cache)
    assert "arrival_counters" not in inspect.getsource(uaq)
    assert "arrival_counters" in inspect.getsource(boundary)
    src = "".join((KB.CSRC / f).read_text() for f in KB.SOURCES)
    names = {}
    for name, args in re.findall(r'extern "C" int (coach_\w+)\(([^)]*)\)',
                                 src):
        names[name] = [a.split()[-1].lstrip("*") for a in args.split(",")]
    assert names["coach_semantic_probe"] == [
        "x", "centers", "sep", "best", "sims", "B", "S", "D", "L", "dtype",
        "stream"]
    assert names["coach_uaq_quantize"] == [
        "x", "payload", "scale", "zp", "M", "N", "bits", "warps", "dtype",
        "stream"]
    for name in ("coach_semantic_probe", "coach_uaq_quantize"):
        assert not {"ws", "counters", "rows_per_cta", "wpr", "cluster"} & set(
            names[name])


def test_arrival_counters_are_kept_per_stream_and_per_capture(monkeypatch):
    """Outside a capture one zeroed buffer per (device, stream) is reused;
    each CUDA-graph capture gets its own, made inside it, so two graphs
    captured on one stream never share counters; only the newest
    capture's buffer is kept beside the stream's own."""
    state = {"stream": 1, "capture": 0}
    monkeypatch.setattr(KB, "stream_of", lambda t: state["stream"])
    monkeypatch.setattr(KB, "capture_id", lambda s: state["capture"])
    monkeypatch.setattr(KB, "_counters", {})
    t = torch.zeros(1)
    eager = KB.arrival_counters(t, 8)
    assert eager.dtype == torch.int32 and not eager.any()
    assert KB.arrival_counters(t, 8) is eager
    state["capture"] = 5
    first = KB.arrival_counters(t, 8)
    assert first is not eager and KB.arrival_counters(t, 4) is first
    state["capture"] = 6
    second = KB.arrival_counters(t, 8)
    assert second is not first
    assert set(KB._counters[(t.device.index, 1)]) == {0, 6}
    state["capture"] = 0
    assert KB.arrival_counters(t, 8) is eager
    assert KB.arrival_counters(t, 1000).numel() >= 1000  # grown, refilled
    state["stream"] = 2
    assert KB.arrival_counters(t, 8) is not eager


def test_ctypes_signatures_match_the_c_entry_points():
    """A pointer passed as a 32-bit int is cut on the card, and no CPU
    test calls the library: so parse every ``extern "C"`` entry point of
    the sources and hold ``_build``'s ctypes argument types (and dtype
    codes) to it."""
    src = "".join((KB.CSRC / f).read_text()
                  for f in KB.SOURCES + KB.HEADERS)
    found = {}
    for name, args in re.findall(r'extern "C" int (coach_\w+)\(([^)]*)\)',
                                 src):
        kinds = []
        for arg in (" ".join(a.split()) for a in args.split(",")):
            if "*" in arg:
                kinds.append(ctypes.c_void_p)
            else:
                kind = re.fullmatch(r"(int|float) \w+", arg)
                assert kind, arg
                kinds.append(ctypes.c_int if kind.group(1) == "int"
                             else ctypes.c_float)
        found[name] = kinds
    assert found == KB._SIGNATURES
    enum = re.search(r"enum DType \{([^}]*)\}", src).group(1)
    codes = [int(v) for v in re.findall(r"= (\d+)", enum)]
    assert codes == list(KB.DTYPE_CODES.values())
    assert list(KB.DTYPE_CODES) == [torch.float32, torch.bfloat16,
                                    torch.float16]


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
