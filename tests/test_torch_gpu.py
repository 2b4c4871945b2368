"""The port on a CUDA device: the Hopper kernels against their plain
PyTorch versions, the wrappers' input checks, and the model and runtime
on the card against the CPU.  Every test here is marked ``gpu`` and skips
without a CUDA device.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has the card but no JAX:

  PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: wire fields bit for bit; probe fields ``PROBE_TOL`` (atol
1e-5, rtol 1e-4: the kernel sums GAP and dot products in another order);
model outputs ``TOL`` (rtol/atol 1e-4, fp32 matmuls on another device);
greedy tokens equal except at near-ties of the logits within ``TOL``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS as ALL_ARCHS, get_config  # noqa: E402
from repro_torch.core.collab import CollabRuntime  # noqa: E402
from repro_torch.kernels import _build as KB  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.boundary import fused_boundary  # noqa: E402
from repro_torch.kernels.semantic_cache import semantic_probe  # noqa: E402
from repro_torch.kernels.uaq import uaq_dequantize, uaq_quantize  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import generate  # noqa: E402

PROBE_TOL = dict(atol=1e-5, rtol=1e-4)
TOL = dict(atol=1e-4, rtol=1e-4)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, S, D, L, device, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, D)) * 2.0 + 0.3).astype(np.float32)
    c = rng.standard_normal((L, D)).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(c).to(device)


def _near(a, b, tol=PROBE_TOL):
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **tol)


# the JAX package's test shapes, serve's, and rows that take a group of 2
# and of 4 warps (D = 4608, 9216)
SHAPES = [(2, 64, 32, 5), (3, 100, 33, 4), (1, 1, 16, 2), (1, 8, 2304, 16),
          (13, 700, 64, 7), (2, 16, 4608, 3), (1, 4, 9216, 2)]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B,S,D,L", SHAPES)
def test_kernels_match_plain_versions(cuda, B, S, D, L, bits):
    _check_all_kernels(cuda, B, S, D, L, bits, torch.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B,S,D,L", SHAPES)
def test_kernels_match_plain_versions_in_16_bit(cuda, B, S, D, L, bits,
                                                dtype):
    """The kernels read bfloat16/float16 activations and write 16-bit
    dequantized values, as the Pallas kernels do."""
    _check_all_kernels(cuda, B, S, D, L, bits, dtype)


def _check_all_kernels(cuda, B, S, D, L, bits, dtype):
    x, c = _inputs(B, S, D, L, cuda, seed=B * S)
    x = x.to(dtype)
    before = dict(KB.LAUNCHES)
    got = fused_boundary(x, c, bits)
    want = ref.fused_boundary_ref(x, c, bits)
    for i in range(3):  # payload, scale, zp
        assert torch.equal(got[i], want[i])
    for i in (3, 4, 6):  # feat, sep, sims
        _near(got[i], want[i])
    assert torch.equal(got[5], want[5])
    x2 = x.reshape(B * S, D)
    q = uaq_quantize(x2, bits)
    for g, w in zip(q, ref.uaq_quantize_ref(x2, bits)):
        assert torch.equal(g, w)
    assert torch.equal(uaq_dequantize(*q, bits, dtype, n=D),
                       ref.uaq_dequantize_ref(*q, bits, dtype, n=D))
    sep, best, sims = semantic_probe(x, c)
    wsep, wbest, wsims = ref.semantic_probe_ref(x, c)
    _near(sep, wsep)
    _near(sims, wsims)
    assert torch.equal(best, wbest)
    torch.cuda.synchronize()
    for name in ("fused_boundary", "uaq_quantize", "uaq_dequantize",
                 "semantic_probe"):
        assert KB.LAUNCHES[name] == before.get(name, 0) + 1


def test_ops_route_cuda_tensors_to_the_kernels(cuda):
    x, c = _inputs(2, 8, 48, 3, cuda, seed=1)
    before = dict(KB.LAUNCHES)
    p, s, z = ops.quantize_activation(x, 4)
    ops.dequantize_activation(p, s, z, 4, channels=48)
    ops.boundary_pass(x.clone(), c, 8)
    ops.probe_cache(x, c)
    ops.quantize_activation(x, 5)  # no wire kernel: plain version on cuda
    ops.quantize_activation(x, 8, use_kernel=False)
    torch.cuda.synchronize()
    counts = {k: KB.LAUNCHES[k] - before.get(k, 0) for k in KB.LAUNCHES}
    assert counts == {"uaq_quantize": 1, "uaq_dequantize": 1,
                      "fused_boundary": 1, "semantic_probe": 1}


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x, c = _inputs(2, 8, 48, 3, cuda, seed=2)
    with pytest.raises(TypeError):
        fused_boundary(x.double(), c, 8)
    with pytest.raises(ValueError):
        fused_boundary(x.transpose(0, 1), c, 8)
    with pytest.raises(ValueError):
        fused_boundary(x, c[:, :40].contiguous(), 8)
    with pytest.raises(ValueError):
        fused_boundary(x, c, 5)
    with pytest.raises(ValueError):
        semantic_probe(x, c.cpu())
    with pytest.raises(TypeError):
        uaq_quantize(x.reshape(16, 48).double(), 8)
    with pytest.raises(ValueError):
        fused_boundary(torch.zeros((1, 2, 9224), device=cuda),
                       torch.zeros((2, 9224), device=cuda), 8)
    p, s, z = uaq_quantize(x.reshape(16, 48), 8)
    with pytest.raises(TypeError):
        uaq_dequantize(p, s, z, 8, out_dtype=torch.float64)
    with pytest.raises(ValueError):
        uaq_dequantize(p, s[:8].contiguous(), z, 8)


def test_fused_boundary_is_deterministic_across_calls_and_graph_replays(cuda):
    """feat is summed in a fixed order (no float atomics), and the arrival
    counters the one-launch epilogue uses are back at 0 after every
    launch, also when a captured launch is replayed many times."""
    x, c = _inputs(8, 512, 2304, 16, cuda, seed=7)
    first = fused_boundary(x, c, 4)
    second = fused_boundary(x, c, 4)
    for g, w in zip(first, second):
        assert torch.equal(g, w)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_boundary(x, c, 4)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fused_boundary(x, c, 4)
    for _ in range(50):
        graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(captured, first):
        assert torch.equal(g, w)


@pytest.mark.parametrize("probe", ["fused_boundary", "semantic_probe"])
def test_graphs_captured_on_one_stream_keep_their_own_counters(cuda, probe):
    """Two graphs captured one after the other on the same stream, each
    with a probe launch, replayed in reverse order and then at the same
    time on two streams, each match the plain version: neither starts
    from the other's counters or races on them."""
    # the call, its plain version, and which outputs are probe fields
    fn, plain, near = {
        "fused_boundary": (lambda x, c: fused_boundary(x, c, 8),
                           lambda x, c: ref.fused_boundary_ref(x, c, 8),
                           (3, 4, 6)),
        "semantic_probe": (semantic_probe, ref.semantic_probe_ref, (0, 2)),
    }[probe]
    xs = [_inputs(8, 512, 2304, 16, cuda, seed=s)[0] for s in (8, 9)]
    c = _inputs(1, 1, 2304, 16, cuda, seed=10)[1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(xs[0], c)
    torch.cuda.current_stream().wait_stream(side)
    graphs, outs = [], []
    for x in xs:
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1]):
            outs.append(fn(x, c))
    graphs[1].replay()
    graphs[0].replay()
    other = torch.cuda.Stream()
    for _ in range(10):
        other.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(other):
            graphs[1].replay()
        graphs[0].replay()
        torch.cuda.current_stream().wait_stream(other)
    torch.cuda.synchronize()
    for x, got in zip(xs, outs):
        for i, (g, w) in enumerate(zip(got, plain(x, c))):
            if i in near:
                _near(g, w)
            else:
                assert torch.equal(g, w)


# every registered arch, reduced; jamba at 16 layers for two groups
ARCHS = [(a, {"num_layers": 16} if a.startswith("jamba") else {})
         for a in sorted(ALL_ARCHS)]


@pytest.mark.parametrize("arch,over", ARCHS)
def test_forward_and_runtime_on_card_match_cpu(cuda, arch, over):
    cfg = get_config(arch).reduced(**over)
    params = M.init_params(cfg, seed=0, device="cpu")
    gparams = M.params_from_numpy(
        _as_numpy(params), cfg, cuda)
    rng = np.random.default_rng(3)
    if cfg.embed_inputs:
        toks = torch.from_numpy((rng.standard_normal((2, 96, cfg.d_model))
                                 * 0.5).astype(np.float32))
    else:
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 96)).astype(np.int32))
    h, _, aux = M.forward(params, cfg, toks)
    hg, _, auxg = M.forward(gparams, cfg, toks.to(cuda))
    _near(hg, h, TOL)
    _near(auxg, aux, TOL)
    rt = CollabRuntime(cfg, params, cut_group=1)
    grt = CollabRuntime(cfg, gparams, cut_group=1)
    x = toks[:, :8]
    centers = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (5, cfg.d_model)).astype(np.float32))
    _, probe = rt.end_step_fused(x, centers)
    gpkt, gprobe = grt.end_step_fused(x.to(cuda), centers.to(cuda))
    _near(gprobe.sims, probe.sims)
    _near(grt.monolithic(gparams, x.to(cuda)), rt.monolithic(params, x), TOL)
    logits = grt.cloud_step(gpkt)
    assert logits.shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m"])
def test_generate_on_card_matches_cpu_greedy(cuda, arch):
    """Greedy tokens on the card equal the CPU's, except where the CPU's
    top-2 logits are within ``TOL`` of each other at that step (a
    near-tie either side may win); after the first such step the two
    continuations may differ, so the comparison stops there."""
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=1, device="cpu")
    gparams = M.params_from_numpy(_as_numpy(params), cfg, cuda)
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    out = generate(params, cfg, prompt, 10, device="cpu")
    gout = generate(gparams, cfg, prompt.to(cuda), 10).cpu()
    assert gout.shape == out.shape == (2, 22)
    h, _, _ = M.forward(params, cfg, out)
    logits = M._lm_head(params, cfg, h)
    for b in range(2):
        for t in range(12, 22):
            if gout[b, t] == out[b, t]:
                continue
            top2 = torch.topk(logits[b, t - 1], 2).values
            gap = float(top2[0] - top2[1])
            assert gap <= TOL["atol"] + TOL["rtol"] * float(top2[0].abs()), \
                (arch, b, t, gap)
            break


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_as_numpy(v) for v in tree)
    return tree.numpy()
