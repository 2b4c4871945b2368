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

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS as ALL_ARCHS, get_config  # noqa: E402
from repro_torch.core.collab import CollabRuntime  # noqa: E402
from repro_torch.kernels import _build as KB  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.boundary import fused_boundary  # noqa: E402
from repro_torch.kernels import ssd as SSD  # noqa: E402
from repro_torch.kernels import ssd_proj as PROJ  # noqa: E402
from repro_torch.kernels.semantic_cache import semantic_probe  # noqa: E402
from repro_torch.kernels.uaq import uaq_dequantize, uaq_quantize  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
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
def test_graphs_captured_on_one_stream_keep_their_own_counters(
        cuda, probe, monkeypatch):
    """Two graphs captured one after the other on the same stream, each
    with a probe launch, replayed in reverse order and then at the same
    time on two streams, each match the plain version: neither starts
    from the other's counters or races on them.  The semantic probe has
    no counters (a cluster a batch row): it never asks for them, and its
    replays are bit-equal to an eager call."""
    if probe == "semantic_probe":
        def no_counters(*a):
            raise AssertionError("the semantic probe took arrival counters")
        monkeypatch.setattr(KB, "arrival_counters", no_counters)
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
        if probe == "semantic_probe":
            for g, w in zip(got, fn(x, c)):
                assert torch.equal(g, w)


def _signed_zero_and_nan_rows(M, N, device):
    """Rows whose min or max is a zero of either sign (both signs in one
    row, one alone, all -0.0) and rows holding a NaN, beside plain rows."""
    x = torch.from_numpy(np.random.default_rng(M * N).random(
        (M, N)).astype(np.float32) * 3.0)
    x[0, ::7] = 0.0
    x[0, 3::11] = -0.0
    x[1] = x[1].abs()
    x[1, N // 2] = -0.0
    x[2] = -x[2].abs()
    x[2, N - 1] = 0.0
    x[3, N // 3] = float("nan")
    x[4] = -0.0
    x[5, 0] = float("nan")
    x[5, 1] = 0.0
    return x.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M,N", [(8, 768), (8, 2304), (2048, 2304), (7, 33)])
def test_quantize_on_signed_zeros_and_nan_matches_plain(cuda, M, N, bits,
                                                        dtype):
    """The quantize's min and max order -0.0 below +0.0 and carry a NaN to
    the row's lo and hi: codes and scale are the plain version's bits, zp
    its value (-0.0 == +0.0), and a row holding a NaN gets NaN scale and
    zp and all-zero codes, as torch.amin / clamp / .to(uint8) give.  At
    8 rows (several warps a row), 2048 (one) and an odd width."""
    x = _signed_zero_and_nan_rows(M, N, cuda).to(dtype)
    got = uaq_quantize(x, bits)
    want = ref.uaq_quantize_ref(x, bits)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
    assert bool(torch.isnan(got[1][3]).all() and torch.isnan(got[2][5]).all())
    assert not bool(got[0][3].any())


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M,N", [(8, 2304), (264, 2304), (265, 2304),
                                 (1024, 2304), (1025, 2304), (3000, 768),
                                 (5, 9216), (40, 4608), (33, 4096)])
def test_quantize_paths_match_plain_version(cuda, M, N, bits):
    """The launch shape the wrapper picks and every other one at the same
    rows (1-8 warps a row, where a row fits) give the plain version's
    bits."""
    x = torch.from_numpy((np.random.default_rng(M + N).standard_normal(
        (M, N)) * 2.0 + 0.3).astype(np.float32)).to(cuda)
    want = ref.uaq_quantize_ref(x, bits)
    for g, w in zip(uaq_quantize(x, bits), want):
        assert torch.equal(g, w)
    p, s, z = (torch.empty_like(t) for t in want)
    for w in (1, 2, 4, 8):
        if 32 * w * KB.LANE_CAP < N:
            continue
        KB.check(KB.lib().coach_uaq_quantize(
            x.data_ptr(), p.data_ptr(), s.data_ptr(), z.data_ptr(), M, N,
            bits, w, 0, KB.stream_of(x)), "uaq_quantize")
        torch.cuda.synchronize()
        for g, h in zip((p, s, z), want):
            assert torch.equal(g, h), w


@pytest.mark.parametrize("B,S,D,L", [(1, 8, 2304, 16), (3, 100, 33, 4),
                                     (2, 5, 16, 40), (2, 64, 9216, 3),
                                     (8, 512, 768, 600)])
def test_probe_on_awkward_shapes_matches_plain(cuda, B, S, D, L):
    """Cluster ranks whose slice holds no vector (D = 16), odd widths,
    more centers than threads, and the widest rows give the plain
    version's sims and sep within PROBE_TOL."""
    x, c = _inputs(B, S, D, L, cuda, seed=D + L)
    sep, best, sims = semantic_probe(x, c)
    wsep, wbest, wsims = ref.semantic_probe_ref(x, c)
    _near(sims, wsims)
    _near(sep, wsep)
    assert torch.equal(best, wbest)


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


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m"])
def test_three_tier_runtime_on_card_matches_cpu(cuda, arch, bits):
    """The three-tier (end -> edge -> cloud) runtime at reduced width, four
    groups, cuts (1, 3).  Each hop's packet from the card is the plain
    version's on the same activation bit for bit, and its dequantized
    values lie within a quantum of the CPU run's (the two forwards round
    in other places, so a code may round the other way); the card's last
    segment on the CPU's last packet gives the CPU's logits within
    ``TOL``.  The executor running the card runtime's fused segment
    handles gives ``rt.run``'s logits within 1e-5, and each delivered
    probe matches ``CollabRuntime.probe`` on the same activation."""
    from repro_torch.core.collab import WirePacket
    from repro_torch.core.pipeline import TaskPlan
    from repro_torch.serving import AsyncHopPipeline, VirtualClock
    base = get_config(arch)
    cfg = base.reduced(num_layers=4 * len(base.pattern))
    params = M.init_params(cfg, seed=0, device="cpu")
    gparams = M.params_from_numpy(_as_numpy(params), cfg, cuda)
    rt = CollabRuntime(cfg, params, (1, 3), default_bits=(bits, bits))
    grt = CollabRuntime(cfg, gparams, (1, 3), default_bits=(bits, bits))
    xs = [torch.from_numpy(np.random.default_rng(7 + i).integers(
        0, cfg.vocab_size, (1, 8)).astype(np.int32)) for i in range(3)]
    D = cfg.d_model
    for x in xs:
        logits, pkts = rt.run(x)
        glogits, gpkts = grt.run(x.to(cuda))
        gpkt, gh = grt.segment_step(0, x.to(cuda))
        for k in range(grt.n_hops):
            if k:
                gpkt, gh = grt.segment_step(k, gpkt)
            want = ref.uaq_quantize_ref(gh.cpu().reshape(-1, D), bits)
            for g, w in zip((gpkt.payload, gpkt.scale, gpkt.zp), want):
                assert torch.equal(g.cpu().reshape(w.shape), w)
            assert torch.equal(gpkt.payload, gpkts[k].payload)
            deq = gpkts[k].dequantize().cpu()
            assert bool(((deq - pkts[k].dequantize()).abs()
                         <= pkts[k].scale * 1.001).all())
        last = pkts[-1]
        same = WirePacket(last.payload.to(cuda), last.scale.to(cuda),
                          last.zp.to(cuda), bits, hop=last.hop,
                          channels=last.channels)
        _near(grt.segment_step(grt.n_segments - 1, same), logits, TOL)
        assert glogits.shape == logits.shape
    gen = torch.Generator(device=cuda).manual_seed(2)
    centers = [torch.randn((6, D), generator=gen, device=cuda)
               for _ in range(grt.n_hops)]
    probes, cur = {}, [None]
    handles = [grt.segment_handle(
        k, probe_centers=lambda k=k: centers[k],
        on_probe=lambda k, pr: probes.__setitem__((cur[0], k), pr))
        for k in range(grt.n_segments)]

    def segment_fn(k, idx, payload):
        cur[0] = idx
        return handles[k](payload)

    KB.LAUNCHES.clear()
    pipe = AsyncHopPipeline(2, clock=VirtualClock(), segment_fn=segment_fn)
    pipe.run(lambda i, _a: TaskPlan.multihop((1e-3,) * 3, (1e-3,) * 2)
             .as_sim_plan(2), len(xs), [0.0, 1e-3, 2e-3],
             payloads=[x.to(cuda) for x in xs])
    assert KB.LAUNCHES["fused_boundary"] == 2 * len(xs)
    assert KB.LAUNCHES["uaq_dequantize"] == 2 * len(xs)
    for i, x in enumerate(xs):
        want, _ = grt.run(x.to(cuda))
        _near(pipe.outputs[i], want, dict(atol=1e-5, rtol=1e-5))
        pkt, h = grt.segment_step(0, x.to(cuda))
        for k in range(grt.n_hops):
            if k:
                pkt, h = grt.segment_step(k, pkt)
            sep, best, sims = grt.probe(h, centers[k])
            _near(probes[(i, k)].sims, sims)
            _near(probes[(i, k)].sep, sep)
            _near(probes[(i, k)].feat, h.mean(dim=1))


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


# ------------------------------------------------ NaN through K1 and K4
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B,S,N", [(4, 2, 768), (4, 2, 2304),
                                   (1024, 2, 2304), (7, 1, 33), (1, 8, 2304),
                                   (1, 6, 16)])
def test_fused_boundary_on_signed_zeros_and_nan_matches_plain(cuda, B, S, N,
                                                              bits, dtype):
    """K1's twin of the quantize's test: the same rows, as (B, S, N)
    tokens.  Codes and scale are the plain version's bits, zp its value
    (-0.0 == +0.0), and a row holding a NaN gets NaN scale and zp and
    all-zero codes; the feature, sims and sep of a batch row that holds a
    NaN are NaN where the plain version's are, its ``best`` the plain
    version's (the first NaN sim), and the other rows' probe fields within
    PROBE_TOL.  Rows of several warps, of one, of the scalar path, serve's
    shape and the smallest."""
    x = _signed_zero_and_nan_rows(B * S, N, cuda).to(dtype).reshape(B, S, N)
    c = _inputs(1, 1, N, 5, cuda, seed=N)[1]
    got = fused_boundary(x, c, bits)
    want = ref.fused_boundary_ref(x, c, bits)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(torch.isnan(g), torch.isnan(w)), i
        if i in (3, 4, 6):  # feat, sep, sims
            _near(torch.nan_to_num(g), torch.nan_to_num(w))
        else:
            assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w)), i
    scale = got[1].reshape(-1)
    assert bool(torch.isnan(scale[3]) and torch.isnan(scale[5]))
    assert not bool(got[0].reshape(B * S, -1)[3].any())


def _nan_cases(D, L, device):
    """(x, centers) pairs: a center holding a NaN, two such centers (the
    first NaN index wins), a NaN center past the first 32, and a token
    holding a NaN (every sim of its batch row NaN)."""
    x, c = _inputs(3, 8, D, L, device, seed=D + L)
    cases = []
    for rows in ((2,), (4, 1), (L - 1,)):
        cc = c.clone()
        for r in rows:
            cc[r, r % D] = float("nan")
        cases.append((x, cc))
    xx = x.clone()
    xx[1, 3, D // 2] = float("nan")
    cases.append((xx, c))
    return cases


@pytest.mark.parametrize("probe", ["fused_boundary", "semantic_probe"])
@pytest.mark.parametrize("D,L", [(2304, 40), (768, 16), (33, 37), (16, 5)])
def test_nan_center_or_feature_picks_best_as_plain(cuda, probe, D, L):
    """``best`` is torch.argmax's (the first NaN sim is the max) and sep
    and sims are NaN where the plain version's are, else within
    PROBE_TOL."""
    fn, plain, at = {
        "fused_boundary": (lambda x, c: fused_boundary(x, c, 8),
                           lambda x, c: ref.fused_boundary_ref(x, c, 8),
                           (4, 5, 6)),
        "semantic_probe": (semantic_probe, ref.semantic_probe_ref,
                           (0, 1, 2)),
    }[probe]
    for x, c in _nan_cases(D, L, cuda):
        got, want = fn(x, c), plain(x, c)
        sep, best, sims = (got[i] for i in at)
        wsep, wbest, wsims = (want[i] for i in at)
        assert torch.equal(best, wbest), (best, wbest)
        for g, w in ((sep, wsep), (sims, wsims)):
            assert torch.equal(torch.isnan(g), torch.isnan(w))
            _near(torch.nan_to_num(g), torch.nan_to_num(w))
    assert bool(torch.isnan(wsep[1]))  # the NaN token's batch row


# ------------------------------------------------ serve's decisions
@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m"])
def test_serve_on_card_makes_the_cpu_decisions(cuda, arch, monkeypatch,
                                               capsys):
    """``serve`` on the card and on the CPU, 24 requests, on the same
    CPU-drawn weights: the printed cut and offline bits, and every task's
    online decision, equal; a task may decide otherwise only where its
    separability lies within PROBE_TOL of a threshold it was taken
    against, and the exit ratio and mean bits are equal when no task
    does."""
    from repro_torch.core import online as ON
    from repro_torch.launch.serve import serve
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    gparams = M.params_from_numpy(_as_numpy(params), cfg, cuda)
    logs = {"cpu": [], "cuda": []}
    where = ["cpu"]
    step = ON.OnlineScheduler.step

    def wrapped(self, feat, *a, **kw):
        dec = step(self, feat, *a, **kw)
        logs[where[0]].append((dec, self.th))
        return dec

    monkeypatch.setattr(ON.OnlineScheduler, "step", wrapped)
    want = serve(arch, requests=24, device="cpu", params=params)
    out_cpu = capsys.readouterr().out.splitlines()
    where[0] = "cuda"
    got = serve(arch, requests=24, device=cuda, params=gparams)
    out_cuda = capsys.readouterr().out.splitlines()
    assert out_cuda[0] == out_cpu[0] and "cut_group=" in out_cuda[0]
    assert len(logs["cpu"]) == len(logs["cuda"]) == 24
    differ = 0
    for (wd, wth), (gd, gth) in zip(logs["cpu"], logs["cuda"]):
        np.testing.assert_allclose(gd.separability, wd.separability,
                                   **PROBE_TOL)
        if (wd.early_exit, wd.bits) == (gd.early_exit, gd.bits):
            continue
        differ += 1
        cuts = [wth.s_ext] + [f for f, _ in wth.s_adj]
        assert any(abs(wd.separability - t) <= PROBE_TOL["atol"]
                   + PROBE_TOL["rtol"] * abs(t) for t in cuts), (wd, gd)
    if not differ:
        assert got.exit_ratio == want.exit_ratio
        assert got.mean_bits == want.mean_bits
        assert [t.early_exit for t in got.pipeline.tasks] == \
            [t.early_exit for t in want.pipeline.tasks]


# ------------------------------------------------ two-pod pipeline
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_stream_pipeline_matches_serial_plain_and_monolithic(cuda,
                                                                  dtype):
    """The card form of the two-pod pipeline on reduced qwen3-14b (8 bits,
    2 microbatches of (4, 32) tokens): with the pods on two streams it
    equals the pods on one stream and the run with the plain quantize and
    dequantize bit for bit, launches K3 and K2 once a microbatch, and each
    microbatch is within rel 0.05 (max|d| / max|ref|) of the monolithic
    forward."""
    from repro_torch.core.collab import PodMesh, make_collab_pipeline_step
    from repro_torch.training.optim import tree_map
    cfg = get_config("qwen3-14b").reduced()
    params = tree_map(lambda t: t.to(cuda, dtype),
                      M.init_params(cfg, seed=0, device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 4, 32)).astype(np.int32)).to(cuda)
    KB.LAUNCHES.clear()
    two = make_collab_pipeline_step(cfg, PodMesh.on_card(cuda))(params, toks)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["uaq_quantize"] == KB.LAUNCHES["uaq_dequantize"] == 2
    one = make_collab_pipeline_step(cfg, PodMesh.on_card(
        cuda, overlap=False))(params, toks)
    plain = make_collab_pipeline_step(cfg, PodMesh.on_card(cuda),
                                      use_kernel=False)(params, toks)
    assert two.shape == (2, 4, cfg.vocab_size) and two.dtype == dtype
    assert torch.equal(two, one) and torch.equal(two, plain)
    for i in range(2):
        h, _, _ = M.forward(params, cfg, toks[i])
        want = M._lm_head(params, cfg, h)[:, -1].float()
        rel = float((two[i].float() - want).abs().max() / want.abs().max())
        assert rel < 0.05, (i, rel)


# ------------------------------------------------ training on the card
@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m"])
def test_train_step_on_card_matches_cpu(cuda, arch, tmp_path):
    """One train step's loss (1e-5 relative) and each gradient leaf (1e-3
    relative L2: fp32 forward and backward on another device) on the card
    against the CPU, on the same CPU-drawn weights and batch; then a
    checkpoint of the stepped params and AdamW state saved on the card
    loads back bit-equal."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.launch import steps as ST
    from repro_torch.training.optim import (AdamWConfig, adamw_init,
                                            tree_leaves, tree_map)
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    gparams = M.params_from_numpy(_as_numpy(params), cfg, cuda)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    b = {"tokens": toks, "labels": toks}
    loss, _, grads = ST.loss_and_grads(params, cfg, b)
    gloss, _, ggrads = ST.loss_and_grads(
        gparams, cfg, {k: v.to(cuda) for k, v in b.items()})
    assert float(gloss) == pytest.approx(float(loss), rel=1e-5)
    for g, w in zip(tree_leaves(ggrads), tree_leaves(grads)):
        err = float(torch.linalg.vector_norm(g.cpu() - w))
        assert err <= 1e-3 * float(torch.linalg.vector_norm(w)) + 1e-12
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    p2, o2, _, _ = ST.make_train_step(cfg, opt_cfg, donate=True)(
        gparams, adamw_init(gparams, opt_cfg),
        {k: v.to(cuda) for k, v in b.items()})
    tree = {"params": p2, "opt": o2}
    save_checkpoint(str(tmp_path), 1, tree)
    back = load_checkpoint(str(tmp_path), 1, tree_map(torch.zeros_like, tree))
    for a, w in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.device == w.device and a.dtype == w.dtype
        assert torch.equal(a, w)


# ------------------------------------- the launch tooling on the card
@pytest.fixture(scope="module")
def card_mesh():
    """The 1x1 ("data", "model") mesh on the card (a one-rank group)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh("cuda")


def _on_card_mesh(mesh, cfg, params, serving, fn, B):
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.sharding import (distribute, layout_specs,
                                             shard_params)
    from repro_torch.models.shardctx import activation_sharding
    with activation_sharding(layout_specs(cfg, mesh, B)), \
            implicit_replication():
        return fn(distribute(params, shard_params(params, mesh, cfg,
                                                  serving=serving)))


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


@pytest.mark.parametrize("serving", [True, False])
@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m",
                                  "mixtral-8x7b"])
def test_card_mesh_forward_matches_plain(cuda, card_mesh, arch, serving):
    """The reduced forward with DTensor parameters on the 1x1 card mesh,
    hooks live, in the serving and the FSDP layout: logits within 1e-6
    (max|d| / max|ref|) of the plain tensors' (one device runs the same
    local ops; the MoE product runs expert-major there)."""
    from repro_torch.launch.sharding import (NamedSharding, batch_spec,
                                             distribute)
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)).to(cuda)

    def logits(p, x):
        h, _, _ = M.forward(p, cfg, x)
        return _full(M._lm_head(p, cfg, h))

    with torch.no_grad():
        want = logits(params, toks)
        got = _on_card_mesh(card_mesh, cfg, params, serving, lambda p: logits(
            p, distribute(toks, NamedSharding(card_mesh, batch_spec(
                card_mesh, 4, 1)))), 4)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-6


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m",
                                  "mixtral-8x7b"])
def test_card_mesh_train_step_matches_plain(cuda, card_mesh, arch):
    """A train step's loss and gradients with DTensor parameters in the
    FSDP layout on the 1x1 card mesh: loss within 1e-6 relative and each
    gradient leaf within 1e-6 relative L2 of the plain tensors'."""
    from repro_torch.launch import steps as ST
    from repro_torch.launch.sharding import (NamedSharding, batch_spec,
                                             distribute)
    from repro_torch.training.optim import tree_leaves
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)).to(cuda)
    b = {"tokens": toks, "labels": toks}
    loss, _, grads = ST.loss_and_grads(params, cfg, b)
    shard = NamedSharding(card_mesh, batch_spec(card_mesh, 2, 1))
    dloss, _, dgrads = _on_card_mesh(
        card_mesh, cfg, params, False, lambda p: ST.loss_and_grads(
            p, cfg, distribute(b, {k: shard for k in b})), 2)
    assert float(_full(dloss)) == pytest.approx(float(loss), rel=1e-6)
    for g, w in zip(tree_leaves(dgrads), tree_leaves(grads)):
        err = float(torch.linalg.vector_norm(_full(g) - w))
        assert err <= 1e-6 * float(torch.linalg.vector_norm(w)) + 1e-12


def test_dryrun_on_a_cuda_mesh(cuda):
    """``launch.dryrun`` with a CUDA mesh (this host has CUDA) on a fake
    2x2 group, in a subprocess: a decode and a train pair finish with
    positive flops and finite collective bytes of every kind."""
    import json
    import math
    import os
    import subprocess
    import sys
    script = (
        "import json\n"
        "from repro_torch.launch import dryrun as D\n"
        "D.init_fake_group(4)\n"
        "print(json.dumps([D.lower_pair(a, s, False)[1] for a, s in "
        "[('gemma2-2b', 'decode_32k'), ('mamba2-130m', 'train_4k')]]))\n")
    env = dict(os.environ, REPRO_MESH_SHAPE="2,2", REPRO_MICROBATCHES="1",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    for rep in json.loads(r.stdout.strip().splitlines()[-1]):
        assert rep["cost"]["flops_per_dev"] > 0
        assert all(math.isfinite(v) for v in rep["collectives"].values())


# the reduced archs whose train steps torch 2.11's DTensor refused on a 4x4
# mesh until the port redistributed their gradients (a microbatch of 2
# rows does not divide the 4-way data axis)
PROBE_ARCHS = ["jamba-1.5-large-398b", "llama4-scout-17b-a16e",
               "mamba2-130m", "mixtral-8x7b", "qwen3-14b"]


@pytest.fixture(scope="module")
def probe_4x4():
    """``tools/dtensor_probe.py 4,4 ... --jobs train`` on this host (a CUDA
    mesh of a fake 16-rank group, in a subprocess): its stdout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os
    import subprocess
    import sys
    root = os.path.join(os.path.dirname(__file__), "..")
    r = subprocess.run([sys.executable, os.path.join(root, "tools",
                                                     "dtensor_probe.py"),
                        "4,4", ",".join(PROBE_ARCHS), "--jobs", "train"],
                       capture_output=True, text=True, timeout=600)
    assert "mesh DeviceMesh((data=4, model=4), 'cuda'" in r.stdout, \
        r.stdout + r.stderr[-3000:]
    return r.stdout


@pytest.mark.parametrize("arch", PROBE_ARCHS)
def test_reduced_train_step_on_a_fake_4x4_cuda_mesh(cuda, probe_4x4, arch):
    """The reduced train step (B, S = 4, 32, two microbatches) on meta
    DTensors over a fake 4x4 CUDA mesh, the hooks live, runs."""
    lines = [l for l in probe_4x4.splitlines() if f" {arch} train" in l]
    assert len(lines) == 1 and lines[0].startswith("ok "), probe_4x4


# ------------------------------------------------ core.jit: CUDA graphs
def _jit_weights(cuda, d=64, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return {"w": torch.randn((d, d), generator=g, device=cuda),
            "b": torch.randn((d,), generator=g, device=cuda)}


def _affine(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m",
                                  "mixtral-8x7b"])
def test_jitted_segments_are_bit_equal_to_the_eager_ones(cuda, arch):
    """Each segment of a two-hop runtime on the card, through its CUDA
    graph, gives the bare segment function's output on the same input
    bit for bit; the first call captures, the second replays."""
    from repro_torch.core.jit import jit
    base = get_config(arch)
    cfg = base.reduced(num_layers=3 * len(base.pattern))
    params = M.init_params(cfg, seed=0, device="cpu")
    rt = CollabRuntime(cfg, M.params_from_numpy(_as_numpy(params), cfg,
                                                cuda), (1, 2))
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)).to(cuda)
    bare = [f.fn for f in rt._seg_fns]
    with torch.no_grad():
        for k, fn in enumerate(bare):
            f, p = rt._seg_fns[k], rt.p_segments[k]
            assert isinstance(f, jit)
            n = f.captures
            got, again = f(p, x), f(p, x)
            assert f.captures == n + 1
            want = fn(p, x)
            assert torch.equal(got, want) and torch.equal(again, want), k
            x = got
    assert rt._seg_fns[1].replays == 2


def test_jit_replays_a_shape_and_captures_a_new_batch_or_params(cuda):
    from repro_torch.core.jit import jit
    f = jit(_affine)
    p = _jit_weights(cuda)
    x = torch.randn((4, 64), device=cuda)
    with torch.no_grad():
        f(p, x)
        f(p, torch.randn((4, 64), device=cuda))
        assert (f.captures, f.replays) == (1, 2)
        f(p, torch.randn((8, 64), device=cuda))  # a new batch size
        assert f.captures == 2
        q = {k: v.clone() for k, v in p.items()}  # same values, new tensors
        assert torch.equal(f(q, x), _affine(q, x))
        assert f.captures == 3
        f(dict(p), x)  # the same tensors in another dict: a replay
        assert (f.captures, f.replays) == (3, 5)


def test_jit_sees_an_in_place_weight_update(cuda):
    from repro_torch.core.jit import jit
    f = jit(_affine)
    p = _jit_weights(cuda)
    x = torch.randn((4, 64), device=cuda)
    with torch.no_grad():
        before = f(p, x)
        p["w"].mul_(0.5)
        p["b"].add_(1.0)
        after = f(p, x)
    assert f.captures == 1
    assert torch.equal(after, _affine(p, x))
    assert not torch.equal(after, before)


def test_jit_outputs_do_not_alias(cuda):
    """Two calls' outputs are fresh tensors, as ``jax.jit``'s are: the
    second call leaves the first's values as they were."""
    from repro_torch.core.jit import jit
    f = jit(_affine)
    p = _jit_weights(cuda)
    x1, x2 = (torch.randn((4, 64), device=cuda) for _ in range(2))
    with torch.no_grad():
        y1 = f(p, x1)
        keep = y1.clone()
        y2 = f(p, x2)
    assert y1.data_ptr() != y2.data_ptr()
    assert torch.equal(y1, keep) and torch.equal(y2, _affine(p, x2))


def test_recorded_replays_carry_their_device_interval(cuda, monkeypatch):
    """While ``obs.runtime`` records from ``enable()``, each replay is a
    ``jit.replay`` span whose device interval (two CUDA events around
    ``graph.replay()``) is read without a sync of its own: when the spans
    are read, or, once ``READ_AT`` replays wait, those done at a close of
    a span with no parent.  The events are reused."""
    from repro_torch.core.jit import jit
    from repro_torch.obs import runtime as RT
    monkeypatch.setattr(RT, "READ_AT", 16)
    f = jit(_affine)
    p = _jit_weights(cuda)
    x = torch.randn((4, 64), device=cuda)
    n = RT.READ_AT + 4
    rec = RT.enable()
    rec.clear()
    try:
        with torch.no_grad():
            for _ in range(n):  # the first call captures, then replays
                f(p, x)
                torch.cuda.synchronize()
            rec.close(rec.open("tick"))
            assert 0 < len(rec._pending) < RT.READ_AT
            assert len(rec._events) + len(rec._pending) <= RT.READ_AT
    finally:
        RT.disable()
    spans = rec.spans()
    rec.clear()
    assert not rec._pending
    assert [s.name for s in spans if s.parent is None] == \
        ["jit"] * n + ["tick"]
    replays = [s for s in spans if s.name == "jit.replay"]
    assert len(replays) == n == f.replays
    assert all(s.device_ms is not None and 0 < s.device_ms < 1e3
               for s in replays)
    first = next(s for s in spans if s.name == "jit")
    assert [s.name for s in spans if s.parent == first.id] == \
        ["jit.key", "jit.capture", "jit.copy_in", "jit.replay",
         "jit.clone_out"]


def test_a_profiled_replay_has_no_device_interval(cuda):
    """Under a ``torch.profiler`` profile without ``enable()`` the recorder
    keeps the replay's host span and makes no CUDA event: the profile has
    the device's own trace."""
    from repro_torch.core.jit import jit
    from repro_torch.obs import runtime as RT
    f = jit(_affine)
    p = _jit_weights(cuda)
    x = torch.randn((4, 64), device=cuda)
    f(p, x)
    RT.RECORDER.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        f(p, x)
        f(p, x)
        torch.cuda.synchronize()
        assert not RT.RECORDER._pending
    spans = RT.RECORDER.spans()
    RT.RECORDER.clear()
    assert [s.name for s in spans if s.name != "gc"] == ["jit.replay"] * 2
    assert all(s.device_ms is None for s in spans)


def test_a_replay_still_running_is_read_later(cuda):
    """A device interval whose events have not completed is left for a
    later read, which waits for it."""
    from repro_torch.core.jit import jit
    from repro_torch.obs import runtime as RT

    def slow(p, x):
        torch.cuda._sleep(100_000_000)  # ~50 ms of device time
        return x * p["w"][0, 0]

    f = jit(slow)
    p = _jit_weights(cuda)
    x = torch.randn((4, 64), device=cuda)
    f(p, x)
    torch.cuda.synchronize()
    rec = RT.enable()
    rec.clear()
    try:
        f(p, x)
        rec._poll(wait=False)
        assert len(rec._pending) == 1  # still running: not read
    finally:
        RT.disable()
    replay, = [s for s in rec.spans() if s.name == "jit.replay"]
    rec.clear()
    assert replay.device_ms > 10.0 and not rec._pending


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m",
                                  "mixtral-8x7b"])
def test_captured_generate_matches_the_eager_loop(cuda, arch):
    """``generate`` (prefill and decode step jitted, the position a device
    tensor) gives the tokens of the same greedy loop over the bare
    ``prefill`` / ``decode_step`` with int positions, token for token."""
    base = get_config(arch).reduced()
    cfg = dataclasses.replace(base, capacity_factor=100.0) \
        if base.num_experts else base
    params = M.init_params(cfg, seed=2, device="cpu")
    gparams = M.params_from_numpy(_as_numpy(params), cfg, cuda)
    prompt = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)).to(cuda)
    n = 10
    out = generate(gparams, cfg, prompt, n)
    with torch.no_grad():
        logits, cache = M.prefill(gparams, cfg, prompt, 12 + n)
        toks = prompt
        for t in range(n):
            nxt = torch.argmax(logits, -1)[:, None].to(prompt.dtype)
            toks = torch.cat([toks, nxt], dim=1)
            if t < n - 1:
                logits, cache = M.decode_step(gparams, cfg, cache, nxt,
                                              12 + t)
    assert torch.equal(out, toks)


def test_jit_raises_when_the_function_syncs_in_the_capture(cuda):
    """A function that reads a value back to the host (a sync, which a
    CUDA-graph capture refuses) raises on the card, at every call: each
    call runs it once eagerly to warm up and once in the capture, since a
    failed capture leaves no graph behind, and the jit never runs it
    eagerly in place of the graph."""
    from repro_torch.core.jit import jit
    calls = []

    def syncs(p, x):
        calls.append(1)
        return x * float((x @ p["w"]).sum())

    f = jit(syncs)
    p = _jit_weights(cuda)
    x = torch.randn((4, 64), device=cuda)
    with torch.no_grad():
        with pytest.raises(RuntimeError):
            f(p, x)
        assert len(calls) == 2
        with pytest.raises(RuntimeError):
            f(p, x)
        assert len(calls) == 4
    assert (f.captures, f.replays) == (0, 0)
    torch.cuda.synchronize()
    assert torch.equal(_affine(p, x), _affine(p, x))  # the card still runs


def test_jit_captures_and_replays_after_a_failed_capture(cuda):
    """A failed capture leaves the jit as it was, as ``jax.jit`` stays
    usable after a failed trace: a capture-safe call on the same jit then
    captures and replays, both on another key and on the key whose
    capture failed; and the card's default generator draws again outside
    a capture (a capture that cannot end leaves it in its capture state
    unless the jit takes it out)."""
    from repro_torch.core.jit import jit
    syncs = [True]

    def fn(p, x, scale=1.0):
        if syncs[0]:
            float(x.sum())
        return _affine(p, x) * scale

    f = jit(fn)
    p = _jit_weights(cuda)
    x = _jit_weights(cuda, seed=1)["w"][:4]
    with torch.no_grad():
        with pytest.raises(RuntimeError):
            f(p, x)
        assert (f.captures, f.replays) == (0, 0)
        y = torch.randn((4, 64), device=cuda)
        syncs[0] = False
        got = [f(p, x, scale=2.0), f(p, y, scale=2.0)]  # another key
        assert (f.captures, f.replays) == (1, 2)
        assert torch.equal(got[0], _affine(p, x) * 2.0)
        assert torch.equal(got[1], _affine(p, y) * 2.0)
        got = [f(p, y), f(p, x)]  # the key whose capture failed
        assert (f.captures, f.replays) == (2, 4)
        assert torch.equal(got[0], _affine(p, y))
        assert torch.equal(got[1], _affine(p, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_jitted_two_stream_pipeline_is_bit_equal_to_the_eager_one(cuda,
                                                                  dtype):
    """``jit`` of the two-stream pipeline step (reduced qwen3-14b, 8 bits,
    2 microbatches of (4, 32) tokens): one CUDA graph holds both pods'
    streams, K3 and K2 (launched into the capture once a microbatch, and
    never by a replay), and every replay gives the eager step's logits on
    the same tokens bit for bit."""
    from repro_torch.core.collab import PodMesh, make_collab_pipeline_step
    from repro_torch.core.jit import jit
    from repro_torch.training.optim import tree_map
    cfg = get_config("qwen3-14b").reduced()
    params = tree_map(lambda t: t.to(cuda, dtype),
                      M.init_params(cfg, seed=0, device="cpu"))
    rng = np.random.default_rng(6)
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 4, 32))
                             .astype(np.int32)).to(cuda) for _ in range(2)]
    step = make_collab_pipeline_step(cfg, PodMesh.on_card(cuda))
    want = [step(params, t) for t in toks]
    f = jit(step)
    KB.LAUNCHES.clear()
    got = f(params, toks[0])
    torch.cuda.synchronize()
    # the warm-up's launches and the capture's
    assert KB.LAUNCHES["uaq_quantize"] == KB.LAUNCHES["uaq_dequantize"] == 4
    got = [got, f(params, toks[1]), f(params, toks[0])]
    torch.cuda.synchronize()
    assert KB.LAUNCHES["uaq_quantize"] == KB.LAUNCHES["uaq_dequantize"] == 4
    assert (f.captures, f.replays) == (1, 3)
    for g, w in zip(got, want + want[:1]):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m"])
def test_jitted_donated_train_steps_equal_the_eager_ones(cuda, arch):
    """Three steps of the train step jitted with params and opt_state
    donated (as ``launch/train.py`` runs it) against three bare donated
    steps on a copy of the same CPU-drawn weights and the same batches:
    the loss and every params, m and v leaf bit-equal or within 1e-6
    (max |d| over max |ref|; a GEMM under capture may pick another cuBLAS
    algorithm), ``step == 3``, one capture and two replays (the first
    call returns the warm-up's outputs: it applied the first update), and
    the donated outputs are the caller's tensors, never clones: a replay
    copies in the batch (2 leaves) and clones out the loss and the 2
    metrics, nothing else."""
    from repro_torch.core.jit import jit
    from repro_torch.launch import steps as ST
    from repro_torch.training.optim import (AdamWConfig, adamw_init,
                                            tree_leaves)
    cfg = get_config(arch).reduced()
    cpu = _as_numpy(M.init_params(cfg, seed=0, device="cpu"))
    mine, theirs = (M.params_from_numpy(cpu, cfg, cuda) for _ in range(2))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    opt, bare_opt = adamw_init(mine, opt_cfg), adamw_init(theirs, opt_cfg)
    step = jit(ST.make_train_step(cfg, opt_cfg, donate=True),
               donate=("params", "opt_state"))
    bare = ST.make_train_step(cfg, opt_cfg, donate=True)
    rng = np.random.default_rng(8)

    def rel(a, w):
        if torch.equal(a, w):
            return 0.0
        return float((a - w).abs().max() / w.abs().max())

    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))
                                .astype(np.int32)).to(cuda)
        b = {"tokens": toks, "labels": toks}
        p2, o2, loss, _ = step(mine, opt, b)
        assert all(a is w for a, w in zip(tree_leaves((p2, o2)),
                                          tree_leaves((mine, opt))))
        _, _, want, _ = bare(theirs, bare_opt, b)
        assert rel(loss, want) <= 1e-6
    assert int(opt.step) == int(bare_opt.step) == 3
    assert (step.captures, step.replays, step.copies) == (1, 2, 2 * 5)
    for a, w in zip(tree_leaves((mine, opt.m, opt.v)),
                    tree_leaves((theirs, bare_opt.m, bare_opt.v))):
        assert rel(a, w) <= 1e-6


# ------------------------------------- core.jit on DTensor steps
def _dtensor_rel(a, w):
    a, w = _full(a), _full(w)
    if torch.equal(a, w):
        return 0.0
    return float((a - w).abs().max() / w.abs().max())


def test_jitted_dtensor_decode_step_captures_once_and_equals_eager(
        cuda, card_mesh):
    """``jit(make_serve_step(cfg))`` on reduced gemma2-2b with DTensor
    params in the serving layout on the 1x1 card mesh, the hooks live and
    the position a device tensor: one capture serves all 5 positions, and
    every step's logits and cache equal the eager DTensor step's on the
    same cache and tokens bit for bit; the outputs are DTensors of the
    eager step's layout."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.core.jit import jit
    from repro_torch.launch import steps as ST
    from repro_torch.launch.sharding import (NamedSharding, batch_spec,
                                             distribute, layout_specs,
                                             shard_params)
    from repro_torch.models.shardctx import activation_sharding
    from repro_torch.training.optim import tree_leaves
    cfg = get_config("gemma2-2b").reduced()
    params = M.init_params(cfg, seed=0, device=cuda)
    B, S, n = 2, 16, 5
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (B, S + n)).astype(np.int32)).to(cuda)
    serve = ST.make_serve_step(cfg)
    step = jit(serve)
    batch = NamedSharding(card_mesh, batch_spec(card_mesh, B, 1))
    with torch.no_grad(), activation_sharding(
            layout_specs(cfg, card_mesh, B)), implicit_replication():
        dp = distribute(params, shard_params(params, card_mesh, cfg,
                                             serving=True))
        _, cache = ST.make_prefill_step(cfg, S + n)(
            dp, distribute(toks[:, :S], batch))
        pos = torch.full((), S, dtype=torch.int32, device=cuda)
        for i in range(n):
            x = distribute(toks[:, S + i:S + i + 1], batch)
            got, got_cache = step(dp, cache, x, pos)
            want, cache = serve(dp, cache, x, pos)
            assert isinstance(got, DTensor)
            assert got.placements == want.placements
            assert _dtensor_rel(got, want) == 0.0, i
            for a, w in zip(tree_leaves(got_cache), tree_leaves(cache)):
                assert torch.equal(_full(a), _full(w)), i
            pos = pos + 1
    assert (step.captures, step.replays) == (1, n)


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m"])
def test_jitted_donated_dtensor_train_steps_equal_the_eager_ones(
        cuda, card_mesh, arch):
    """Two train steps jitted with params and opt_state donated, on
    DTensor params in the FSDP layout on the 1x1 card mesh, against two
    eager donated DTensor steps on a copy of the same weights and the same
    batches: the loss and every params, m and v leaf bit-equal or within
    1e-6 (max |d| over max |ref|), ``step == 2``, one capture, and the
    donated outputs the caller's own DTensors."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.core.jit import jit
    from repro_torch.launch import steps as ST
    from repro_torch.launch.sharding import (NamedSharding, batch_spec,
                                             distribute, layout_specs,
                                             shard_params)
    from repro_torch.models.shardctx import activation_sharding
    from repro_torch.training.optim import (AdamWConfig, adamw_init,
                                            tree_leaves)
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=0, device=cuda)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = jit(ST.make_train_step(cfg, opt_cfg, donate=True),
               donate=("params", "opt_state"))
    bare = ST.make_train_step(cfg, opt_cfg, donate=True)
    rng = np.random.default_rng(13)
    batch = NamedSharding(card_mesh, batch_spec(card_mesh, 2, 1))
    with activation_sharding(layout_specs(cfg, card_mesh, 2)), \
            implicit_replication():
        layout = shard_params(params, card_mesh, cfg)
        mine, theirs = (distribute(params, layout) for _ in range(2))
        assert all(a.to_local().data_ptr() != b.to_local().data_ptr()
                   for a, b in zip(tree_leaves(mine), tree_leaves(theirs)))
        opt, bare_opt = adamw_init(mine, opt_cfg), adamw_init(theirs,
                                                               opt_cfg)
        for _ in range(2):
            toks = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (2, 32)).astype(np.int32)).to(cuda)
            b = {k: distribute(toks, batch) for k in ("tokens", "labels")}
            p2, o2, loss, _ = step(mine, opt, b)
            assert all(a is w for a, w in zip(tree_leaves((p2, o2)),
                                              tree_leaves((mine, opt))))
            _, _, want, _ = bare(theirs, bare_opt, b)
            assert _dtensor_rel(loss, want) <= 1e-6
    assert int(opt.step) == int(bare_opt.step) == 2
    assert (step.captures, step.replays) == (1, 1)
    for a, w in zip(tree_leaves((mine, opt.m, opt.v)),
                    tree_leaves((theirs, bare_opt.m, bare_opt.v))):
        assert _dtensor_rel(a, w) <= 1e-6


def test_a_failed_dtensor_capture_raises_and_the_next_key_captures(
        cuda, card_mesh):
    """A DTensor function that syncs inside the capture raises on the
    card; the same jit then captures and replays a capture-safe call on
    another key (another layout), bit-equal to the eager function."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.core.jit import jit
    syncs = [True]

    def fn(p, x):
        if syncs[0]:
            float(x.to_local().sum())
        return _affine(p, x)

    def dt(t, *placements):
        return DTensor.from_local(t, card_mesh, placements, run_check=False)

    f = jit(fn)
    rep = (Replicate(), Replicate())
    with torch.no_grad(), implicit_replication():
        p = {k: dt(v, *rep) for k, v in _jit_weights(cuda).items()}
        local = torch.randn((4, 64), device=cuda)
        x, y = dt(local, Shard(0), Replicate()), dt(local.clone(), *rep)
        with pytest.raises(RuntimeError):
            f(p, x)
        assert (f.captures, f.replays) == (0, 0)
        syncs[0] = False
        got = [f(p, y), f(p, y)]
        assert (f.captures, f.replays) == (1, 2)
        for g in got:
            assert torch.equal(_full(g), _full(_affine(p, y)))


# ------------------------------------------------ K5: the SSD mixer
def _ssd_block(cfg, dtype, device, seed=0):
    """A mamba2 block's parameters with biases, D and norm scale drawn away
    from their init (0 and 1, which would hide terms), the typed ones in
    ``dtype``, A_log / D / dt_bias in float32."""
    gen = torch.Generator().manual_seed(seed)
    p = SSM.init_mamba(cfg, gen, torch.float32, "cpu")
    for k in ("conv_bx", "conv_bB", "conv_bC"):
        p[k] = torch.randn(p[k].shape, generator=gen) * 0.1
    p["norm_scale"] = 1.0 + 0.1 * torch.randn(p["norm_scale"].shape,
                                              generator=gen)
    p["D"] = 1.0 + 0.1 * torch.randn(p["D"].shape, generator=gen)
    return {k: v.to(device, dtype if k not in SSD.HEAD_PARAMS else
                    torch.float32) for k, v in p.items()}


def _ssd_acts(cfg, B, S, dtype, device, seed=1):
    """z, xr, Br, Cr, dt as the projections give them."""
    gen = torch.Generator().manual_seed(seed)
    di, N, H = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    shapes = ((B, S, di), (B, S, di), (B, S, N), (B, S, N), (B, S, H))
    return tuple((torch.randn(s, generator=gen) * sc).to(device, dtype)
                 for s, sc in zip(shapes, (1.0, 1.0, 0.5, 0.5, 1.0)))


def _ssd_cfg(chunk=256):
    return dataclasses.replace(get_config("mamba2-130m"), ssm_chunk=chunk)


def _widened(tree):
    return {k: v.float() for k, v in tree.items()}


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


SSD_SHAPES = [(1, 1, 256), (1, 8, 256), (1, 128, 256), (2, 77, 256),
              (1, 256, 256), (1, 300, 256), (2, 77, 32)]


@pytest.mark.parametrize("want_state", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,chunk", SSD_SHAPES)
def test_ssd_mixer_matches_the_plain_chain(cuda, B, S, chunk, dtype,
                                           with_h0, want_state):
    """The fused mixer (three launches, four with a state) against
    ``mixer_plain`` on the same inputs at mamba2-130m's widths (24 heads
    of 64, state 128, 4 taps): in fp32 within ``TOL`` of the plain chain
    on the card (the out_proj input) and within 1e-4 of the largest
    value (the final state, a sum over the chunk); in bf16 within four
    bf16 half-ulps of the largest value of the plain chain run in fp32
    on the same bf16 values (the kernels compute in fp32 and round
    once).  (1, 300) is two chunks of 256, the second padded; (2, 77) at
    chunk 32 three, the last padded."""
    cfg = _ssd_cfg(chunk)
    p = _ssd_block(cfg, dtype, cuda)
    acts = _ssd_acts(cfg, B, S, dtype, cuda)
    h0 = (torch.randn((B, cfg.ssm_heads, 64, 128), generator=torch.Generator(
        ).manual_seed(2)) * 0.5).to(cuda, dtype) if with_h0 else None
    nc = -(-S // min(chunk, S))
    state = nc > 1 or with_h0 or want_state
    KB.LAUNCHES.clear()
    with torch.no_grad():
        out, hT = SSD.ssd_mixer(*acts, p, chunk=chunk, eps=cfg.norm_eps,
                                h0=h0, want_state=want_state)
        torch.cuda.synchronize()
        assert sum(KB.LAUNCHES.values()) == 3 + state
        assert (hT is not None) == state
        if dtype == torch.float32:
            want, whT = SSM.mixer_plain(p, *acts, cfg, h0)
            _near(out, want, TOL)
        else:
            want, whT = SSM.mixer_plain(
                _widened(p), *(a.float() for a in acts), cfg,
                None if h0 is None else h0.float())
            assert _max_err(out, want) <= 2 ** -7 * float(want.abs().max())
    assert out.dtype == dtype and out.shape == acts[0].shape
    if state:
        assert hT.dtype == dtype and hT.shape == whT.shape
        tol = 1e-4 if dtype == torch.float32 else 2 ** -7
        assert _max_err(hT, whT) <= tol * float(whT.abs().max())


def test_ssd_mixer_replays_bit_equal_in_a_graph(cuda):
    """Captured in a CUDA graph, the mixer (with its state kernel) gives
    the eager launch's bits at every replay, and counts its launches at
    capture only."""
    cfg = _ssd_cfg()
    p = _ssd_block(cfg, torch.float32, cuda)
    acts = _ssd_acts(cfg, 1, 300, torch.float32, cuda)
    with torch.no_grad():
        want, whT = SSD.ssd_mixer(*acts, p, chunk=256, eps=cfg.norm_eps)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            SSD.ssd_mixer(*acts, p, chunk=256, eps=cfg.norm_eps)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        KB.LAUNCHES.clear()
        with torch.cuda.graph(graph):
            out, hT = SSD.ssd_mixer(*acts, p, chunk=256, eps=cfg.norm_eps)
        assert dict(KB.LAUNCHES) == {"ssd_prep": 1, "ssd_chunk": 1,
                                     "ssd_state": 1, "gated_rmsnorm": 1}
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, want) and torch.equal(hT, whT)
        assert sum(KB.LAUNCHES.values()) == 4


@pytest.mark.parametrize("case", ["cpu_input", "z_on_cpu", "dtype",
                                  "mixed_dtype", "head_param_dtype",
                                  "shape", "state_width", "h0_shape",
                                  "not_contiguous", "chunk"])
def test_ssd_mixer_wrapper_raises(cuda, case):
    cfg = _ssd_cfg()
    p = _ssd_block(cfg, torch.float32, cuda)
    z, xr, Br, Cr, dt = _ssd_acts(cfg, 1, 8, torch.float32, cuda)
    h0, chunk, err = None, 256, ValueError
    if case == "cpu_input":
        z, xr, Br, Cr, dt = (t.cpu() for t in (z, xr, Br, Cr, dt))
    elif case == "z_on_cpu":
        z = z.cpu()
    elif case == "dtype":
        z, xr, Br, Cr, dt = (t.double() for t in (z, xr, Br, Cr, dt))
        err = TypeError
    elif case == "mixed_dtype":
        Br = Br.to(torch.bfloat16)
        err = TypeError
    elif case == "head_param_dtype":
        p["dt_bias"] = p["dt_bias"].to(torch.bfloat16)
        err = TypeError
    elif case == "shape":
        xr = xr[:, :, :-64].contiguous()
    elif case == "state_width":
        Br = Br[:, :, :64].contiguous()
    elif case == "h0_shape":
        h0 = torch.zeros((1, cfg.ssm_heads, 64, 64), device=cuda)
    elif case == "not_contiguous":
        xr = torch.stack([xr, xr], -1)[..., 0]
    elif case == "chunk":
        chunk = 0
    with torch.no_grad(), pytest.raises(err):
        SSD.ssd_mixer(z, xr, Br, Cr, dt, p, chunk=chunk, eps=cfg.norm_eps,
                      h0=h0)


@pytest.mark.parametrize("S", [8, 128])
def test_full_mamba2_forward_on_card_matches_cpu(cuda, S):
    """The whole mamba2-130m (24 layers at the published widths) on the
    card, every layer through the fused mixer, gives the CPU's hidden
    states within ``TOL``."""
    cfg = get_config("mamba2-130m")
    params = M.init_params(cfg, seed=0, device="cpu")
    gparams = M.params_from_numpy(_as_numpy(params), cfg, cuda)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, S)).astype(np.int32))
    with torch.no_grad():
        want, _, _ = M.forward(params, cfg, toks)
        paths, (got, _, _) = _paths_during(
            lambda: M.forward(gparams, cfg, toks.to(cuda)))
    assert paths == {"fused": cfg.num_layers}
    _near(got, want, TOL)


def _paths_during(fn):
    """The ``ssm.PATHS`` counts that ``fn()`` adds, and its result."""
    before = SSM.PATHS.copy()
    out = fn()
    paths = SSM.PATHS.copy()
    paths.subtract(before)
    return {k: v for k, v in paths.items() if v}, out


def _cache_leaves(tree, at=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _cache_leaves(v, f"{at}/{k}")
    elif isinstance(tree, tuple):
        for k, v in enumerate(tree):
            yield from _cache_leaves(v, f"{at}/{k}")
    else:
        yield at, tree


@pytest.mark.parametrize("S", [8, 300])
def test_mamba2_prefill_cache_on_card_matches_cpu(cuda, S):
    """A prefill of the whole mamba2-130m with its cache on the card: every
    layer's mixer fused with the state kernel (``return_cache``), the
    last position's logits, each layer's final SSM state and its conv
    tails against the CPU's, the state within 1e-4 of its largest value
    (a sum over the chunk), the rest within ``TOL``.  S = 300 is two
    chunks of 256, the second padded."""
    cfg = get_config("mamba2-130m")
    params = M.init_params(cfg, seed=0, device="cpu")
    gparams = M.params_from_numpy(_as_numpy(params), cfg, cuda)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, S)).astype(np.int32))
    with torch.no_grad():
        want, wcache = M.prefill(params, cfg, toks, S + 4)
        KB.LAUNCHES.clear()
        paths, (got, gcache) = _paths_during(
            lambda: M.prefill(gparams, cfg, toks.to(cuda), S + 4))
        torch.cuda.synchronize()
    assert paths == {"fused": cfg.num_layers}
    assert KB.LAUNCHES["ssd_state"] == cfg.num_layers
    _near(got, want, TOL)
    wl, gl = dict(_cache_leaves(wcache)), dict(_cache_leaves(gcache))
    assert sorted(wl) == sorted(gl) and any("state" in k for k in wl)
    for k, w in wl.items():
        g = gl[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if "state" in k:
            assert _max_err(g.cpu(), w) <= 1e-4 * float(w.abs().max()), k
        else:
            _near(g, w, TOL)


def test_jitted_segments_with_the_fused_mixer_are_bit_equal(cuda):
    """As ``test_jitted_segments_are_bit_equal_to_the_eager_ones``, at the
    head dim and state the fused mixer takes: each segment's graph gives
    the bare function's bits at its capture and at two replays, and
    every mamba layer took the fused path at capture."""
    from repro_torch.core.jit import jit
    cfg = get_config("mamba2-130m").reduced(num_layers=3, ssm_head_dim=64,
                                            ssm_state=128)
    params = M.init_params(cfg, seed=0, device="cpu")
    rt = CollabRuntime(cfg, M.params_from_numpy(_as_numpy(params), cfg,
                                                cuda), (1, 2))
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)).to(cuda)
    before = SSM.PATHS.copy()
    with torch.no_grad():
        for k, f in enumerate(rt._seg_fns):
            p = rt.p_segments[k]
            assert isinstance(f, jit)
            got = [f(p, x) for _ in range(3)]
            want = f.fn(p, x)
            for g in got:
                assert torch.equal(g, want), k
            x = got[0]
    paths = SSM.PATHS.copy()
    paths.subtract(before)
    assert paths["fused"] >= cfg.num_layers and not any(
        v for k, v in paths.items() if k.startswith("plain"))


# ------------------------------------------------ K6: the projections
def _proj_weights(cfg, device, seed=0):
    """A mamba2 block's six projection weights (fp32) on ``device``."""
    p = SSM.init_mamba(cfg, torch.Generator().manual_seed(seed),
                       torch.float32, "cpu")
    return {k: p[k].to(device) for k in SSM.IN_PROJ + ("out_proj",)}


def _rel(got, want):
    return _max_err(got, want) / float(want.float().abs().max())


def _proj_paths_during(fn):
    """The ``ssm.PROJ_PATHS`` counts that ``fn()`` adds, and its result."""
    before = SSM.PROJ_PATHS.copy()
    out = fn()
    paths = SSM.PROJ_PATHS.copy()
    paths.subtract(before)
    return {k: v for k, v in paths.items() if v}, out


@pytest.mark.parametrize("rows", [1, 3, 8, 16])
def test_ssd_proj_matches_the_fp32_product(cuda, rows):
    """Both entry points against ``x @ w`` in fp32 (TF32 off, precision
    "highest") at mamba2-130m's widths: the five input projections (768
    -> 1536, 1536, 128, 128 and in_dt's ragged 24) in one launch and
    out_proj (1536 -> 768) in another (tiles of 16 and of 8 columns, each
    at 4, 8 and 16 rows of x padded); max |d| over max |ref| within 1e-5
    (the same fp32 FMAs, summed in another order)."""
    assert torch.get_float32_matmul_precision() == "highest"
    cfg = get_config("mamba2-130m")
    w = _proj_weights(cfg, cuda)
    gen = torch.Generator().manual_seed(rows)
    x = torch.randn((1, rows, cfg.d_model), generator=gen).to(cuda)
    g = torch.randn((1, rows, cfg.ssm_inner), generator=gen).to(cuda)
    KB.LAUNCHES.clear()
    with torch.no_grad():
        outs = PROJ.ssd_in_proj(x, *(w[k] for k in SSM.IN_PROJ))
        y = PROJ.ssd_out_proj(g, w["out_proj"])
        torch.cuda.synchronize()
        assert dict(KB.LAUNCHES) == {"ssd_in_proj": 1, "ssd_out_proj": 1}
        for k, got in list(zip(SSM.IN_PROJ, outs)) + [("out_proj", y)]:
            want = (g if k == "out_proj" else x) @ w[k]
            assert got.shape == want.shape and got.dtype == torch.float32
            assert got.is_contiguous()
            assert _rel(got, want) <= 1e-5, k


def test_ssd_proj_replays_bit_equal_in_a_graph(cuda):
    """Captured in a CUDA graph, both entry points give the eager launch's
    bits at each of two replays (the contraction is summed in a fixed
    order, no atomics), and count their launches at capture only."""
    cfg = get_config("mamba2-130m")
    w = _proj_weights(cfg, cuda)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((1, 8, cfg.d_model), generator=gen).to(cuda)
    g = torch.randn((1, 8, cfg.ssm_inner), generator=gen).to(cuda)

    def call():
        return PROJ.ssd_in_proj(x, *(w[k] for k in SSM.IN_PROJ)) + (
            PROJ.ssd_out_proj(g, w["out_proj"]),)

    with torch.no_grad():
        want = call()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        KB.LAUNCHES.clear()
        with torch.cuda.graph(graph):
            out = call()
        assert dict(KB.LAUNCHES) == {"ssd_in_proj": 1, "ssd_out_proj": 1}
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert all(torch.equal(o, v) for o, v in zip(out, want))
        assert sum(KB.LAUNCHES.values()) == 2


def test_mamba_forward_on_the_projection_kernels_matches_the_plain_one(
        cuda, monkeypatch):
    """A mamba2-130m block at S = 8 on the card: its projections on the
    kernels (``PROJ_PATHS`` "fused", one launch of each entry point beside
    the mixer's three) against the same block on the plain products (the
    kernels' row limit set to 0: "plain.rows"), within 1e-5 of the
    largest value."""
    cfg = _ssd_cfg()
    p = _ssd_block(cfg, torch.float32, cuda)
    x = torch.randn((1, 8, cfg.d_model), generator=torch.Generator(
        ).manual_seed(6)).to(cuda)
    with torch.no_grad():
        KB.LAUNCHES.clear()
        paths, got = _proj_paths_during(lambda: SSM.mamba_forward(p, x, cfg))
        torch.cuda.synchronize()
        launches = dict(KB.LAUNCHES)
        monkeypatch.setattr(PROJ, "MAX_ROWS", 0)
        KB.LAUNCHES.clear()
        plain, want = _proj_paths_during(
            lambda: SSM.mamba_forward(p, x, cfg))
        torch.cuda.synchronize()
        plain_launches = dict(KB.LAUNCHES)
    assert paths == {"fused": 1} and plain == {"plain.rows": 1}
    mixer = {"ssd_prep": 1, "ssd_chunk": 1, "gated_rmsnorm": 1}
    assert launches == dict(mixer, ssd_in_proj=1, ssd_out_proj=1)
    assert plain_launches == mixer
    assert got.shape == want.shape and _rel(got, want) <= 1e-5


@pytest.mark.parametrize("B,S,path", [(1, 16, "fused"), (2, 8, "fused"),
                                      (1, 17, "plain.rows"),
                                      (3, 6, "plain.rows")])
def test_projection_rows_decide_the_path(cuda, B, S, path):
    """Up to 16 rows (B * S) the projections take the kernels; a 17-row
    call, or 18 rows over 3 batch rows, counts "plain.rows" and launches
    neither entry point."""
    cfg = _ssd_cfg()
    p = _ssd_block(cfg, torch.float32, cuda)
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator(
        ).manual_seed(7)).to(cuda)
    with torch.no_grad():
        KB.LAUNCHES.clear()
        paths, out = _proj_paths_during(lambda: SSM.mamba_forward(p, x, cfg))
        torch.cuda.synchronize()
    assert paths == {path: 1} and out.shape == x.shape
    n = int(path == "fused")
    assert (KB.LAUNCHES["ssd_in_proj"], KB.LAUNCHES["ssd_out_proj"]) == (n, n)


@pytest.mark.parametrize("case", ["rows", "dtype", "width", "unaligned",
                                  "weight_rows", "weight_on_cpu",
                                  "not_contiguous"])
def test_ssd_proj_wrapper_raises(cuda, case):
    """The wrapper refuses what the kernel does not take: 17 rows, another
    type, a width that is no multiple of 4, a weight off 16 bytes, a
    weight whose rows are not x's columns, a weight off the card or a
    strided weight."""
    cfg = get_config("mamba2-130m")
    w = _proj_weights(cfg, cuda)["out_proj"]
    g = torch.randn((1, 8, cfg.ssm_inner), device=cuda)
    err = ValueError
    if case == "rows":
        g = torch.randn((1, 17, cfg.ssm_inner), device=cuda)
    elif case == "dtype":
        w, err = w.double(), TypeError
    elif case == "width":
        w = w[:, :-2].contiguous()
    elif case == "unaligned":
        w = torch.empty(w.numel() + 1, device=cuda)[1:].view(w.shape)
    elif case == "weight_rows":
        w = w[:-4].contiguous()
    elif case == "weight_on_cpu":
        w = w.cpu()
    else:
        w = torch.stack([w, w], -1)[..., 0]
    with torch.no_grad(), pytest.raises(err):
        PROJ.ssd_out_proj(g, w)
