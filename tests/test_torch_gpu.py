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
    from repro_torch.launch.sharding import (activation_specs, distribute,
                                             shard_params)
    from repro_torch.models.shardctx import activation_sharding
    with activation_sharding(activation_specs(cfg, mesh, B)), \
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
