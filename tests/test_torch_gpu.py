"""The port on a CUDA device: the Hopper kernels against their plain
PyTorch versions, the wrappers' input checks, and the model and runtime
on the card against the CPU.  Every test here is marked ``gpu`` and skips
without a CUDA device.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has the card but no JAX:

  PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: wire fields bit for bit; probe fields ``PROBE_TOL`` (atol
1e-5, rtol 1e-4: the kernel sums GAP and dot products in another order);
model outputs ``TOL`` (rtol/atol 1e-4, fp32 matmuls on another device).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.collab import CollabRuntime  # noqa: E402
from repro_torch.kernels import _build as KB  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.boundary import fused_boundary  # noqa: E402
from repro_torch.kernels.semantic_cache import semantic_probe  # noqa: E402
from repro_torch.kernels.uaq import uaq_dequantize, uaq_quantize  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

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


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B,S,D,L", [(2, 64, 32, 5), (3, 100, 33, 4),
                                     (1, 1, 16, 2), (1, 8, 2304, 16),
                                     (13, 700, 64, 7)])
def test_kernels_match_plain_versions(cuda, B, S, D, L, bits):
    x, c = _inputs(B, S, D, L, cuda, seed=B * S)
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
    assert torch.equal(uaq_dequantize(*q, bits, n=D),
                       ref.uaq_dequantize_ref(*q, bits, n=D))
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
    p, s, z = uaq_quantize(x.reshape(16, 48), 8)
    with pytest.raises(TypeError):
        uaq_dequantize(p, s, z, 8, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        uaq_dequantize(p, s[:8].contiguous(), z, 8)


def test_forward_and_runtime_on_card_match_cpu(cuda):
    cfg = get_config("gemma2-2b").reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    gparams = M.params_from_numpy(
        _as_numpy(params), cfg, cuda)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 96)).astype(np.int32))
    h, _, _ = M.forward(params, cfg, toks)
    hg, _, _ = M.forward(gparams, cfg, toks.to(cuda))
    _near(hg, h, TOL)
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


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_as_numpy(v) for v in tree)
    return tree.numpy()
