"""Which path ``models.ssm.mamba_forward`` takes between its projections
and ``out_proj``: the fused SSD mixer kernels (``kernels/ssd.py``, on the
card) or the plain chain, and the reason ``PATHS`` names for the plain
one; and which path its projections take: the projection kernels
(``kernels/ssd_proj.py``, on the card) or ``layers.column`` and ``@``,
and the reason ``PROJ_PATHS`` names for the plain one.  The kernels
themselves run only on the card (``tests/test_torch_gpu.py``); here the
dispatch is held on CPU tensors, with the device test patched where a
case needs to get past it.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ssd as SSD  # noqa: E402
from repro_torch.kernels import ssd_proj as PROJ  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.layers import column, residual, row  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def _cfg(full=False, **over):
    """Reduced mamba2-130m (head dim 32, state 16), or with the published
    head dim and state (64, 128) that the kernels are built for."""
    if full:
        over = dict(ssm_head_dim=64, ssm_state=128, **over)
    return get_config("mamba2-130m").reduced(**over)


def _block(cfg, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = SSM.init_mamba(cfg, gen, dtype, "cpu")
    x = torch.randn((1, 8, cfg.d_model), generator=gen).to(dtype)
    return params, x


def _paths_of(fn, paths=SSM.PATHS):
    before = paths.copy()
    out = fn()
    after = paths.copy()
    after.subtract(before)
    return {k: v for k, v in after.items() if v}, out


def _proj_paths_of(fn):
    return _paths_of(fn, SSM.PROJ_PATHS)


@pytest.fixture
def on_card(monkeypatch):
    """CPU tensors taken for the card's, so the checks after the device
    one are reached (the fused path itself is never launched here)."""
    monkeypatch.setattr(SSM, "_on_card", lambda t: True)


def _acts(params, x):
    return tuple(x @ params[k] for k in ("in_z", "in_x", "in_B", "in_C",
                                         "in_dt"))


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("return_cache", [False, True])
def test_cpu_forward_takes_the_plain_chain(full, return_cache):
    cfg = _cfg(full)
    params, x = _block(cfg)
    paths, out = _paths_of(lambda: SSM.mamba_forward(
        params, x, cfg, return_cache=return_cache))
    assert paths == {"plain.cpu": 1}
    y = out[0] if return_cache else out
    assert y.shape == x.shape and bool(torch.isfinite(y).all())


def test_grad_mode_with_parameters_that_require_grad_is_plain(on_card):
    cfg = _cfg(full=True)
    params, x = _block(cfg)
    params["in_x"].requires_grad_(True)
    paths, out = _paths_of(lambda: SSM.mamba_forward(params, x, cfg))
    assert paths == {"plain.grad": 1}
    out.sum().backward()
    assert params["in_x"].grad is not None
    # the same parameters outside grad mode need no autograd
    with torch.no_grad():
        assert SSM.plain_reason(params, _acts(params, x), cfg) is None


def test_an_unsupported_dtype_is_plain(on_card):
    cfg = _cfg(full=True)
    params, x = _block(cfg, torch.float64)
    with torch.no_grad():
        assert SSM.plain_reason(params, _acts(params, x), cfg) == "dtype"
        paths, _ = _paths_of(lambda: SSM.mamba_forward(params, x, cfg))
    assert paths == {"plain.dtype": 1}


@pytest.mark.parametrize("case", ["reduced_head_dim_and_state", "state_64",
                                  "head_dim_32", "chunk_512", "conv_9"])
def test_an_unsupported_shape_is_plain(on_card, case):
    over = {"chunk_512": dict(ssm_chunk=512), "conv_9": dict(ssm_conv=9),
            "state_64": dict(ssm_state=64),
            "head_dim_32": dict(ssm_head_dim=32)}.get(case, {})
    full = case != "reduced_head_dim_and_state"
    cfg = _cfg(full) if not over else get_config("mamba2-130m").reduced(
        **dict(dict(ssm_head_dim=64, ssm_state=128), **over))
    params, x = _block(cfg)
    if case == "chunk_512":
        x = torch.randn((1, 300, cfg.d_model))  # Q = min(512, 300) > 256
    acts = _acts(params, x)
    with torch.no_grad():
        assert SSM.plain_reason(params, acts, cfg) == "shape"
        paths, _ = _paths_of(lambda: SSM.mamba_forward(params, x, cfg))
    assert paths == {"plain.shape": 1}


@pytest.mark.parametrize("case", ["head_params_bf16", "conv_x_bf16",
                                  "h0_bf16", "not_contiguous"])
def test_other_types_and_layouts_are_handed_to_the_kernels(on_card, case):
    """A parameter or state in another type, or a strided view, is no
    reason for the plain chain: ``_as_taken`` gives the kernels contiguous
    tensors in xr's type, and A_log, D and dt_bias in float32."""
    cfg = _cfg(full=True)
    params, x = _block(cfg)
    h0 = None
    if case == "head_params_bf16":
        params["dt_bias"] = params["dt_bias"].to(torch.bfloat16)
    elif case == "conv_x_bf16":
        params["conv_x"] = params["conv_x"].to(torch.bfloat16)
    elif case == "h0_bf16":
        h0 = torch.zeros((1, cfg.ssm_heads, 64, 128), dtype=torch.bfloat16)
    else:
        params["conv_bx"] = torch.stack([params["conv_bx"]] * 2, 1)[:, 0]
        assert not params["conv_bx"].is_contiguous()
    with torch.no_grad():
        acts = _acts(params, x)
        assert SSM.plain_reason(params, acts, cfg, h0) is None
        got, taken, th0 = SSM._as_taken(params, acts, h0)
    for name, t in list(zip(("z", "xr", "Br", "Cr", "dt"), got)) + list(
            taken.items()) + [("h0", th0)]:
        if t is None:
            continue
        want = torch.float32
        assert t.dtype == want and t.is_contiguous(), name
        src = params.get(name, dict(zip(("z", "xr", "Br", "Cr", "dt"),
                                        acts)).get(name, h0))
        assert torch.equal(t, src.to(want)), name
        # what is already as the kernels take it is handed on as it is
        assert (t is src) == (src.dtype == want and src.is_contiguous()), \
            name


def test_the_published_widths_take_the_fused_path_on_the_card(on_card):
    """With the device test passed, fp32, bf16 and fp16 blocks at head dim
    64 and state 128, up to chunks of 256 steps, with or without h0, take
    the fused path."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for chunk, S in ((256, 8), (256, 300), (16, 128)):
            cfg = _cfg(full=True, ssm_chunk=chunk)
            params, _ = _block(cfg, dtype)
            x = torch.randn((2, S, cfg.d_model)).to(dtype)
            h0 = torch.zeros((2, cfg.ssm_heads, 64, 128), dtype=dtype)
            with torch.no_grad():
                acts = _acts(params, x)
                assert SSM.plain_reason(params, acts, cfg) is None
                assert SSM.plain_reason(params, acts, cfg, h0) is None


@pytest.mark.parametrize("B,S,P,N,K,chunk,takes", [
    (1, 8, 64, 128, 4, 256, True), (1, 128, 64, 128, 4, 256, True),
    (1, 300, 64, 128, 4, 256, True), (2, 77, 64, 128, 4, 16, True),
    (1, 1, 64, 128, 1, 1, True), (65535, 8, 64, 128, 4, 256, True),
    (65535, 9, 64, 128, 4, 8, True), (1, 300, 64, 128, 4, 300, False),
    (1, 8, 32, 128, 4, 256, False), (1, 8, 64, 16, 4, 256, False),
    (1, 8, 64, 128, 9, 256, False), (0, 8, 64, 128, 4, 256, False),
    (1, 0, 64, 128, 4, 256, False), (1, 8, 64, 128, 4, 0, False)])
def test_takes_shape(B, S, P, N, K, chunk, takes):
    assert SSD.takes_shape(B, S, P, N, K, chunk) is takes


def test_the_wrapper_refuses_cpu_tensors():
    cfg = _cfg(full=True)
    params, x = _block(cfg)
    with torch.no_grad():
        z, xr, Br, Cr, dt = _acts(params, x)
    with pytest.raises(ValueError, match="CUDA"):
        SSD.ssd_mixer(z, xr, Br, Cr, dt, params, chunk=256, eps=1e-6)


_DTENSOR_SCRIPT = r"""
import json
import torch
from torch.distributed.tensor import Replicate, distribute_tensor
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import ssm as SSM
cfg = get_config("mamba2-130m").reduced(ssm_head_dim=64, ssm_state=128)
mesh = make_host_mesh("cpu")
gen = torch.Generator().manual_seed(0)
params = SSM.init_mamba(cfg, gen, torch.float32, "cpu")
x = torch.randn((1, 8, cfg.d_model), generator=gen)
rep = [Replicate(), Replicate()]
dparams = {k: distribute_tensor(v, mesh, rep) for k, v in params.items()}
with torch.no_grad():
    want = SSM.mamba_forward(params, x, cfg)
    got = SSM.mamba_forward(dparams, distribute_tensor(x, mesh, rep), cfg)
print(json.dumps({"paths": dict(SSM.PATHS),
                  "proj_paths": dict(SSM.PROJ_PATHS),
                  "equal": bool(torch.allclose(got.full_tensor(), want,
                                               rtol=1e-6, atol=1e-6))}))
"""


@pytest.fixture(scope="module")
def dtensor_forward():
    """The script's result: a forward on plain tensors, then one on
    replicated DTensors on a one-rank gloo group (in a subprocess, so that
    no process group leaks into this one)."""
    r = subprocess.run([sys.executable, "-c", _DTENSOR_SCRIPT],
                       env=dict(os.environ, PYTHONPATH=SRC),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_dtensor_forward_takes_the_plain_chain(dtensor_forward):
    """A forward on replicated DTensors is plain with the reason
    "dtensor", and equals the forward on plain tensors."""
    assert dtensor_forward["paths"] == {"plain.cpu": 1, "plain.dtensor": 1}
    assert dtensor_forward["equal"]


def test_dtensor_forward_takes_the_plain_projections(dtensor_forward):
    """The same forward's projections are plain with the reason
    "dtensor"."""
    assert dtensor_forward["proj_paths"] == {"plain.cpu": 1,
                                             "plain.dtensor": 1}


def test_the_kernel_modules_import_without_nvcc(tmp_path):
    """The wrapper and the model import, and a CPU forward runs, on a
    machine with no CUDA compiler: the kernels are built at first use."""
    script = ("import torch, shutil\n"
              "assert shutil.which('nvcc') is None\n"
              "from repro_torch.kernels import ssd\n"
              "from repro_torch.kernels import _build as KB\n"
              "from repro_torch.configs import get_config\n"
              "from repro_torch.models import ssm as SSM\n"
              "cfg = get_config('mamba2-130m').reduced()\n"
              "p = SSM.init_mamba(cfg, torch.Generator().manual_seed(0),"
              " torch.float32, 'cpu')\n"
              "SSM.mamba_forward(p, torch.randn((1, 4, cfg.d_model)), cfg)\n"
              "assert KB._lib is None\n"
              "print(dict(SSM.PATHS))\n")
    env = dict(os.environ, PYTHONPATH=SRC, PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path / "no-cuda"))
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "{'plain.cpu': 1}"


# ------------------------------------------- the projections' dispatch
@pytest.mark.parametrize("full", [False, True])
def test_cpu_projections_are_plain(full):
    cfg = _cfg(full)
    params, x = _block(cfg)
    assert SSM.proj_plain_reason(params, x) == "cpu"
    paths, y = _proj_paths_of(lambda: SSM.mamba_forward(params, x, cfg))
    assert paths == {"plain.cpu": 1} and y.shape == x.shape


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("return_cache", [False, True])
def test_plain_projections_are_the_column_products(full, return_cache,
                                                   monkeypatch):
    """On the CPU the projections are ``layers.column`` products, the same
    bits as before the projection kernels: the mixer's inputs are
    ``column(x, w)`` for the five input weights, and the block's output is
    ``residual(g @ row(out_proj))`` of the mixer's output g."""
    cfg = _cfg(full)
    params, x = _block(cfg, seed=3)
    seen = {}
    plain = SSM.mixer_plain

    def spy(p, *acts, **kw):
        seen["acts"] = acts[:5]
        seen["g"], hT = plain(p, *acts, **kw)
        return seen["g"], hT

    monkeypatch.setattr(SSM, "mixer_plain", spy)
    out = SSM.mamba_forward(params, x, cfg, return_cache=return_cache)
    y = out[0] if return_cache else out
    for k, got in zip(SSM.IN_PROJ, seen["acts"]):
        assert torch.equal(got, column(x, params[k])), k
    assert torch.equal(y, residual(seen["g"] @ row(params["out_proj"])))


def test_projections_with_grad_are_plain(on_card):
    cfg = _cfg(full=True)
    params, x = _block(cfg)
    assert SSM.proj_plain_reason(params, x) is None
    params["in_dt"].requires_grad_(True)
    assert SSM.proj_plain_reason(params, x) == "grad"
    x.requires_grad_(True)
    params["in_dt"].requires_grad_(False)
    assert SSM.proj_plain_reason(params, x) == "grad"
    with torch.no_grad():
        assert SSM.proj_plain_reason(params, x) is None


@pytest.mark.parametrize("case", ["float64", "bf16_weight", "bf16_x"])
def test_projections_off_fp32_are_plain(on_card, case):
    """Activations or any weight in another type than float32: the kernels
    compute in fp32 from fp32 operands only."""
    cfg = _cfg(full=True)
    params, x = _block(cfg, torch.float64 if case == "float64"
                       else torch.float32)
    if case == "bf16_weight":
        params["out_proj"] = params["out_proj"].to(torch.bfloat16)
    elif case == "bf16_x":
        x = x.to(torch.bfloat16)
    with torch.no_grad():
        assert SSM.proj_plain_reason(params, x) == "dtype"
    if case == "float64":
        with torch.no_grad():
            paths, _ = _proj_paths_of(lambda: SSM.mamba_forward(params, x,
                                                                cfg))
        assert paths == {"plain.dtype": 1}


@pytest.mark.parametrize("B,S,why", [(1, 1, None), (1, 8, None),
                                     (1, 16, None), (2, 8, None),
                                     (1, 17, "rows"), (3, 6, "rows"),
                                     (1, 128, "rows"), (1, 0, "rows")])
def test_projection_rows(on_card, B, S, why):
    """Up to ``MAX_ROWS`` rows (B * S) the kernels take the call; above,
    where the product is bound by its FMAs and not by its weights' bytes,
    the plain products run it."""
    cfg = _cfg(full=True)
    params, _ = _block(cfg)
    x = torch.randn((B, S, cfg.d_model))
    assert SSM.proj_plain_reason(params, x) == why


@pytest.mark.parametrize("case", ["width", "strided", "unaligned"])
def test_projection_weights_the_kernels_do_not_take_are_plain(on_card,
                                                              case):
    """A width that is no multiple of 4, a strided weight or one off 16
    bytes: "shape", never a copy of the weight."""
    cfg = _cfg(full=True)
    params, x = _block(cfg)
    w = params["in_dt"]
    if case == "width":
        params["in_dt"] = w[:, :-1].contiguous()
    elif case == "strided":
        params["in_dt"] = torch.stack([w, w], -1)[..., 0]
    else:
        params["in_dt"] = torch.empty(w.numel() + 1)[1:].view(w.shape)
    with torch.no_grad():
        assert SSM.proj_plain_reason(params, x) == "shape"


def test_projections_on_the_card_path_run_the_column_products(
        on_card, monkeypatch):
    """With the device test passed, a block whose mixer the kernels do not
    take (head dim 32) runs its projections through the wrappers, which
    on CPU tensors compute the plain products: the same bits as the plain
    path, counted "fused"."""
    cfg = _cfg()
    params, x = _block(cfg)
    with torch.no_grad():
        paths, got = _proj_paths_of(lambda: SSM.mamba_forward(params, x,
                                                              cfg))
    assert paths == {"fused": 1}
    monkeypatch.setattr(SSM, "_on_card", lambda t: False)
    with torch.no_grad():
        plain, want = _proj_paths_of(lambda: SSM.mamba_forward(params, x,
                                                               cfg))
    assert plain == {"plain.cpu": 1} and torch.equal(got, want)


@pytest.mark.parametrize("rows,width_in,widths,takes", [
    (8, 768, (1536, 1536, 128, 128, 24), True), (16, 1536, (768,), True),
    (1, 4, (4,), True), (17, 768, (1536,), False), (0, 768, (1536,), False),
    (8, 770, (1536,), False), (8, 768, (1538,), False),
    (8, 768, (), False), (8, 768, (4,) * 6, False),
    (8, PROJ.MAX_IN, (4,), True), (8, PROJ.MAX_IN + 4, (4,), False)])
def test_proj_takes(rows, width_in, widths, takes):
    assert PROJ.takes(rows, width_in, widths) is takes


def test_the_projection_wrappers_compute_the_products_on_the_cpu():
    cfg = _cfg(full=True)
    params, x = _block(cfg)
    outs = PROJ.ssd_in_proj(x, *(params[k] for k in SSM.IN_PROJ))
    for k, got in zip(SSM.IN_PROJ, outs):
        assert torch.equal(got, x @ params[k]), k
    g = torch.randn((1, 8, cfg.ssm_inner))
    assert torch.equal(PROJ.ssd_out_proj(g, params["out_proj"]),
                       g @ params["out_proj"])
