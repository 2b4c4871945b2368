"""The port's launch tooling on DTensor: ``launch.hlo_cost`` /
``launch.hlo_analysis`` (a dispatch trace of the step in place of XLA's
HLO), ``launch.dryrun`` and the ``constrain`` hooks of the models.

- Single-device flops: every reduced arch's forward and train step, the
  port's trace against the reference's ``hlo_cost.analyze`` of the same
  step jitted on one CPU device.  They are equal, but for one op: at
  S <= ssm_chunk the SSD scan has one chunk, so the per-chunk state
  einsum ``Sc`` ("bcjhn,bcjhp->bchpn", ``models/ssm.py``) only feeds the
  final state, which ``forward`` without a cache discards; XLA deletes
  it as dead code and eager PyTorch computes it.  So the SSM archs'
  forwards differ by exactly that einsum's flops (1.9% on mamba2-130m).
- The dry-run of a train, a prefill and a decode pair on a fake 2x2
  mesh (a subprocess: no process group leaks into this one): its
  per-device argument bytes equal the local shard sizes worked out from
  the reference's ``param_spec``, ``cache_spec`` and ``batch_spec``.
- Four gloo ranks on a 2x2 CPU mesh (subprocesses, as
  ``tests/test_torch_collab.py`` starts its pods): reduced gemma2-2b,
  mamba2-130m and mixtral-8x7b with DTensor parameters in the serving
  and the train layout, the hooks live: logits within 1e-5 relative
  (max|d| / max|ref|) of the unsharded port forward, and a train step's
  loss within 1e-5 and each gradient leaf within 1e-5 relative L2.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import hlo_cost as JHC  # noqa: E402
from repro.launch import sharding as JS  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.training.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import hlo_cost as HC  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.sharding import leaves_with_path  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.training.optim import AdamWConfig, adamw_init  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module: its work is tracing and small
    products, and it runs beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg):
    rng = np.random.default_rng(0)
    if cfg.embed_inputs:
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        return x, {"embeds": x, "labels": rng.integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)}
    x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return x, {"tokens": x, "labels": x}


def _dead_state_flops(cfg):
    """Flops of the SSD state einsum that XLA deletes from a one-chunk
    forward without a cache (see the module docstring)."""
    if S > cfg.ssm_chunk:
        return 0
    n = sum(1 for i in range(cfg.num_layers)
            if cfg.pattern[i % len(cfg.pattern)].mixer == "mamba")
    return n * 2 * B * S * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_single_device_flops_equal_the_reference(arch):
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = M.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    x, batch = _inputs(cfg)

    def hlo_flops(fn, *args):
        return JHC.analyze(jax.jit(fn).lower(*args).compile().as_text()
                           ).flops

    want = hlo_flops(lambda p, i: JM.forward(p, jcfg, i), jp, x)
    got = HC.analyze(HC.trace_step(lambda p, i: M.forward(p, cfg, i),
                                   params, torch.from_numpy(x))).flops
    assert got - want == _dead_state_flops(cfg), (got, want)
    assert abs(got - want) <= 0.02 * want

    jopt = JAdamWConfig()
    want = hlo_flops(JST.make_train_step(jcfg, jopt), jp,
                     j_adamw_init(jp, jopt), batch)
    opt = AdamWConfig()
    got = HC.analyze(HC.trace_step(
        ST.make_train_step(cfg, opt), params, adamw_init(params, opt),
        {k: torch.from_numpy(v) for k, v in batch.items()})).flops
    assert got == want


def test_trace_counts_local_ops_views_free():
    """On plain tensors the trace is one device's ops: a matmul's flops,
    its bytes (inputs read once, output written once), views and
    allocation free, and the peak of what the step allocated."""
    a, b = torch.ones(8, 16), torch.ones(16, 4)

    def step(a, b):
        return (a.t().t() @ b).reshape(4, 8)

    tr = HC.trace_step(step, a, b)
    c = HC.analyze(tr)
    assert c.flops == 2 * 8 * 16 * 4 and c.coll_bytes == 0
    assert c.hbm_bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    assert tr.argument_bytes == 4 * (8 * 16 + 16 * 4)
    assert tr.output_bytes == tr.peak_bytes == 4 * 8 * 4
    assert tr.alias_bytes == 0


# ---------------------------------------------------- dry-run, fake 2x2
_DRYRUN_SCRIPT = r"""
import json, sys
import torch
from repro_torch.launch import dryrun as D
torch.set_num_threads(1)  # meta tensors: nothing to compute
D.init_fake_group(4)
out = {}
for arch, shape in json.loads(sys.argv[1]):
    trace, rep = D.lower_pair(arch, shape, False)
    out[f"{arch}/{shape}"] = rep
print(json.dumps(out))
"""

PAIRS = [("mamba2-130m", "train_4k"), ("qwen3-14b", "prefill_32k"),
         ("mixtral-8x7b", "decode_32k")]


class FakeMesh:
    def __init__(self, shape_map):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)


def _local_bytes(shape, dtype_bytes, spec, mesh):
    n = 1
    for i, d in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        div = int(np.prod([mesh.shape[a] for a in axes]))
        assert d % div == 0
        n *= d // div
    return n * dtype_bytes


def _expected_argument_bytes(arch, sname, mesh):
    """Local shard bytes of the step's arguments from the reference's
    specs and eval_shape trees (layout and moment dtypes as the dry-run
    chooses them)."""
    cfg, shape = j_get_config(arch), J_SHAPES[sname]
    jp = JST.abstract_params(cfg, jax.numpy.bfloat16)
    serving = shape.kind != "train" and JS.serving_layout_fits(jp, mesh)

    def params_bytes(tree, serving):
        return sum(_local_bytes(
            leaf.shape, leaf.dtype.itemsize,
            JS.param_spec("/".join(str(getattr(k, "key", getattr(
                k, "idx", k))) for k in path), leaf.shape, mesh,
                cfg.num_groups, serving=serving), mesh)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0])

    total = params_bytes(jp, serving)
    specs = JST.input_specs(cfg, shape)
    B = shape.global_batch
    if shape.kind == "train":
        from repro.launch.hlo_analysis import _active_params
        big = _active_params(cfg) > 2e10 or cfg.num_experts > 0
        dt = jax.numpy.bfloat16 if big else jax.numpy.float32
        opt = JST.abstract_opt_state(jp, JAdamWConfig(state_dtype=dt))
        total += 2 * params_bytes(opt.m, False) + 4  # m, v, step
    if shape.kind == "decode":
        cache = JST.abstract_cache(cfg, B, shape.seq_len)
        total += sum(_local_bytes(l.shape, l.dtype.itemsize, JS.cache_spec(
            mesh, cfg, B, l.shape), mesh) for l in jax.tree.leaves(cache))
        specs = {"inputs": specs["inputs"]}
    total += sum(_local_bytes(v.shape, v.dtype.itemsize, JS.batch_spec(
        mesh, B, len(v.shape) - 1), mesh) for v in specs.values())
    return total, serving


def test_dryrun_pairs_on_a_fake_2x2_mesh():
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_MESH_SHAPE="2,2",
               REPRO_MICROBATCHES="1")
    r = subprocess.run([sys.executable, "-c", _DRYRUN_SCRIPT,
                        json.dumps(PAIRS)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    reps = json.loads(r.stdout.strip().splitlines()[-1])
    mesh = FakeMesh({"data": 2, "model": 2})
    for arch, sname in PAIRS:
        rep = reps[f"{arch}/{sname}"]
        want, serving = _expected_argument_bytes(arch, sname, mesh)
        assert rep["serving_layout"] == serving
        assert rep["memory"]["argument_size_in_bytes"] == want, (arch, sname)
        assert rep["devices"] == 4 and rep["mesh"] == "2x2"
        assert rep["cost"]["flops_per_dev"] > 0
        assert rep["collectives"]["total"] > 0
        assert rep["roofline"]["bottleneck"] in ("compute", "memory",
                                                 "collective")
        frac = rep["useful_flop_frac"]
        assert 0 < frac < 1.5, (arch, sname, frac)


# ------------------------------------- reduced train steps, fake 4x4 mesh
PROBE = os.path.join(os.path.dirname(__file__), "..", "tools",
                     "dtensor_probe.py")
PROBE_ARCHS = ["jamba-1.5-large-398b", "llama4-scout-17b-a16e",
               "mamba2-130m", "mixtral-8x7b", "qwen3-14b"]


def test_reduced_train_steps_on_a_fake_4x4_mesh():
    """The reduced train steps of the archs torch 2.11's DTensor refused on
    a 4x4 mesh (B, S = 4, 32: a microbatch of 2 rows does not divide the
    4-way data axis) on meta DTensors over a fake 4x4 CPU mesh, hooks live
    (``tools/dtensor_probe.py``, two subprocesses side by side: jamba's
    step takes about as long as the other four): every step runs."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, PROBE, "4,4", ",".join(archs),
                               "--jobs", "train"], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for archs in (PROBE_ARCHS[:1], PROBE_ARCHS[1:])]
    outs = [p.communicate(timeout=300) for p in procs]
    ok = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and "0 failed" in out, out + err[-3000:]
        ok += [l.split()[1] for l in out.splitlines() if l.startswith("ok ")]
    assert ok == PROBE_ARCHS


# --------------------------------------------- four gloo ranks, 2x2 mesh
_RANK_SCRIPT = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_config
from repro_torch.launch import steps as ST
from repro_torch.launch.sharding import (NamedSharding, activation_specs,
                                         batch_spec, distribute,
                                         leaves_with_path, shard_params)
from repro_torch.models import model as M
from repro_torch.models.shardctx import activation_sharding
rank, d = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)  # four ranks beside the other test workers
dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                        world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
out = {}
for i, arch in enumerate(sys.argv[3].split(",")):
    cfg = get_config(arch).reduced()
    params = load_checkpoint(d, i, M.init_params(cfg, seed=0, device="cpu"))
    toks = torch.from_numpy(np.load(f"{d}/tokens.npy"))
    B = toks.shape[0]
    tb = NamedSharding(mesh, batch_spec(mesh, B, 1))
    with activation_sharding(activation_specs(cfg, mesh, B)), \
            implicit_replication():
        for serving in (True, False):
            dp = distribute(params, shard_params(params, mesh, cfg,
                                                 serving=serving))
            h, _, _ = M.forward(dp, cfg, distribute(toks, tb))
            out[f"{arch}/logits/{int(serving)}"] = \
                M._lm_head(dp, cfg, h).full_tensor().numpy()
        batch = {"tokens": distribute(toks, tb), "labels": distribute(toks, tb)}
        loss, _, grads = ST.loss_and_grads(dp, cfg, batch)
        out[f"{arch}/loss"] = np.asarray(float(loss.full_tensor()))
        for path, g in leaves_with_path(grads):
            out[f"{arch}/grad/{path}"] = g.full_tensor().numpy()
if rank == 0:
    np.savez(f"{d}/out.npz", **out)
dist.destroy_process_group()
"""

GLOO_ARCHS = ("gemma2-2b", "mamba2-130m", "mixtral-8x7b")


def test_sharded_forward_and_train_step_on_four_gloo_ranks(tmp_path):
    from repro_torch.checkpoint import save_checkpoint
    plain = {}
    toks = np.random.default_rng(3).integers(0, 512, (4, 16)).astype(
        np.int32)
    np.save(tmp_path / "tokens.npy", toks)
    for i, arch in enumerate(GLOO_ARCHS):
        cfg = get_config(arch).reduced()
        assert cfg.vocab_size == 512
        jp = JM.init_params(j_get_config(arch).reduced(),
                            jax.random.PRNGKey(i))
        params = M.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                     "cpu")
        save_checkpoint(str(tmp_path), i, params)
        t = torch.from_numpy(toks)
        h, _, _ = M.forward(params, cfg, t)
        plain[f"{arch}/logits"] = M._lm_head(params, cfg, h).numpy()
        loss, _, grads = ST.loss_and_grads(params, cfg,
                                           {"tokens": t, "labels": t})
        plain[f"{arch}/loss"] = float(loss)
        plain[f"{arch}/grads"] = {p: g.numpy()
                                  for p, g in leaves_with_path(grads)}
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_SCRIPT, str(r),
                               str(tmp_path), ",".join(GLOO_ARCHS)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    got = np.load(tmp_path / "out.npz")
    for arch in GLOO_ARCHS:
        want = plain[f"{arch}/logits"]
        for serving in (1, 0):
            d = got[f"{arch}/logits/{serving}"]
            rel = float(np.abs(d - want).max() / np.abs(want).max())
            assert rel < 1e-5, (arch, serving, rel)
        lw = plain[f"{arch}/loss"]
        assert abs(float(got[f"{arch}/loss"]) - lw) <= 1e-5 * abs(lw), arch
        for path, w in plain[f"{arch}/grads"].items():
            err = np.linalg.norm(got[f"{arch}/grad/{path}"] - w)
            assert err <= 1e-5 * np.linalg.norm(w) + 1e-12, (arch, path)
