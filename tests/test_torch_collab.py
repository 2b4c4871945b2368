"""The port's collaborative runtime (``repro_torch.core.collab``): twins
of the JAX package's runtime tests (split == monolithic up to quantization
error, wire compression, lossless handoff, probe on the boundary, fused
end hop == classic hop, segment handles), a multi-hop relay, and the
cross-package check: the same weights give the same logits (fp32
tolerance ``TOL``, rtol/atol 1e-4) and the same probe decision.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.collab import CollabRuntime as JRuntime  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.core.collab import (BoundaryProbe, CollabRuntime,  # noqa: E402
                                     WirePacket, split_params)
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _centers(cfg, L, seed):
    return np.random.default_rng(seed).standard_normal(
        (L, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def rt():
    cfg = get_config("gemma2-2b").reduced()
    jp = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    params = M.params_from_numpy(jp, cfg, "cpu")
    return cfg, jp, params, CollabRuntime(cfg, params, cut_group=1)


def test_split_params_partitions_groups(rt):
    cfg, _, params, r = rt
    ge = r.p_end["groups"][0]["attn"]["wq"].shape[0]
    gc = r.p_cloud["groups"][0]["attn"]["wq"].shape[0]
    assert ge == 1 and ge + gc == cfg.num_groups
    end, cloud = split_params(params, cfg, 1)
    assert "embed" in end and "final_norm" in cloud and "embed" in cloud


@pytest.mark.parametrize("bits,tol", [(8, 0.02), (4, 0.25)])
def test_split_matches_monolithic(rt, bits, tol):
    cfg, _, params, r = rt
    x = torch.from_numpy(_tokens(cfg, (4, 32), 1))
    pkt, h = r.end_step(x, bits=bits)
    out = r.cloud_step(pkt)
    want = r.monolithic(params, x)
    rel = float((out - want).abs().max() / want.abs().max())
    assert rel < tol, rel
    # wire compression: 8-bit ~4x, 4-bit ~8x vs fp32
    assert pkt.wire_bytes < h.numel() * 4 / (32 // bits) * 1.1


def test_lossless_handoff(rt):
    """Un-quantized handoff equals the monolithic forward."""
    cfg, _, params, r = rt
    x = torch.from_numpy(_tokens(cfg, (2, 16), 2))
    out = r._cloud_fn(r.p_cloud, r._end_fn(r.p_end, x))
    np.testing.assert_allclose(_np(out), _np(r.monolithic(params, x)),
                               rtol=1e-5, atol=1e-5)


def test_probe_on_boundary(rt):
    cfg, _, _, r = rt
    x = torch.from_numpy(_tokens(cfg, (4, 32), 3))
    _, h = r.end_step(x)
    sep, best, sims = r.probe(h, torch.from_numpy(_centers(cfg, 7, 4)))
    assert sep.shape == (4,) and sims.shape == (4, 7)
    assert best.dtype == torch.int32 and bool((sep >= 0).all())


def test_end_step_fused_matches_classic_hop(rt):
    """The fused end hop emits the same wire packet as the classic
    quantize path plus a probe consistent with the boundary activation,
    and the cloud consumes the packet identically."""
    cfg, _, _, r = rt
    x = torch.from_numpy(_tokens(cfg, (2, 8), 5))
    centers = torch.from_numpy(_centers(cfg, 5, 6))
    pkt_c, h = r.segment_step(0, x)
    pkt_f, probe = r.end_step_fused(x, centers)
    assert isinstance(pkt_f, WirePacket) and isinstance(probe, BoundaryProbe)
    assert pkt_f.channels == cfg.d_model
    for a, b in ((pkt_f.payload, pkt_c.payload), (pkt_f.scale, pkt_c.scale),
                 (pkt_f.zp, pkt_c.zp)):
        assert torch.equal(a, b)
    sep_r, best_r, sims_r = ref.semantic_probe_ref(h, centers)
    assert torch.equal(probe.best, best_r)
    np.testing.assert_allclose(_np(probe.sims), _np(sims_r), atol=1e-5)
    np.testing.assert_allclose(_np(probe.sep), _np(sep_r), rtol=1e-4,
                               atol=1e-5)
    gap = h.sum(dim=1) / h.shape[1]
    np.testing.assert_allclose(_np(probe.feat), _np(gap), atol=1e-5)
    assert torch.equal(r.cloud_step(pkt_f), r.cloud_step(pkt_c))


def test_segment_handle_fused_delivers_probe(rt):
    cfg, _, _, r = rt
    x = torch.from_numpy(_tokens(cfg, (2, 8), 7))
    centers = torch.from_numpy(_centers(cfg, 4, 8))
    seen = {}
    h = r.segment_handle(0, probe_centers=lambda: centers,
                         on_probe=lambda k, p: seen.setdefault(k, p))
    pkt = h(x)
    assert isinstance(pkt, WirePacket)
    assert 0 in seen and isinstance(seen[0], BoundaryProbe)
    pkt_f, probe = r.end_step_fused(x, centers)
    assert torch.equal(pkt.payload, pkt_f.payload)
    assert torch.equal(seen[0].sims, probe.sims)
    logits = r.segment_handle(1)(pkt)
    assert logits.shape == (2, cfg.vocab_size)


def test_multi_hop_relay_matches_monolithic():
    """Two cuts (end -> edge -> cloud): one packet per hop, and the relay
    through ``cloud_step`` equals ``run``."""
    cfg = get_config("gemma2-2b").reduced(num_layers=6)
    params = M.init_params(cfg, seed=0, device="cpu")
    r = CollabRuntime(cfg, params, cut_group=(1, 2), default_bits=(8, 4))
    x = torch.from_numpy(_tokens(cfg, (2, 16), 9))
    logits, pkts = r.run(x)
    assert [p.hop for p in pkts] == [0, 1] and [p.bits for p in pkts] == [8, 4]
    pkt0, _ = r.end_step(x)
    assert torch.equal(r.cloud_step(pkt0), logits)
    want = r.monolithic(params, x)
    assert float((logits - want).abs().max() / want.abs().max()) < 0.25
    with pytest.raises(AssertionError):
        r.segment_step(2, pkt0)  # segment 2 consumes the hop-1 packet


@pytest.mark.parametrize("bits", [4, 8])
def test_same_weights_same_logits_and_probe_across_packages(rt, bits):
    cfg, jp, params, r = rt
    jr = JRuntime(cfg, jax.tree.map(jnp.asarray, jp), cut_group=1)
    toks = _tokens(cfg, (3, 8), 10)
    centers = _centers(cfg, 6, 11)
    pkt, probe = r.end_step_fused(torch.from_numpy(toks),
                                  torch.from_numpy(centers), bits=bits)
    jpkt, jprobe = jr.end_step_fused(jnp.asarray(toks), jnp.asarray(centers),
                                     bits=bits)
    np.testing.assert_array_equal(_np(probe.best), np.asarray(jprobe.best))
    np.testing.assert_allclose(_np(probe.sims), np.asarray(jprobe.sims),
                               **TOL)
    np.testing.assert_allclose(_np(probe.feat), np.asarray(jprobe.feat),
                               **TOL)
    # the boundary activations differ in the last bits, so a code may
    # round the other way: compare the dequantized hop within a quantum,
    # and the cloud segments on the very same packet
    deq, jdeq = _np(pkt.dequantize()), np.asarray(jpkt.dequantize())
    assert (np.abs(deq - jdeq) <= np.asarray(jpkt.scale) * 1.001).all()
    same = WirePacket(*(torch.from_numpy(np.array(a)) for a in
                        (jpkt.payload, jpkt.scale, jpkt.zp)), bits,
                      channels=jpkt.channels)
    np.testing.assert_allclose(_np(r.cloud_step(same)),
                               np.asarray(jr.cloud_step(jpkt)), **TOL)
    np.testing.assert_allclose(
        _np(r.monolithic(params, torch.from_numpy(toks))),
        np.asarray(jr.monolithic(jax.tree.map(jnp.asarray, jp),
                                 jnp.asarray(toks))), **TOL)


@pytest.mark.parametrize("arch,over", [
    ("mamba2-130m", {}), ("mixtral-8x7b", {}),
    ("jamba-1.5-large-398b", {"num_layers": 16})])
def test_fused_hop_on_mamba_moe_and_hybrid_boundaries_matches_jax(arch,
                                                                  over):
    """Mamba, MoE and hybrid (two jamba groups) boundaries through the
    fused end hop.  On the same boundary activation the port's fused pass
    writes the JAX package's wire fields bit for bit; the port's own end
    segment gives the probe within ``TOL`` and a hop within a quantum;
    the cloud segment on the same packet and the monolithic forward agree
    within ``TOL``."""
    from repro.kernels import ops as JOPS
    from repro_torch.kernels import ops as KOPS
    cfg = get_config(arch).reduced(**over)
    assert cfg.num_groups == 2
    jp = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    params = M.params_from_numpy(jp, cfg, "cpu")
    r = CollabRuntime(cfg, params, cut_group=1)
    jr = JRuntime(cfg, jax.tree.map(jnp.asarray, jp), cut_group=1)
    toks = _tokens(cfg, (2, 8), 12)
    centers = _centers(cfg, 5, 13)
    for bits in (4, 8):
        pkt, probe = r.end_step_fused(torch.from_numpy(toks),
                                      torch.from_numpy(centers), bits=bits)
        jpkt, jprobe = jr.end_step_fused(jnp.asarray(toks),
                                         jnp.asarray(centers), bits=bits)
        _, jh = jr.end_step(jnp.asarray(toks), bits=bits)
        wire = KOPS.boundary_pass(torch.from_numpy(np.array(jh)),
                                  torch.from_numpy(centers), bits)
        jwire = JOPS.boundary_pass(jh, jnp.asarray(centers), bits)
        for g, w in zip(wire[:3], (jpkt.payload, jpkt.scale, jpkt.zp)):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
        for g, w in zip(wire[3:], jwire[3:]):
            np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
        np.testing.assert_array_equal(_np(probe.best),
                                      np.asarray(jprobe.best))
        for g, w in ((probe.sims, jprobe.sims), (probe.sep, jprobe.sep),
                     (probe.feat, jprobe.feat)):
            np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
        deq, jdeq = _np(pkt.dequantize()), np.asarray(jpkt.dequantize())
        assert (np.abs(deq - jdeq) <= np.asarray(jpkt.scale) * 1.001).all()
        same = WirePacket(*(torch.from_numpy(np.array(a)) for a in
                            (jpkt.payload, jpkt.scale, jpkt.zp)), bits,
                          channels=jpkt.channels)
        np.testing.assert_allclose(_np(r.cloud_step(same)),
                                   np.asarray(jr.cloud_step(jpkt)), **TOL)
    np.testing.assert_allclose(
        _np(r.monolithic(params, torch.from_numpy(toks))),
        np.asarray(jr.monolithic(jax.tree.map(jnp.asarray, jp),
                                 jnp.asarray(toks))), **TOL)


# ----------------------------------------------------- two-pod pipeline
_POD_SCRIPT = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.collab import PodMesh, make_collab_pipeline_step
from repro_torch.models import model as M
rank, d = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                        world_size=2)
cfg = get_config("qwen3-14b").reduced()
params = load_checkpoint(d, 0, M.init_params(cfg, seed=1, device="cpu"))
tokens = torch.from_numpy(np.load(f"{d}/tokens.npy"))
step = make_collab_pipeline_step(cfg, PodMesh(rank=rank), bits=8, n_micro=2)
out = step(params, tokens)
np.save(f"{d}/out{rank}.npy", out.numpy())
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    """Reduced qwen3-14b through the gloo two-rank pipeline (two
    processes, one pod each), on the JAX package's weights: (cfg, JAX
    params, port params, tokens (2, 4, 32), each rank's logits)."""
    import os
    import subprocess
    import sys
    from repro_torch.checkpoint import save_checkpoint
    d = tmp_path_factory.mktemp("pods")
    cfg = get_config("qwen3-14b").reduced()
    jp = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    params = M.params_from_numpy(jp, cfg, "cpu")
    save_checkpoint(str(d), 0, params)
    toks = _tokens(cfg, (2, 4, 32), 14)
    np.save(d / "tokens.npy", toks)
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _POD_SCRIPT, str(r),
                               str(d)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    outs = [np.load(d / f"out{r}.npy") for r in (0, 1)]
    return cfg, jp, params, toks, outs


def test_two_pod_pipeline_matches_monolithic(pods):
    """The twin of the JAX package's multi-pod test: each microbatch's
    last-token logits within rel 0.05 (max|d| / max|ref|, its bound) of
    the monolithic forward, and both ranks return the same logits."""
    cfg, _, params, toks, outs = pods
    assert outs[0].shape == (2, 4, cfg.vocab_size)
    np.testing.assert_array_equal(outs[0], outs[1])
    for i in range(2):
        h, _, _ = M.forward(params, cfg, torch.from_numpy(toks[i]))
        ref_ = _np(M._lm_head(params, cfg, h)[:, -1])
        rel = float(np.abs(outs[1][i] - ref_).max() / np.abs(ref_).max())
        assert rel < 0.05, (i, rel)


def test_two_pod_pipeline_matches_the_jax_composition(pods):
    """The reference's pipeline, composed in JAX (first half of the
    groups, ``wire_quantize``, ``wire_dequantize``, second half, final
    norm, head), against the port's: each microbatch's dequantized
    boundary within a quantum of JAX's (the halves round in other places,
    so a code may round the other way); on JAX's packet the port's second
    half gives JAX's logits within ``TOL``; the pipeline gives the port's
    own composition within ``TOL``."""
    from repro.core.collab import _run_groups
    from repro.kernels import ops as JOPS
    from repro.models import layers as JL
    from repro_torch.kernels import ops as KOPS
    from repro_torch.models import layers as TL
    cfg, jp, params, toks, outs = pods
    half, D = cfg.num_groups // 2, cfg.d_model
    jparams = jax.tree.map(jnp.asarray, jp)
    jg = [jax.tree.map(lambda x, k=k: x[k * half:(k + 1) * half],
                       jparams["groups"]) for k in (0, 1)]
    tg = [M.group_slice(params["groups"], slice(k * half, (k + 1) * half))
          for k in (0, 1)]
    B, S = toks.shape[1:]
    jpos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    tpos = M.positions_for(B, S, "cpu")

    def t_tail(h):
        h = M.run_groups(tg[1], h, cfg, tpos)
        h = TL.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return _np(M._lm_head(params, cfg, h[:, -1]))

    for i in range(2):
        jh = _run_groups(jg[0], JM._embed(jparams, cfg, jnp.asarray(toks[i])),
                         cfg, jpos)
        jpkt = JOPS.wire_quantize(jh.reshape(-1, D), 8)
        jdeq = JOPS.wire_dequantize(*jpkt, 8, channels=D).reshape(B, S, D)
        jh2 = JL.rms_norm(_run_groups(jg[1], jdeq, cfg, jpos),
                          jparams["final_norm"], cfg.norm_eps)
        jlogits = np.asarray(JM._lm_head(jparams, cfg, jh2[:, -1]))
        th = M.run_groups(tg[0], M._embed(params, cfg,
                                          torch.from_numpy(toks[i])),
                          cfg, tpos)
        tpkt = KOPS.wire_quantize(th.reshape(-1, D), 8)
        tdeq = KOPS.wire_dequantize(*tpkt, 8, channels=D).reshape(B, S, D)
        assert (np.abs(_np(tdeq) - np.asarray(jdeq))
                <= np.asarray(jpkt[1]).reshape(B, S, 1) * 1.001).all()
        np.testing.assert_allclose(
            t_tail(torch.from_numpy(np.array(jdeq))), jlogits, **TOL)
        np.testing.assert_allclose(outs[1][i], t_tail(tdeq), **TOL)


def test_two_pod_pipeline_needs_an_even_group_count():
    from repro_torch.core.collab import PodMesh, make_collab_pipeline_step
    cfg = get_config("qwen3-14b").reduced(num_layers=3)
    assert cfg.num_groups == 3
    with pytest.raises(ValueError):
        make_collab_pipeline_step(cfg, PodMesh(rank=0))
