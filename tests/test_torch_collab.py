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
