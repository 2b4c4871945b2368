"""The three-tier (end -> edge -> cloud) path through the port: twins of
the JAX package's multi-hop runtime tests on reduced gemma2-2b with four
groups, cuts (1, 3) and 8-bit hops over converted weights, and the
``examples/edge_tier.py`` run (planner cuts and bits, hop-level exits,
sync and async engines with ``classify`` through ``rt.run``) through both
packages on the same weights and stream.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import collab as JCL  # noqa: E402
from repro.core import costs as JCO  # noqa: E402
from repro.core import partitioner as JP  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.async_engine import AsyncCoachEngine as JAsync  # noqa: E402
from repro.serving.engine import CoachEngine as JSync  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import collab as TCL  # noqa: E402
from repro_torch.core import costs as TCO  # noqa: E402
from repro_torch.core import partitioner as TP  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.kernels import ops as KOPS  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.async_engine import AsyncCoachEngine  # noqa: E402
from repro_torch.serving.engine import CoachEngine  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _edge_tier():
    spec = importlib.util.spec_from_file_location(
        "edge_tier_example", ROOT / "examples" / "edge_tier.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.fixture(scope="module")
def rt3():
    cfg = get_config("gemma2-2b").reduced(num_layers=8)  # 4 groups
    jp = JM.init_params(jget_config("gemma2-2b").reduced(num_layers=8),
                        jax.random.PRNGKey(0))
    params = M.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, params, jp, TCL.CollabRuntime(cfg, params, (1, 3),
                                              default_bits=(8, 8))


def test_split_params_multi_partitions_groups(rt3):
    cfg, params, _, r = rt3
    segs = TCL.split_params_multi(params, cfg, (1, 3))
    sizes = [s["groups"][0]["attn"]["wq"].shape[0] for s in segs]
    assert sizes == [1, 2, 1]
    assert "embed" in segs[0] and "final_norm" in segs[-1]
    assert r.n_hops == 2 and r.n_segments == 3


def test_three_segment_matches_monolithic(rt3):
    cfg, params, _, r = rt3
    x = torch.from_numpy(_tokens(cfg, (2, 16), 1))
    logits, packets = r.run(x)
    assert [p.hop for p in packets] == [0, 1]
    assert all(p.bits == 8 for p in packets)
    ref = r.monolithic(params, x)
    rel = float((logits - ref).abs().max() / ref.abs().max())
    assert rel < 0.05, rel  # two 8-bit quantization hops


def test_cloud_step_relays_remaining_hops(rt3):
    cfg, _, _, r = rt3
    x = torch.from_numpy(_tokens(cfg, (2, 16), 2))
    logits, packets = r.run(x)
    np.testing.assert_allclose(r.cloud_step(packets[0]).numpy(),
                               logits.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [4, 8])
def test_hop_packets_bit_equal_to_jax(rt3, bits):
    """On the same boundary activation each hop's packet (payload, scale,
    zp) is the JAX package's bit for bit; the port's whole relay agrees
    with the JAX runtime's (a code may round the other way where the two
    forwards differ in the last bits, so within a quantum)."""
    from tests.test_torch_async import assert_runs_agree_across_packages
    cfg, params, jp, _ = rt3
    jr = JCL.CollabRuntime(cfg, jp, (1, 3), default_bits=(bits, bits))
    x = _tokens(cfg, (2, 16), 3)
    _, jh0 = jr.end_step(jnp.asarray(x), bits=bits)
    jpkt0, _ = jr.segment_step(0, jnp.asarray(x), bits=bits)
    jpkt1, jh1 = jr.segment_step(1, jpkt0, bits=bits)
    for jh, jpkt in ((jh0, jpkt0), (jh1, jpkt1)):
        got = KOPS.quantize_activation(torch.from_numpy(np.array(jh)), bits)
        want = JOPS.quantize_activation(jh, bits)
        for g, w, field in zip(got, want, ("payload", "scale", "zp")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), field)
            np.testing.assert_array_equal(
                g.numpy(), np.asarray(getattr(jpkt, field)), field)
    r = TCL.CollabRuntime(cfg, params, (1, 3), default_bits=(bits, bits))
    assert_runs_agree_across_packages(r, jr, x)


# ------------------------------------------------- the edge_tier run
DEVICES = ("JETSON_NX", "EDGE_AGX_ORIN", "A6000_SERVER")


def _edge_tier_run(pkg, requests=32):
    """``examples/edge_tier.py``'s three-tier run (reduced gemma2-2b, four
    groups, 50 Mbps WiFi + LAN backhaul, hop-level exits calibrated) in
    package ``pkg``, on weights from the JAX package's ``init_params``."""
    if pkg == "jax":
        CO, P, D, cfg_of = JCO, JP, JD, jget_config
        RT, Sync, Async = JCL.CollabRuntime, JSync, JAsync
    else:
        CO, P, D, cfg_of = TCO, TP, TD, get_config
        RT, Sync, Async = TCL.CollabRuntime, CoachEngine, AsyncCoachEngine
    base = cfg_of("gemma2-2b")
    cfg = base.reduced(num_layers=4 * len(base.pattern))
    jparams = JM.init_params(jget_config("gemma2-2b").reduced(
        num_layers=4 * len(base.pattern)), jax.random.PRNGKey(0))
    params = jparams if pkg == "jax" else M.params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    devices = tuple(getattr(CO, d) for d in DEVICES)
    links = (CO.WIFI_5GHZ(50.0), CO.ETH_LAN())
    stream = D.CorrelatedTaskStream(n_labels=16, dim=cfg.d_model,
                                    correlation="medium", seed=0,
                                    n_probe_depths=2, depth_decay=0.9)
    calib = D.make_hop_calibration_sets(stream, n=300)
    off = P.coach_offline_multihop(CO.transformer_graph(cfg, batch=1,
                                                        seq=128),
                                   devices, links)
    cuts = chip_smoke.group_cuts_from_frontiers(off.decision, cfg)
    hop_bits = [int(np.mean(list(b.values()))) if b else 8
                for b in off.decision.all_hop_bits]
    rt = RT(cfg, params, cuts, default_bits=hop_bits)

    def classify(task):
        toks = (np.abs((task.features[:8] * 1000).astype(np.int64))
                % cfg.vocab_size).astype(np.int32)
        if pkg == "jax":
            logits, _ = rt.run(jnp.asarray(toks)[None])
            logits = np.asarray(logits[0])
        else:
            logits, _ = rt.run(torch.from_numpy(toks)[None])
            logits = logits[0].numpy()
        return task.hop_features, int(np.argmax(logits) % stream.n_labels)

    tasks = stream.tasks(requests)
    out = []
    for cls in (Sync, Async):
        eng = cls(rt, off.times, devices[0], links[0], devices[-1],
                  n_labels=16, calib_feats=calib[0][0],
                  calib_labels=calib[0][1], boundary_elems=128 * cfg.d_model,
                  links=list(links), hop_bits_offline=hop_bits,
                  hop_calib=calib[1:2])
        out.append(eng.run_stream(list(tasks),
                                  arrival_period=off.times.max_stage,
                                  classify=classify))
    return cuts, hop_bits, out


def test_edge_tier_run_gives_the_jax_packages_cuts_bits_and_decisions():
    jcuts, jbits, (js, ja) = _edge_tier_run("jax")
    cuts, bits, (s, a) = _edge_tier_run("port")
    assert (cuts, bits) == (jcuts, jbits) == ((2, 3), [8, 8])
    for f in ("exit_ratio", "mean_bits", "accuracy"):
        assert getattr(s, f) == getattr(a, f) == getattr(js, f) == \
            getattr(ja, f), f
    assert s.exit_hops == a.exit_hops == js.exit_hops == ja.exit_hops
    assert s.exit_hops.get(1, 0) > 0, s.exit_hops  # the edge tier exits
    for x, y in ((s, js), (a, ja)):
        assert abs(x.pipeline.makespan - y.pipeline.makespan) < 1e-6


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m", "qwen3-14b"])
@pytest.mark.parametrize("reduced", [True, False])
def test_chip_smoke_cut_mapping_is_the_examples(arch, reduced):
    """``chip_smoke.py`` keeps its own copy of the example's frontier ->
    group-cut mapping (the example imports JAX): the same cuts on the
    same three-tier decision."""
    edge_tier = _edge_tier()
    cfg = jget_config(arch)
    if reduced:
        cfg = cfg.reduced(num_layers=4 * len(cfg.pattern))
    off = JP.coach_offline_multihop(
        JCO.transformer_graph(cfg, batch=1, seq=128),
        tuple(getattr(JCO, d) for d in DEVICES),
        (JCO.WIFI_5GHZ(50.0), JCO.ETH_LAN()))
    assert chip_smoke.group_cuts_from_frontiers(off.decision, cfg) == \
        edge_tier.group_cuts_from_frontiers(off.decision, cfg)


def test_chip_smoke_phase_9_runs_on_the_cpu():
    """``chip_smoke.py``'s phase 9 (the three-tier runs and their checks)
    on the CPU, where the wrappers take the plain versions: full-width
    mamba2-130m cut to 4 layers, whose planner picks 4-bit hops."""
    cfg = dataclasses.replace(get_config("mamba2-130m"), num_layers=4)
    params = M.init_params(cfg, seed=0, device="cpu")
    launches, res, rt, _ = chip_smoke.three_tier_check(torch, cfg, params,
                                                       device="cpu")
    assert launches == {}  # CPU tensors never reach a kernel
    assert (res["cuts"], res["hop_bits"]) == ([1, 3], [4, 4])
    assert res["decisions"]["exit_hops"] == {0: 23, 1: 1}
    assert res["executor_max_abs_err"] == 0.0
    assert res["split_max_ratio"][8] < chip_smoke.THREE_TIER_BOUND
    assert rt.default_bits_per_hop == (4, 4)
