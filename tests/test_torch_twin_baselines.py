"""Baseline schedulers (NS/DADS/SPINN/JPS) vs COACH on the paper's models."""

import pytest

from repro_torch.core import baselines as BL
from repro_torch.core.costs import A6000_SERVER, JETSON_NX, WIFI_5GHZ
from repro_torch.core.partitioner import coach_offline
from repro_torch.core.pipeline import plan_from_stage_times, run_pipeline
from repro_torch.models.cnn import resnet101, vgg16


@pytest.fixture(scope="module")
def setting():
    return resnet101(), JETSON_NX, A6000_SERVER, WIFI_5GHZ(20)


def test_all_baselines_produce_valid_decisions(setting):
    g, e, c, l = setting
    for name, fn in BL.BASELINES.items():
        r = fn(g, e, c, l)
        assert g.valid_end_set(r.decision.end_set), name
        assert r.times.latency > 0


def test_ns_minimizes_single_task_latency(setting):
    g, e, c, l = setting
    ns = BL.neurosurgeon(g, e, c, l)
    for other in (BL.dads, BL.jps):
        assert ns.times.latency <= other(g, e, c, l).times.latency + 1e-12


def test_jps_balances_end_and_tx(setting):
    g, e, c, l = setting
    r = BL.jps(g, e, c, l)
    # by construction JPS's max(T_e, T_t) is minimal among chain cuts at 8 bits
    assert max(r.times.T_e, r.times.T_t) <= r.times.latency


def test_coach_beats_baselines_on_pipeline_throughput():
    """The paper's central claim: the full COACH system (offline + online)
    achieves >= saturation throughput than every baseline, across models
    and bandwidths (same cost model & task stream)."""
    from torch_twin_bench_common import run_baseline, run_coach
    for g in (resnet101(), vgg16()):
        for mbps in (20, 50, 100):
            tp_coach = run_coach(g, "NX", mbps, "medium", n_tasks=400,
                                 arrival_factor=0.0).throughput
            for name in BL.BASELINES:
                tp = run_baseline(name, g, "NX", mbps, "medium",
                                  n_tasks=400, arrival_factor=0.0).throughput
                assert tp_coach >= tp * 0.95, (g.name, mbps, name,
                                               tp_coach, tp)


def test_spinn_has_nonempty_end(setting):
    g, e, c, l = setting
    r = BL.spinn(g, e, c, l)
    assert len(r.decision.end_set) >= 1
