"""Scenario engine (repro_torch.scenarios): timeline compilation, the
dual-engine pin across dynamic regimes, and plan-migration invariants.

The load-bearing properties:

* a zero-dynamics timeline is *bit-identical* to the plain static run
  on both engines (the scenario layer adds no arithmetic),
* the 1e-6 differential pin holds across a mid-stream regime shift with
  online re-planning and in-flight migration (and is in fact bit-exact
  here),
* migration conserves work: every task completes exactly once, every
  resource's busy + attributed bubbles tile the horizon (including the
  ``replanning`` cause), and both engines migrate the same tasks.
"""

import math

import pytest

from repro_torch.core.costs import (A6000_SERVER, JETSON_NX, LinkProfile,
                              WIFI_5GHZ)
from repro_torch.core.pipeline import run_pipeline
from repro_torch.core.sim import PoolSpec
from repro_torch.models.cnn import vgg16
from repro_torch.obs.bubbles import REPLANNING, attribute, chain_resources
from repro_torch.scenarios import (LinkShift, LoadScale, ReplicaDown, ReplicaUp,
                             TenantArrive, TenantDepart, Timeline,
                             run_chain_scenario, run_churn_scenario)
from repro_torch.scenarios.replan import (PlanSchedule, PlanVersion,
                                    RegimeDetector, replan_timeline)

DEVICES = (JETSON_NX, A6000_SERVER)
LINKS = (WIFI_5GHZ(50.0),)


@pytest.fixture(scope="module")
def base():
    """Shared base plan + period for the 2-tier vgg16 deployment."""
    graph = vgg16()
    versions, _ = replan_timeline(graph, DEVICES, list(LINKS),
                                  arrivals=[])
    period = versions[0].times.max_stage * 1.05
    return graph, versions[0], period


# ------------------------------------------------------------ compilation
def test_timeline_link_profiles_only_trace_shifted_hops():
    tl = Timeline([LinkShift(1.0, 0, 10.0)], horizon=5.0)
    nominal = [LinkProfile("a", 50e6), LinkProfile("b", 400e6)]
    out = tl.link_profiles(nominal)
    assert out[0].trace is not None and out[1] is nominal[1]
    assert out[0].bps_at(0.5) == 50e6 and out[0].bps_at(1.5) == 10e6


def test_timeline_availability_windows():
    tl = Timeline([ReplicaDown(1.0, 0, 1), ReplicaUp(2.0, 0, 1),
                   ReplicaDown(3.0, 1, 0)], horizon=4.0)
    av = tl.availability()
    assert av[(0, 1)] == [(1.0, 2.0)]
    assert av[(1, 0)] == [(3.0, 4.0)]  # no rejoin: down to horizon


def test_timeline_load_scale_changes_arrival_density():
    tl = Timeline([LoadScale(1.0, 2.0)], horizon=4.0)
    arr = tl.arrivals(0.5)
    # 0.5 s spacing before t=1, 1.0 s spacing after
    assert arr[:3] == [0.0, 0.5, 1.0]
    assert arr[3] - arr[2] == pytest.approx(1.0)


def test_timeline_tenant_streams():
    tl = Timeline([TenantArrive(0.0, 0, 1.0), TenantArrive(2.0, 1, 0.5),
                   TenantDepart(4.0, 1)], horizon=6.0)
    per = tl.tenant_arrivals()
    assert per[0][0] == 0.0 and len(per[0]) == 6
    assert per[1][0] == 2.0 and all(t < 4.0 for t in per[1])


# ---------------------------------------------------------- zero dynamics
def test_zero_dynamics_bit_identical_to_static(base):
    graph, v0, period = base
    n = 30
    tl0 = Timeline([], horizon=(n + 5) * period)
    res = run_chain_scenario(graph, DEVICES, LINKS, tl0, n_tasks=n)
    assert res.n_replans == 0 and res.n_migrations == 0
    assert res.max_done_delta == 0.0
    direct = run_pipeline([v0.plan] * n, arrivals=tl0.arrivals(period, n),
                          links=[LINKS[0]])
    for pr in (res.sim, res.async_):
        assert all(a.done == b.done
                   for a, b in zip(direct.tasks, pr.tasks))


# ----------------------------------------------- regime shift + migration
@pytest.fixture(scope="module")
def degraded(base):
    graph, _v0, period = base
    n = 90
    tl = Timeline([LinkShift(20 * period, 0, 12.0),
                   LinkShift(60 * period, 0, 50.0)],
                  horizon=(n + 5) * period)
    res = run_chain_scenario(graph, DEVICES, LINKS, tl, n_tasks=n,
                             min_gap=10 * period, degraded_tx_scale=0.5)
    return res


def test_pin_holds_across_regime_shift(degraded):
    res = degraded
    assert res.n_replans >= 1 and res.n_migrations >= 1
    assert res.max_done_delta <= 1e-6  # run_dual asserts this too


def test_migration_conserves_tasks_and_horizon(degraded):
    res = degraded
    ids_s = sorted(t.id for t in res.sim.tasks)
    ids_a = sorted(t.id for t in res.async_.tasks)
    assert ids_s == ids_a == list(range(len(ids_s)))  # once each, no loss
    for rec in res.traces:
        att = attribute(rec, resources=chain_resources(res.sim.n_hops))
        assert att.max_conservation_error() <= 1e-9
        causes = {c for cs in att.by_label().values() for c in cs}
        assert REPLANNING in causes


def test_replanned_variant_beats_static_in_window(base, degraded):
    graph, _v0, period = base
    n = 90
    tl = Timeline([LinkShift(20 * period, 0, 12.0),
                   LinkShift(60 * period, 0, 50.0)],
                  horizon=(n + 5) * period)
    static = run_chain_scenario(graph, DEVICES, LINKS, tl, n_tasks=n,
                                replan=False)
    lo, hi = 20 * period, 60 * period

    def p99(pr):
        lat = sorted(t.latency for t in pr.tasks
                     if lo <= t.arrival < hi)
        return lat[min(len(lat) - 1, int(math.ceil(0.99 * len(lat))))]

    assert p99(degraded.sim) < p99(static.sim)


# ------------------------------------------------------------------ churn
def test_churn_scenario_pinned_on_pools(base):
    graph, v0, period = base
    pools = [PoolSpec((1.0, 1.0)), PoolSpec((1.0, 1.0, 1.0))]
    tl = Timeline([ReplicaDown(10 * period, 1, 0),
                   ReplicaUp(40 * period, 1, 0),
                   ReplicaDown(20 * period, 0, 1),
                   ReplicaUp(35 * period, 0, 1)],
                  horizon=70 * period)
    res = run_churn_scenario([v0.plan], tl, period, pools,
                             links=[LINKS[0]], n_tasks=60)
    assert res.max_done_delta <= 1e-6
    assert len(res.sim.tasks) == 60


# ------------------------------------------------------ schedule invariants
def test_plan_schedule_splices_relative_to_admission(base):
    _graph, v0, _period = base
    n_hops = len(LINKS) + 1
    base_v = PlanVersion(-math.inf, v0.plan, (1.0,) * v0.times.n_hops)
    late_v = PlanVersion(0.5, v0.plan, (0.5,) * v0.times.n_hops)
    sched = PlanSchedule([base_v, late_v], arrivals=[0.0, 0.7],
                         n_hops=n_hops)
    # task 0 admitted under v0: migrating at t=0.6 halves its volumes
    p0 = sched(0, 0, 0.6)
    assert p0.tx[0] == pytest.approx(sched.sim_plans[0].tx[0] * 0.5)
    # consulted again: no further migration (version already applied)
    assert sched(0, 0, 0.8) is None
    # task 1 admitted under the late version: nothing to migrate to
    assert sched(1, 0, 0.9) is None
    assert sched.n_migrations == 1
    sched.reset()
    assert sched.n_migrations == 0 and sched(0, 0, 0.6) is not None


def test_regime_detector_drift_and_rebase():
    det = RegimeDetector([50e6], alpha=0.5, threshold=0.25)
    assert not det.observe(0, 50e6)
    assert det.observe(0, 12e6)  # ema 31e6, drift 19e6 > 12.5e6
    det.rebase()
    assert not det.observe(0, det.ema[0])  # re-based: no drift at ema
