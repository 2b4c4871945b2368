"""Replicated-tier pools: differential pins + unit coverage.

The tentpole contract of the pool DAG: per-tier replica pools
(``sim.PoolSpec``, heterogeneous speeds allowed) behind a pluggable
router (``serving.routing``) must time identically in the arithmetic
simulator (``sim.simulate_pool_stream``: staged dispatch -> per-replica
replay -> sequencer) and the event-driven executor
(``AsyncHopPipeline(pools=...)``: dispatcher / replica / sequencer
workers under the virtual clock) — completion times, routes, and
per-replica busy intervals to 1e-6, across every router policy and
``m in {1, 2, 4}``.  An ``m = 1`` pool must reduce *bit-identically* to
the legacy serial chain.  Micro-batching (per-tier caps) composes with
replication on both sides.

Deterministic regression tests for the two ``core.online`` bugfixes ride
along here (the hypothesis versions live in ``test_pool_props.py``):
``gap_features`` layout handling and the cold-cache separability /
exit-eligibility rule.
"""

import numpy as np
import pytest

from repro_torch.core import online as ON
from repro_torch.core import sim
from repro_torch.core.pipeline import (TaskPlan, result_from_pool_stream,
                                 run_pipeline)
from repro_torch.serving.async_engine import (AsyncCoachEngine, AsyncHopPipeline,
                                        VirtualClock, run_pipeline_async)
from repro_torch.serving.base import EngineConfig
from repro_torch.serving.engine import CoachEngine
from repro_torch.serving.routing import (ROUTER_POLICIES, RouterPolicy,
                                   make_router)
from repro_torch.serving.tenancy import MultiTenantHopPipeline, make_policy
from test_torch_twin_async_engine import (_random_multihop_plans,
                                     _random_single_hop_plans)
from test_torch_twin_batching import _batched_plans

TOL = 1e-6

POLICIES = sorted(ROUTER_POLICIES)


# ----------------------------------------------------------------- helpers
def _sim_plans(plans, n_hops):
    return [p.as_sim_plan(n_hops) for p in plans]


def _pin_pool(plans, arrivals, pools, policy, n_hops, seed=0, links=None,
              batch_caps=None, tol=TOL):
    """Run both sides on identical inputs and assert the timelines and
    placements agree to ``tol``."""
    sps = _sim_plans(plans, n_hops)
    ps = sim.simulate_pool_stream(sps, arrivals, pools,
                                  make_router(policy, seed=seed),
                                  links=links, batch_caps=batch_caps)
    pipe = AsyncHopPipeline(n_hops, links=links, clock=VirtualClock(),
                            pools=pools,
                            router=make_router(policy, seed=seed),
                            batch_caps=batch_caps)
    pa = pipe.run(lambda i, _a: sps[i], len(sps), arrivals)
    assert isinstance(pa, sim.PoolStreamResult)
    assert ps.routes == pa.routes
    for a, b in zip(ps.done, pa.done):
        assert abs(a - b) <= tol
    for k in range(n_hops + 1):
        for r in range(len(ps.replica_intervals[k])):
            ia = ps.replica_intervals[k][r]
            ib = pa.replica_intervals[k][r]
            assert len(ia) == len(ib)
            for (s1, e1), (s2, e2) in zip(ia, ib):
                assert abs(s1 - s2) <= tol and abs(e1 - e2) <= tol
            assert abs(ps.replica_busy[k][r] - pa.replica_busy[k][r]) <= tol
    for a, b in zip(ps.link_busy, pa.link_busy):
        assert abs(a - b) <= tol
    return ps, pa


# ------------------------------------------------------------ pool basics
def test_pool_spec_and_as_pools_normalization():
    p = sim.PoolSpec((1.0, 2.0, 0.5))
    assert p.m == 3
    # ints, speed tuples, and PoolSpec instances normalize; a missing
    # tail pads with single unit replicas
    pools = sim.as_pools([2, (1.0, 1.5), p], 5)
    assert [q.m for q in pools] == [2, 2, 3, 1, 1]
    assert pools[0].speeds == (1.0, 1.0)
    assert pools[1].speeds == (1.0, 1.5)
    with pytest.raises(AssertionError):
        sim.PoolSpec((1.0, -2.0))


def test_make_router_names_and_passthrough():
    for name in POLICIES:
        r = make_router(name, seed=3)
        assert isinstance(r, RouterPolicy)
        assert make_router(r) is r
    with pytest.raises(ValueError):
        make_router("least-loaded")


# --------------------------------------------------- m = 1 chain identity
@pytest.mark.parametrize("n_hops", [1, 2, 3])
def test_m1_pools_reduce_bitwise_to_chain(n_hops):
    """Single-replica pools are the serial chain, *bit-identically*: the
    staged pool replay takes the same float expressions (``1.0 * x`` is
    exact), and one serial replica's release instants are monotone, so
    the sequencer never delays a forward."""
    plans = _random_multihop_plans(11, n=40, n_hops=n_hops) if n_hops > 1 \
        else _random_single_hop_plans(11, n=40)
    sps = _sim_plans(plans, n_hops)
    arr = [i * 1.5e-3 for i in range(len(sps))]
    ref = sim.simulate_stream(sps, arr)
    for policy in POLICIES:
        res = sim.simulate_pool_stream(sps, arr, [1] * (n_hops + 1),
                                       make_router(policy))
        sr = res.as_stream_result()
        assert sr.done == ref.done                      # bitwise
        assert sr.compute_busy == ref.compute_busy
        assert sr.link_busy == ref.link_busy
        assert sr.compute_intervals == ref.compute_intervals
        assert sr.link_intervals == ref.link_intervals
        # every tier a task reached placed it on the only replica
        assert all(r in (None, 0) for rt in res.routes for r in rt)


# ------------------------------------------------- differential pinning
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("m", [1, 2, 4])
def test_differential_pool_executor_pinned(policy, m):
    """Acceptance: executor == simulator at 1e-6 for every router policy
    and m in {1, 2, 4} on the bottleneck (middle) tier."""
    plans = _random_multihop_plans(23, n=40, n_hops=2)
    arr = [i * 1.0e-3 for i in range(len(plans))]
    _pin_pool(plans, arr, [1, m, 1], policy, n_hops=2, seed=5)


@pytest.mark.parametrize("policy", POLICIES)
def test_differential_heterogeneous_pools_pinned(policy):
    """Replicas with different speeds (service = speed * segment time)
    stay pinned — including a pool on every tier at once."""
    plans = _random_multihop_plans(31, n=36, n_hops=2)
    arr = [i * 0.8e-3 for i in range(len(plans))]
    pools = [2, (1.0, 1.7, 0.6), (0.5, 2.0)]
    ps, _ = _pin_pool(plans, arr, pools, policy, n_hops=2, seed=9)
    # heterogeneity actually exercised: some task landed off replica 0
    assert any(r not in (None, 0) for rt in ps.routes for r in rt)


def test_differential_pool_with_traced_links_pinned():
    """Dynamic per-hop bandwidth (trace repricing at the transfer's
    actual start) composes with pools on both sides."""
    from repro_torch.core.costs import LinkProfile
    from repro_torch.core.pipeline import bandwidth_step_trace
    plans = _random_multihop_plans(41, n=30, n_hops=2, hop_exits=True)
    arr = [i * 1.2e-3 for i in range(len(plans))]
    links = [LinkProfile("uplink", 20e6,
                         trace=bandwidth_step_trace([(0.0, 20.0),
                                                     (15e-3, 6.0)])),
             LinkProfile("backhaul", 900e6)]
    _pin_pool(plans, arr, [1, 2, 2], "jsq", n_hops=2, links=links)


@pytest.mark.parametrize("policy", ["jsq", "po2"])
def test_differential_batched_pools_pinned(policy):
    """Micro-batching (PR 6) composes with replication: per-replica
    greedy batch formation at speed-scaled service times pins at 1e-6,
    and real multi-task batches form."""
    plans = _batched_plans(7, n_hops=2, n=40, deadline_slack=30e-3)
    arr = [i * 0.6e-3 for i in range(len(plans))]
    ps, pa = _pin_pool(plans, arr, [2, 2, 2], policy, n_hops=2, seed=1,
                       batch_caps=[2, 4, 3])
    assert ps.replica_batch_sizes == pa.replica_batch_sizes
    assert max(b for tier in ps.replica_batch_sizes
               for rep in tier for b in rep) > 1


def test_pool_throughput_scales_on_bottleneck_tier():
    """Replicating the bottleneck tier raises throughput: m = 2 on a
    dominant middle tier must cut the makespan materially (near 2x when
    that tier is the only bottleneck)."""
    n = 60
    sps = [sim.SimPlan(compute=(0.2e-3, 4e-3, 0.2e-3),
                       tx=(0.05e-3, 0.05e-3),
                       tx_offset=(None, None), rx_offset=(None, None))
           for _ in range(n)]
    arr = [i * 0.1e-3 for i in range(n)]
    t1 = sim.simulate_pool_stream(sps, arr, [1, 1, 1],
                                  make_router("jsq")).makespan
    t2 = sim.simulate_pool_stream(sps, arr, [1, 2, 1],
                                  make_router("jsq")).makespan
    assert t1 / t2 >= 1.8


# -------------------------------------------------- result-type plumbing
def test_pool_stream_result_tier_view_and_bubbles():
    plans = _random_multihop_plans(3, n=30, n_hops=2)
    arr = [i * 0.5e-3 for i in range(len(plans))]
    res = sim.simulate_pool_stream(_sim_plans(plans, 2), arr, [1, 2, 1],
                                   make_router("jsq"))
    # tier busy = sum of its replicas
    for k in range(3):
        assert abs(res.compute_busy[k] - sum(res.replica_busy[k])) < 1e-12
    pr = result_from_pool_stream(res)
    assert pr.pool_sizes == (1, 2, 1)
    # utilization judged against m * makespan keeps bubbles in [0, 1]
    for k in range(3):
        assert 0.0 <= pr.bubble_fraction(("compute", k)) <= 1.0
    assert 0.0 <= pr.bubble_fraction("cloud") <= 1.0


def test_run_pipeline_pool_path_matches_pool_sim():
    plans = _random_multihop_plans(5, n=24, n_hops=2)
    arr = [i * 1e-3 for i in range(len(plans))]
    pr = run_pipeline(plans, arrivals=arr, links=[None, None],
                      pools=[1, 2, 1], router=make_router("po2", seed=2))
    ref = sim.simulate_pool_stream(_sim_plans(plans, 2), arr, [1, 2, 1],
                                   make_router("po2", seed=2))
    assert pr.pool_sizes == (1, 2, 1)
    assert abs(pr.makespan - ref.makespan) < 1e-12
    assert [t.done for t in pr.tasks] == list(ref.done)


def test_run_pipeline_async_pool_path_pinned_to_sync():
    plans = _random_multihop_plans(13, n=24, n_hops=2)
    arr = [i * 1e-3 for i in range(len(plans))]
    pr_s = run_pipeline(plans, arrivals=arr, links=[None, None],
                        pools=[2, 2, 1], router=make_router("jsq"))
    pr_a = run_pipeline_async(plans, arrivals=arr, links=[None, None],
                              clock=VirtualClock(), pools=[2, 2, 1],
                              router=make_router("jsq"))
    assert pr_a.pool_sizes == (2, 2, 1)
    assert abs(pr_s.makespan - pr_a.makespan) < TOL
    for a, b in zip(pr_s.tasks, pr_a.tasks):
        assert abs(a.done - b.done) < TOL


# --------------------------------------------------------- multi-tenant
@pytest.mark.parametrize("policy", ["fifo", "rr", "wdrr"])
def test_differential_multitenant_pool_pinned(policy):
    """Pool ingress credits (a token whenever *any* tier-0 replica
    frees) generalize the single-replica credit gate: executor ==
    ``simulate_multitenant_pool_stream`` on order + merged timeline."""
    rng = np.random.RandomState(29)
    n_hops, weights = 2, [1.0, 2.5, 0.5]
    plans, arrs = [], []
    for t in range(3):
        n = int(rng.randint(8, 14))
        ps, ar = [], []
        tt = float(rng.uniform(0, 1e-3))
        for _ in range(n):
            comp = tuple(rng.uniform(1e-4, 4e-3, n_hops + 1))
            tx = tuple(rng.uniform(0.0, 2e-3, n_hops))
            ps.append(TaskPlan.multihop(comp, tx).as_sim_plan(n_hops))
            ar.append(tt)
            tt += float(rng.uniform(0, 1e-3))
        plans.append(ps)
        arrs.append(ar)
    pools = [2, 2, 1]
    mt_sim = sim.simulate_multitenant_pool_stream(
        plans, arrs, make_policy(policy, weights=weights), pools,
        make_router("jsq", seed=4))
    pipe = MultiTenantHopPipeline(
        n_hops, clock=VirtualClock(),
        policy=make_policy(policy, weights=weights), pools=pools,
        router=make_router("jsq", seed=4))
    mt_ex = pipe.run([(lambda t: (lambda i, _a: plans[t][i]))(t)
                      for t in range(3)], arrs)
    assert isinstance(mt_ex, sim.MultiTenantPoolStreamResult)
    assert mt_ex.order == mt_sim.order
    for a, b in zip(mt_sim.stream.done, mt_ex.stream.done):
        assert abs(a - b) <= TOL


def test_multitenant_pool_affinity_keeps_tenants_sticky():
    """The affinity router pins each tenant to one replica per tier."""
    n_hops = 1
    plans = [[sim.SimPlan(compute=(1e-3, 2e-3), tx=(0.1e-3,),
                          tx_offset=(None,), rx_offset=(None,))
              for _ in range(8)] for _ in range(2)]
    arrs = [[i * 0.4e-3 for i in range(8)],
            [0.1e-3 + i * 0.4e-3 for i in range(8)]]
    res = sim.simulate_multitenant_pool_stream(
        plans, arrs, make_policy("rr"), [1, 2], make_router("affinity"))
    pool = res.pool
    assert pool is not None
    by_tenant = {}
    for (t, _i), rt in zip(res.order, pool.routes):
        by_tenant.setdefault(t, set()).add(rt[1])
    assert all(len(reps) == 1 for reps in by_tenant.values())
    assert by_tenant[0] != by_tenant[1]   # JSQ seeding spread them


# --------------------------------------------------------- engine level
def _mk_pool_engines(**cfg_kw):
    from repro_torch.core.costs import DeviceProfile, LinkProfile
    from repro_torch.core.schedule import StageTimes
    from repro_torch.data.pipeline import (CorrelatedTaskStream,
                                     make_calibration_set)
    st = StageTimes(
        T_e=2e-3, T_t=4e-3, T_c=2e-3, T_t_par=0.0, T_c_par=0.0,
        latency=9e-3, first_tx_offset=2e-3, cloud_start_offset=3e-3,
        compute=(2e-3, 1.5e-3, 2e-3), link=(3e-3, 1e-3),
        link_par=(0.0, 0.0), compute_par=(0.0, 0.0),
        tx_offsets=(2e-3, 1.5e-3), rx_offsets=(3e-3, 1e-3))
    links = [LinkProfile("uplink", 20e6), LinkProfile("backhaul", 900e6)]
    stream = CorrelatedTaskStream(n_labels=30, dim=48,
                                  correlation="medium", seed=2)
    feats, labels = make_calibration_set(stream, 400)
    mk = lambda cls: cls(
        None, st, DeviceProfile("end", 1e9), links[0],
        DeviceProfile("cloud", 8e9), n_labels=30, calib_feats=feats,
        calib_labels=labels, boundary_elems=50_000, links=links,
        cfg=EngineConfig(**cfg_kw))

    def classify(task):
        d = np.linalg.norm(stream.mu - task.features[None], axis=1)
        return task.features, int(np.argmin(d))

    return mk(CoachEngine), mk(AsyncCoachEngine), stream, classify


def test_engine_pool_config_sync_equals_async():
    """EngineConfig pool knobs plumb end to end: the sync engine (pool
    simulator) and async engine (pool executor) agree on the timeline
    and both report the pool topology."""
    sync_e, async_e, stream, classify = _mk_pool_engines(
        per_hop_bits=False, pool_sizes=[1, 2, 2], router="jsq",
        router_seed=3)
    assert sync_e.pools is not None
    tasks = list(stream.tasks(40))
    ss = sync_e.run_stream(list(tasks), 2e-3, classify)
    sa = async_e.run_stream(list(tasks), 2e-3, classify,
                            clock=VirtualClock())
    assert ss.pipeline.pool_sizes == (1, 2, 2)
    assert sa.pipeline.pool_sizes == (1, 2, 2)
    assert abs(ss.pipeline.makespan - sa.pipeline.makespan) < TOL
    for a, b in zip(ss.pipeline.tasks, sa.pipeline.tasks):
        assert abs(a.done - b.done) < TOL
    assert ss.exit_ratio == sa.exit_ratio
    assert ss.accuracy == sa.accuracy


def test_engine_pool_speeds_override_sizes():
    sync_e, _, _, _ = _mk_pool_engines(
        pool_sizes=[2, 2, 2], pool_speeds=[[1.0], [1.0, 1.5], [1.0]])
    assert tuple(p.speeds for p in sync_e.pools) == \
        ((1.0,), (1.0, 1.5), (1.0,))


# ------------------------------------------ online bugfix regressions
def test_gap_features_layout_explicit_and_heuristic():
    """Regression (``core.online.gap_features``): the shape heuristic
    misclassifies deep channels-first maps — ``(512, 7, 7)`` pooled over
    its channel axis yields 7 spatial means.  The explicit ``layout``
    parameter fixes it; ``None`` keeps the documented legacy fallback."""
    rng = np.random.RandomState(0)
    shallow = rng.rand(64, 112, 112)       # heuristic: CHW (correct)
    deep = rng.rand(512, 7, 7)             # heuristic: HWC (WRONG)
    deep_hwc = rng.rand(7, 7, 512)         # heuristic: CHW (WRONG axis!)
    # explicit layout: channel-dimension outputs
    assert ON.gap_features(shallow, layout="CHW").shape == (64,)
    assert ON.gap_features(deep, layout="CHW").shape == (512,)
    assert ON.gap_features(deep_hwc, layout="HWC").shape == (512,)
    np.testing.assert_allclose(ON.gap_features(deep, layout="CHW"),
                               deep.mean(axis=(1, 2)))
    np.testing.assert_allclose(ON.gap_features(deep_hwc, layout="HWC"),
                               deep_hwc.mean(axis=(0, 1)))
    # the documented fallback reproduces the legacy (buggy) behavior
    assert ON.gap_features(shallow).shape == (64,)
    assert ON.gap_features(deep).shape == (7,)        # former misbehavior
    # batched maps: legacy default assumed (B,C,H,W)
    b = rng.rand(4, 16, 8, 8)
    assert ON.gap_features(b).shape == (4, 16)
    assert ON.gap_features(rng.rand(4, 8, 8, 16),
                           layout="HWC").shape == (4, 16)
    with pytest.raises(ValueError):
        ON.gap_features(deep, layout="CWH")


def test_cold_cache_never_exits_below_two_warm_labels():
    """Regression (cold-cache separability): with exactly one warmed
    label every untrained center contributes similarity 0.0, so t_SH is
    an artificial 0 and Eq. 9 blows up through ``t_H / max(t_SH,
    1e-12)`` — the legacy scheduler exited warm-up tasks spuriously.
    Eq. 9 now runs over trained centers only and exit eligibility
    requires >= 2 warmed labels."""
    rng = np.random.RandomState(1)
    cache = ON.SemanticCache(n_labels=8, dim=16)
    assert cache.n_warm == 0
    f = rng.rand(16)
    # one warmed label: similarity vector has exactly one nonzero entry
    cache.update(f, 3)
    assert cache.n_warm == 1
    sims = cache.similarities(f)
    assert np.count_nonzero(sims) == 1
    # trained-centers-only Eq. 9: no second-highest degree -> 0, where
    # the legacy full-vector statistic blew up past any threshold
    assert ON.separability(sims, cache.counts) == 0.0
    assert ON.separability(sims) > 1e6            # former misbehavior
    th = ON.Thresholds(s_ext=0.5, s_adj=((0.9, 3), (0.0, 8)))
    sched = ON.OnlineScheduler(cache, th, boundary_elems=1000,
                               T_e=1e-3, T_c=1e-3)
    dec = sched.step(f, bandwidth_bps=1e6)
    assert not dec.early_exit            # a cold cache never terminates
    # two warmed labels: eligibility restored, statistic finite
    cache.update(rng.rand(16), 5)
    assert cache.n_warm == 2
    dec2 = sched.step(f, bandwidth_bps=1e6)
    s2 = ON.separability(cache.similarities(f), cache.counts)
    assert np.isfinite(s2)
    if dec2.early_exit:
        assert s2 > th.s_ext


def test_cold_cache_rule_applies_to_hop_probes():
    rng = np.random.RandomState(2)
    cache = ON.SemanticCache(4, 8)
    cache.warm_up(rng.rand(12, 8), rng.randint(0, 4, 12))
    th = ON.Thresholds(s_ext=float("inf"), s_adj=((0.0, 8),))
    probe_cache = ON.SemanticCache(4, 8)
    probe_cache.update(rng.rand(8), 0)   # single warm label at the tier
    probe = ON.HopProbe(cache=probe_cache,
                        thresholds=ON.Thresholds(s_ext=0.0,
                                                 s_adj=((0.0, 8),)))
    sched = ON.OnlineScheduler(cache, th, 1000, 1e-3, 1e-3,
                               hop_elems=[1000, 1000],
                               stage_compute=[1e-3, 1e-3, 1e-3],
                               hop_probes=[probe])
    dec = sched.probe_hop(1, rng.rand(8))
    assert dec.exit_hop is None          # cold tier probe never exits


def test_warm_cache_separability_unchanged_by_fix():
    """A fully warmed cache is unaffected: every center is trained, so
    the trained-centers restriction is the identity."""
    rng = np.random.RandomState(3)
    cache = ON.SemanticCache(6, 12)
    cache.warm_up(rng.rand(60, 12), rng.randint(0, 6, 60))
    assert cache.n_warm == 6
    for _ in range(10):
        sims = cache.similarities(rng.rand(12))
        assert ON.separability(sims, cache.counts) == \
            ON.separability(sims)
