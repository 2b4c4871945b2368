"""Hypothesis properties for replicated-tier pools.

The main property is the PR's acceptance invariant at generative scale:
for any drawn stream (task count, service times, hop exits), pool shape
(replica counts, heterogeneous speeds), and router policy, the async
pool executor under the virtual clock reproduces
``sim.simulate_pool_stream`` — completions, routes, per-replica busy
intervals — to 1e-6; single-replica pools reduce bit-identically to the
serial chain.  The cold-cache exit rule is also pinned generatively: no
scheduler configuration may terminate a task while fewer than two labels
are warm.  (Module is collect-ignored by ``conftest.py`` when hypothesis
is not installed.)
"""

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import online as ON
from repro_torch.core import sim
from repro_torch.serving.async_engine import AsyncHopPipeline, VirtualClock
from repro_torch.serving.routing import ROUTER_POLICIES, make_router

TOL = 1e-6


@st.composite
def pool_scenarios(draw):
    n_hops = draw(st.integers(1, 3))
    n = draw(st.integers(1, 16))
    plans, arr, t = [], [], 0.0
    for _ in range(n):
        comp = tuple(draw(st.floats(1e-4, 5e-3)) for _ in range(n_hops + 1))
        tx = tuple(draw(st.floats(1e-5, 3e-3)) for _ in range(n_hops))
        exit_hop = draw(st.one_of(st.none(), st.integers(0, n_hops - 1))) \
            if n_hops > 1 else None
        plans.append(sim.SimPlan(compute=comp, tx=tx,
                                 tx_offset=(None,) * n_hops,
                                 rx_offset=(None,) * n_hops,
                                 exit_hop=exit_hop))
        arr.append(t)
        # strictly positive gaps: zero-duration event chains are the
        # executor's known settle() blind spot (same exposure as the
        # chain/batching differential suites)
        t += draw(st.floats(1e-5, 3e-3))
    pools = []
    for _ in range(n_hops + 1):
        m = draw(st.integers(1, 4))
        pools.append(tuple(draw(st.floats(0.3, 2.5))
                           for _ in range(m)))
    policy = draw(st.sampled_from(sorted(ROUTER_POLICIES)))
    seed = draw(st.integers(0, 5))
    return plans, arr, pools, policy, seed


@settings(max_examples=40, deadline=None)
@given(sc=pool_scenarios())
def test_pool_executor_pinned_to_simulator(sc):
    plans, arr, pools, policy, seed = sc
    n_hops = len(plans[0].tx)
    ps = sim.simulate_pool_stream(plans, arr, pools,
                                  make_router(policy, seed=seed))
    pipe = AsyncHopPipeline(n_hops, clock=VirtualClock(), pools=pools,
                            router=make_router(policy, seed=seed))
    pa = pipe.run(lambda i, _a: plans[i], len(plans), arr)
    assert ps.routes == pa.routes
    for a, b in zip(ps.done, pa.done):
        assert abs(a - b) <= TOL
    for k in range(n_hops + 1):
        for r in range(len(pools[k])):
            ia, ib = ps.replica_intervals[k][r], pa.replica_intervals[k][r]
            assert len(ia) == len(ib)
            for (s1, e1), (s2, e2) in zip(ia, ib):
                assert abs(s1 - s2) <= TOL and abs(e1 - e2) <= TOL


@settings(max_examples=40, deadline=None)
@given(sc=pool_scenarios())
def test_m1_pool_is_bitwise_chain(sc):
    plans, arr, pools, policy, _seed = sc
    m1 = [1] * len(pools)
    ref = sim.simulate_stream(plans, arr)
    res = sim.simulate_pool_stream(plans, arr, m1, make_router(policy))
    sr = res.as_stream_result()
    assert sr.done == ref.done
    assert sr.compute_intervals == ref.compute_intervals
    assert sr.link_intervals == ref.link_intervals


@settings(max_examples=40, deadline=None)
@given(sc=pool_scenarios())
def test_pool_routes_are_valid_and_conserving(sc):
    """Every reached tier places the task on exactly one in-range
    replica; tiers past a hop exit are never routed; replica interval
    counts sum to the tier's task load."""
    plans, arr, pools, policy, seed = sc
    res = sim.simulate_pool_stream(plans, arr, pools,
                                   make_router(policy, seed=seed))
    for p, rt in zip(plans, res.routes):
        for k, r in enumerate(rt):
            if sim.occupies_compute(p.exit_hop, k):
                assert r is not None and 0 <= r < len(pools[k])
            else:
                assert r is None


@settings(max_examples=60, deadline=None)
@given(
    n_labels=st.integers(2, 10),
    dim=st.integers(2, 24),
    warm_label=st.integers(0, 9),
    n_updates=st.integers(1, 6),
    s_ext=st.floats(0.0, 5.0, allow_nan=False),
    seed=st.integers(0, 1000),
)
def test_no_exit_with_fewer_than_two_warm_labels(n_labels, dim, warm_label,
                                                 n_updates, s_ext, seed):
    """Cold-cache acceptance property: however the cache, thresholds,
    and feature stream are drawn, a scheduler whose cache has fewer than
    two warmed labels never terminates a task (Eq. 9 over trained
    centers only + the >= 2 warm-label eligibility rule)."""
    rng = np.random.RandomState(seed)
    cache = ON.SemanticCache(n_labels, dim)
    label = warm_label % n_labels
    th = ON.Thresholds(s_ext=s_ext, s_adj=((0.0, 8),))
    sched = ON.OnlineScheduler(cache, th, boundary_elems=100,
                               T_e=1e-3, T_c=1e-3,
                               update_centers=False)
    # zero warm labels, then exactly one (updated repeatedly)
    for _ in range(3):
        dec = sched.step(rng.rand(dim), bandwidth_bps=1e6)
        assert not dec.early_exit
        assert dec.separability == 0.0
    for _ in range(n_updates):
        cache.update(rng.rand(dim), label)
    assert cache.n_warm == 1
    for _ in range(5):
        dec = sched.step(rng.rand(dim), bandwidth_bps=1e6)
        assert not dec.early_exit
