"""Differential harness: the async hop-queue executor pinned to
``core.sim.simulate_stream``.

The async executor (one worker per ``2n+1`` resource, virtual clock,
unbounded hop queues) must reproduce the event simulator's timeline —
per-task completion times, per-resource busy time / intervals, bubble
fractions — to 1e-6, on the seed single-hop scenario, multi-hop chains,
and dynamic-bandwidth traces.  On top of that: decision determinism
(async == sync EngineStats), bounded-queue backpressure sanity, real
segment execution through worker handles, and the EngineConfig
mutable-default regression.
"""

import numpy as np
import pytest

from repro_torch.core.costs import DeviceProfile, LinkProfile
from repro_torch.core.pipeline import (TaskPlan, bandwidth_step_trace,
                                 plan_from_stage_times, run_pipeline)
from repro_torch.core.schedule import PartitionDecision, StageTimes, \
    evaluate_partition
from repro_torch.data.pipeline import (CorrelatedTaskStream, make_calibration_set,
                                 make_hop_calibration_sets)
from repro_torch.serving.async_engine import (AsyncCoachEngine, AsyncHopPipeline,
                                        VirtualClock, run_pipeline_async)
from repro_torch.serving.base import EngineConfig
from repro_torch.serving.engine import CoachEngine

TOL = 1e-6

END = DeviceProfile("end", 1e9)
CLOUD = DeviceProfile("cloud", 8e9)


# ----------------------------------------------------------------- helpers
def _random_single_hop_plans(seed, n=40):
    rng = np.random.RandomState(seed)
    plans = []
    for _ in range(n):
        t_end = rng.uniform(1e-3, 5e-3)
        if rng.rand() < 0.2:
            plans.append(TaskPlan(t_end, 0.0, 0.0, True))
            continue
        t_tx = rng.uniform(0.5e-3, 4e-3)
        t_cloud = rng.uniform(1e-3, 5e-3)
        tx_off = rng.uniform(0, t_end) if rng.rand() < 0.5 else None
        cl_off = rng.uniform(0, t_tx) if rng.rand() < 0.5 else None
        plans.append(TaskPlan(t_end, t_tx, t_cloud,
                              tx_offset=tx_off, cloud_offset=cl_off))
    return plans


def _random_multihop_plans(seed, n=40, n_hops=2, hop_exits=True):
    """Random streams mixing full-pipeline tasks, classic end-device
    exits, and (for ``n_hops >= 2``) hop-level semantic exits at every
    intermediate segment."""
    rng = np.random.RandomState(seed)
    plans = []
    for _ in range(n):
        comp = rng.uniform(1e-3, 4e-3, n_hops + 1)
        tx = rng.uniform(0.2e-3, 3e-3, n_hops)
        if rng.rand() < 0.15:
            plans.append(TaskPlan(comp[0], 0.0, 0.0, True))
            continue
        txo = [rng.uniform(0, comp[k]) if rng.rand() < 0.5 else None
               for k in range(n_hops)]
        rxo = [rng.uniform(0, tx[k]) if rng.rand() < 0.5 else None
               for k in range(n_hops)]
        exit_hop = None
        if hop_exits and n_hops >= 2 and rng.rand() < 0.25:
            exit_hop = int(rng.randint(1, n_hops))  # mid-pipeline exit
        plans.append(TaskPlan.multihop(comp, tx, txo, rxo,
                                       exit_hop=exit_hop))
    return plans


def _assert_timelines_agree(pr_sim, pr_async, tol=TOL):
    assert abs(pr_sim.makespan - pr_async.makespan) < tol
    assert len(pr_sim.tasks) == len(pr_async.tasks)
    for a, b in zip(pr_sim.tasks, pr_async.tasks):
        assert a.id == b.id and a.early_exit == b.early_exit
        assert a.exit_hop == b.exit_hop, a.id
        assert abs(a.done - b.done) < tol, a.id
        assert abs(a.latency - b.latency) < tol, a.id
    assert len(pr_sim.compute_busy) == len(pr_async.compute_busy)
    for k in range(len(pr_sim.compute_busy)):
        assert abs(pr_sim.compute_busy[k] - pr_async.compute_busy[k]) < tol
        assert abs(pr_sim.bubble_fraction(("compute", k))
                   - pr_async.bubble_fraction(("compute", k))) < tol
    for k in range(len(pr_sim.link_busy_hops)):
        assert abs(pr_sim.link_busy_hops[k]
                   - pr_async.link_busy_hops[k]) < tol
        assert abs(pr_sim.bubble_fraction(("link", k))
                   - pr_async.bubble_fraction(("link", k))) < tol
    # raw busy intervals, resource by resource, task by task
    for ivs, ivr in zip(pr_sim.compute_intervals, pr_async.compute_intervals):
        assert len(ivs) == len(ivr)
        for (s0, e0), (s1, e1) in zip(ivs, ivr):
            assert abs(s0 - s1) < tol and abs(e0 - e1) < tol
    for ivs, ivr in zip(pr_sim.link_intervals, pr_async.link_intervals):
        assert len(ivs) == len(ivr)
        for (s0, e0), (s1, e1) in zip(ivs, ivr):
            assert abs(s0 - s1) < tol and abs(e0 - e1) < tol


# ----------------------------------------------------- differential: plans
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_differential_single_hop_seed_scenario(seed):
    """The n_hops = 1 seed scenario: executor == simulator to 1e-6."""
    plans = _random_single_hop_plans(seed)
    pr_sim = run_pipeline(plans, arrival_period=2.5e-3)
    pr_async = run_pipeline_async(plans, arrival_period=2.5e-3)
    _assert_timelines_agree(pr_sim, pr_async)


@pytest.mark.parametrize("seed", [0, 1])
def test_differential_single_hop_with_bandwidth_trace(seed):
    link = LinkProfile("dyn", 50e6, trace=bandwidth_step_trace(
        [(0.0, 50.0), (0.03, 8.0), (0.1, 80.0)]))
    plans = _random_single_hop_plans(seed + 10)
    pr_sim = run_pipeline(plans, arrival_period=2.5e-3, link=link)
    pr_async = run_pipeline_async(plans, arrival_period=2.5e-3, link=link)
    _assert_timelines_agree(pr_sim, pr_async)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_hops", [2, 3])
def test_differential_multihop_chain(seed, n_hops):
    """3-tier and 4-tier chains (2/3 links), early exits included."""
    plans = _random_multihop_plans(seed, n_hops=n_hops)
    period = 2e-3
    pr_sim = run_pipeline(plans, arrival_period=period)
    pr_async = run_pipeline_async(plans, arrival_period=period)
    _assert_timelines_agree(pr_sim, pr_async)


def test_differential_multihop_with_traced_uplink():
    uplink = LinkProfile("dyn", 40e6, trace=bandwidth_step_trace(
        [(0.0, 40.0), (0.02, 6.0), (0.08, 60.0)]))
    backhaul = LinkProfile("bh", 900e6)
    plans = _random_multihop_plans(5, n_hops=2)
    pr_sim = run_pipeline(plans, arrival_period=2e-3,
                          links=[uplink, backhaul])
    pr_async = run_pipeline_async(plans, arrival_period=2e-3,
                                  links=[uplink, backhaul])
    _assert_timelines_agree(pr_sim, pr_async)


def test_differential_irregular_arrivals():
    rng = np.random.RandomState(42)
    plans = _random_multihop_plans(7, n_hops=2, n=30)
    arrivals = np.cumsum(rng.uniform(0, 4e-3, len(plans))).tolist()
    pr_sim = run_pipeline(plans, arrivals=arrivals)
    pr_async = run_pipeline_async(plans, arrivals=arrivals)
    _assert_timelines_agree(pr_sim, pr_async)


# ------------------------------------------------- hop-level semantic exit
def test_differential_exit_at_hop_1_of_3_hop_chain():
    """Acceptance: tasks exiting at hop 1 of a 3-hop chain — executor ==
    simulator at 1e-6, and the exit releases every downstream resource
    (links >= 1 and computes >= 2 never see the exited tasks)."""
    rng = np.random.RandomState(13)
    plans = []
    for i in range(36):
        comp = rng.uniform(1e-3, 4e-3, 4)
        tx = rng.uniform(0.2e-3, 3e-3, 3)
        plans.append(TaskPlan.multihop(
            comp, tx, exit_hop=1 if i % 3 == 0 else None))
    pr_sim = run_pipeline(plans, arrival_period=2e-3)
    pr_async = run_pipeline_async(plans, arrival_period=2e-3)
    _assert_timelines_agree(pr_sim, pr_async)
    n_exit = sum(1 for p in plans if p.exit_hop == 1)
    assert n_exit > 0
    for pr in (pr_sim, pr_async):
        assert pr.exit_hop_counts() == {1: n_exit}
        # exited tasks occupy compute 0-1 and link 0 only
        assert len(pr.compute_intervals[0]) == len(plans)
        assert len(pr.compute_intervals[1]) == len(plans)
        assert len(pr.link_intervals[0]) == len(plans)
        for k in (2, 3):
            assert len(pr.compute_intervals[k]) == len(plans) - n_exit
        for k in (1, 2):
            assert len(pr.link_intervals[k]) == len(plans) - n_exit


def test_exit_hop_releases_downstream_and_cuts_bubbles():
    """The point of hop-level exit: on a stream where half the tasks
    terminate at the edge tier, the cloud's busy time drops by exactly
    the exited tasks' cloud occupation, and every exited task finishes
    no later than its full-pipeline twin."""
    comp, tx = (2e-3, 1.5e-3, 2e-3), (1e-3, 1e-3)
    full = [TaskPlan.multihop(comp, tx) for _ in range(40)]
    mixed = [TaskPlan.multihop(comp, tx, exit_hop=1 if i % 2 else None)
             for i in range(40)]
    pf = run_pipeline(full, arrival_period=2.2e-3)
    pm = run_pipeline(mixed, arrival_period=2.2e-3)
    n_exit = sum(1 for p in mixed if p.exit_hop is not None)
    assert abs(pf.compute_busy[2] - pm.compute_busy[2]
               - n_exit * comp[2]) < TOL
    assert abs(pf.link_busy_hops[1] - pm.link_busy_hops[1]
               - n_exit * tx[1]) < TOL
    for a, b in zip(pf.tasks, pm.tasks):
        assert b.done <= a.done + TOL
    assert pm.makespan < pf.makespan - TOL


# ------------------------------------------- overlap on a benchmark stream
def test_async_overlap_on_two_tier_benchmark_stream():
    """2-hop (end->cloud) stream from a real model cost graph: the
    executor overlaps stages (makespan < serial latency sum) and still
    matches the simulator to 1e-6."""
    from repro_torch.models.cnn import vgg16

    g = vgg16()
    n = len(g)
    cut = n // 2
    dec = PartitionDecision(frozenset(range(cut)), {(cut - 1, cut): 8})
    link = LinkProfile("wifi", 50e6)
    st = evaluate_partition(g, dec, DeviceProfile("jetson", 3.5e12),
                            DeviceProfile("a6000", 25e12), link)
    plans = [plan_from_stage_times(st) for _ in range(40)]
    period = st.max_stage * 1.05
    pr_async = run_pipeline_async(plans, arrival_period=period,
                                  links=[link])
    serial_sum = sum(t.latency for t in pr_async.tasks)
    assert pr_async.makespan < serial_sum - TOL, \
        "no stage overlap: executor is serializing tasks"
    pr_sim = run_pipeline(plans, arrival_period=period, links=[link])
    _assert_timelines_agree(pr_sim, pr_async)


# --------------------------------------------------- bounded-queue policy
def test_bounded_queues_complete_in_order_with_backpressure():
    plans = _random_multihop_plans(3, n_hops=2, n=30)
    free = run_pipeline_async(plans, arrival_period=0.0)
    tight = run_pipeline_async(plans, arrival_period=0.0, queue_capacity=1)
    # every task completes, in admission order on the final resource
    ids = [t.id for t in tight.tasks]
    assert ids == sorted(ids) and len(ids) == len(plans)
    full_done = [t.done for t in tight.tasks if not t.early_exit]
    assert full_done == sorted(full_done)
    # backpressure can only delay completion, never accelerate it
    assert tight.makespan >= free.makespan - TOL
    for a, b in zip(free.tasks, tight.tasks):
        assert b.done >= a.done - TOL


@pytest.mark.slow
def test_wall_clock_driver_smoke():
    """WallClock is the only driver without a differential pin (real
    scheduling jitter makes exact times unreproducible); this real-time
    smoke run asserts the *completion set* — every task id, its early-
    exit flag, and full-pipeline completion order — matches a
    VirtualClock run of the same stream (~100 ms of wall time)."""
    from repro_torch.serving.async_engine import WallClock

    plans = _random_multihop_plans(9, n_hops=2, n=16)
    arrivals = [i * 1.5e-3 for i in range(len(plans))]
    ref = run_pipeline_async(plans, arrivals=arrivals)
    wall = run_pipeline_async(plans, arrivals=arrivals, clock=WallClock())
    assert [t.id for t in wall.tasks] == [t.id for t in ref.tasks]
    assert [t.early_exit for t in wall.tasks] == \
        [t.early_exit for t in ref.tasks]
    # per-resource interval counts match (every task visited every
    # resource it was planned to)
    for ivw, ivr in zip(wall.compute_intervals, ref.compute_intervals):
        assert len(ivw) == len(ivr)
    for ivw, ivr in zip(wall.link_intervals, ref.link_intervals):
        assert len(ivw) == len(ivr)
    # full-pipeline tasks complete in admission order on the wall clock
    full = [t.done for t in wall.tasks if not t.early_exit]
    assert full == sorted(full)
    assert wall.makespan > 0


def test_virtual_clock_deadlock_detected():
    clock = VirtualClock()

    async def main():
        from repro_torch.serving.async_engine import HopQueue
        q = HopQueue(clock)
        w = clock.spawn(q.get())   # nothing will ever put
        import asyncio
        await asyncio.gather(w)

    with pytest.raises(RuntimeError, match="deadlock"):
        clock.run(main())


# --------------------------------------------- decisions: async == sync
def _mk_engines(n_hops, seed=0, hop_exit=False, **cfg_kw):
    if n_hops == 1:
        st = StageTimes(T_e=2e-3, T_t=3e-3, T_c=2e-3, T_t_par=0,
                        T_c_par=0, latency=7e-3, first_tx_offset=2e-3,
                        cloud_start_offset=3e-3)
        links = None
    else:
        st = StageTimes(
            T_e=2e-3, T_t=4e-3, T_c=2e-3, T_t_par=0.0, T_c_par=0.0,
            latency=9e-3, first_tx_offset=2e-3, cloud_start_offset=3e-3,
            compute=(2e-3, 1.5e-3, 2e-3), link=(3e-3, 1e-3),
            link_par=(0.0, 0.0), compute_par=(0.0, 0.0),
            tx_offsets=(2e-3, 1.5e-3), rx_offsets=(3e-3, 1e-3))
        links = [LinkProfile("uplink", 20e6), LinkProfile("backhaul", 900e6)]
    depths = n_hops if hop_exit else 1
    stream = CorrelatedTaskStream(n_labels=30, dim=48,
                                  correlation="medium", seed=seed,
                                  n_probe_depths=depths)
    hop_calib = None
    if hop_exit:
        sets = make_hop_calibration_sets(stream, 400, n_depths=n_hops)
        feats, labels = sets[0]
        hop_calib = sets[1:]
    else:
        feats, labels = make_calibration_set(stream, 400)
    mk = lambda cls, cfg: cls(
        None, st, END, LinkProfile("wifi", 20e6), CLOUD, n_labels=30,
        calib_feats=feats, calib_labels=labels, boundary_elems=50_000,
        links=links, cfg=cfg, hop_calib=hop_calib)
    sync = mk(CoachEngine, None)
    async_ = mk(AsyncCoachEngine, EngineConfig(**cfg_kw) if cfg_kw else None)
    return sync, async_, stream


def _classify(stream):
    def f(task):
        d = np.linalg.norm(stream.mu - task.features[None], axis=1)
        feats = task.hop_features if task.hop_features is not None \
            else task.features
        return feats, int(np.argmin(d))
    return f


@pytest.mark.parametrize("n_hops", [1, 2])
def test_async_engine_decisions_identical_to_sync(n_hops):
    """Concurrency never changes decisions, only timing: a seeded stream
    yields identical EngineStats decision aggregates."""
    sync, async_, stream = _mk_engines(n_hops, seed=4)
    tasks = stream.tasks(300)
    s = sync.run_stream(list(tasks), arrival_period=3e-3,
                        classify=_classify(stream))
    a = async_.run_stream(list(tasks), arrival_period=3e-3,
                          classify=_classify(stream))
    assert a.exit_ratio == s.exit_ratio
    assert a.mean_bits == s.mean_bits
    assert a.accuracy == s.accuracy


@pytest.mark.parametrize("n_hops", [1, 2])
def test_async_engine_timeline_matches_sync_reference(n_hops):
    """With per-hop retiming off and unbounded queues the async engine's
    virtual-clock timeline equals the sync engine's simulated one."""
    sync, async_, stream = _mk_engines(
        n_hops, seed=6, per_hop_bits=False, queue_capacity=0)
    tasks = stream.tasks(250)
    s = sync.run_stream(list(tasks), arrival_period=3e-3,
                        classify=_classify(stream))
    a = async_.run_stream(list(tasks), arrival_period=3e-3,
                          classify=_classify(stream))
    _assert_timelines_agree(s.pipeline, a.pipeline)
    assert abs(a.wire_kb_per_task - s.wire_kb_per_task) < 1e-9


def test_hop_exit_engine_decisions_identical_sync_async():
    """With per-hop probes calibrated, a seeded stream exits tasks at the
    intermediate tier — and the sync and async engines still make bit-
    identical decisions (exit hops included)."""
    sync, async_, stream = _mk_engines(2, seed=4, hop_exit=True)
    tasks = stream.tasks(300)
    s = sync.run_stream(list(tasks), arrival_period=3e-3,
                        classify=_classify(stream))
    a = async_.run_stream(list(tasks), arrival_period=3e-3,
                          classify=_classify(stream))
    assert a.exit_ratio == s.exit_ratio
    assert a.mean_bits == s.mean_bits
    assert a.accuracy == s.accuracy
    assert a.exit_hops == s.exit_hops
    # the new axis is real: some tasks exited at the edge tier (hop 1),
    # on top of the classic end-device exits
    assert s.exit_hops.get(1, 0) > 0, s.exit_hops
    assert s.exit_hops.get(0, 0) > 0, s.exit_hops


def test_hop_exit_engine_timeline_matches_sync_reference():
    """Acceptance (engine level): with hop probes active, per-hop
    retiming off and unbounded queues, the async engine's virtual-clock
    timeline — mid-pipeline exits included — equals the sync engine's
    simulated one at 1e-6."""
    sync, async_, stream = _mk_engines(
        2, seed=6, hop_exit=True, per_hop_bits=False, queue_capacity=0)
    tasks = stream.tasks(250)
    s = sync.run_stream(list(tasks), arrival_period=3e-3,
                        classify=_classify(stream))
    a = async_.run_stream(list(tasks), arrival_period=3e-3,
                          classify=_classify(stream))
    _assert_timelines_agree(s.pipeline, a.pipeline)
    assert abs(a.wire_kb_per_task - s.wire_kb_per_task) < 1e-9
    assert s.pipeline.exit_hop_counts().get(1, 0) > 0


def test_hop_exit_engine_releases_downstream_resources():
    """Engine level resource release: the cloud serves exactly the tasks
    no probe exited, the backhaul carries exactly those too, and the
    uplink additionally carries the hop-1 exits (they were transmitted
    once, then terminated at the edge tier)."""
    _, hop, stream = _mk_engines(2, seed=11, hop_exit=True,
                                 per_hop_bits=False)
    n = 250
    tasks = stream.tasks(n)
    h = hop.run_stream(list(tasks), arrival_period=3e-3,
                       classify=_classify(stream))
    e0 = h.exit_hops.get(0, 0)
    e1 = h.exit_hops.get(1, 0)
    assert e0 > 0 and e1 > 0, h.exit_hops
    pr = h.pipeline
    assert len(pr.compute_intervals[0]) == n
    assert len(pr.link_intervals[0]) == n - e0
    assert len(pr.compute_intervals[1]) == n - e0
    assert len(pr.link_intervals[1]) == n - e0 - e1
    assert len(pr.compute_intervals[2]) == n - e0 - e1


def test_async_engine_per_hop_bits_retimes_inner_hop():
    """With per-hop adaptive bits on, the inner hop's occupation follows
    its own (fast backhaul) EMA instead of the offline-planned time:
    Eq. 11 fills the idle backhaul up toward the adjacent compute ceiling
    with extra precision (free accuracy margin), so the hop-1 busy time
    moves off the planned value, toward ``n_full * ceiling``."""
    _, async_, stream = _mk_engines(2, seed=8, queue_capacity=0)
    st = async_.st
    tasks = stream.tasks(200)
    a = async_.run_stream(list(tasks), arrival_period=3e-3,
                          classify=_classify(stream))
    n_full = sum(1 for t in a.pipeline.tasks if not t.early_exit)
    assert n_full > 0
    planned = n_full * st.link[1]
    ceiling = max(st.compute[1], st.compute[2])
    got = a.pipeline.link_busy_hops[1]
    assert abs(got - planned) > TOL, "inner hop was not retimed"
    # retimed occupation chases the per-hop Eq. 11 target
    assert abs(got - n_full * ceiling) < n_full * ceiling * 0.35


def test_hop_elems_priced_at_offline_precision():
    """Regression: the inner hop's element count must be derived from the
    offline partition's per-hop precision, not ``cfg.default_bits`` — a
    4-bit offline boundary at the same planned link time carries twice
    the elements of an 8-bit one."""
    _, eight, stream = _mk_engines(2, seed=1)
    four = AsyncCoachEngine(
        None, eight.st, END, eight.links[0], CLOUD, n_labels=30,
        calib_feats=stream.mu.astype(np.float32),
        calib_labels=np.arange(30), boundary_elems=50_000,
        links=eight.links, hop_bits_offline=(8, 4))
    assert four.sched.hop_elems[1] == 2 * eight.sched.hop_elems[1]
    # hop 0 stays the boundary feature count either way
    assert four.sched.hop_elems[0] == eight.sched.hop_elems[0] == 50_000


# ----------------------------------------------- real compute in workers


# --------------------------------------------- EngineConfig regression
def test_engine_config_default_is_not_shared():
    """Regression: ``cfg`` used to default to a single module-level
    ``EngineConfig()`` instance shared by every engine, so mutating one
    engine's config silently reconfigured all others."""
    stream = CorrelatedTaskStream(n_labels=5, dim=16, seed=0)
    feats, labels = make_calibration_set(stream, 50)
    st = StageTimes(T_e=1e-3, T_t=1e-3, T_c=1e-3, T_t_par=0, T_c_par=0,
                    latency=3e-3, first_tx_offset=1e-3,
                    cloud_start_offset=1e-3)
    mk = lambda: CoachEngine(None, st, END, LinkProfile("l", 1e7), CLOUD,
                             n_labels=5, calib_feats=feats,
                             calib_labels=labels, boundary_elems=100)
    e1, e2 = mk(), mk()
    assert e1.cfg is not e2.cfg
    e1.cfg.default_bits = 3
    assert e2.cfg.default_bits == 8
    # and the dataclass default itself was never mutated
    assert EngineConfig().default_bits == 8
