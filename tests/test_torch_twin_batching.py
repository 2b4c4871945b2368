"""Continuous micro-batching: differential pins + unit coverage.

The tentpole contract: with per-tier ``batch_caps``, the event-driven
executor (``AsyncHopPipeline``, virtual clock) and the arithmetic
simulator (``sim.simulate_stream`` -> staged batched replay) apply the
SAME greedy drain-up-to-cap-or-deadline batch formation rule — shared
helpers ``sim.greedy_batch_size`` / ``sim.batched_service_time`` make
the float arithmetic identical — so their timelines agree to 1e-6 on
2-/3-hop chains, caps {1, 2, 4, mixed}, mid-pipeline exits, staleness
deadlines, and dynamic-bandwidth links.  ``cap = 1`` must reproduce the
unbatched replay bit-identically (singleton batches fall through to the
legacy code paths on both sides).

On top of that: ``HopQueue.get_nowait/drain/snapshot`` semantics
(including the drain-must-snapshot-at-wake race the batching worker
fixes), the auto batch-size finder (geometric-then-binary probe) against
brute force, engine-level sync == async pins with batching configured,
and the multi-tenant engines (tier 0 clamped to cap 1 on both sides).
"""

import asyncio

import numpy as np
import pytest

from repro_torch.core import sim
from repro_torch.core.costs import DeviceProfile, LinkProfile
from repro_torch.core.pipeline import (TaskPlan, bandwidth_step_trace,
                                 result_from_stream, run_pipeline)
from repro_torch.core.schedule import StageTimes
from repro_torch.data.pipeline import CorrelatedTaskStream, make_calibration_set
from repro_torch.serving.async_engine import (AsyncCoachEngine, HopQueue,
                                        VirtualClock, run_pipeline_async)
from repro_torch.serving.base import EngineConfig
from repro_torch.serving.batching import (auto_batch_caps, find_batch_cap,
                                    realized_batch_sizes)
from repro_torch.serving.engine import CoachEngine
from repro_torch.serving.tenancy import (MultiTenantCoachEngine, TenantSpec,
                                   make_policy, run_multitenant_async)
from test_torch_twin_async_engine import _assert_timelines_agree

TOL = 1e-6

END = DeviceProfile("end", 1e9)
CLOUD = DeviceProfile("cloud", 8e9)


# ----------------------------------------------------------------- helpers
def _batched_plans(seed, n_hops=2, n=40, fixed_frac=0.7, deadline_slack=None,
                   offsets=True):
    """Random multi-hop streams with per-segment fixed costs, mixed
    mid-pipeline exits, optional Fig. 4 overlap offsets, and optional
    per-task staleness deadlines (``arrival + deadline_slack``)."""
    rng = np.random.RandomState(seed)
    plans = []
    for i in range(n):
        comp = rng.uniform(1e-3, 4e-3, n_hops + 1)
        tx = rng.uniform(0.2e-3, 3e-3, n_hops)
        t_fixed = tuple(fixed_frac * c for c in comp)
        deadline = None if deadline_slack is None \
            else i * 2e-3 + deadline_slack
        if rng.rand() < 0.15:
            plans.append(TaskPlan(comp[0], 0.0, 0.0, True,
                                  t_fixed=(t_fixed[0],), deadline=deadline))
            continue
        txo = rxo = None
        if offsets:
            txo = [rng.uniform(0, comp[k]) if rng.rand() < 0.5 else None
                   for k in range(n_hops)]
            rxo = [rng.uniform(0, tx[k]) if rng.rand() < 0.5 else None
                   for k in range(n_hops)]
        exit_hop = None
        if n_hops >= 2 and rng.rand() < 0.25:
            exit_hop = int(rng.randint(1, n_hops))
        plans.append(TaskPlan.multihop(comp, tx, txo, rxo, exit_hop=exit_hop,
                                       t_fixed=t_fixed, deadline=deadline))
    return plans


def _caps(n_hops, variant):
    n_seg = n_hops + 1
    return {
        "all2": [2] * n_seg,
        "all4": [4] * n_seg,
        "mixed": [1, 4] + [2] * (n_seg - 2),
    }[variant]


# ------------------------------------------------ differential: plan level
@pytest.mark.parametrize("variant", ["all2", "all4", "mixed"])
@pytest.mark.parametrize("n_hops", [2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_differential_batched_chain(variant, n_hops, seed):
    """Acceptance: batched executor == batched simulator at 1e-6 on 2-
    and 3-hop chains, caps {2, 4, mixed}, mid-pipeline exits included."""
    plans = _batched_plans(seed, n_hops=n_hops)
    caps = _caps(n_hops, variant)
    pr_sim = run_pipeline(plans, arrival_period=2e-3, batch_caps=caps)
    pr_async = run_pipeline_async(plans, arrival_period=2e-3,
                                  batch_caps=caps)
    _assert_timelines_agree(pr_sim, pr_async)


@pytest.mark.parametrize("seed", [0, 1])
def test_differential_batched_with_deadlines(seed):
    """Staleness deadlines gate batch formation identically on both
    sides (the deadline check runs inside the shared greedy rule)."""
    plans = _batched_plans(seed, n_hops=2, deadline_slack=3e-3)
    caps = [4, 4, 4]
    pr_sim = run_pipeline(plans, arrival_period=2e-3, batch_caps=caps)
    pr_async = run_pipeline_async(plans, arrival_period=2e-3,
                                  batch_caps=caps)
    _assert_timelines_agree(pr_sim, pr_async)


def test_differential_batched_with_traced_uplink():
    """Dynamic-bandwidth repricing composes with batching: the link
    stage re-integrates each transfer at its actual start on both
    sides, and the retimed hand-off instants still form identical
    batches downstream."""
    uplink = LinkProfile("dyn", 40e6, trace=bandwidth_step_trace(
        [(0.0, 40.0), (0.02, 6.0), (0.08, 60.0)]))
    backhaul = LinkProfile("bh", 900e6)
    plans = _batched_plans(5, n_hops=2)
    caps = [2, 4, 4]
    pr_sim = run_pipeline(plans, arrival_period=2e-3,
                          links=[uplink, backhaul], batch_caps=caps)
    pr_async = run_pipeline_async(plans, arrival_period=2e-3,
                                  links=[uplink, backhaul], batch_caps=caps)
    _assert_timelines_agree(pr_sim, pr_async)


def test_differential_batched_burst_arrivals():
    """All-at-once arrivals (deepest queues -> largest batches): the
    executor's wake-instant snapshot equals the simulator's candidate
    prefix even when every queue is saturated."""
    plans = _batched_plans(11, n_hops=2, n=30)
    arrivals = [0.0] * len(plans)
    caps = [4, 4, 4]
    pr_sim = run_pipeline(plans, arrivals=arrivals, batch_caps=caps)
    pr_async = run_pipeline_async(plans, arrivals=arrivals, batch_caps=caps)
    _assert_timelines_agree(pr_sim, pr_async)
    # saturation makes real multi-task batches: fewer busy intervals
    # than tasks on the batched downstream tiers
    n_t1 = sum(1 for p in plans
               if sim.occupies_compute(p.as_sim_plan(2).exit_hop, 1))
    assert len(pr_sim.compute_intervals[1]) < n_t1


# --------------------------------------------------- cap = 1 bit-identity
@pytest.mark.parametrize("n_hops", [2, 3])
def test_cap_one_is_bit_identical_to_unbatched(n_hops):
    """Acceptance: ``batch_caps`` of all ones reproduces today's
    timelines *bit-identically* (not 1e-6) — the batched entry point
    routes to the untouched legacy replay."""
    for seed in range(3):
        plans = _batched_plans(seed, n_hops=n_hops)
        a = run_pipeline(plans, arrival_period=2e-3)
        b = run_pipeline(plans, arrival_period=2e-3,
                         batch_caps=[1] * (n_hops + 1))
        assert [t.done for t in a.tasks] == [t.done for t in b.tasks]
        assert a.compute_intervals == b.compute_intervals
        assert a.link_intervals == b.link_intervals
        assert a.makespan == b.makespan
        ae = run_pipeline_async(plans, arrival_period=2e-3)
        be = run_pipeline_async(plans, arrival_period=2e-3,
                                batch_caps=[1] * (n_hops + 1))
        assert [t.done for t in ae.tasks] == [t.done for t in be.tasks]
        assert ae.compute_intervals == be.compute_intervals


def test_staged_replay_all_ones_matches_legacy_bitwise():
    """The staged tier-by-tier batched replay with every cap at 1 uses
    the same float expressions as the classic interleaved loop: the
    timelines are equal with ``==`` on the seeds pinned here."""
    for seed in range(3):
        plans = [p.as_sim_plan(2)
                 for p in _batched_plans(seed + 20, n_hops=2)]
        arrivals = [i * 2e-3 for i in range(len(plans))]
        a = sim.simulate_stream(plans, arrivals)
        b = sim._simulate_stream_batched(plans, arrivals, None, [1, 1, 1])
        assert a.done == b.done
        assert a.compute_intervals == b.compute_intervals
        assert a.link_intervals == b.link_intervals


# ---------------------------------------------- batching actually batches
def test_batching_compresses_busy_intervals_and_cuts_makespan():
    """On an overloaded stream with a large fixed fraction, batching
    amortizes the launch cost: fewer busy intervals, smaller makespan,
    conserved task set."""
    plans = _batched_plans(3, n_hops=2, n=40, fixed_frac=0.85,
                           offsets=False)
    arrivals = [i * 0.5e-3 for i in range(len(plans))]
    un = run_pipeline(plans, arrivals=arrivals)
    ba = run_pipeline(plans, arrivals=arrivals, batch_caps=[4, 4, 4])
    assert len(ba.tasks) == len(un.tasks)
    assert [t.exit_hop for t in ba.tasks] == [t.exit_hop for t in un.tasks]
    assert ba.makespan < un.makespan - TOL
    assert sum(len(iv) for iv in ba.compute_intervals) < \
        sum(len(iv) for iv in un.compute_intervals)
    rb = realized_batch_sizes(ba)
    ru = realized_batch_sizes(un)
    assert all(abs(r - 1.0) < 1e-12 for r in ru)
    assert max(rb) > 1.0
    # batch members forward serially, so per-resource FIFO survives:
    # busy intervals stay sorted and disjoint on every resource
    for iv in list(ba.compute_intervals) + list(ba.link_intervals):
        assert sim._sorted_disjoint(iv)


def test_deadline_excludes_overrunning_follower():
    """The staleness gate, white-box: two same-instant tasks on a cap-2
    tier batch together for ``fixed + 2 * marginal`` — unless the
    follower's deadline can't absorb the batched finish, in which case
    it runs solo.  Executor and simulator agree either way."""
    def plans(follower_deadline):
        mk = lambda dl: TaskPlan.multihop(
            (4e-3, 1e-3), (0.5e-3,), t_fixed=(3e-3, 0.0), deadline=dl)
        return [mk(None), mk(follower_deadline)]

    for dl, expected_iv0 in ((5.5e-3, 1), (4.5e-3, 2)):
        pr_sim = run_pipeline(plans(dl), arrivals=[0.0, 0.0],
                              batch_caps=[2, 1])
        pr_async = run_pipeline_async(plans(dl), arrivals=[0.0, 0.0],
                                      batch_caps=[2, 1])
        _assert_timelines_agree(pr_sim, pr_async)
        # batch of 2 costs 3 + 2*1 = 5 ms: a 5.5 ms deadline admits the
        # follower (one tier-0 interval), a 4.5 ms one excludes it (two)
        assert len(pr_sim.compute_intervals[0]) == expected_iv0, dl
        if expected_iv0 == 1:
            s, e = pr_sim.compute_intervals[0][0]
            assert abs((e - s) - 5e-3) < 1e-12
            assert e <= dl + 1e-12


# --------------------------------------------------- shared greedy rule
def _plan(comp, fixed, deadline=None):
    return sim.SimPlan(compute=tuple(comp), tx=(0.0,) * (len(comp) - 1),
                       t_fixed=tuple(fixed), deadline=deadline)


def test_batched_service_time_semantics():
    p1 = _plan([4e-3, 2e-3], [3e-3, 1e-3])
    p2 = _plan([6e-3, 2e-3], [5e-3, 0.5e-3])
    # singleton: exactly compute[k] (bit-identity by construction)
    assert sim.batched_service_time([p1], 0) == p1.compute[0]
    # pair: max fixed + sum of marginals
    got = sim.batched_service_time([p1, p2], 0)
    assert abs(got - (5e-3 + 1e-3 + 1e-3)) < 1e-15
    # batching a pair is cheaper than serial, dearer than one task
    assert p2.compute[0] < got < p1.compute[0] + p2.compute[0]


def test_greedy_batch_size_cap_ready_and_deadline_gates():
    p = lambda dl=None: _plan([4e-3, 1e-3], [3e-3, 0.0], deadline=dl)
    plans = [p(), p(), p(), p()]
    ready = [0.0, 0.0, 0.0, 0.0]
    # cap gate
    assert sim.greedy_batch_size(0, 1, 0.0, plans, ready) == 1
    assert sim.greedy_batch_size(0, 3, 0.0, plans, ready) == 3
    assert sim.greedy_batch_size(0, 8, 0.0, plans, ready) == 4
    # ready gate: formation stops at the first not-yet-ready follower
    # (FIFO prefix — even though plans[3] is ready, it cannot jump ahead)
    assert sim.greedy_batch_size(0, 8, 0.0, plans,
                                 [0.0, 0.0, 1e-6, 0.0]) == 2
    # deadline gate: an n-batch costs 3 + n ms.  A 6 ms follower
    # deadline admits the 3-batch (exactly 6 ms) but blocks the fourth
    # member (7 ms); tightened to 5.5 ms it refuses to join at all
    tight = [p(), p(), p(6e-3), p()]
    assert sim.greedy_batch_size(0, 8, 0.0, tight, ready) == 3
    tighter = [p(), p(), p(5.5e-3), p()]
    assert sim.greedy_batch_size(0, 8, 0.0, tighter, ready) == 2
    # the head itself is never deadline-gated (it must run regardless)
    late = [p(1e-6), p(), p(), p()]
    assert sim.greedy_batch_size(0, 8, 0.0, late, ready) >= 1
    # ... and its (blown) deadline still gates followers
    assert sim.greedy_batch_size(0, 8, 0.0, late, ready) == 1


# ------------------------------------------------------- HopQueue API
def test_hop_queue_get_nowait_and_snapshot():
    clock = VirtualClock()
    q = HopQueue(clock)

    async def main():
        await q.put("a")
        await q.put("b")
        assert q.snapshot() == ("a", "b")   # non-destructive
        assert len(q) == 2
        assert q.get_nowait() == "a"
        assert q.get_nowait() == "b"
        with pytest.raises(asyncio.QueueEmpty):
            q.get_nowait()

    clock.run(main())


def test_hop_queue_drain_is_fifo_and_respects_n():
    clock = VirtualClock()
    q = HopQueue(clock)

    async def main():
        for i in range(5):
            await q.put(i)
        assert q.drain(3) == [0, 1, 2]
        assert q.snapshot() == (3, 4)
        assert q.drain(99) == [3, 4]     # never blocks: takes what's there
        assert q.drain(2) == []

    clock.run(main())


def test_hop_queue_drain_admits_blocked_putters():
    """Each slot freed by ``drain``/``get_nowait`` admits one blocked
    putter, preserving FIFO across the bound."""
    clock = VirtualClock()
    q = HopQueue(clock, maxsize=2)
    landed = []

    async def producer(i):
        await q.put(i)     # producers 2, 3 block (queue holds 0, 1)
        landed.append(i)

    async def consumer():
        await clock.sleep(1.0)          # let all four producers run/block
        assert q.snapshot() == (0, 1)
        assert q.drain(2) == [0, 1]
        # draining freed two slots: both blocked putters were admitted
        assert q.snapshot() == (2, 3)
        assert q.get_nowait() == 2
        assert q.get_nowait() == 3

    async def main():
        ws = [clock.spawn(producer(i)) for i in range(4)]
        ws.append(clock.spawn(consumer()))
        await asyncio.gather(*ws)

    clock.run(main())
    assert sorted(landed) == [0, 1, 2, 3]


def test_hop_queue_snapshot_fixes_membership_against_later_puts():
    """The race ``drain`` documents: items enqueued after the wake
    instant must not join the batch.  A consumer that snapshots, sleeps,
    then drains by the *snapshot* size never sees the late item; sizing
    the drain by ``len(queue)`` at drain time would."""
    clock = VirtualClock()
    q = HopQueue(clock)
    got = {}

    async def early_producer():
        await q.put("early-0")
        await q.put("early-1")

    async def late_producer():
        await clock.sleep(0.5)
        await q.put("late")

    async def consumer():
        await clock.settle()
        n_wake = len(q.snapshot())       # membership fixed at wake: 2
        await clock.sleep(1.0)           # late item lands mid-sleep
        got["len_at_drain"] = len(q)     # the racy size would be 3
        got["batch"] = q.drain(n_wake)

    async def main():
        ws = [clock.spawn(early_producer()), clock.spawn(late_producer()),
              clock.spawn(consumer())]
        await asyncio.gather(*ws)

    clock.run(main())
    assert got["len_at_drain"] == 3
    assert got["batch"] == ["early-0", "early-1"]


# -------------------------------------------------- auto batch-size finder
def _brute_cap(measure, slack, cap_limit):
    base = measure(1)
    best = 1
    for n in range(2, cap_limit + 1):
        if measure(n) - base <= slack:
            best = n
        else:
            break
    return best


@pytest.mark.parametrize("fixed,marginal,slack,cap_limit", [
    (9e-3, 1e-3, 5e-3, 32),    # boundary mid-range
    (9e-3, 1e-3, 0.0, 32),     # no slack -> 1
    (9e-3, 1e-3, 1e-3, 32),    # exactly one extra member
    (5e-3, 0.0, 1e-9, 32),     # free members -> cap_limit
    (9e-3, 1e-3, 5e-3, 1),     # cap_limit = 1 short-circuits
    (9e-3, 1e-3, 4.5e-3, 7),   # non-power-of-two limit
    (1e-3, 3e-3, 7e-3, 16),    # marginal-dominated
])
def test_find_batch_cap_matches_brute_force(fixed, marginal, slack,
                                            cap_limit):
    measure = lambda n: fixed + n * marginal
    assert find_batch_cap(measure, slack, cap_limit) == \
        _brute_cap(measure, slack, cap_limit)


def test_find_batch_cap_probe_count_is_logarithmic():
    """Geometric-then-binary: far fewer probes than the exhaustive
    sweep (the point of the Lightning-style finder)."""
    calls = []
    measure = lambda n: (calls.append(n), 1e-3 * n)[1]
    cap = find_batch_cap(measure, 20e-3, 1024)
    assert cap == _brute_cap(lambda n: 1e-3 * n, 20e-3, 1024) == 21
    assert len(calls) <= 2 * 10 + 2      # ~2 log2(1024), not ~1024


def test_find_batch_cap_general_monotone_measure():
    """Only monotonicity is assumed: a measured (non-affine) profile
    with a sharp knee still lands exactly on the knee."""
    measure = lambda n: 1e-3 * n if n <= 5 else 1e-3 * n + 50e-3
    assert find_batch_cap(measure, 10e-3, 32) == 5


def test_auto_batch_caps_per_tier_split_and_ingress_clamp():
    compute = [4e-3, 4e-3, 4e-3]
    fixed = [3.6e-3, 3.6e-3, 0.0]     # tier 2 has no amortizable part
    # slack 6.1 ms -> ~2.03 ms per tier -> ~5 extra members at 0.4 ms
    # marginal on the high-fixed tiers; the all-marginal tier (4 ms
    # marginal) can't batch at all
    caps = auto_batch_caps(compute, fixed, slack=6.1e-3, cap_limit=32)
    assert caps == [6, 6, 1]
    # a hard ingress clamp (cap <= 1) excludes tier 0 from the split:
    # its unusable 1/3 share is redistributed, so tier 1's budget grows
    # from ~2.03 ms to ~3.05 ms (-> 8 members at 0.4 ms marginal).  The
    # former even split silently wasted the clamped share ([1, 6, 1]).
    caps = auto_batch_caps(compute, fixed, slack=6.1e-3, cap_limit=32,
                           ingress_cap=1)
    assert caps == [1, 8, 1]
    # zero / negative slack: unbatched everywhere
    assert auto_batch_caps(compute, fixed, slack=0.0) == [1, 1, 1]
    assert auto_batch_caps(compute, fixed, slack=-1.0) == [1, 1, 1]


def test_auto_batch_caps_redistribution_is_monotone_downstream():
    """Excluding a clamped ingress from the split can only grow the
    downstream tiers' budgets: every unclamped cap under ``ingress_cap=1``
    is >= its naive even-split counterpart (``find_batch_cap`` is
    monotone in its slack budget)."""
    rng = np.random.RandomState(7)
    for _ in range(50):
        n_seg = int(rng.randint(2, 6))
        compute = rng.uniform(1e-3, 6e-3, n_seg)
        fixed = compute * rng.uniform(0.0, 0.95, n_seg)
        slack = float(rng.uniform(0.0, 20e-3))
        naive = auto_batch_caps(list(compute), list(fixed), slack)
        redis = auto_batch_caps(list(compute), list(fixed), slack,
                                ingress_cap=1)
        assert redis[0] == 1
        for k in range(1, n_seg):
            assert redis[k] >= naive[k]
    # ingress_cap > 1 still clamps but does NOT exclude tier 0 from the
    # split (it can spend some slack), so downstream caps are unchanged
    compute, fixed = [4e-3, 4e-3, 4e-3], [3.6e-3, 3.6e-3, 0.0]
    assert auto_batch_caps(compute, fixed, slack=6.1e-3,
                           ingress_cap=2) == [2, 6, 1]


# ------------------------------------------------------- engine level
def _mk_engine_pair(n_hops, seed=0, **cfg_kw):
    """Sync + async engines sharing one batching-enabled EngineConfig
    (unlike ``test_async_engine._mk_engines``, the sync side gets the
    same config — the batched timelines must agree)."""
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
    stream = CorrelatedTaskStream(n_labels=30, dim=48,
                                  correlation="medium", seed=seed)
    feats, labels = make_calibration_set(stream, 400)
    mk = lambda cls: cls(
        None, st, END, LinkProfile("wifi", 20e6), CLOUD, n_labels=30,
        calib_feats=feats, calib_labels=labels, boundary_elems=50_000,
        links=links, cfg=EngineConfig(**cfg_kw))

    def classify(task):
        d = np.linalg.norm(stream.mu - task.features[None], axis=1)
        return task.features, int(np.argmin(d))

    return mk(CoachEngine), mk(AsyncCoachEngine), stream, classify


def test_engine_batched_timeline_sync_equals_async():
    """Acceptance (engine level): a batching-configured AsyncCoachEngine
    stays differentially pinned to the sync reference (which replays the
    same plans through ``core.sim``) at 1e-6."""
    sync, async_, stream, classify = _mk_engine_pair(
        2, seed=6, per_hop_bits=False, queue_capacity=0,
        batch_caps=[2, 4, 4], batch_fixed_frac=0.75, batch_slack=30e-3)
    tasks = stream.tasks(250)
    s = sync.run_stream(list(tasks), arrival_period=1e-3,
                        classify=classify)
    a = async_.run_stream(list(tasks), arrival_period=1e-3,
                          classify=classify)
    _assert_timelines_agree(s.pipeline, a.pipeline)
    # decisions are batching-invariant
    assert a.exit_ratio == s.exit_ratio and a.mean_bits == s.mean_bits
    # the stream is overloaded enough that batches actually formed
    assert max(realized_batch_sizes(a.pipeline)) > 1.0


def test_engine_batching_preserves_decisions_and_cap1_timeline():
    """``batch_caps`` of ones with a fixed-cost calibration is exactly
    the unbatched engine: identical timeline (the t_fixed annotations
    alone change nothing)."""
    _, base, stream, classify = _mk_engine_pair(
        2, seed=3, per_hop_bits=False, queue_capacity=0)
    _, ones, _, _ = _mk_engine_pair(
        2, seed=3, per_hop_bits=False, queue_capacity=0,
        batch_caps=[1, 1, 1], batch_fixed_frac=0.75)
    tasks = stream.tasks(150)
    b = base.run_stream(list(tasks), arrival_period=2e-3,
                        classify=classify)
    o = ones.run_stream(list(tasks), arrival_period=2e-3,
                        classify=classify)
    assert [t.done for t in o.pipeline.tasks] == \
        [t.done for t in b.pipeline.tasks]
    assert o.pipeline.compute_intervals == b.pipeline.compute_intervals


def test_engine_auto_batch_finder_plumbed_through_config():
    """``auto_batch = True`` runs the finder at engine build: the caps
    equal a direct ``auto_batch_caps`` call on the engine's calibrated
    stage times, and a high fixed fraction + generous slack yields real
    (> 1) caps."""
    _, eng, _, _ = _mk_engine_pair(
        2, seed=0, auto_batch=True, batch_fixed_frac=0.9,
        batch_slack=12e-3, batch_cap_limit=16)
    expect = auto_batch_caps(list(eng.st.compute), eng.batch_fixed,
                             12e-3, 16)
    assert eng.batch_caps == expect
    assert max(eng.batch_caps) > 1
    # explicit caps win over the finder
    _, expl, _, _ = _mk_engine_pair(
        2, seed=0, auto_batch=True, batch_caps=[1, 2, 3],
        batch_fixed_frac=0.9, batch_slack=12e-3)
    assert expl.batch_caps == [1, 2, 3]


# ------------------------------------------------------- multi-tenant
@pytest.mark.parametrize("policy", ["fifo", "rr", "wdrr"])
def test_differential_multitenant_batched_plan_level(policy):
    """Batched multi-tenant executor == batched multi-tenant simulator:
    admission order, merged timeline, busy intervals — tier 0 clamped to
    cap 1 on both sides (credit-gated ingress)."""
    rng = np.random.RandomState(17)
    n_hops, caps, weights = 2, [8, 4, 2], [1.0, 2.5, 0.5]
    plans, arrs = [], []
    for t in range(3):
        n = int(rng.randint(6, 14))
        ps, ar = [], []
        tt = float(rng.uniform(0, 2e-3))
        for _ in range(n):
            comp = tuple(rng.uniform(1e-4, 4e-3, n_hops + 1))
            tx = tuple(rng.uniform(0.0, 2e-3, n_hops))
            eh = None if rng.rand() < 0.75 else int(rng.randint(1, n_hops))
            ps.append(TaskPlan.multihop(
                comp, tx, exit_hop=eh,
                t_fixed=tuple(0.7 * c for c in comp), deadline=tt + 8e-3))
            ar.append(tt)
            tt += float(rng.uniform(0, 1.2e-3))
        plans.append(ps)
        arrs.append(ar)
    mt_exec = run_multitenant_async(plans, arrs, policy=policy,
                                    weights=weights, links=[None, None],
                                    batch_caps=caps)
    sps = [[p.as_sim_plan(n_hops) for p in ps] for ps in plans]
    mt_sim = sim.simulate_multitenant_stream(
        sps, arrs, make_policy(policy, weights=weights), batch_caps=caps)
    assert mt_exec.order == mt_sim.order
    _assert_timelines_agree(result_from_stream(mt_sim.stream),
                            result_from_stream(mt_exec.stream))
    for t in range(3):
        la = mt_exec.tenant_latencies(t)
        lb = mt_sim.tenant_latencies(t)
        assert all(abs(a - b) < TOL for a, b in zip(la, lb))


def test_mt_engine_batched_timeline_pinned_to_simulator():
    """Acceptance (engine level): a batching-configured
    MultiTenantCoachEngine stays pinned to
    ``simulate_multitenant_stream(batch_caps=...)`` at 1e-6, and the
    burst tenant's queue depth produces real multi-task batches."""
    tenants = [
        TenantSpec("interactive", 40, arrival_period=4e-3, weight=4.0,
                   slo_latency=200e-3),
        TenantSpec("burst", 50, arrivals=(0.0,) * 50, weight=1.0,
                   slo_latency=1.0),
    ]
    # downstream-heavy deployment: a fast ingress feeding slow edge /
    # cloud tiers, so the burst builds real queue depth where batching
    # is allowed (tier 0 is clamped to cap 1 by the credit gate)
    st = StageTimes(
        T_e=1e-3, T_t=2e-3, T_c=3.5e-3, T_t_par=0.0, T_c_par=0.0,
        latency=10.5e-3, first_tx_offset=1e-3, cloud_start_offset=2e-3,
        compute=(1e-3, 3e-3, 3.5e-3), link=(2e-3, 1e-3),
        link_par=(0.0, 0.0), compute_par=(0.0, 0.0),
        tx_offsets=(1e-3, 3e-3), rx_offsets=(2e-3, 1e-3))
    # fast links so the slow compute tiers (not the wire) are the
    # bottleneck where queue depth accumulates
    links = [LinkProfile("uplink", 400e6), LinkProfile("backhaul", 900e6)]
    stream = CorrelatedTaskStream(n_labels=30, dim=48,
                                  correlation="medium", seed=4)
    feats, labels = make_calibration_set(stream, 400)

    def classify(task):
        d = np.linalg.norm(stream.mu - task.features[None], axis=1)
        return task.features, int(np.argmin(d))

    cfg = EngineConfig(per_hop_bits=False, queue_capacity=0,
                       batch_caps=[4, 4, 4], batch_fixed_frac=0.75,
                       batch_slack=150e-3)
    eng = MultiTenantCoachEngine(
        None, st, END, links[0], CLOUD, n_labels=30, calib_feats=feats,
        calib_labels=labels, tenants=tenants, policy="wdrr", cfg=cfg,
        boundary_elems=50_000, links=links)
    tasks = [stream.tasks(t.n_tasks) for t in tenants]
    mt = eng.run_streams([list(ts) for ts in tasks], classify)
    ref = sim.simulate_multitenant_stream(
        mt.plans, mt.arrivals,
        make_policy("wdrr", weights=[t.weight for t in tenants]),
        links=eng.links, batch_caps=eng.batch_caps)
    assert mt.order == ref.order
    _assert_timelines_agree(result_from_stream(ref.stream), mt.pipeline)
    assert max(realized_batch_sizes(mt.pipeline)) > 1.0
    # tier 0 was clamped: ingress ran strictly one task per slot
    assert len(mt.pipeline.compute_intervals[0]) == sum(
        t.n_tasks for t in tenants)
