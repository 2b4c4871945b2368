"""Hypothesis properties for the observability layer.

Two generative invariants over random streams (task counts, service
times, hop exits), shapes (serial chains, heterogeneous replica pools,
micro-batching caps), and router policies:

1. *Trace pin* — the async executor under the virtual clock emits the
   same span timeline as the arithmetic simulator, to 1e-6 (the repo's
   differential-pin invariant extended from latencies to traces).
2. *Conservation* — ``repro_torch.obs.bubbles.attribute`` partitions every
   resource's horizon into busy intervals and attributed gaps:
   ``busy + sum(bubbles) = horizon`` per resource at 1e-9, every gap
   carries exactly one cause from the closed enum, and pinned
   unbounded-queue runs never produce ``downstream_backpressure``.

(Module is collect-ignored by ``conftest.py`` when hypothesis is not
installed.)
"""

from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core.pipeline import TaskPlan, run_pipeline
from repro_torch.core.sim import PoolSpec
from repro_torch.obs.bubbles import CAUSES, attribute, chain_resources
from repro_torch.obs.trace import TraceRecorder, assert_traces_match
from repro_torch.serving.async_engine import VirtualClock, run_pipeline_async
from repro_torch.serving.routing import ROUTER_POLICIES, make_router

CONS_TOL = 1e-9
PIN_TOL = 1e-6


@st.composite
def traced_scenarios(draw):
    n_hops = draw(st.integers(1, 3))
    n = draw(st.integers(1, 10))
    batched = draw(st.booleans())
    # t_fixed must stay within every drawn segment compute time (>= 1e-4)
    t_fixed = [draw(st.floats(0.0, 1e-4)) for _ in range(n_hops + 1)] \
        if batched else None
    plans, arr, t = [], [], 0.0
    for _ in range(n):
        comp = [draw(st.floats(1e-4, 5e-3)) for _ in range(n_hops + 1)]
        tx = [draw(st.floats(1e-5, 3e-3)) for _ in range(n_hops)]
        exit_hop = draw(st.one_of(st.none(), st.integers(0, n_hops - 1))) \
            if n_hops > 1 else None
        plans.append(TaskPlan.multihop(comp, tx, exit_hop=exit_hop,
                                       t_fixed=t_fixed))
        arr.append(t)
        # strictly positive gaps: zero-duration event chains are the
        # executor's known settle() blind spot (same exposure as the
        # chain/batching/pool differential suites)
        t += draw(st.floats(1e-5, 3e-3))
    caps = [draw(st.integers(1, 3)) for _ in range(n_hops + 1)] \
        if batched else None
    pools = policy = None
    seed = 0
    if draw(st.booleans()):
        pools = [PoolSpec(speeds=tuple(
            draw(st.floats(0.3, 2.5))
            for _ in range(draw(st.integers(1, 3)))))
            for _ in range(n_hops + 1)]
        policy = draw(st.sampled_from(sorted(ROUTER_POLICIES)))
        seed = draw(st.integers(0, 5))
    return plans, arr, caps, pools, policy, seed


def _run(engine, plans, arr, caps, pools, policy, seed):
    rec = TraceRecorder()
    router = make_router(policy, seed=seed) if pools else None
    kw = dict(arrivals=arr, batch_caps=caps, pools=pools, router=router,
              sink=rec)
    pr = run_pipeline(plans, **kw) if engine == "sim" else \
        run_pipeline_async(plans, clock=VirtualClock(), **kw)
    return pr, rec


@settings(max_examples=40, deadline=None)
@given(sc=traced_scenarios())
def test_trace_pin_extends_to_span_timelines(sc):
    pr_s, rec_s = _run("sim", *sc)
    pr_a, rec_a = _run("async", *sc)
    assert abs(pr_s.makespan - pr_a.makespan) <= PIN_TOL
    assert_traces_match(rec_s, rec_a, tol=PIN_TOL)


@settings(max_examples=40, deadline=None)
@given(sc=traced_scenarios())
def test_attribution_conserves_and_closes(sc):
    pr, rec = _run("sim", *sc)
    att = attribute(rec, resources=chain_resources(
        pr.n_hops, pr.pool_sizes or None))
    assert att.max_conservation_error() <= CONS_TOL
    for b in att.bubbles:
        assert b.cause in CAUSES
        assert b.dur > 0.0
        assert -CONS_TOL <= b.t0 and b.t1 <= att.horizon_s + CONS_TOL
    assert att.total(cause="downstream_backpressure") == 0.0
    # independent re-derivation of the identity, per resource
    busy = att.busy_by_label()
    for label, causes in att.by_label().items():
        assert abs(busy[label] + sum(causes.values()) - att.horizon_s) \
            <= CONS_TOL
